"""Evaluation metrics (counterpart of `r3dfsseg_tpu/utils/metrics.py`).

Vectorised replacement for the reference's pure-Python per-point confusion
loop (its `eval_noise.py:23-72`), which walks every query point
of every episode in nested Python `for` loops — the eval-side host hot loop.
Here each episode contributes one `np.bincount` over remapped labels.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class IoUAccumulator:
    """Streaming confusion counts over (len(test_classes)+1) global classes.

    Episode labels j in {1..n_way} map through label2class (the episode's
    sampled dataset classes) into `test_classes` indices, exactly as
    eval_noise.py:48-62; background is global class 0; mean-IoU excludes
    background (eval_noise.py:70).
    """

    def __init__(self, test_classes: Sequence[int]):
        self.test_classes = list(test_classes)
        n = len(self.test_classes) + 1
        self.n = n
        self.gt = np.zeros(n, np.int64)
        self.pos = np.zeros(n, np.int64)
        self.tp = np.zeros(n, np.int64)

    def _remap(self, labels: np.ndarray, label2class: np.ndarray) -> np.ndarray:
        """episode label (0..n_way) -> global index (0..len(test_classes))."""
        lut = np.zeros(len(label2class) + 1, np.int64)
        for j, cls in enumerate(label2class):
            lut[j + 1] = self.test_classes.index(int(cls)) + 1
        return lut[labels.astype(np.int64).ravel()]

    def update(self, pred: np.ndarray, gt: np.ndarray, label2class: np.ndarray):
        """pred/gt: (n_queries*n_way, n_points) episode-label arrays."""
        p = self._remap(np.asarray(pred), label2class)
        g = self._remap(np.asarray(gt), label2class)
        self.gt += np.bincount(g, minlength=self.n)
        self.pos += np.bincount(p, minlength=self.n)
        self.tp += np.bincount(g[p == g], minlength=self.n)

    def iou(self) -> np.ndarray:
        denom = self.gt + self.pos - self.tp
        return self.tp / np.maximum(denom, 1)

    def mean_iou(self) -> float:
        """Mean over foreground classes (eval_noise.py:64-72)."""
        return float(self.iou()[1:].mean())


def evaluate_metric(pred_list: List[np.ndarray], gt_list: List[np.ndarray],
                    label2class_list: List[np.ndarray],
                    test_classes: Sequence[int]) -> float:
    """Drop-in equivalent of `evaluate_metric` (eval_noise.py:23-72)."""
    acc = IoUAccumulator(test_classes)
    for pred, gt, l2c in zip(pred_list, gt_list, label2class_list):
        acc.update(pred, gt, l2c)
    return acc.mean_iou()
