"""Noise-robustness diagnostics (counterpart of
`r3dfsseg_tpu/utils/diagnostics.py`), computed against ground-truth labels:

  * `clean_detection_precision_recall` — the original code's
    `check_clean_detection` (`models/protonet.py:159-182`);
  * `query_label_precision_recall` — `check_query_label`
    (protonet.py:184-212);
  * `support_mask_accuracy` — `check_support_mask_accuracy`
    (protonet.py:214-242);
  * `prototype_cleanness` — `Check_Proto_Cleanness`
    (`models/mpti.py:374-412`).

Plain tensor functions; the eval step returns the MDNS ones in its aux
dict (`models/mpti.py`), without a host sync.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from r3dfsseg_tpu_torch.ops.segment import segment_sum


def clean_detection_precision_recall(gt_flags: torch.Tensor, pred_flags: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision and recall of predicted clean flags against the truth.
    Any matching shapes; 1 = clean."""
    gt = gt_flags.float()
    pr = pred_flags.float()
    tp = (gt * pr).sum()
    fn = (gt * (1.0 - pr)).sum()
    fp = ((1.0 - gt) * pr).sum()
    return tp / (tp + fp).clamp_min(1e-12), tp / (tp + fn).clamp_min(1e-12)


def query_label_precision_recall(gt_label: torch.Tensor, pred_label: torch.Tensor,
                                 n_classes: int) -> Dict[str, torch.Tensor]:
    """Per-class precision and recall averaged over the classes, background
    included."""
    precisions, recalls = [], []
    for c in range(n_classes):
        g = gt_label == c
        p = pred_label == c
        tp = (g & p).sum().float()
        fn = (g & ~p).sum().float()
        fp = (~g & p).sum().float()
        precisions.append(tp / (tp + fp).clamp_min(1e-12))
        recalls.append(tp / (tp + fn).clamp_min(1e-12))
    return {"avg_precision": torch.stack(precisions).mean(),
            "avg_recall": torch.stack(recalls).mean()}


def support_mask_accuracy(estimate_mask: torch.Tensor, original_mask: torch.Tensor,
                          gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Point-level mask quality after clean detection: the clean share
    inside the estimated mask and the surviving size share, averaged over
    ways.  Shapes (n_way, k_shot, n_points), binary."""
    est = estimate_mask.float()
    orig = original_mask.float()
    gt = gt_mask.float()
    est_1 = est.sum((1, 2))
    orig_1 = orig.sum((1, 2))
    est_clean = (est * gt).sum((1, 2))
    return {"clean_ratio": (est_clean / est_1.clamp_min(1.0)).mean(),
            "size_ratio": (est_1 / orig_1.clamp_min(1.0)).mean()}


def prototype_cleanness(gt_support_y: torch.Tensor, support_y: torch.Tensor,
                        fg_assign: torch.Tensor, fg_valid_points: torch.Tensor,
                        n_protos: int) -> Dict[str, torch.Tensor]:
    """Per-prototype mean cleanness of the fg points assigned to it.

    gt_support_y / support_y (n_way, k_shot, n_points) binary masks,
    fg_assign (n_way, k_shot*n_points) point -> prototype slot,
    fg_valid_points (n_way, k_shot*n_points) bool (the fg mask, flat),
    n_protos prototype slots per way.  Returns the per-way cleanness matrix,
    the count of fully clean prototypes per way and the support's own
    cleanness."""
    n_way = support_y.shape[0]
    clean = (gt_support_y.reshape(n_way, -1) > 0).float()
    w = fg_valid_points.float()
    rows = []
    for cl, assign, wt in zip(clean, fg_assign, w):
        sums = segment_sum((cl * wt)[:, None], assign, n_protos)[:, 0]
        cnts = segment_sum(wt, assign, n_protos)
        rows.append(sums / cnts.clamp_min(1e-12))
    proto_clean = torch.stack(rows)                                   # (w, P)
    orig = (clean * w).sum(1) / w.sum(1).clamp_min(1.0)
    return {"proto_cleanness": proto_clean,
            "count_fully_clean": (proto_clean == 1.0).int().sum(1),
            "original_cleanness": orig}
