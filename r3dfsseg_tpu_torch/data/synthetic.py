"""Synthetic scan generator (counterpart of `r3dfsseg_tpu/data/synthetic.py`):
builds a miniature S3DIS-format dataset on disk
(data/*.npy with columns xyzrgb + label [+ cluster] + instance) so the full
pipeline — catalogs, class2scans, episode samplers, episode cache — runs in tests
and benchmarks without the real datasets."""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def make_synthetic_dataset(
    root: str,
    *,
    n_classes: int = 13,
    n_scans: int = 40,
    pts_per_scan: int = 4096,
    classes_per_scan: int = 4,
    objects_per_class: int = 2,
    seed: int = 0,
    classnames: Optional[Sequence[str]] = None,
) -> str:
    """Create <root>/data/*.npy + <root>/../meta/s3dis_classnames.txt.

    Each scan holds a few blob 'objects' per class so partial-noise object
    flips and class-stratified sampling behave like the real data.
    Returns the dataset path (== root).
    """
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    meta_dir = os.path.join(os.path.dirname(root), "meta")
    os.makedirs(meta_dir, exist_ok=True)
    if classnames is None:
        if n_classes == 13:
            # real S3DIS names so the catalog's fold splits resolve
            from r3dfsseg_tpu_torch.data.catalogs import S3DIS_CLASSNAMES
            classnames = S3DIS_CLASSNAMES
        else:
            classnames = [f"class{i}" for i in range(n_classes)]
    with open(os.path.join(meta_dir, "s3dis_classnames.txt"), "w") as f:
        f.write("\n".join(classnames) + "\n")

    for s in range(n_scans):
        # every scan contains `classes_per_scan` classes, rotating so each
        # class appears in plenty of scans
        cls_ids = [(s + j) % n_classes for j in range(classes_per_scan)]
        rows = []
        inst = 0
        n_obj = classes_per_scan * objects_per_class
        pts_per_obj = pts_per_scan // n_obj
        for c in cls_ids:
            for _ in range(objects_per_class):
                center = rng.uniform(0, 5, size=3)
                xyz = center + rng.normal(scale=0.3, size=(pts_per_obj, 3))
                rgb = rng.uniform(0, 255, size=(pts_per_obj, 3))
                lab = np.full((pts_per_obj, 1), c, np.float64)
                ins = np.full((pts_per_obj, 1), inst, np.float64)
                rows.append(np.concatenate([xyz, rgb, lab, ins], axis=1))
                inst += 1
        arr = np.concatenate(rows, axis=0)
        rng.shuffle(arr, axis=0)
        np.save(os.path.join(data_dir, f"scan{s:03d}.npy"), arr)
    return root
