"""Dataset catalogs: class splits and the class->scans index (counterpart
of `r3dfsseg_tpu/data/catalogs.py`).

Re-design of `dataloaders/s3dis.py` and `scannet.py`:
same cvfold class splits, same scan filter (a scan lists a class only when
that class has > max(5% of points, 100) points), same `class2scans.pkl`
cache location so existing preprocessed datasets drop in unchanged.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List

import numpy as np

# Standard class name orders for the two benchmarks (the reference reads
# them from meta/<dataset>_classnames.txt; we do too, with these fallbacks).
S3DIS_CLASSNAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]
SCANNET_CLASSNAMES = [
    "unannotated", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "sofa", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refridgerator", "picture",
    "cabinet", "otherfurniture",
]

MIN_RATIO = 0.05   # s3dis.py:55
MIN_PTS = 100      # s3dis.py:56


class _Catalog:
    n_classes: int
    fold_0_names: List[str]
    fold_1_names: List[str]
    fallback_names: List[str]
    train_class_range: range  # classes eligible for meta-training

    def __init__(self, cvfold: int, data_path: str):
        self.data_path = data_path
        names = self._read_classnames(data_path)
        self.class2type = dict(enumerate(names))
        self.type2class = {v: k for k, v in self.class2type.items()}

        fold = self.fold_0_names if cvfold == 0 else self.fold_1_names
        if cvfold not in (0, 1):
            raise NotImplementedError(f"Unknown cvfold ({cvfold}). [Options: 0,1]")
        self.test_classes = [self.type2class[n] for n in fold]
        self.train_classes = [c for c in self.train_class_range
                              if c not in self.test_classes]
        self.class2scans = self._get_class2scans()

    def _read_classnames(self, data_path: str) -> List[str]:
        meta = os.path.join(os.path.dirname(data_path), "meta",
                            self.meta_filename)
        if os.path.exists(meta):
            with open(meta) as f:
                return [ln.strip() for ln in f if ln.strip()]
        return list(self.fallback_names)

    def _get_class2scans(self) -> Dict[int, List[str]]:
        cache = os.path.join(self.data_path, "class2scans.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        class2scans: Dict[int, List[str]] = {k: [] for k in range(self.n_classes)}
        for file in sorted(glob.glob(os.path.join(self.data_path, "data", "*.npy"))):
            scan_name = os.path.basename(file)[:-4]
            data = np.load(file)
            labels = data[:, 6].astype(np.int64)
            threshold = max(int(data.shape[0] * MIN_RATIO), MIN_PTS)
            classes, counts = np.unique(labels, return_counts=True)
            for class_id, cnt in zip(classes, counts):
                if cnt > threshold and 0 <= class_id < self.n_classes:
                    class2scans[int(class_id)].append(scan_name)
        with open(cache, "wb") as f:
            pickle.dump(class2scans, f, pickle.HIGHEST_PROTOCOL)
        return class2scans


class S3DISCatalog(_Catalog):
    """13 S3DIS classes; folds from s3dis.py:30-41 (clutter, class 12,
    never meta-trained: train classes come from range(0, 12))."""
    n_classes = 13
    meta_filename = "s3dis_classnames.txt"
    fallback_names = S3DIS_CLASSNAMES
    fold_0_names = ["beam", "board", "bookcase", "ceiling", "chair", "column"]
    fold_1_names = ["door", "floor", "sofa", "table", "wall", "window"]
    train_class_range = range(0, 12)


class ScanNetCatalog(_Catalog):
    """21 ScanNet classes; folds from scannet.py:23-34 (class 0 =
    'unannotated' excluded: train classes from range(1, 21))."""
    n_classes = 21
    meta_filename = "scannet_classnames.txt"
    fallback_names = SCANNET_CLASSNAMES
    fold_0_names = ["bathtub", "bed", "bookshelf", "cabinet", "chair",
                    "counter", "curtain", "desk", "door", "floor"]
    fold_1_names = ["otherfurniture", "picture", "refridgerator",
                    "shower curtain", "sink", "sofa", "table", "toilet",
                    "wall", "window"]
    train_class_range = range(1, 21)


def get_catalog(dataset_name: str, cvfold: int, data_path: str) -> _Catalog:
    if dataset_name == "s3dis":
        return S3DISCatalog(cvfold, data_path)
    if dataset_name == "scannet":
        return ScanNetCatalog(cvfold, data_path)
    raise NotImplementedError(f"Unknown dataset {dataset_name}!")
