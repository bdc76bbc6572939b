"""Scan-level point sampling and augmentation, host-side numpy
(counterpart of `r3dfsseg_tpu/data/sampler.py`, line for line).

Re-design of `sample_pointcloud_universal` + `augment_pointcloud`
(`dataloaders/loader.py:138-373`):

  * class-stratified 2048-point subsampling that guarantees target-class
    points survive (loader.py:160-172);
  * xyz min-shift, optional augmentation, XYZ unit-box normalisation,
    attribute selection (loader.py:200-219);
  * binary support masks / (1..n_way) query labels (loader.py:222-237);
  * 'partial' noise: object-level label flips driven by the instance
    column (loader.py:239-322);
  * augmentation = composed 3x3 matrix (uniform scale, z-rotation,
    x/y mirror) on xyz + clipped Gaussian jitter on all attributes
    (loader.py:354-373) — written directly against numpy instead of
    transforms3d.

Scans are memoised in a small LRU cache: the reference re-reads every .npy
from disk per shot (loader.py:153), which is the host-side hot loop.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_SCAN_CACHE: "OrderedDict[str, np.ndarray]" = OrderedDict()
_SCAN_CACHE_MAX = 256
_SCAN_CACHE_LOCK = threading.Lock()   # the loader's worker threads share the cache


def load_scan(data_path: str, scan_name: str) -> np.ndarray:
    key = os.path.join(data_path, "data", f"{scan_name}.npy")
    with _SCAN_CACHE_LOCK:
        hit = _SCAN_CACHE.get(key)
        if hit is not None:
            _SCAN_CACHE.move_to_end(key)
            return hit
    # float64 C-contiguous: the layout the native assemble kernel reads
    # (reference block scans are float64 .npy already)
    arr = np.ascontiguousarray(np.load(key), np.float64)
    with _SCAN_CACHE_LOCK:
        _SCAN_CACHE[key] = arr
        while len(_SCAN_CACHE) > _SCAN_CACHE_MAX:
            _SCAN_CACHE.popitem(last=False)
    return arr


def _rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _mirror(axis: int) -> np.ndarray:
    m = np.eye(3)
    m[axis, axis] = -1.0
    return m


def draw_augment(cfg: Dict, rng: np.random.Generator, num_point: int):
    """Draw the augmentation matrix + (float32-rounded) jitter.  ONE place
    makes the numpy and native paths consume an identical RNG stream."""
    M = np.eye(3)
    if cfg.get("scale", 0) > 1:
        s = rng.uniform(1.0 / cfg["scale"], cfg["scale"])
        M = (np.eye(3) * s) @ M
    if cfg.get("rot", 0) == 1:
        M = _rotation_z(rng.uniform(0.0, 2.0 * np.pi)) @ M
    if cfg.get("mirror_prob", 0) > 0:
        if rng.random() < cfg["mirror_prob"] / 2:
            M = _mirror(0) @ M
        if rng.random() < cfg["mirror_prob"] / 2:
            M = _mirror(1) @ M
    jitter = None
    if cfg.get("jitter", 0):
        sigma, clip = 0.01, 0.05
        jitter = np.clip(sigma * rng.standard_normal((num_point, 3)),
                         -clip, clip).astype(np.float32)
    return M, jitter


def augment_pointcloud(P: np.ndarray, cfg: Dict, rng: np.random.Generator
                       ) -> np.ndarray:
    """Compose scale/rot/mirror on xyz, jitter everything (loader.py:354-373)."""
    M, jitter = draw_augment(cfg, rng, len(P))
    P = P.copy()
    P[:, :3] = P[:, :3] @ M.T
    if jitter is not None:
        P = P + jitter
    return P


def sample_scan(
    data_path: str,
    scan_name: str,
    num_point: int,
    pc_attribs: str,
    *,
    sampled_classes: Sequence[int],
    sampled_class: int = 0,
    support: bool = False,
    random_sample: bool = False,
    partial_noise: bool = False,
    pc_augm: bool = False,
    pc_augm_config: Optional[Dict] = None,
    use_label_noise: bool = False,
    noise_in_fold: int = -1,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample one scan into a (num_point, attrs) cloud + labels.

    Returns (ptcloud, label, gt_label, cluster_label) mirroring
    sample_pointcloud_universal's return (loader.py:351).

    ``use_label_noise`` selects a pre-annotated noisy-label column instead
    of the clean column 6 for both stratified selection and the returned
    label (loader.py:174-181,222-229: fold 0 -> column 7, fold 1 -> column
    8); the diagnostic gt label always reads the clean column.  The
    reference never enables this branch from any live entry point, but it
    is part of the sampler's public surface.
    """
    rng = rng or np.random.default_rng()
    sampled_classes = list(sampled_classes)
    data = load_scan(data_path, scan_name)
    n = data.shape[0]

    if use_label_noise:
        if noise_in_fold not in (0, 1):
            raise ValueError("use_label_noise requires noise_in_fold in "
                             "{0, 1} (loader.py:149-150)")
        label_col = 7 + noise_in_fold
    else:
        label_col = 6

    # ---- stratified point selection (loader.py:156-192) ----
    if random_sample or partial_noise:
        idx = rng.choice(n, num_point, replace=(n < num_point))
    else:
        valid = np.nonzero(data[:, label_col] == sampled_class)[0]
        if n < num_point:
            n_valid = len(valid)
        else:
            n_valid = int(len(valid) / float(n) * num_point)
        pick_valid = rng.choice(valid, n_valid, replace=False)
        pick_other = rng.choice(n, num_point - n_valid, replace=(n < num_point))
        idx = np.concatenate([pick_valid, pick_other])

    # ---- native fast path: one C pass over the selected rows ----
    # (partial noise needs data-dependent object loops, and the noisy-label
    # column swap is a cold path -> numpy)
    from r3dfsseg_tpu_torch import native
    assemble = native.assemble_scan()
    if assemble is not None and not partial_noise and not use_label_noise:
        return _assemble_native(
            assemble, data, idx.astype(np.int64), num_point, pc_attribs,
            sampled_class, sampled_classes, support,
            pc_augm, pc_augm_config or {}, rng, scan_name)

    data = data[idx]

    # ---- attributes (loader.py:200-219) ----
    xyz = data[:, 0:3].copy()
    rgb = data[:, 3:6]
    xyz -= np.amin(xyz, axis=0)
    if pc_augm:
        xyz = augment_pointcloud(xyz, pc_augm_config or {}, rng)
    parts = []
    if "xyz" in pc_attribs:
        parts.append(xyz)
    if "rgb" in pc_attribs:
        parts.append(rgb / 255.0)
    if "XYZ" in pc_attribs:
        mn = np.amin(xyz, axis=0)
        rel = xyz - mn
        parts.append(rel / np.amax(rel, axis=0))
    ptcloud = np.concatenate(parts, axis=1).astype(np.float32)

    # ---- labels (loader.py:222-237; noisy fold column when enabled) ----
    labels = data[:, label_col].astype(np.int64)
    if support:
        gt = labels == sampled_class
    else:
        gt = np.zeros_like(labels)
        for i, cls in enumerate(sampled_classes):
            gt[labels == cls] = i + 1

    # ---- partial noise: object-level flips (loader.py:239-322) ----
    gt_fg_objs = np.unique(data[np.asarray(gt, bool)][:, -1]) if support else None
    if partial_noise:
        obj_list = list(np.unique(data[:, -1]))
        if len(obj_list) > 1 and len(np.unique(data[:, 6])) > 1:
            while True:
                sel = rng.choice(obj_list)
                mask = data[:, -1] == sel
                if data[mask][:, 6][0] != sampled_class:
                    break
            gt = np.asarray(gt, bool)
            gt[mask] = True
        if rng.uniform() > 0.7 and len(gt_fg_objs) > 0:
            sel = rng.choice(gt_fg_objs)
            gt = np.asarray(gt, bool)
            gt[data[:, -1] == sel] = False
    if np.sum(gt) <= 0:
        raise ValueError(f"no fg points for class {sampled_class} in {scan_name}")

    # ---- clean gt labels for diagnostics (loader.py:329-337) ----
    gt_labels = data[:, 6]
    if support:
        gt_gt = gt_labels == sampled_class
    else:
        gt_gt = np.zeros_like(gt_labels, dtype=np.int64)
        for i, cls in enumerate(sampled_classes):
            gt_gt[gt_labels == cls] = i + 1

    # ---- cluster column (loader.py:339-349) ----
    if data.shape[1] == 10:
        cluster = data[:, 9].astype(np.int64)
    elif data.shape[1] in (8, 9):
        cluster = data[:, 7].astype(np.int64)
    else:
        cluster = np.zeros(num_point, np.int64)

    return (ptcloud, np.asarray(gt, np.int64), np.asarray(gt_gt, np.int64),
            cluster)


def _assemble_native(assemble, data, idx, num_point, pc_attribs, sampled_class,
                     sampled_classes, support, pc_augm, pc_augm_config, rng,
                     scan_name):
    """ctypes call of ``assemble`` (native/episode_ops.c) — the same outputs
    and RNG stream as the numpy path (tests/test_torch_data.py)."""
    import ctypes

    aug_m = jit = None
    if pc_augm:
        aug_m, jit = draw_augment(pc_augm_config, rng, num_point)
        aug_m = np.ascontiguousarray(aug_m, np.float64)
        if jit is not None:
            jit = np.ascontiguousarray(jit, np.float64)

    n_cols = data.shape[1]
    if n_cols == 10:
        cluster_col = 9
    elif n_cols in (8, 9):
        cluster_col = 7
    else:
        cluster_col = -1

    n_attr = 3 * (("xyz" in pc_attribs) + ("rgb" in pc_attribs)
                  + ("XYZ" in pc_attribs))
    pt = np.empty((num_point, n_attr), np.float32)
    label = np.empty(num_point, np.int64)
    gt = np.empty(num_point, np.int64)
    cluster = np.empty(num_point, np.int64)
    classes = np.ascontiguousarray(sampled_classes, np.int64)

    def ptr(a):
        return ctypes.c_void_p(0 if a is None else a.ctypes.data)

    fg = assemble(
        ptr(data), data.shape[0], n_cols,
        ptr(idx), num_point,
        ptr(aug_m), ptr(jit),
        int("xyz" in pc_attribs), int("rgb" in pc_attribs),
        int("XYZ" in pc_attribs),
        int(sampled_class), ptr(classes), len(classes), int(support),
        cluster_col,
        ptr(pt), ptr(label), ptr(gt), ptr(cluster))
    if fg <= 0:
        raise ValueError(f"no fg points for class {sampled_class} in {scan_name}")
    return pt, label, gt, cluster


def sample_k_scans(data_path, num_point, pc_attribs, scan_names, *,
                   sampled_class, sampled_classes, is_support,
                   partial_noise=False, pc_augm=False, pc_augm_config=None,
                   use_label_noise=False, noise_in_fold=-1,
                   rng=None):
    """Stack K scans (loader.py:19-56)."""
    outs = [
        sample_scan(data_path, s, num_point, pc_attribs,
                    sampled_classes=sampled_classes, sampled_class=sampled_class,
                    support=is_support, partial_noise=partial_noise,
                    pc_augm=pc_augm, pc_augm_config=pc_augm_config,
                    use_label_noise=use_label_noise,
                    noise_in_fold=noise_in_fold, rng=rng)
        for s in scan_names
    ]
    pt, lb, gt, cl = zip(*outs)
    return (np.stack(pt), np.stack(lb), np.stack(gt), np.stack(cl))
