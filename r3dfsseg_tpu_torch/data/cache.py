"""Static test-episode cache (counterpart of `r3dfsseg_tpu/data/cache.py`).

The directory names are the JAX package's and the original code's
(`MyTestDataset` / `MyTestDataset_NoiseInMetaTest`), so every package finds
the same set for the same flags.  The port writes its episodes as
``<idx>.npz`` (numpy only: the machines the port runs on need no h5py).
Where the directory already holds a complete ``<idx>.h5`` set, written by
the JAX package or the original code, it reads that set through h5py,
imported only then, and never writes over it.  The episodes are the same
either way: the samplers draw the same streams as the JAX package's.
"""
from __future__ import annotations

import glob
import os
import warnings
from itertools import combinations
from typing import List, Optional

import numpy as np

from r3dfsseg_tpu_torch.data.episodes import EpisodeSampler, NoisyEpisodeSampler
from r3dfsseg_tpu_torch.models.episode import Episode


def write_episode_npz(path: str, ep: Episode) -> None:
    """The fields the reference schema's reader takes (support_ptclouds,
    support_masks, query_ptclouds, query_labels, sampled_classes,
    gt_support_masks), in its dtypes, written under a temporary name and
    renamed, so that a crash leaves no truncated file behind."""
    gt = ep.gt_support_y if ep.gt_support_y is not None else np.zeros_like(ep.support_y)
    tmp = path + ".tmp.npz"
    np.savez(tmp,
             support_ptclouds=np.asarray(ep.support_x, np.float32),
             support_masks=np.asarray(ep.support_y, np.int32),
             query_ptclouds=np.asarray(ep.query_x, np.float32),
             query_labels=np.asarray(ep.query_y, np.int64),
             sampled_classes=np.asarray(ep.sampled_classes, np.int32),
             gt_support_masks=np.asarray(gt, np.int32))
    os.replace(tmp, path)


def _episode(f) -> Episode:
    """An Episode from a mapping of the reference schema (an npz or an h5
    file), as the JAX package's `read_episode_h5` builds it."""
    return Episode(
        support_x=f["support_ptclouds"][:].astype(np.float32),
        support_y=f["support_masks"][:].astype(np.int32),
        query_x=f["query_ptclouds"][:].astype(np.float32),
        query_y=f["query_labels"][:].astype(np.int32),
        gt_support_y=(f["gt_support_masks"][:].astype(np.int32)
                      if "gt_support_masks" in f else None),
        sampled_classes=f["sampled_classes"][:].astype(np.int32),
    )


def read_episode_npz(path: str) -> Episode:
    with np.load(path) as f:
        return _episode(f)


def read_episode_h5(path: str) -> Episode:
    """An episode file of the JAX package or the original code (needs h5py)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path}: reading an .h5 episode cache needs the h5py package, "
                          f"which is not installed") from e
    with h5py.File(path, "r") as f:
        return _episode(f)


def _complete_set(root: str, ext: str, expected: int) -> Optional[List[str]]:
    """The ``<idx>.<ext>`` files of ``root`` in index order, where there are
    exactly ``expected`` of them; else None."""
    files = glob.glob(os.path.join(root, f"*.{ext}"))
    files = [f for f in files if os.path.basename(f)[:-len(ext) - 1].isdigit()]
    if len(files) != expected:
        return None
    return sorted(files, key=lambda p: int(os.path.basename(p)[:-len(ext) - 1]))


class StaticTestDataset:
    """Materialise-or-load the C(test_classes, n_way) x episodes_per_comb
    cache with the reference's directory naming."""

    def __init__(self, data_path: str, dataset_name: str, *, cvfold: int = 0,
                 num_episode_per_comb: int = 100, n_way: int = 2,
                 k_shot: int = 5, n_queries: int = 1, num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", mode: str = "valid",
                 noise_ratio: float = 0.0, noise_type: Optional[str] = None,
                 noise_pair=None, seed: Optional[int] = None):
        tag = "test_episodes" if mode == "test" else "episodes"
        if noise_ratio and noise_ratio > 0:
            sampler = NoisyEpisodeSampler(
                data_path, dataset_name, cvfold=cvfold, n_way=n_way,
                k_shot=k_shot, n_queries=n_queries, mode="test",
                num_point=num_point, pc_attribs=pc_attribs,
                noise_ratio=noise_ratio, noise_type=noise_type,
                noise_pair=noise_pair, seed=seed)
            dirname = ("NoiseTest_%s_%f_S_%d_N_%d_K_%d_%s_%d_pts_%d" % (
                noise_type, noise_ratio, cvfold, n_way, k_shot, tag,
                num_episode_per_comb, num_point))
            if noise_type == "pair":
                # the mapping changes the episodes: different dicts must
                # not share a cache
                dirname += "_pair_" + "_".join(f"{a}-{b}" for a, b in sorted(noise_pair.items()))
        else:
            sampler = EpisodeSampler(
                data_path, dataset_name, cvfold=cvfold, n_way=n_way,
                k_shot=k_shot, n_queries=n_queries, mode="test",
                num_point=num_point, pc_attribs=pc_attribs, seed=seed)
            dirname = ("S_%d_N_%d_K_%d_%s_%d_pts_%d" % (
                cvfold, n_way, k_shot, tag, num_episode_per_comb, num_point))

        self.classes = sampler.classes
        self.root = os.path.join(data_path, dirname)
        combs = list(combinations(self.classes.tolist(), n_way))
        expected = len(combs) * num_episode_per_comb
        self.file_names = _complete_set(self.root, "npz", expected)
        self._read = read_episode_npz
        if self.file_names is None:
            h5 = _complete_set(self.root, "h5", expected)
            if h5 is not None:
                self.file_names, self._read = h5, read_episode_h5
        if self.file_names is None:
            # absent, empty, or cut short by a crash: write the whole set
            partial = glob.glob(os.path.join(self.root, "*.npz"))
            if partial:
                warnings.warn(f"episode cache {self.root} holds {len(partial)} of "
                              f"{expected} files: regenerating")
            os.makedirs(self.root, exist_ok=True)
            self.file_names = []
            for comb in combs:
                for _ in range(num_episode_per_comb):
                    out = os.path.join(self.root, f"{len(self.file_names)}.npz")
                    write_episode_npz(out, sampler.sample(list(comb)))
                    self.file_names.append(out)

    def __len__(self):
        return len(self.file_names)

    def __getitem__(self, i: int) -> Episode:
        return self._read(self.file_names[i])
