"""Masked farthest point sampling and multi-prototypes (counterpart of
`r3dfsseg_tpu/ops/fps.py`), batched over a leading instance axis.

Gradients flow through the cluster means (and a seed's own feature where
its cluster is empty); the FPS seeds and the nearest-seed assignment are
chosen on detached features."""
from __future__ import annotations

from typing import NamedTuple

import torch

from r3dfsseg_tpu_torch.ops import cuda_fps
from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist
from r3dfsseg_tpu_torch.ops.segment import segment_sum


def masked_fps(feat: torch.Tensor, valid: torch.Tensor, k: int,
               impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic FPS over the valid subset of each instance.

    feat (P, N, C), valid (P, N) bool -> seed_idx (P, k) int32 and
    seed_valid (P, k) bool: slot i is a real seed iff i < min(k, n_valid).
    impl 'auto' runs the kernel on CUDA tensors (`ops/cuda_fps.py`), 'xla'
    the plain version everywhere; both use the direct sum((x - c)^2) form.
    """
    feat = feat.detach().float()
    n_valid = valid.sum(-1, keepdim=True)
    seed_valid = torch.arange(k, device=feat.device) < n_valid.clamp_max(k)
    if impl == "auto":
        seeds = cuda_fps.fps(feat, valid, k)
    elif impl == "xla":
        seeds = cuda_fps.fps_reference(feat, valid, k)
    else:
        raise NotImplementedError(f"fps_impl {impl!r}: the port has 'auto' and 'xla'")
    return seeds, seed_valid


class MultiPrototypes(NamedTuple):
    prototypes: torch.Tensor   # (P, k, C) cluster means (0 in invalid slots)
    proto_valid: torch.Tensor  # (P, k) bool
    assignments: torch.Tensor  # (P, N) nearest-seed slot per point


def multi_prototypes(feat: torch.Tensor, valid: torch.Tensor, k: int,
                     impl: str = "auto") -> MultiPrototypes:
    """FPS seeds, hard nearest-seed assignment and per-cluster means.

    feat (P, N, C), valid (P, N) bool.  An empty cluster (only possible
    when duplicate points collapse) falls back to its seed's feature.
    """
    p, n, c = feat.shape
    feat32 = feat.float()
    seed_idx, seed_valid = masked_fps(feat32, valid, k, impl)
    seeds = torch.gather(feat32, 1, seed_idx.long()[..., None].expand(p, k, c))
    d = pairwise_sqdist(feat32.detach(), seeds.detach())         # (P, N, k)
    d = torch.where(seed_valid[:, None, :], d, 3.4e38)
    assign = torch.argmin(d, dim=-1)                             # (P, N)

    w = valid.float()
    ids = (assign + torch.arange(p, device=feat.device)[:, None] * k).reshape(-1)
    sums = segment_sum((feat32 * w[..., None]).reshape(p * n, c), ids, p * k)
    cnts = segment_sum(w.reshape(p * n, 1), ids, p * k)[:, 0]
    sums, cnts = sums.reshape(p, k, c), cnts.reshape(p, k)
    means = sums / cnts.clamp_min(1.0)[..., None]
    protos = torch.where((cnts > 0.0)[..., None], means, seeds)
    protos = torch.where(seed_valid[..., None], protos, 0.0).to(feat.dtype)
    return MultiPrototypes(protos, seed_valid, assign.to(torch.int32))
