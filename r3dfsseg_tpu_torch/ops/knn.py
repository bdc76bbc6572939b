"""Pairwise squared distances and k-nearest-neighbour selection
(counterpart of `r3dfsseg_tpu/ops/knn.py`)."""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops.fast_gather import flat_take


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N, C) x (..., M, C) -> (..., N, M) squared distances, >= 0.

    The grouping (xx + yy^T) - 2 * inner keeps the self-distance matrix
    exactly symmetric: both addends are symmetric, so the rounded sum is.
    """
    if y is None:
        y = x
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1, keepdim=True)
    inner = torch.matmul(x, y.transpose(-1, -2))
    d = (xx + yy.transpose(-1, -2)) - 2.0 * inner
    return d.clamp_min(0.0)


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N, C) -> (..., N, k) int32 indices of the k nearest points,
    self included; ties go to the lowest index (a stable sort: `torch.topk`
    promises no order among ties)."""
    idx = torch.sort(pairwise_sqdist(x), dim=-1, stable=True).indices[..., :k]
    return idx.to(torch.int32)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, C), idx (..., N, K) -> (..., N, K, C) neighbour features."""
    n, c = x.shape[-2:]
    out = flat_take(x.reshape(-1, n, c), idx.reshape(-1, *idx.shape[-2:]))
    return out.reshape(*idx.shape, c)
