"""Neighbour gather, forward only (counterpart of
`r3dfsseg_tpu/ops/fast_gather.py:_flat_take`).

No kernel runs here: the TPU package's Pallas kernels in that module are
the scatter-add backward (training) and an unused one-hot gather.
"""
from __future__ import annotations

import torch


def flat_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, NQ, K) -> (B, NQ, K, C), as one row take from
    the flattened (B*N, C) table."""
    b, n, c = x.shape
    off = (torch.arange(b, device=idx.device, dtype=idx.dtype) * n)[:, None, None]
    flat = (idx + off).reshape(-1).long()
    return x.reshape(b * n, c).index_select(0, flat).reshape(*idx.shape, c)
