"""Fixed-size segment sum and masked means (counterpart of
`r3dfsseg_tpu/ops/segment.py`)."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int, *,
                eps: float = 1e-5) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only ``mask`` entries (``mask``
    broadcasts against ``x``), with the original model's 1e-5 guard on the
    denominator of its masked average pooling.  Plain reductions: the same
    sum on every run, on the card too."""
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim) / (mask.sum(dim) + eps)
