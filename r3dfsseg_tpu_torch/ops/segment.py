"""Fixed-size segment sum (counterpart of `r3dfsseg_tpu/ops/segment.py`)."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)
