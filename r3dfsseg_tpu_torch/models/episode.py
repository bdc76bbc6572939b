"""Episode container (counterpart of `r3dfsseg_tpu/models/episode.py`).

Channels-last arrays, numpy or torch tensors.  Shapes are for one episode;
every field may carry a leading episode-batch axis ``E``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional


class Episode(NamedTuple):
    support_x: Any               # (n_way, k_shot, n_points, C_in) float
    support_y: Any               # (n_way, k_shot, n_points) int {0,1} fg mask
    query_x: Any                 # (n_q*n_way, n_points, C_in) float
    query_y: Any                 # (n_q*n_way, n_points) int in [0, n_way]
    gt_support_y: Optional[Any] = None
    gt_query_y: Optional[Any] = None
    support_flag: Optional[Any] = None     # (n_way, k_shot)
    sampled_classes: Optional[Any] = None  # (n_way,)

    @property
    def batched(self) -> bool:
        return self.support_x.ndim == 5

    def with_batch_dim(self) -> "Episode":
        """Add a leading episode axis of size 1 if missing."""
        if self.batched:
            return self
        return Episode(*(None if a is None else a[None] for a in self))
