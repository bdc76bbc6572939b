"""Episode container (counterpart of `r3dfsseg_tpu/models/episode.py`)
and the encoding of an episode that every model shares.

Channels-last arrays, numpy or torch tensors.  Shapes are for one episode;
every field may carry a leading episode-batch axis ``E``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np


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


def stack_episodes(episodes) -> Episode:
    """Stack host-side episodes into one batched Episode (numpy); a field
    that any episode lacks is None."""
    fields = {}
    for name in Episode._fields:
        vals = [getattr(e, name) for e in episodes]
        fields[name] = None if any(v is None for v in vals) else np.stack(vals, 0)
    return Episode(**fields)


def encode_episode(features, cfg, ep: Episode, train: bool = False, generator=None,
                   shard=None):
    """Encode a batched episode's support and query clouds with the feature
    extractor ``features``, as two separate batches, so that training's
    BatchNorm statistics span each batch (per episode: groups = E) and its
    running statistics take two updates, as in every model of the JAX
    package.  Returns support (E, n_way, k_shot, N, d) and query (E,
    n_q * n_way, N, d) features; ``generator`` seeds the attention
    dropout.  ``shard`` (`parallel/mesh.py:Shard`, in episodes) places a
    data-parallel rank's episodes in the whole batch: each of the two
    batches passes its clouds' place, support clouds from offset
    n_way k_shot and query clouds from offset n_q n_way times the first
    episode."""
    c = cfg
    e = ep.support_x.shape[0]
    sx = ep.support_x.reshape(e * c.n_way * c.k_shot, c.pc_npts, -1)
    qx = ep.query_x.reshape(e * c.n_queries * c.n_way, c.pc_npts, -1)
    s_shard = None if shard is None else shard.scaled(c.n_way * c.k_shot)
    q_shard = None if shard is None else shard.scaled(c.n_queries * c.n_way)
    sf = features(sx, train, e, generator, s_shard)
    qf = features(qx, train, e, generator, q_shard)
    d = sf.shape[-1]
    return (sf.reshape(e, c.n_way, c.k_shot, c.pc_npts, d),
            qf.reshape(e, c.n_queries * c.n_way, c.pc_npts, d))
