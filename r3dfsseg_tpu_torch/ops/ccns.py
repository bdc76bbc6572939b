"""Cluster-level clean detection (counterpart of `r3dfsseg_tpu/ops/ccns.py`).

The original model's `aggregate_cluster_one_class` /
`detect_clean_cluster_one_class` have no caller there, and the JAX package
keeps them as a standalone op; so does the port.  Plain tensor functions,
fixed shapes: absent cluster ids have size 0 and are masked out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def aggregate_class_clusters(feat: torch.Tensor, label: torch.Tensor,
                             cluster_label: torch.Tensor, num_clusters: int):
    """Per-shot cluster aggregation.

    feat (K, N, d) point features, label (K, N) binary class membership,
    cluster_label (K, N) ids in [0, num_clusters).  Returns the clusters'
    mean features (K, C, d) (zero rows for empty slots), their sizes (K,
    C), and (K, C) bool: the cluster exists in the shot and its mean label
    exceeds 0.5."""
    one_hot = F.one_hot(cluster_label.long(), num_clusters).to(feat.dtype)    # (K, N, C)
    sizes = one_hot.sum(1)
    means = torch.einsum("knc,knd->kcd", one_hot, feat) / sizes.clamp_min(1.0)[..., None]
    mean_label = torch.einsum("knc,kn->kc", one_hot, label.to(feat.dtype)) / sizes.clamp_min(1.0)
    return means, sizes, (mean_label > 0.5) & (sizes > 0)


def detect_clean_clusters(cluster_feat: torch.Tensor, sizes: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Size-weighted cosine-degree clean mask over (M, d) cluster features
    (all shots' clusters, padded rows allowed), their (M,) sizes and (M,)
    bool live rows: a row is clean when its cosine similarities to every
    row (itself included), weighted by size / the largest size, sum above
    the live rows' mean.  Padded rows are never clean and do not count."""
    valid_f = valid.to(cluster_feat.dtype)
    f = cluster_feat / torch.linalg.vector_norm(cluster_feat, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = f @ f.T
    max_size = torch.where(valid, sizes, torch.zeros_like(sizes)).max()
    w = sizes / max_size.clamp_min(1.0) * valid_f
    score = sim @ w
    mean_score = (score * valid_f).sum() / valid_f.sum().clamp_min(1.0)
    return (score > mean_score) & valid
