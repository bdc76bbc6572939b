"""The prototypical-network baselines, ProtoNet and ProtoNet_Contrast
(counterpart of `r3dfsseg_tpu/models/protonet.py`).

Per episode: masked-average fg and bg features of every support shot,
one fg prototype per way and one bg prototype, then the query points'
cosine (scaled by 10) or negative squared euclidean similarity to them
as logits, and cross-entropy.  ``with_contrast`` is the noise-robust
variant: the WayContrast loss on each shot's FPS prototypes in training
(the MPTI model's, `models/mpti.py`) and MDNS in eval, whose clean flags
weight the shots in the fg prototype.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode, encode_episode
from r3dfsseg_tpu_torch.models.mpti import (_contrast_prototypes, check_encoder,
                                            mdns_keep_mask, way_contrast_loss)
from r3dfsseg_tpu_torch.nn.dgcnn import FeatureExtractor, init_linear_weights
from r3dfsseg_tpu_torch.ops.segment import masked_mean

DIST_METHODS = ("cosine", "euclidean")


class ProtoOutput(NamedTuple):
    query_logits: torch.Tensor    # (E, n_q*n_way, n_points, n_classes)
    loss: torch.Tensor
    contrast_loss: torch.Tensor
    aux: Dict[str, torch.Tensor]


def check_dist_method(cfg: R3DConfig) -> None:
    if cfg.dist_method not in DIST_METHODS:
        raise NotImplementedError(
            f"Error! Distance computation method ({cfg.dist_method}) is unknown!")


def similarity(q: torch.Tensor, protos: torch.Tensor, dist_method: str) -> torch.Tensor:
    """Logits of query features (..., N, d) against prototypes (..., C, d)
    sharing the leading axes: cosine times 10, or -max(|q - p|^2, 0) by
    the expanded square."""
    if dist_method == "cosine":
        qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
        pn = protos / torch.linalg.vector_norm(protos, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.matmul(qn, pn.transpose(-1, -2)) * 10.0
    if dist_method == "euclidean":
        d2 = ((q * q).sum(-1, keepdim=True) - 2.0 * torch.matmul(q, protos.transpose(-1, -2))
              + (protos * protos).sum(-1).unsqueeze(-2))
        return -d2.clamp_min(0.0)
    raise NotImplementedError(f"Error! Distance computation method ({dist_method}) is unknown!")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under the logits."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def _proto_core(support_feat: torch.Tensor, query_feat: torch.Tensor, ep: Episode,
                cfg: R3DConfig, *, train: bool, eval_mdns: bool):
    """One episode: (logits (Q, N, n_way + 1), loss, aux)."""
    n_way, k_shot, n, d = support_feat.shape
    fg = ep.support_y > 0                                           # (w, k, N)
    shot_w = torch.ones((n_way, k_shot), device=support_feat.device)
    if eval_mdns and not train:
        shot_w, _ = mdns_keep_mask(support_feat, fg, ep.support_x[..., :3], cfg.mdns_scales)
    fg_feat = masked_mean(support_feat, fg[..., None], dim=2)        # (w, k, d)
    bg_feat = masked_mean(support_feat, ~fg[..., None], dim=2)
    # the clean-flag-weighted mean of the shots' fg features
    wsum = shot_w.sum(1).clamp_min(1.0)
    fg_proto = torch.einsum("wk,wkd->wd", shot_w, fg_feat) / wsum[:, None]
    bg_proto = bg_feat.reshape(n_way * k_shot, d).mean(0)
    protos = torch.cat([bg_proto[None], fg_proto], 0)                # (w+1, d)
    sim = similarity(query_feat, protos, cfg.dist_method)            # (Q, N, w+1)
    loss = cross_entropy(sim, ep.query_y)
    aux = {"accuracy": (sim.argmax(-1) == ep.query_y).float().mean()}
    return sim, loss, aux


class ProtoNet(nn.Module):
    """FeatureExtractor + prototype matching; ``with_contrast`` adds the
    WayContrast projection head `proj` (ProtoNet_Contrast).  `forward`
    takes an Episode of tensors, with or without a leading episode axis."""

    def __init__(self, cfg: R3DConfig, with_contrast: bool = False):
        super().__init__()
        check_encoder(cfg)
        check_dist_method(cfg)
        self.cfg = cfg
        self.with_contrast = with_contrast
        self.features = FeatureExtractor.from_config(cfg)
        if with_contrast:
            self.proj = nn.Linear(cfg.feat_dim, cfg.proj_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """Linear weights and biases from ``generator``
        (`nn/dgcnn.py:init_linear_weights`)."""
        init_linear_weights(self, generator)

    def forward(self, ep: Episode, train: bool = False, eval_mdns: bool = False,
                generator: Optional[torch.Generator] = None, shard=None) -> ProtoOutput:
        """The contrast loss needs ``ep.support_flag``; MDNS runs with
        ``eval_mdns`` in eval on the contrast variant only; ``shard`` as
        `models/episode.py:encode_episode`'s."""
        c = self.cfg
        ep = ep.with_batch_dim()
        sf, qf = encode_episode(self.features, c, ep, train, generator, shard)
        eps = [Episode(*(None if a is None else a[i] for a in ep)) for i in range(sf.shape[0])]
        contrast = torch.zeros((), device=sf.device)
        if train and self.with_contrast and ep.support_flag is not None:
            losses = []
            for i, one in enumerate(eps):
                protos, pvalid, labels, svalid = _contrast_prototypes(
                    sf[i], one.support_y, one.support_flag, c.contrast_fps_k, c.fps_impl)
                z = self.proj(protos)
                z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
                losses.append(way_contrast_loss(z, pvalid, labels, svalid, c.contrast_temp))
            contrast = torch.stack(losses).mean()
        outs = [_proto_core(sf[i], qf[i], one, c, train=train,
                            eval_mdns=eval_mdns and self.with_contrast)
                for i, one in enumerate(eps)]
        logits = torch.stack([o[0] for o in outs])
        loss = torch.stack([o[1] for o in outs]).mean()
        aux = {k: torch.stack([o[2][k] for o in outs]).mean() for k in outs[0][2]}
        return ProtoOutput(logits, loss, contrast, aux)
