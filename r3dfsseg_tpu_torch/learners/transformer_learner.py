"""Learner of the transformer baseline (counterpart of
`r3dfsseg_tpu/learners/transformer_learner.py`): loss = CE + binary
outlier BCE + clean-prototype MSE (their weights 0.5 and 1 inside the
model), Adam in the two groups and StepLR (`learners/base.py`).

    learner = TransformerLearner(R3DConfig(phase="transformertrain"))
    metrics = learner.train(episode)   # loss, lp_loss, contrast_loss (the BCE),
                                       # clean_proto_loss, accuracy
"""
from __future__ import annotations

from typing import Optional

import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners.base import Learner
from r3dfsseg_tpu_torch.models.transformer import ProtoNetTransformer


class TransformerLearner(Learner):
    """A `ProtoNetTransformer` on ``device``.  The architecture comes from
    the config (``d_model``, ``n_layers``, ``n_head``, ``d_feed``); the
    keyword arguments override it.  ``dropout`` is the transformer's (the
    JAX model's 0.1; the encoder's attention takes ``cfg.attn_dropout``).
    `test` takes ``eval_mdns``, which the model ignores, as the JAX
    learner does."""

    def __init__(self, cfg: R3DConfig, device: str | torch.device | None = None,
                 generator: Optional[torch.Generator] = None, *,
                 d_model: Optional[int] = None, n_layers: Optional[int] = None,
                 n_head: Optional[int] = None, d_feed: Optional[int] = None,
                 dropout: float = 0.1):
        self.arch = dict(d_model=d_model or cfg.d_model, n_layers=n_layers or cfg.n_layers,
                         n_head=n_head or cfg.n_head, d_feed=d_feed or cfg.d_feed,
                         dropout=dropout)
        super().__init__(cfg, device, generator)

    def make_model(self) -> ProtoNetTransformer:
        return ProtoNetTransformer(self.cfg, **self.arch)

    def objective(self, out):
        loss = out.loss + out.binary_loss + out.clean_proto_loss
        return loss, dict(loss=loss, lp_loss=out.loss, contrast_loss=out.binary_loss,
                          clean_proto_loss=out.clean_proto_loss)
