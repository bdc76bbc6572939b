"""Optimizer and learning-rate schedule of the learners (counterpart of
`r3dfsseg_tpu/learners/base.py`).

Adam with two parameter groups: the pretrained DGCNN trunk
(`features.encoder.*`, the JAX package's `_param_labels` 'encoder') at
``encoder_lr`` and every other parameter at ``lr``, with optax's defaults
(betas 0.9 and 0.999, eps 1e-8, no weight decay).  StepLR multiplies both
rates by ``gamma`` every ``max(step_size // episode_batch, 1)`` optimizer
steps, so the decay points stay where they are in episodes; it is stepped
once per optimizer step, as optax's staircase `exponential_decay` counts.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from r3dfsseg_tpu_torch.config import R3DConfig

ENCODER_PREFIX = "features.encoder."


def make_optimizer(model: nn.Module, cfg: R3DConfig
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.StepLR]:
    """Adam over [the encoder group at encoder_lr, the rest at lr] and its
    StepLR."""
    enc, rest = [], []
    for name, p in model.named_parameters():
        (enc if name.startswith(ENCODER_PREFIX) else rest).append(p)
    groups = [{"params": enc, "lr": cfg.encoder_lr}, {"params": rest, "lr": cfg.lr}]
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    transition = max(cfg.step_size // max(cfg.episode_batch, 1), 1)
    return opt, torch.optim.lr_scheduler.StepLR(opt, step_size=transition, gamma=cfg.gamma)
