"""ProtoNet learner (counterpart of `r3dfsseg_tpu/learners/proto_learner.py`):
loss = CE + contrast_weight * WayContrast, Adam in the two groups and
StepLR (`learners/base.py`).

    learner = ProtoLearner(R3DConfig(phase="prototrain"), with_contrast=True)
    metrics = learner.train(episode)      # loss, contrast_loss, accuracy
    pred, loss, acc = learner.test(episode, eval_mdns=True)
"""
from __future__ import annotations

from typing import Optional

import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners.base import Learner
from r3dfsseg_tpu_torch.models.protonet import ProtoNet


class ProtoLearner(Learner):
    """A `ProtoNet` (``with_contrast``: ProtoNet_Contrast, the baseline's
    phases) on ``device``."""

    def __init__(self, cfg: R3DConfig, device: str | torch.device | None = None,
                 generator: Optional[torch.Generator] = None, with_contrast: bool = False):
        self.with_contrast = with_contrast
        super().__init__(cfg, device, generator)

    def make_model(self) -> ProtoNet:
        return ProtoNet(self.cfg, with_contrast=self.with_contrast)

    def objective(self, out):
        loss = out.loss + self.cfg.contrast_weight * out.contrast_loss
        return loss, dict(loss=loss, contrast_loss=out.contrast_loss)
