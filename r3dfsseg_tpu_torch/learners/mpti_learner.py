"""MPTI learner, eval only (counterpart of
`r3dfsseg_tpu/learners/mpti_learner.py`).  The optimizer and the train
step come with the training port (ROADMAP.md queue item 1)."""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from r3dfsseg_tpu_torch import pin_f32_matmul
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.models.mpti import MPTINet
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax


class MPTILearner:
    """Holds an `MPTINet` on ``device``.  Weights start from
    ``generator`` (default: seeded with ``cfg.seed``)."""

    def __init__(self, cfg: R3DConfig, device: str | torch.device = "cpu",
                 generator: Optional[torch.Generator] = None):
        pin_f32_matmul()
        self.cfg = cfg
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.model = MPTINet(cfg)
        self.model.init_weights(generator)
        self.model.to(self.device)

    def load_params(self, params: Mapping, batch_stats: Mapping) -> None:
        """Install the JAX package's Flax ``params`` and ``batch_stats``
        trees (every weight must have a counterpart, and back)."""
        self.model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)

    def _tensor(self, a):
        if a is None:
            return None
        t = torch.as_tensor(a)
        if t.is_floating_point():
            t = t.float()
        return t.to(self.device)

    def test(self, ep: Episode, *, eval_mdns: bool = False):
        """(predictions (E, Q, N) int32, lp_loss, accuracy) under running BN
        statistics."""
        ep = Episode(*(self._tensor(a) for a in ep))
        with torch.inference_mode():
            out = self.model(ep, train=False, eval_mdns=eval_mdns)
        pred = out.query_logits.argmax(-1).to(torch.int32)
        return pred, out.lp_loss, out.aux["accuracy"]
