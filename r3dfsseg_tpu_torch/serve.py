"""Serving API (counterpart of `r3dfsseg_tpu/serve.py`).

    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.serve import FewShotPredictor

    p = FewShotPredictor.from_checkpoint("<log_dir>", R3DConfig())   # on "cuda"
    labels = p.predict(support_x, support_y, query_x)   # (Q, N) int32

`support_x` is (n_way, k_shot, n_points, 9) xyzrgbXYZ, `support_y`
(n_way, k_shot, n_points) binary fg masks, `query_x` (Q, n_points, 9);
labels are 0 = background, 1..n_way = way.  MDNS clean-shot suppression is
on by default.  The learner follows ``cfg.phase``, as in the JAX package:
the MPTI phases serve the MPTI model, ``protoeval``/``prototrain``
ProtoNet_Contrast and ``transformereval``/``transformertrain`` the
transformer baseline (`learners/__init__.py:make_learner`); any other phase
raises.  The predictor runs on ``device``, "cuda" unless the caller asks
for "cpu".  Checkpoints: the JAX package's `checkpoint.msgpack`
(`utils/checkpoint.py`) and the original PyTorch model's `checkpoint.tar`
(`utils/torch_convert.py`).  Whole-scene serving (`predict_scene`) is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners import make_learner
from r3dfsseg_tpu_torch.learners.base import Learner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.utils.checkpoint import restore


class FewShotPredictor:
    """The learner of ``cfg.phase`` on ``device`` that segments query clouds."""

    def __init__(self, cfg: R3DConfig, learner: Optional[Learner] = None, *,
                 device: str | torch.device | None = None, eval_mdns: bool = True):
        self.cfg = cfg
        self.eval_mdns = eval_mdns
        self._learner = learner if learner is not None else make_learner(cfg, device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[R3DConfig] = None, *,
                        device: str | torch.device | None = None,
                        eval_mdns: bool = True) -> "FewShotPredictor":
        """A predictor whose weights come from ``path``: the JAX package's
        `checkpoint.msgpack`, a `checkpoint.tar` of the original PyTorch
        model (any schema of `utils/torch_convert.py:load_torch_checkpoint`;
        a pretraining checkpoint replaces the feature extractor's encoder
        only), or a log directory holding one, searched for
        `checkpoint.msgpack` first, then `checkpoint.tar`, as in the JAX
        package (`utils/checkpoint.py:restore`)."""
        self = cls(cfg or R3DConfig(), device=device, eval_mdns=eval_mdns)
        restore(path, self._learner)
        return self

    def predict(self, support_x: np.ndarray, support_y: np.ndarray,
                query_x: np.ndarray) -> np.ndarray:
        """Segment `query_x` against the support set: (Q, N) int32 labels."""
        c = self.cfg
        q, n = query_x.shape[0], query_x.shape[1]
        if (support_x.shape[:2] != (c.n_way, c.k_shot)
                or n != c.pc_npts or q != c.n_way * c.n_queries):
            raise ValueError(
                f"episode shape mismatch: support {support_x.shape}, "
                f"query {query_x.shape} vs config "
                f"({c.n_way}-way {c.k_shot}-shot, {c.pc_npts} pts, "
                f"{c.n_way * c.n_queries} queries)")
        ep = Episode(
            support_x=np.asarray(support_x, np.float32),
            support_y=np.asarray(support_y, np.int32),
            query_x=np.asarray(query_x, np.float32),
            query_y=np.zeros((q, n), np.int32))          # dummy: the loss is unused
        pred, _, _ = self._learner.test(ep, eval_mdns=self.eval_mdns)
        return pred[0].cpu().numpy()

    __call__ = predict
