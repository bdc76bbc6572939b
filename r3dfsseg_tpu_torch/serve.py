"""Serving API (counterpart of `r3dfsseg_tpu/serve.py`).

    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.serve import FewShotPredictor

    p = FewShotPredictor.from_checkpoint("<log_dir>", R3DConfig())   # on "cuda"
    labels = p.predict(support_x, support_y, query_x)   # (Q, N) int32

`support_x` is (n_way, k_shot, n_points, 9) xyzrgbXYZ, `support_y`
(n_way, k_shot, n_points) binary fg masks, `query_x` (Q, n_points, 9);
labels are 0 = background, 1..n_way = way.  MDNS clean-shot suppression is
on by default.  The predictor runs on ``device``, "cuda" unless the caller
asks for "cpu".  Checkpoints: the original PyTorch model's `checkpoint.tar`
(`utils/torch_convert.py`); the JAX package's `checkpoint.msgpack` is not
read yet (ROADMAP.md).  Whole-scene serving (`predict_scene`) is not
ported yet.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.utils.torch_convert import load_torch_checkpoint


class FewShotPredictor:
    """An MPTI learner on ``device`` that segments query clouds."""

    def __init__(self, cfg: R3DConfig, learner: Optional[MPTILearner] = None, *,
                 device: str | torch.device | None = None, eval_mdns: bool = True):
        if cfg.phase not in ("mptinoise_eval", "mptieval", "mptitrain"):
            raise NotImplementedError(f"phase {cfg.phase!r} is not servable by the port yet")
        self.cfg = cfg
        self.eval_mdns = eval_mdns
        self._learner = learner if learner is not None else MPTILearner(cfg, device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[R3DConfig] = None, *,
                        device: str | torch.device | None = None,
                        eval_mdns: bool = True) -> "FewShotPredictor":
        """A predictor whose weights come from ``path``: a `checkpoint.tar`
        of the original PyTorch model (any schema of
        `utils/torch_convert.py:load_torch_checkpoint`; a pretraining
        checkpoint replaces the feature extractor's encoder only), or a log
        directory holding one.  A directory is searched for
        `checkpoint.msgpack` first, then `checkpoint.tar`, as in the JAX
        package; a `.msgpack` raises NotImplementedError."""
        if os.path.isdir(path):
            for name in ("checkpoint.msgpack", "checkpoint.tar"):
                f = os.path.join(path, name)
                if os.path.exists(f):
                    path = f
                    break
        if path.endswith(".msgpack"):
            raise NotImplementedError(
                f"{path}: the JAX package's Flax checkpoints are not read by the port yet "
                f"(ROADMAP.md); pass a checkpoint.tar")
        if not path.endswith(".tar"):
            raise ValueError(f"no checkpoint found at {path!r}")
        sd, encoder_only = load_torch_checkpoint(path)
        self = cls(cfg or R3DConfig(), device=device, eval_mdns=eval_mdns)
        self._learner.load_torch_state(sd, encoder_only=encoder_only)
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
