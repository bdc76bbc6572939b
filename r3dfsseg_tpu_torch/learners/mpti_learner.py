"""MPTI learner: the meta-training step with Adam + StepLR and the eval
step (counterpart of `r3dfsseg_tpu/learners/mpti_learner.py`).

    learner = MPTILearner(R3DConfig())            # on "cuda"
    metrics = learner.train(episode)              # one optimizer step

loss = lp_loss + contrast_weight * contrast_loss, then backward, Adam and
StepLR.  The learner runs on ``device``, "cuda" unless the caller asks for
"cpu"; without a CUDA device the default raises rather than fall back
(`learners/base.py`).
"""
from __future__ import annotations

from r3dfsseg_tpu_torch.learners.base import Learner
from r3dfsseg_tpu_torch.models.mpti import MPTINet


class MPTILearner(Learner):
    """Holds an `MPTINet` on ``device`` with its optimizer.  Weights start
    from ``generator`` (default: seeded with ``cfg.seed``), which then
    seeds each training call's attention dropout masks.

    `train` returns loss, lp_loss, contrast_loss, accuracy and, where the
    episode has gt fields, query_acc_LP, query_acc_original,
    clean_ratio_LP and clean_ratio_original.  `test` returns
    (predictions, lp_loss, accuracy); with ``return_aux`` and
    ``eval_mdns`` on an episode with gt masks the aux dict holds the MDNS
    diagnostics (mdns_shot_clean_ratio, mdns_point_clean_ratio,
    mdns_size_ratio, mdns_precision, mdns_recall)."""

    test_loss = "lp_loss"
    reference_adam = True

    def make_model(self) -> MPTINet:
        return MPTINet(self.cfg)

    def objective(self, out):
        loss = out.lp_loss + self.cfg.contrast_weight * out.contrast_loss
        return loss, dict(loss=loss, lp_loss=out.lp_loss, contrast_loss=out.contrast_loss)
