"""MPTI learner: the meta-training step with Adam + StepLR and the eval
step (counterpart of `r3dfsseg_tpu/learners/mpti_learner.py`).

    learner = MPTILearner(R3DConfig())            # on "cuda"
    metrics = learner.train(episode)              # one optimizer step

loss = lp_loss + contrast_weight * contrast_loss, then backward, Adam and
StepLR.  The learner runs on ``device``, "cuda" unless the caller asks for
"cpu"; without a CUDA device the default raises rather than fall back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from r3dfsseg_tpu_torch import pin_f32_matmul
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners.base import make_optimizer
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.models.mpti import MPTINet
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from r3dfsseg_tpu_torch.utils.torch_convert import state_dict_from_torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device``, or "cuda" when None; raises when CUDA is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


class MPTILearner:
    """Holds an `MPTINet` on ``device`` with its optimizer.  Weights start
    from ``generator`` (default: seeded with ``cfg.seed``), which then
    seeds each training call's attention dropout masks."""

    def __init__(self, cfg: R3DConfig, device: str | torch.device | None = None,
                 generator: Optional[torch.Generator] = None):
        pin_f32_matmul()
        self.cfg = cfg
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.generator = generator
        self.model = MPTINet(cfg)
        self.model.init_weights(generator)
        self.model.to(self.device)
        self.optimizer, self.scheduler = make_optimizer(self.model, cfg)

    def load_params(self, params: Mapping, batch_stats: Optional[Mapping] = None, *,
                    encoder_only: bool = False) -> None:
        """Install the JAX package's Flax ``params`` and ``batch_stats``
        trees and reset the optimizer state.  The whole model loads
        strictly (every weight must have a counterpart, and back); with
        ``encoder_only`` only the feature extractor's weights given (the
        tree's ``features`` subtree, or the tree itself) replace the
        current ones."""
        if encoder_only:
            params = params.get("features", params)
            batch_stats = (batch_stats or {}).get("features", batch_stats or {})
            sd = state_dict_from_jax(params, batch_stats)
            unknown = set(sd) - set(self.model.features.state_dict())
            if unknown:
                raise KeyError(f"no feature-extractor counterpart for {sorted(unknown)}")
            self.model.features.load_state_dict(sd, strict=False)
        else:
            self.model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
        self.optimizer, self.scheduler = make_optimizer(self.model, self.cfg)

    def load_torch_state(self, torch_state: Mapping) -> None:
        """Install the original PyTorch model's tensors, keyed as its
        `state_dict` (`utils/torch_convert.py`), and reset the optimizer
        state.  The whole model loads strictly: a torch key without a port
        counterpart raises, and so does a port tensor left unfilled.  A
        pretraining checkpoint's trunk goes through `load_encoder_state`."""
        sd = state_dict_from_torch(torch_state, self.model)
        missing = sorted(set(self.model.state_dict()) - set(sd))
        if missing:
            raise KeyError(f"the checkpoint leaves {missing} unfilled")
        self.model.load_state_dict(sd, strict=True)
        self.optimizer, self.scheduler = make_optimizer(self.model, self.cfg)

    def load_encoder_state(self, state: Mapping) -> None:
        """Install a pretrained DGCNN trunk, keyed as the trunk's own
        `state_dict` (`utils/checkpoint.py:load_pretrain_checkpoint`), with
        a strict load into ``features.encoder``, and reset the optimizer
        state; the rest keeps its values."""
        self.model.features.encoder.load_state_dict(state, strict=True)
        self.optimizer, self.scheduler = make_optimizer(self.model, self.cfg)

    def _tensor(self, a):
        if a is None:
            return None
        t = torch.as_tensor(a)
        if t.is_floating_point():
            t = t.float()
        return t.to(self.device)

    def train(self, ep: Episode) -> Dict[str, torch.Tensor]:
        """One optimizer step on an episode (batch).  Returns the metrics
        as 0-d tensors on the device, without a host sync: loss, lp_loss,
        contrast_loss, accuracy and, where the episode has gt fields,
        query_acc_LP, query_acc_original, clean_ratio_LP and
        clean_ratio_original."""
        ep = Episode(*(self._tensor(a) for a in ep))
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(ep, train=True, generator=self.generator)
        loss = out.lp_loss + self.cfg.contrast_weight * out.contrast_loss
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        metrics = {k: v.detach() for k, v in out.aux.items()}
        metrics.update(loss=loss.detach(), lp_loss=out.lp_loss.detach(),
                       contrast_loss=out.contrast_loss.detach())
        return metrics

    def test(self, ep: Episode, *, eval_mdns: bool = False, return_aux: bool = False):
        """(predictions (E, Q, N) int32, lp_loss, accuracy) under running BN
        statistics, on the device without a host sync.  With
        ``return_aux`` also the aux dict: accuracy and, with ``eval_mdns``
        on an episode with gt masks, the MDNS diagnostics (mdns_shot_clean_ratio,
        mdns_point_clean_ratio, mdns_size_ratio, mdns_precision,
        mdns_recall)."""
        ep = Episode(*(self._tensor(a) for a in ep))
        with torch.inference_mode():
            out = self.model(ep, train=False, eval_mdns=eval_mdns)
        pred = out.query_logits.argmax(-1).to(torch.int32)
        if return_aux:
            return pred, out.lp_loss, out.aux["accuracy"], out.aux
        return pred, out.lp_loss, out.aux["accuracy"]
