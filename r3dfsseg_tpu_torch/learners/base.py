"""What the learners share (counterpart of `r3dfsseg_tpu/learners/base.py`):
the device, the generator, the optimizer and its schedule, the weight
loads, and the train and test steps.

Adam with two parameter groups: the pretrained DGCNN trunk
(`features.encoder.*`, the JAX package's `_param_labels` 'encoder') at
``encoder_lr`` and every other parameter at ``lr``, with optax's defaults
(betas 0.9 and 0.999, eps 1e-8, no weight decay).  StepLR multiplies both
rates by ``gamma`` every ``max(step_size // episode_batch, 1)`` optimizer
steps, so the decay points stay where they are in episodes; it is stepped
once per optimizer step, as optax's staircase `exponential_decay` counts.

Episode data parallelism (the JAX package's `MeshedLearner`):
`attach_mesh` makes rank 0's parameters, buffers, Adam state and generator
every rank's.  A batch of E episodes that the W ranks divide then runs
rows [r E / W, (r + 1) E / W) on rank r (`parallel/mesh.py`): BatchNorm per
episode as on one device, the running statistics mean-reduced after the
forward (the mean of the per-episode updates, as on one device), the
gradient mean-reduced after the backward (the gradient of the mean over
all E episodes), the metrics mean-reduced, and `test`'s predictions
gathered in episode order.  Adam and StepLR then step alike on every rank.
A batch that W does not divide, or an unbatched episode, runs whole on
every rank with no collective.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from r3dfsseg_tpu_torch import pin_f32_matmul
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import BatchNorm
from r3dfsseg_tpu_torch.parallel.mesh import (Shard, all_gather_rows, all_reduce_grads_,
                                              all_reduce_mean, divides, replicate,
                                              shard_episode)
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from r3dfsseg_tpu_torch.utils.torch_convert import state_dict_from_torch

ENCODER_PREFIX = "features.encoder."


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device``, or "cuda" when None; raises when CUDA is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


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


class Learner:
    """A model on ``device`` ("cuda" unless the caller asks for "cpu";
    without a CUDA device the default raises rather than fall back) with
    its optimizer.  Weights start from ``generator`` (default: seeded with
    ``cfg.seed``), which then seeds each training call's dropout masks.

    A subclass builds its model (`make_model`) and names its losses:
    `objective` (the loss that training minimises and its metrics) and
    ``test_loss`` (the output field that `test` returns)."""

    test_loss = "loss"
    mesh = None          # `attach_mesh`
    # whether a `.tar`'s optimizer state is restored on resume: the JAX
    # package restores it for the MPTI phases only
    # (`r3dfsseg_tpu/utils/torch_convert.py:resume_from_reference_checkpoint`)
    reference_adam = False

    def __init__(self, cfg: R3DConfig, device: str | torch.device | None = None,
                 generator: Optional[torch.Generator] = None):
        pin_f32_matmul()
        self.cfg = cfg
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.generator = generator
        self.model = self.make_model()
        self.model.init_weights(generator)
        self.model.to(self.device)
        self.optimizer, self.scheduler = make_optimizer(self.model, cfg)

    def make_model(self) -> nn.Module:
        raise NotImplementedError

    def objective(self, out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the training loss, the step's metrics besides the aux dict)."""
        raise NotImplementedError

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
        `state_dict` (`utils/torch_convert.py:key_map`), and reset the
        optimizer state.  The whole model loads strictly: a torch key
        without a port counterpart raises, and so does a port tensor left
        unfilled.  A pretraining checkpoint's trunk goes through
        `load_encoder_state`."""
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

    def attach_mesh(self, mesh) -> bool:
        """Run episode batches data-parallel over ``mesh``
        (`parallel/mesh.py:make_mesh`, on this rank's device) where it
        divides ``cfg.episode_batch``: rank 0's parameters, buffers, Adam
        state and generator state go to every rank.  Otherwise every rank
        runs whole batches with no mesh (the JAX CLIs' choice).  Returns
        whether it attached.  Attach after loading weights (a load resets
        Adam)."""
        if self.cfg.episode_batch % mesh.size:
            return False
        self.mesh = mesh
        adam = [v for g in self.optimizer.param_groups for p in g["params"]
                for _, v in sorted(self.optimizer.state.get(p, {}).items())
                if torch.is_tensor(v)]
        gen = self.generator.get_state()
        replicate([*self.model.parameters(), *self.model.buffers(), *adam, gen], mesh)
        self.generator.set_state(gen)
        return True

    def shard(self, ep: Episode):
        """(this rank's rows of a batched host episode, their global
        offset) where the mesh divides the batch, else (ep, None): the
        episode runs whole (the JAX package's `_maybe_shard`)."""
        if not (ep[0].ndim == 5 and divides(self.mesh, ep[0].shape[0])):
            return ep, None
        return shard_episode(Episode(*ep), self.mesh)

    def _bn_buffers(self):
        return [b for m in self.model.modules() if isinstance(m, BatchNorm)
                for b in (m.running_mean, m.running_var)]

    def _mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = sorted(metrics)
        return dict(zip(keys, all_reduce_mean([metrics[k].float() for k in keys], self.mesh)))

    def _tensor(self, a):
        if a is None:
            return None
        t = torch.as_tensor(a)
        if t.is_floating_point():
            t = t.float()
        return t.to(self.device)

    def train(self, ep: Episode, offset: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on an episode (batch): the model's training
        forward, `objective`, backward, Adam and StepLR.  Returns the
        metrics as 0-d tensors on the device, without a host sync.  With a
        mesh the step is data-parallel where the mesh divides the batch
        (module docstring) and the metrics are the whole batch's; ep is
        then the whole host batch, or this rank's rows (`shard`) at
        ``offset``."""
        if offset is None:
            ep, offset = self.shard(ep)
        ep = Episode(*(self._tensor(a) for a in ep))
        shard = None if offset is None else Shard(offset,
                                                  ep.support_x.shape[0] * self.mesh.size)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(ep, train=True, generator=self.generator, shard=shard)
        if shard is not None:
            bufs = self._bn_buffers()
            with torch.no_grad():
                for b, m in zip(bufs, all_reduce_mean(bufs, self.mesh)):
                    b.copy_(m)
        loss, metrics = self.objective(out)
        loss.backward()
        if shard is not None:
            all_reduce_grads_(list(self.model.parameters()), self.mesh)
        self.optimizer.step()
        self.scheduler.step()
        metrics = {**{k: v.detach() for k, v in out.aux.items()},
                   **{k: v.detach() for k, v in metrics.items()}}
        return metrics if shard is None else self._mean(metrics)

    def test(self, ep: Episode, *, eval_mdns: bool = False, return_aux: bool = False,
             offset: Optional[int] = None):
        """(predictions (E, Q, N) int32, the ``test_loss``, accuracy) under
        running BN statistics, on the device without a host sync; with
        ``return_aux`` also the model's aux dict.  With a mesh that divides
        the batch (ep the whole batch, or this rank's rows at ``offset``,
        as `train`'s) each rank runs its rows, and every rank returns the
        whole batch's predictions in episode order and its mean loss,
        accuracy and aux."""
        if offset is None:
            ep, offset = self.shard(ep)
        ep = Episode(*(self._tensor(a) for a in ep))
        with torch.inference_mode():
            out = self.model(ep, train=False, eval_mdns=eval_mdns)
            pred = out.query_logits.argmax(-1).to(torch.int32)
            aux = dict(out.aux, **{self.test_loss: getattr(out, self.test_loss)})
            if offset is not None:
                pred = all_gather_rows(pred, self.mesh)
                aux = self._mean(aux)
        loss = aux.pop(self.test_loss)
        if return_aux:
            return pred, loss, aux["accuracy"], aux
        return pred, loss, aux["accuracy"]
