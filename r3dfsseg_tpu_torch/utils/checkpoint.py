"""The JAX package's Flax `.msgpack` checkpoints on the port's learner
(counterpart of `r3dfsseg_tpu/utils/checkpoint.py`).

    save_checkpoint(path, learner, loss=..., iou=..., iteration=...)
    blob = load_checkpoint(path, learner, episode_batch=...)

The file is the JAX package's: ``{iteration, params, batch_stats,
opt_state, loss, IoU}`` in Flax's msgpack (`utils/flax_msgpack.py`), the
trees in Flax's layout (`utils/convert.py`), and the optax Adam state as
Flax's `to_state_dict` flattens the JAX learner's `multi_transform`:

    opt_state/inner_states/{encoder,rest}/inner_state/0/count       Adam's step
    opt_state/inner_states/{encoder,rest}/inner_state/0/{mu,nu}/<param path>
    opt_state/inner_states/{encoder,rest}/inner_state/1/count       the schedule's

with ``{}`` in place of a moment that the other group owns.  The groups
are the port's two Adam groups (`learners/base.py`: the trunk
`features.encoder.*` and the rest); mu and nu are Adam's exp_avg and
exp_avg_sq in the Flax kernels' (in, out) layout.  A load sets Adam's step
from ``count`` and the StepLR position from ``iteration //
episode_batch``, as the JAX package's `load_checkpoint` sets its step.

`save_pretrain_checkpoint` / `load_pretrain_checkpoint` carry the
pretraining run's encoder: a `.msgpack` as the JAX package's `pretrain.py`
writes it (``{params, batch_stats}`` holding ``features/encoder``), or a
`.tar` in the original code's ``{'params': ...}`` schema.  `restore`
installs any model checkpoint, either format, into a learner.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from r3dfsseg_tpu_torch.learners.base import ENCODER_PREFIX
from r3dfsseg_tpu_torch.utils.convert import (flax_paths, jax_tree_from_state_dict,
                                              state_dict_from_jax, to_flax, to_port)
from r3dfsseg_tpu_torch.utils.flax_msgpack import msgpack_restore, msgpack_serialize
from r3dfsseg_tpu_torch.utils.torch_convert import (checkpoint_file, encoder_key_map,
                                                    export_seg_encoder, install_adam_state,
                                                    load_checkpoint_blob, load_torch_checkpoint,
                                                    resume_from_reference_checkpoint,
                                                    state_dict_from_torch, torch_state_of)

GROUPS = ("encoder", "rest")        # the JAX learner's `_param_labels`, the port's groups
PRETRAIN_HEAD = "encoder.att_learner."  # the pretraining model's attention, in its encoder


def _write(path: str, blob: dict) -> None:
    """``blob`` as msgpack at ``path``, under a temporary name renamed into
    place, so a reader never finds half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(blob))
    os.replace(tmp, path)


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _put(tree: dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _get(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _group(name: str) -> str:
    return "encoder" if name.startswith(ENCODER_PREFIX) else "rest"


def adam_tree(learner) -> dict:
    """The learner's Adam state as the JAX learner's `opt_state` state
    dict (module docstring); moments of a parameter with no state yet (or
    none ever: the transformer's class tokens, whose gradient is stopped)
    are zeros."""
    count = np.asarray(learner.scheduler.last_epoch, np.int32)
    params = dict(learner.model.named_parameters())
    paths = flax_paths(learner.model)
    out = {}
    for g in GROUPS:
        mu, nu = {}, {}
        for name, leaf in paths.items():
            if leaf.collection != "params":
                continue
            p = params[name]
            if _group(name) != g:
                _put(mu, leaf.path, {})
                _put(nu, leaf.path, {})
                continue
            st = learner.optimizer.state.get(p, {})
            for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                _put(tree, leaf.path, to_flax(st.get(key, torch.zeros_like(p)), leaf))
        out[g] = {"inner_state": {"0": {"count": count, "mu": mu, "nu": nu},
                                  "1": {"count": count}}}
    return {"inner_states": out}


def save_checkpoint(path: str, learner, *, loss: float = 0.0, iou: float = 0.0,
                    iteration: Optional[int] = None) -> None:
    """Write {iteration, params, batch_stats, opt_state, loss, IoU} as the
    JAX package's `save_checkpoint` does; the JAX `load_checkpoint(path,
    state)` restores it into its TrainState.  ``iteration`` counts
    episodes; by default the learner's optimizer steps (right at
    episode_batch 1)."""
    params, stats = jax_tree_from_state_dict(learner.model)
    _write(path, {
        "iteration": int(learner.scheduler.last_epoch if iteration is None else iteration),
        "params": params, "batch_stats": stats, "opt_state": adam_tree(learner),
        "loss": float(loss), "IoU": float(iou)})


def load_checkpoint(path: str, learner=None, *, episode_batch: int = 1) -> dict:
    """Read a checkpoint written by `save_checkpoint` or by the JAX
    package's; with a ``learner``, install its weights (strictly), its Adam
    moments and steps and the StepLR position ``iteration //
    episode_batch``.  Returns the file's tree."""
    blob = _read(path)
    if not isinstance(blob, dict) or not {"params", "batch_stats", "opt_state"} <= set(blob):
        raise ValueError(f"{path}: not a model checkpoint (want params, batch_stats and "
                         f"opt_state)")
    if learner is None:
        return blob
    learner.load_params(blob["params"], blob["batch_stats"])
    params = dict(learner.model.named_parameters())
    moments, steps = {}, {}
    for name, leaf in flax_paths(learner.model).items():
        if leaf.collection != "params":
            continue
        g = blob["opt_state"]["inner_states"][_group(name)]["inner_state"]["0"]
        p = params[name]
        mv = []
        for key in ("mu", "nu"):
            a = _get(g[key], leaf.path)
            if isinstance(a, dict):
                raise ValueError(f"{path}: {key} of {'/'.join(leaf.path)} is masked in its "
                                 f"group {_group(name)!r}")
            mv.append(torch.from_numpy(to_port(a, leaf, p.shape)).to(p.device))
        moments[p] = tuple(mv)
        steps[p] = int(g["count"])
    install_adam_state(learner.optimizer, learner.scheduler, moments,
                       int(blob["iteration"]) // max(episode_batch, 1), steps)
    return blob


def restore(path: str, learner, log: Optional[Callable[[str], None]] = None) -> dict:
    """Install the model checkpoint that ``path`` names (a file or a log
    directory, `checkpoint_file`) into ``learner``: a `.msgpack` by
    `load_checkpoint`; a full-model `.tar` with its Adam state where it has
    one and the learner takes it (`resume_from_reference_checkpoint`); a
    pretraining `.tar` into the
    trunk only (`load_pretrain_checkpoint`, which says through ``log``
    what it drops).  Returns {path, iteration, IoU, loss}."""
    f = checkpoint_file(path)
    if f.endswith(".msgpack"):
        blob = load_checkpoint(f, learner, episode_batch=learner.cfg.episode_batch)
        info = {k: blob[k] for k in ("iteration", "IoU", "loss")}
    else:
        blob = load_checkpoint_blob(f)
        if "model_state_dict" in blob:
            info = resume_from_reference_checkpoint(f, learner)
            if info["adam_dropped"] and log is not None:
                log("checkpoint %s: its optimizer state is not restored for this model (as in "
                    "the JAX package, only the MPTI phases resume Adam from a .tar)" % f)
        else:
            sd, encoder_only = torch_state_of(blob)
            if encoder_only:
                learner.load_encoder_state(
                    load_pretrain_checkpoint(f, learner.model.features.encoder, log=log))
            else:
                learner.load_torch_state(sd)
            info = {"iteration": 0, "IoU": 0.0, "loss": 0.0}
    return {"path": f, "iteration": int(info["iteration"]), "IoU": float(info["IoU"] or 0.0),
            "loss": float(info["loss"] or 0.0)}


def save_pretrain_checkpoint(path: str, model: nn.Module) -> None:
    """The pretraining model's encoder (`nn/dgcnn.py:DGCNNSegAttention`):
    a `.tar` in the original schema, ``{'params': encoder.state_dict()}``
    with the attention maps (`export_seg_encoder`); a `.msgpack` as the JAX
    package's `pretrain.py` writes it, the trunk alone under
    ``features/encoder``."""
    if path.endswith(".tar"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"params": export_seg_encoder(model)}, tmp)
        os.replace(tmp, path)
        return
    params, stats = jax_tree_from_state_dict(model.encoder)
    _write(path, {"params": {"features": {"encoder": params}},
                  "batch_stats": {"features": {"encoder": stats}}})


def load_pretrain_checkpoint(path: str, encoder: nn.Module,
                             log: Optional[Callable[[str], None]] = None
                             ) -> Dict[str, torch.Tensor]:
    """A pretraining checkpoint -> the DGCNN trunk's tensors, keyed as
    ``encoder``'s (the port's `DGCNN`) state dict, for a strict load:
    from a `.msgpack` its ``features/encoder`` trees (the JAX package's
    artifact), from a `.tar` (the original schemas) the trunk's keys, its
    `encoder.att_learner.*` dropped (said through ``log``); any other key
    raises."""
    if path.endswith(".msgpack"):
        blob = _read(path)
        params, stats = blob["params"], blob.get("batch_stats", {})
        params, stats = params.get("features", params), stats.get("features", stats)
        if "encoder" not in params:
            raise KeyError(f"{path}: no encoder trunk (features/encoder) in the checkpoint")
        return state_dict_from_jax(params["encoder"], stats.get("encoder", {}))
    torch_state = load_torch_checkpoint(path)[0]
    # the original code's filtered merge drops the head: no MPTI model has it there
    dropped = sorted(k for k in torch_state if k.startswith(PRETRAIN_HEAD))
    if dropped and log is not None:
        log("pretrained checkpoint %s: the trunk is installed, the pretraining model's "
            "attention head dropped (%s)" % (path, ", ".join(dropped)))
    kept = {k: v for k, v in torch_state.items() if not k.startswith(PRETRAIN_HEAD)}
    return state_dict_from_torch(kept, encoder, {k: (p[len("encoder."):], nd) for k, (p, nd)
                                                 in encoder_key_map(encoder).items()})
