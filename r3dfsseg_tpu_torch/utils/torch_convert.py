"""The original PyTorch model's checkpoints in the port, both directions
(counterpart of `r3dfsseg_tpu/utils/torch_convert.py`: the MPTI model,
the baselines ProtoNet(_Contrast) and ProtoNet_transformer, and the
pretraining model).

The original `MPTI_SelfAtten` names its tensors by its module layout:
EdgeConv blocks `encoder.edge_convs.{i}.layer.{3j}` (Conv2d 1x1) and
`.{3j+1}` (BatchNorm2d), the MLP `encoder.conv.layer.{3j}` (Conv1d) and
`.{3j+1}`, the BaseLearner `base_learner.convs.{i}.0` (Conv1d with bias)
and `.1`, the attention maps `att_learner.{q,k,v}_map` (Conv1d) or
`linear_mapper` without attention, and the WayContrast head `proj`
(Linear); ProtoNet_Contrast has the same keys, plain ProtoNet no `proj`.
ProtoNet_transformer adds `proj_trans_in`/`proj_trans_out`, its
`transformer` (the class and position embeddings and a torch
`TransformerEncoder`: `encoder.layers.{i}.self_attn.in_proj_weight`/`bias`
packing query, key and value, which the map splits into the port's three
Linear layers on load and joins on export) and
`binary_outlier_detector.fc`.  The pretraining model `DGCNNSeg_attention` holds the trunk and
the attention under `encoder` and a `segmenter` Sequential (`seg_key_map`).
The port names its modules after the JAX package's Flax tree
and its 1x1 convs are `nn.Linear`, so the map renames keys and drops or
adds the trailing 1x1 axes of the conv weights.  BatchNorm's
`num_batches_tracked` has no counterpart: it is dropped on load and
written as 0 (int64) on export, which a strict `load_state_dict` of the
original model needs.

Checkpoint schemas read by `load_torch_checkpoint`: the full model's
``{'model_state_dict': ...}`` (with iteration, optimizer state, loss and
IoU beside it), the pretraining run's ``{'params': ...}`` (the encoder's
tensors without their 'encoder.' prefix, which is put back), and a bare
state dict.  `save_reference_checkpoint` writes the first, with the Adam
state in the original optimizer's layout where it is given one
(`export_adam_state`), and `resume_from_reference_checkpoint` restores
weights, Adam moments and the StepLR position from such a file.  The
pretraining run writes the second (`export_seg_encoder`), which
`utils/checkpoint.py:load_pretrain_checkpoint` reads.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _convbn_keys(out: Dict[str, Tuple[str, int]], conv: str, bn: str, port: str,
                 conv_nd: int, bias: bool = False) -> None:
    out[f"{conv}.weight"] = (f"{port}.conv.weight", conv_nd)
    if bias:
        out[f"{conv}.bias"] = (f"{port}.conv.bias", 0)
    for leaf in _BN_LEAVES:
        out[f"{bn}.{leaf}"] = (f"{port}.bn.{leaf}", 0)


def encoder_key_map(enc: nn.Module) -> Dict[str, Tuple[str, int]]:
    """torch key -> (port key, the conv's trailing 1x1 axes) for the DGCNN
    trunk, walked over the port's `DGCNN` ``enc``: the original model's
    `encoder.edge_convs.{i}.layer.{3j}` (Conv2d) and `.{3j+1}` (BatchNorm)
    and `encoder.conv.layer.{3j}` (Conv1d) and `.{3j+1}`, to
    `encoder.edgeconv{i}.layer{j}` and `encoder.mlp{j}` (the trunk's name
    in both the feature extractor and the segmentation model)."""
    out: Dict[str, Tuple[str, int]] = {}
    for i in range(enc.n_edgeconv):
        for j in range(getattr(enc, f"edgeconv{i}").n_layers):
            _convbn_keys(out, f"encoder.edge_convs.{i}.layer.{3 * j}",
                         f"encoder.edge_convs.{i}.layer.{3 * j + 1}",
                         f"encoder.edgeconv{i}.layer{j}", 2)
    for j in range(enc.n_mlp):
        _convbn_keys(out, f"encoder.conv.layer.{3 * j}", f"encoder.conv.layer.{3 * j + 1}",
                     f"encoder.mlp{j}", 1)
    return out


def feature_key_map(features: nn.Module) -> Dict[str, Tuple[str, int]]:
    """torch key -> (key under the port's `FeatureExtractor`, the conv's
    trailing 1x1 axes) for every tensor of the original model's feature
    extractor but `num_batches_tracked`, walked over ``features``' layers
    (the JAX package's `convert_feature_extractor` walk)."""
    out = encoder_key_map(features.encoder)
    for i in range(features.base_learner.n_layers):
        _convbn_keys(out, f"base_learner.convs.{i}.0", f"base_learner.convs.{i}.1",
                     f"base_learner.conv{i}", 1, bias=True)
    if features.use_attention:
        for m in ("q_map", "k_map", "v_map"):
            out[f"att_learner.{m}.weight"] = (f"att_learner.{m}.weight", 1)
    else:
        out["linear_mapper.weight"] = ("linear_mapper.weight", 1)
    return out


def seg_key_map(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """torch key -> (port key, trailing 1x1 axes) for every tensor of the
    original pretraining model `DGCNNSeg_attention` (or `_v2`) but
    `num_batches_tracked`; ``model`` is the port's `DGCNNSegAttention`
    (the JAX package's `convert_seg_model`).  Its encoder is the trunk
    with the attention inside it, `encoder.att_learner.{q,k,v}_map`
    (Conv1d); the segmenter is a Sequential whose 0/1 and 3/4 are
    Conv1d/BatchNorm pairs (the second conv with a bias) and 7 the Conv1d
    to the classes."""
    out = encoder_key_map(model.encoder)
    for m in ("q_map", "k_map", "v_map"):
        out[f"encoder.att_learner.{m}.weight"] = (f"att_learner.{m}.weight", 1)
    _convbn_keys(out, "segmenter.0", "segmenter.1", "seg0", 1)
    _convbn_keys(out, "segmenter.3", "segmenter.4", "seg1", 1, bias=True)
    out["segmenter.7.weight"] = ("seg_out.weight", 1)
    out["segmenter.7.bias"] = ("seg_out.bias", 0)
    return out


def transformer_key_map(model: nn.Module) -> Dict[str, Tuple[object, int]]:
    """torch key -> port key for the original `ProtoNet_transformer`'s
    head (the JAX package's `convert_transformer_model`); the packed
    ``in_proj`` tensors map to the tuple of the port's query, key and value
    tensors they split into."""
    out: Dict[str, Tuple[object, int]] = {
        "proj_trans_in": ("proj_trans_in", 0), "proj_trans_out": ("proj_trans_out", 0)}
    tr = model.transformer
    for name in ("cls_embeddings", "pos_embeddings"):
        if hasattr(tr, name):
            out[f"transformer.{name}.weight"] = (f"transformer.{name}.weight", 0)
    for i in range(tr.n_layers):
        g, p = f"transformer.encoder.layers.{i}.", f"transformer.layer{i}."
        for leaf in ("weight", "bias"):
            out[f"{g}self_attn.in_proj_{leaf}"] = (
                tuple(f"{p}self_attn.{n}.{leaf}" for n in ("query", "key", "value")), 0)
            out[f"{g}self_attn.out_proj.{leaf}"] = (f"{p}self_attn.out.{leaf}", 0)
            for m in ("linear1", "linear2", "norm1", "norm2"):
                out[f"{g}{m}.{leaf}"] = (f"{p}{m}.{leaf}", 0)
    for leaf in ("weight", "bias"):
        out[f"binary_outlier_detector.fc.{leaf}"] = (f"binary_outlier_detector.{leaf}", 0)
    return out


def key_map(model: nn.Module) -> Dict[str, Tuple[object, int]]:
    """torch key -> (port key, trailing 1x1 axes) for every tensor of the
    original model but `num_batches_tracked`: `MPTI_SelfAtten` for the
    port's `MPTINet`, `ProtoNet(_Contrast)` for its `ProtoNet`,
    `ProtoNet_transformer` for its `ProtoNetTransformer` (the head's map in
    `transformer_key_map`)."""
    out = {k: (f"features.{p}", nd) for k, (p, nd) in feature_key_map(model.features).items()}
    if hasattr(model, "proj"):
        out["proj.weight"] = ("proj.weight", 0)
        out["proj.bias"] = ("proj.bias", 0)
    if hasattr(model, "transformer"):
        out.update(transformer_key_map(model))
    return out


def state_dict_from_torch(torch_state: Mapping, model: nn.Module,
                          kmap: Mapping[str, Tuple[object, int]] | None = None
                          ) -> Dict[str, torch.Tensor]:
    """The original model's tensors (torch tensors or numpy arrays) -> the
    port's ``state_dict`` entries they fill, by ``kmap`` (default
    `key_map`: the JAX package's `convert_for_phase`).  A conv weight
    (out, in, 1[, 1]) becomes the Linear weight (out, in); a tensor mapped
    to several port keys splits into equal parts along its first axis.
    `num_batches_tracked` is dropped; any other key without a counterpart
    raises KeyError.  Whether every port key is filled is the caller's
    strict load to check."""
    kmap = key_map(model) if kmap is None else kmap
    out: Dict[str, torch.Tensor] = {}
    for key, value in torch_state.items():
        if key.endswith(".num_batches_tracked"):
            continue
        if key not in kmap:
            raise KeyError(f"no port counterpart for the torch key {key!r}")
        port, conv_nd = kmap[key]
        t = torch.as_tensor(value)
        if conv_nd:
            if t.dim() != 2 + conv_nd or any(s != 1 for s in t.shape[2:]):
                raise ValueError(f"{key}: want a 1x1 conv weight of {2 + conv_nd} axes, "
                                 f"got {tuple(t.shape)}")
            t = t.reshape(t.shape[:2])
        t = t.detach().to("cpu", torch.float32)
        if isinstance(port, tuple):
            if t.shape[0] % len(port):
                raise ValueError(f"{key}: {tuple(t.shape)} does not split into {len(port)}")
            out.update(zip(port, (part.contiguous() for part in t.chunk(len(port)))))
        else:
            out[port] = t.contiguous()
    return out


def _export(sd: Mapping[str, torch.Tensor], kmap: Mapping[str, Tuple[str, int]],
            prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, (port, conv_nd) in kmap.items():
        t = (torch.cat([sd[p] for p in port]) if isinstance(port, tuple) else sd[port])
        t = t.detach().to("cpu", torch.float32).contiguous()
        out[prefix + key] = t.reshape(*t.shape, *(1,) * conv_nd)
        if key.endswith(".running_var"):
            # torch BatchNorm carries this buffer; strict load_state_dict needs it
            out[prefix + key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return out


def export_feature_extractor(features: nn.Module, *, prefix: str = ""
                             ) -> Dict[str, torch.Tensor]:
    """Inverse of the load for the feature extractor: the port's
    `FeatureExtractor` -> CPU tensors under the original model's key names
    and layouts (Conv2d (out, in, 1, 1), Conv1d (out, in, 1), BatchNorm
    with `num_batches_tracked`), under ``prefix``."""
    return _export(features.state_dict(), feature_key_map(features), prefix)


def export_model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's `MPTINet`, `ProtoNet` or `ProtoNetTransformer` -> the
    original model's state dict (CPU tensors), which it loads with
    strict=True (`key_map`)."""
    return _export(model.state_dict(), key_map(model), "")


def export_seg_encoder(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's `DGCNNSegAttention` -> its encoder's tensors as the
    original pretraining run saves them, ``DGCNNSeg_attention.encoder.
    state_dict()``: the trunk and the attention maps, without the
    'encoder.' prefix (the `{'params': ...}` schema)."""
    sd = _export(model.state_dict(), seg_key_map(model), "")
    return {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}


def _numpy_scalar_globals() -> list:
    """The numpy types a checkpoint's scalar fields (IoU, loss) unpickle to."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype,
            *(type(np.dtype(t)) for t in ("float64", "float32", "int64", "int32"))]


def checkpoint_file(path: str) -> str:
    """The checkpoint file that ``path`` names: the file itself (a `.tar`
    or the JAX package's `.msgpack`), or a log directory's
    `checkpoint.msgpack`, else its `checkpoint.tar`, in the JAX package's
    order.  Callers dispatch on the suffix (`utils/checkpoint.py`)."""
    if os.path.isdir(path):
        for name in ("checkpoint.msgpack", "checkpoint.tar"):
            f = os.path.join(path, name)
            if os.path.exists(f):
                path = f
                break
    if not path.endswith((".tar", ".msgpack")) or not os.path.isfile(path):
        raise ValueError(f"no checkpoint found at {path!r}")
    return path


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A `checkpoint.tar` -> (its flat state dict on the CPU, whether it
    holds the encoder alone).  The file is read with
    ``torch.load(weights_only=True)``, which admits tensors, containers and
    numpy scalars and nothing that runs code."""
    return torch_state_of(load_checkpoint_blob(path))


def torch_state_of(blob: Mapping) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A loaded checkpoint -> (its flat state dict, whether it holds the
    encoder alone); `load_torch_checkpoint` without the read."""
    if "model_state_dict" in blob:
        sd = blob["model_state_dict"]
    elif "params" in blob:
        sd = {"encoder." + k: v for k, v in blob["params"].items()}
    else:
        sd = blob
    sd = {k: v.detach() for k, v in sd.items()}
    return sd, all(k.startswith("encoder.") for k in sd)


# ======================================================================
# The Adam state.  The original code builds four parameter groups, encoder
# | base_learner | att_learner | proj (its `models/mpti_learner.py:27-32`),
# and torch numbers the state by position in the concatenation of their
# parameters (registration order: per conv block Conv.weight[, Conv.bias],
# BN.weight, BN.bias; the EdgeConv blocks before the MLP).  The port has
# two groups (`learners/base.py`), so its moments are matched by name.
# ======================================================================
_REFERENCE_GROUPS = (("encoder.",), ("base_learner.",), ("att_learner.", "linear_mapper."),
                     ("proj.",))


def reference_adam_param_order(model: nn.Module
                               ) -> Tuple[List[Tuple[str, str, int]], List[List[int]]]:
    """The original model's parameters in its Adam's index order, as
    [(torch key, port key, trailing 1x1 axes)], and the four groups' index
    lists (the JAX package's `reference_adam_param_order`; the mapper of a
    model without attention sits in the attention's group)."""
    order = [(k, port, nd) for k, (port, nd) in key_map(model).items()
             if not k.endswith((".running_mean", ".running_var"))]
    groups = [[i for i, (k, _, _) in enumerate(order) if k.startswith(prefixes)]
              for prefixes in _REFERENCE_GROUPS]
    if sum(map(len, groups)) != len(order):
        raise KeyError("a parameter of the original model falls in none of its Adam groups")
    return order, groups


def export_adam_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                      iteration: int) -> dict:
    """The port's Adam state -> an ``optimizer_state_dict`` that the
    original model's Adam loads: moments by the original index order, conv
    moments in the conv weights' (out, in, 1[, 1]) shape, ``step`` =
    ``iteration`` (episodes, as the JAX package writes it), and four groups
    at the port's current rates (the encoder's, then the rest's)."""
    order, groups = reference_adam_param_order(model)
    params = dict(model.named_parameters())
    state = {}
    for i, (_, port, nd) in enumerate(order):
        p = params[port]
        st = optimizer.state.get(p, {})
        moments = [st.get(m, torch.zeros_like(p)).detach().to("cpu", torch.float32)
                   for m in ("exp_avg", "exp_avg_sq")]
        state[i] = {"step": torch.tensor(float(iteration)),
                    **{m: t.reshape(*t.shape, *(1,) * nd).contiguous()
                       for m, t in zip(("exp_avg", "exp_avg_sq"), moments)}}
    port_groups = [{k: v for k, v in g.items() if k != "params"}
                   for g in optimizer.param_groups]
    param_groups = [dict(port_groups[min(gi, 1)], params=idx) for gi, idx in enumerate(groups)]
    return {"state": state, "param_groups": param_groups}


def load_adam_state(opt_sd: Mapping, model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, episode_batch: int = 1) -> int:
    """Install an original-layout ``optimizer_state_dict`` (the port's own
    or the original code's) into the port's Adam, and move the StepLR to
    the same step: the moments by name, ``step`` // ``episode_batch``
    optimizer steps (the JAX package's `convert_adam_state`).  Returns the
    file's step (episodes)."""
    order, _ = reference_adam_param_order(model)
    idx_seq = [i for g in opt_sd.get("param_groups", []) for i in g.get("params", [])]
    idx_seq = idx_seq or list(range(len(order)))
    if len(idx_seq) != len(order):
        raise ValueError(f"the checkpoint's optimizer has {len(idx_seq)} parameters, "
                         f"this model {len(order)}")
    params = dict(model.named_parameters())
    state = opt_sd.get("state", {})
    step, moments = 0, {}
    for (key, port, _), idx in zip(order, idx_seq):
        st = state.get(idx, state.get(str(idx)))
        if st is None:
            continue
        step = max(step, int(torch.as_tensor(st["step"]).item()))
        p = params[port]
        m, v = (torch.as_tensor(st[k]).to(p.device, p.dtype) for k in ("exp_avg", "exp_avg_sq"))
        if m.numel() != p.numel() or v.numel() != p.numel():
            raise ValueError(f"{key}: moments of {tuple(m.shape)} for a parameter of "
                             f"{tuple(p.shape)}")
        moments[p] = (m.reshape(p.shape).clone(), v.reshape(p.shape).clone())
    install_adam_state(optimizer, scheduler, moments, step // max(episode_batch, 1))
    return step


def install_adam_state(optimizer: torch.optim.Optimizer, scheduler, moments: Mapping,
                       n: int, steps: Mapping | None = None) -> None:
    """Replace the Adam state by ``moments`` (parameter -> (exp_avg,
    exp_avg_sq)) at ``n`` optimizer steps (or each parameter's ``steps``
    entry), and move the StepLR to ``n``: ``last_epoch`` n and each group's
    rate its initial one times gamma ** (n // step_size)."""
    optimizer.state.clear()
    for p, (m, v) in moments.items():
        step = n if steps is None else steps[p]
        optimizer.state[p] = {"step": torch.tensor(float(step)), "exp_avg": m,
                              "exp_avg_sq": v}
    scheduler.last_epoch = n
    for g in optimizer.param_groups:
        g["lr"] = g["initial_lr"] * scheduler.gamma ** (n // scheduler.step_size)
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]


def save_reference_checkpoint(path: str, model: nn.Module, *, iteration: int = 0,
                              loss: float = 0.0, iou: float = 0.0,
                              optimizer: torch.optim.Optimizer | None = None) -> None:
    """Write the port's model as a `checkpoint.tar` that the original code
    loads: ``{'iteration', 'model_state_dict', 'optimizer_state_dict',
    'loss', 'IoU'}`` (`export_model_state`), the optimizer state None
    unless ``optimizer`` is given (`export_adam_state`: the MPTI model's
    layout; the learners give it where `Learner.reference_adam` says so).
    Written under a temporary name and renamed, so a reader never finds
    half a file."""
    opt_sd = None if optimizer is None else export_adam_state(model, optimizer, iteration)
    tmp = path + ".tmp"
    torch.save({"iteration": int(iteration), "model_state_dict": export_model_state(model),
                "optimizer_state_dict": opt_sd, "loss": float(loss), "IoU": float(iou)}, tmp)
    os.replace(tmp, path)


def load_checkpoint_blob(path: str) -> dict:
    """A `checkpoint.tar` as saved (weights_only, as `load_torch_checkpoint`)."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def resume_from_reference_checkpoint(path: str, learner) -> dict:
    """Resume meta-training from a full-model `checkpoint.tar` (the port's
    or the original code's): weights and BN statistics, and the Adam
    moments and the StepLR position where the file holds an optimizer
    state and the learner takes one (`Learner.reference_adam`: the MPTI
    model; a baseline starts a fresh Adam, as in the JAX package).
    Returns its bookkeeping fields {iteration, IoU, loss} and whether an
    optimizer state in the file was left out (``adam_dropped``)."""
    blob = load_checkpoint_blob(path)
    if "model_state_dict" not in blob:
        raise ValueError(f"{path}: not a full-model checkpoint (no model_state_dict)")
    learner.load_torch_state({k: v.detach() for k, v in blob["model_state_dict"].items()})
    opt_sd = blob.get("optimizer_state_dict")
    if opt_sd and learner.reference_adam:
        load_adam_state(opt_sd, learner.model, learner.optimizer, learner.scheduler,
                        learner.cfg.episode_batch)
    return {"iteration": int(blob.get("iteration", 0)),
            "IoU": float(blob.get("IoU", 0.0) or 0.0),
            "loss": float(blob.get("loss", 0.0) or 0.0),
            "adam_dropped": bool(opt_sd) and not learner.reference_adam}
