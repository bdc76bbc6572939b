"""The original PyTorch model's checkpoints in the port, both directions
(counterpart of `r3dfsseg_tpu/utils/torch_convert.py`, MPTI phases).

The original `MPTI_SelfAtten` names its tensors by its module layout:
EdgeConv blocks `encoder.edge_convs.{i}.layer.{3j}` (Conv2d 1x1) and
`.{3j+1}` (BatchNorm2d), the MLP `encoder.conv.layer.{3j}` (Conv1d) and
`.{3j+1}`, the BaseLearner `base_learner.convs.{i}.0` (Conv1d with bias)
and `.1`, the attention maps `att_learner.{q,k,v}_map` (Conv1d) or
`linear_mapper` without attention, and the WayContrast head `proj`
(Linear).  The port names its modules after the JAX package's Flax tree
and its 1x1 convs are `nn.Linear`, so the map renames keys and drops or
adds the trailing 1x1 axes of the conv weights.  BatchNorm's
`num_batches_tracked` has no counterpart: it is dropped on load and
written as 0 (int64) on export, which a strict `load_state_dict` of the
original model needs.

Checkpoint schemas read by `load_torch_checkpoint`: the full model's
``{'model_state_dict': ...}`` (with iteration, optimizer state, loss and
IoU beside it), the pretraining run's ``{'params': ...}`` (the encoder's
tensors without their 'encoder.' prefix, which is put back), and a bare
state dict.  `save_reference_checkpoint` writes the first, without an
optimizer state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def feature_key_map(features: nn.Module) -> Dict[str, Tuple[str, int]]:
    """torch key -> (key under the port's `FeatureExtractor`, the conv's
    trailing 1x1 axes) for every tensor of the original model's feature
    extractor but `num_batches_tracked`, walked over ``features``' layers
    (the JAX package's `convert_feature_extractor` walk)."""
    out: Dict[str, Tuple[str, int]] = {}

    def convbn(conv: str, bn: str, port: str, conv_nd: int, bias: bool = False):
        out[f"{conv}.weight"] = (f"{port}.conv.weight", conv_nd)
        if bias:
            out[f"{conv}.bias"] = (f"{port}.conv.bias", 0)
        for leaf in _BN_LEAVES:
            out[f"{bn}.{leaf}"] = (f"{port}.bn.{leaf}", 0)

    enc = features.encoder
    for i in range(enc.n_edgeconv):
        for j in range(getattr(enc, f"edgeconv{i}").n_layers):
            convbn(f"encoder.edge_convs.{i}.layer.{3 * j}",
                   f"encoder.edge_convs.{i}.layer.{3 * j + 1}",
                   f"encoder.edgeconv{i}.layer{j}", 2)
    for j in range(enc.n_mlp):
        convbn(f"encoder.conv.layer.{3 * j}", f"encoder.conv.layer.{3 * j + 1}",
               f"encoder.mlp{j}", 1)
    for i in range(features.base_learner.n_layers):
        convbn(f"base_learner.convs.{i}.0", f"base_learner.convs.{i}.1",
               f"base_learner.conv{i}", 1, bias=True)
    if features.use_attention:
        for m in ("q_map", "k_map", "v_map"):
            out[f"att_learner.{m}.weight"] = (f"att_learner.{m}.weight", 1)
    else:
        out["linear_mapper.weight"] = ("linear_mapper.weight", 1)
    return out


def key_map(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """torch key -> (port key, trailing 1x1 axes) for every tensor of the
    original `MPTI_SelfAtten` but `num_batches_tracked`; ``model`` is the
    port's `MPTINet`."""
    out = {k: (f"features.{p}", nd) for k, (p, nd) in feature_key_map(model.features).items()}
    out["proj.weight"] = ("proj.weight", 0)
    out["proj.bias"] = ("proj.bias", 0)
    return out


def state_dict_from_torch(torch_state: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The original model's tensors (torch tensors or numpy arrays) -> the
    port's ``state_dict`` entries they fill: the JAX package's
    `convert_mpti_model`.  A conv weight (out, in, 1[, 1]) becomes the
    Linear weight (out, in).  `num_batches_tracked` is dropped; any other
    key without a counterpart raises KeyError.  Whether every port key is
    filled is the caller's strict load to check."""
    kmap = key_map(model)
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
        out[port] = t.detach().to("cpu", torch.float32).contiguous()
    return out


def _export(sd: Mapping[str, torch.Tensor], kmap: Mapping[str, Tuple[str, int]],
            prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, (port, conv_nd) in kmap.items():
        t = sd[port].detach().to("cpu", torch.float32).contiguous()
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


def export_mpti_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's `MPTINet` -> the original `MPTI_SelfAtten` state dict
    (CPU tensors), which it loads with strict=True."""
    return _export(model.state_dict(), key_map(model), "")


def _numpy_scalar_globals() -> list:
    """The numpy types a checkpoint's scalar fields (IoU, loss) unpickle to."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype,
            *(type(np.dtype(t)) for t in ("float64", "float32", "int64", "int32"))]


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A `checkpoint.tar` -> (its flat state dict on the CPU, whether it
    holds the encoder alone).  The file is read with
    ``torch.load(weights_only=True)``, which admits tensors, containers and
    numpy scalars and nothing that runs code."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in blob:
        sd = blob["model_state_dict"]
    elif "params" in blob:
        sd = {"encoder." + k: v for k, v in blob["params"].items()}
    else:
        sd = blob
    sd = {k: v.detach() for k, v in sd.items()}
    return sd, all(k.startswith("encoder.") for k in sd)


def save_reference_checkpoint(path: str, model: nn.Module, *, iteration: int = 0,
                              loss: float = 0.0, iou: float = 0.0) -> None:
    """Write the port's `MPTINet` as a `checkpoint.tar` that the original
    code loads: ``{'iteration', 'model_state_dict', 'optimizer_state_dict':
    None, 'loss', 'IoU'}``."""
    torch.save({"iteration": iteration, "model_state_dict": export_mpti_state(model),
                "optimizer_state_dict": None, "loss": loss, "IoU": iou}, path)
