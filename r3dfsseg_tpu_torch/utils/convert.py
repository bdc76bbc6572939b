"""Carry weights between the JAX package's Flax trees and the port.

The port names its submodules after the Flax tree, so the map is
mechanical: the path ``features/encoder/edgeconv0/layer0/conv/kernel``
becomes the key ``features.encoder.edgeconv0.layer0.conv.weight``.
`jax_tree_from_state_dict` is the way back.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from r3dfsseg_tpu_torch.nn.dgcnn import BatchNorm

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` trees (numpy-convertible leaves)
    -> the port's ``state_dict``.

    A Dense ``kernel`` (in, out) becomes ``Linear.weight`` (out, in);
    BatchNorm ``scale``/``bias``/``mean``/``var`` become
    ``weight``/``bias``/``running_mean``/``running_var``.
    """
    sd: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAF), (batch_stats or {}, _STAT_LEAF)):
        for path, leaf in _leaves(tree):
            *mod, name = path
            if name not in names:
                raise KeyError(f"no port counterpart for Flax leaf {'/'.join(path)}")
            a = np.array(leaf, np.float32)
            if name == "kernel":
                a = np.ascontiguousarray(a.T)
            sd[".".join([*mod, names[name]])] = torch.from_numpy(a)
    return sd


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...], bool]]:
    """The port's ``state_dict`` key -> (Flax collection, 'params' or
    'batch_stats'; the leaf's path in it; whether the tensor is the
    transpose of the leaf), for every tensor of ``model``: a Linear's
    weight (out, in) is the Dense ``kernel`` (in, out) and its bias
    ``bias``; a BatchNorm's ``weight``/``bias`` are ``scale``/``bias`` and
    its running statistics ``mean``/``var`` under ``batch_stats``."""
    leaves = {nn.Linear: (("weight", "params", "kernel", True), ("bias", "params", "bias", False)),
              BatchNorm: (("weight", "params", "scale", False), ("bias", "params", "bias", False),
                          ("running_mean", "batch_stats", "mean", False),
                          ("running_var", "batch_stats", "var", False))}
    out = {}
    for path, m in model.named_modules():
        kind = leaves.get(type(m))
        if kind is None:
            if next(m.parameters(recurse=False), None) is not None:
                raise KeyError(f"{path}: a {type(m).__name__} has no Flax counterpart")
            continue
        mod = tuple(path.split(".")) if path else ()
        for attr, coll, leaf, transposed in kind:
            if getattr(m, attr) is not None:
                out[".".join(mod + (attr,))] = (coll, mod + (leaf,), transposed)
    return out


def jax_tree_from_state_dict(model: nn.Module) -> Tuple[dict, dict]:
    """The port's ``model`` -> Flax ``(params, batch_stats)`` trees of numpy
    float32 arrays (`flax_paths`): the exact inverse of
    `state_dict_from_jax`."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for key, (coll, path, transposed) in flax_paths(model).items():
        node = trees[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        a = sd[key].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(a.T if transposed else a)
    return trees["params"], trees["batch_stats"]
