"""Carry weights between the JAX package's Flax trees and the port.

The port names its submodules after the Flax tree, so the map is
mechanical: the path ``features/encoder/edgeconv0/layer0/conv/kernel``
becomes the key ``features.encoder.edgeconv0.layer0.conv.weight``.
`jax_tree_from_state_dict` is the way back.

Each leaf has a layout, the same table both ways (`flax_paths`): whether
the port's tensor is the transpose of the leaf, and the leaf's shape.  A
Dense ``kernel`` (in, out) is a Linear's weight (out, in); the attention's
`DenseGeneral` kernels fold their head axes first (query, key and value
(d, heads, head_dim) and their biases (heads, head_dim); out (heads,
head_dim, d)) and are then Linear weights and biases too.  An ``Embed``'s
``embedding``, a LayerNorm's ``scale`` and a parameter the model holds
itself at the tree's root (the transformer's ``proj_trans_in``) keep
their layout; any other leaf raises.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from r3dfsseg_tpu_torch.nn.dgcnn import BatchNorm

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


class FlaxLeaf(NamedTuple):
    """Where a port tensor lives in the Flax trees, and how it is laid out."""
    collection: str               # 'params' or 'batch_stats'
    path: Tuple[str, ...]         # the leaf's path in the collection
    transposed: bool              # the port's tensor is the leaf's (folded) transpose
    shape: Tuple[int, ...]        # the leaf's shape


def to_port(a: np.ndarray, leaf: FlaxLeaf, port_shape) -> np.ndarray:
    """A Flax leaf's array in the port's layout (``port_shape``)."""
    a = np.asarray(a, np.float32)
    if leaf.transposed:
        return np.ascontiguousarray(a.reshape(tuple(port_shape)[::-1]).T)
    return np.ascontiguousarray(a.reshape(port_shape))


def to_flax(t: torch.Tensor, leaf: FlaxLeaf) -> np.ndarray:
    """A port tensor in its Flax leaf's layout, as float32 numpy."""
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray((a.T if leaf.transposed else a).reshape(leaf.shape))


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_layout(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    """A Flax leaf -> (its port key, its array in the port's layout), by
    the leaf's name and rank (module docstring)."""
    *mod, name = path
    if name == "kernel":
        if a.ndim == 3:      # DenseGeneral: out folds its inputs, q/k/v their outputs
            a = a.reshape(-1, a.shape[-1]) if mod[-1] == "out" else a.reshape(a.shape[0], -1)
        a = a.T
    elif name == "bias" and a.ndim == 2:
        a = a.reshape(-1)
    elif name not in _PARAM_LEAF:
        if mod:
            raise KeyError(f"no port counterpart for Flax leaf {'/'.join(path)}")
        return name, a                       # a parameter the model holds itself
    return ".".join([*mod, _PARAM_LEAF[name]]), a


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` trees (numpy-convertible leaves)
    -> the port's ``state_dict``, by the layouts of the module docstring:
    BatchNorm ``scale``/``bias``/``mean``/``var`` become
    ``weight``/``bias``/``running_mean``/``running_var``.  Whether every
    key has a counterpart is the caller's strict load to check."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key, a = _port_layout(path, np.array(leaf, np.float32))
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    for path, leaf in _leaves(batch_stats or {}):
        *mod, name = path
        if name not in _STAT_LEAF:
            raise KeyError(f"no port counterpart for Flax leaf {'/'.join(path)}")
        sd[".".join([*mod, _STAT_LEAF[name]])] = torch.from_numpy(np.array(leaf, np.float32))
    return sd


def flax_paths(model: nn.Module) -> Dict[str, FlaxLeaf]:
    """The port's ``state_dict`` key -> its `FlaxLeaf`, for every tensor of
    ``model``: a Linear's weight (out, in) is the Dense ``kernel`` (in,
    out) and its bias ``bias`` (inside a `MultiHeadAttention`, folded as
    the module docstring says); a BatchNorm's ``weight``/``bias`` are
    ``scale``/``bias`` and its running statistics ``mean``/``var`` under
    ``batch_stats``; a LayerNorm's ``scale``/``bias``; an Embedding's
    ``embedding``; a parameter of any other module its own name."""
    from r3dfsseg_tpu_torch.models.transformer import MultiHeadAttention

    leaves = {nn.Linear: (("weight", "params", "kernel"), ("bias", "params", "bias")),
              BatchNorm: (("weight", "params", "scale"), ("bias", "params", "bias"),
                          ("running_mean", "batch_stats", "mean"),
                          ("running_var", "batch_stats", "var")),
              nn.LayerNorm: (("weight", "params", "scale"), ("bias", "params", "bias")),
              nn.Embedding: (("weight", "params", "embedding"),)}
    heads = {}
    mods = list(model.named_modules())
    for path, m in mods:
        if isinstance(m, MultiHeadAttention):
            heads.update({f"{path}.{n}" if path else n: (n, m.n_head)
                          for n in ("query", "key", "value", "out")})
    out = {}
    for path, m in mods:
        mod = tuple(path.split(".")) if path else ()
        kind = leaves.get(type(m))
        if kind is None:
            for attr, p in m.named_parameters(recurse=False):
                out[".".join(mod + (attr,))] = FlaxLeaf("params", mod + (attr,), False,
                                                        tuple(p.shape))
            continue
        for attr, coll, leaf in kind:
            t = getattr(m, attr)
            if t is None:
                continue
            shape = tuple(t.shape)
            transposed = isinstance(m, nn.Linear) and attr == "weight"
            if transposed:
                shape = shape[::-1]
            if path in heads:
                role, h = heads[path]
                if role == "out":
                    shape = (h, shape[0] // h, shape[1]) if transposed else shape
                else:
                    shape = (shape[0], h, shape[1] // h) if transposed else (h, shape[0] // h)
            out[".".join(mod + (attr,))] = FlaxLeaf(coll, mod + (leaf,), transposed, shape)
    return out


def jax_tree_from_state_dict(model: nn.Module) -> Tuple[dict, dict]:
    """The port's ``model`` -> Flax ``(params, batch_stats)`` trees of numpy
    float32 arrays (`flax_paths`): the exact inverse of
    `state_dict_from_jax`."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for key, leaf in flax_paths(model).items():
        node = trees[leaf.collection]
        for part in leaf.path[:-1]:
            node = node.setdefault(part, {})
        node[leaf.path[-1]] = to_flax(sd[key], leaf)
    return trees["params"], trees["batch_stats"]
