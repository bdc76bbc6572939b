"""Carry weights from the JAX package's Flax trees into the port.

The port names its submodules after the Flax tree, so the map is
mechanical: the path ``features/encoder/edgeconv0/layer0/conv/kernel``
becomes the key ``features.encoder.edgeconv0.layer0.conv.weight``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

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
