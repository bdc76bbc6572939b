"""Non-local block, a residual self-attention (counterpart of
`r3dfsseg_tpu/nn/nonlocal_block.py`).

A 1-D non-local block with the four pairwise functions of Wang et al.
(gaussian, embedded, dot, concatenate), a W_z projection ending in a
BatchNorm whose scale starts at zero, so that the block starts as the
identity, and the residual connection.  No path of the port uses it, as
no path of the JAX package does; its (B, N, N) products are plain
PyTorch, as the JAX package computes them outside any Pallas kernel.
Submodule names follow the Flax tree (`g`, `theta`, `phi`, `W_f`, `W_z`,
`bn`), so `utils/convert.py:state_dict_from_jax` maps its weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.nn.dgcnn import BatchNorm

MODES = ("gaussian", "embedded", "dot", "concatenate")


class NonLocalBlock(nn.Module):
    """x (B, N, C) -> (W_z(y) + x, the attention (B, N, N)), y the
    attention-weighted g(x).  The pairwise function f is x x^T (gaussian),
    theta(x) phi(x)^T (embedded, dot) or relu(W_f [theta(x_i), phi(x_j)])
    (concatenate); gaussian and embedded normalise it with a softmax over
    j, dot and concatenate divide it by N.  With ``bn_layer`` W_z is
    followed by a BatchNorm whose scale starts at 0; without it W_z's
    weight and bias start at 0 (the JAX module's zeros init).  Either way
    the block starts as the identity."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 mode: str = "embedded", bn_layer: bool = True):
        super().__init__()
        if mode not in MODES:
            raise ValueError("`mode` must be one of `gaussian`, `embedded`, `dot` or "
                             "`concatenate`")
        inter = inter_channels or in_channels
        self.mode = mode
        self.bn_layer = bn_layer
        self.g = nn.Linear(in_channels, inter)
        if mode != "gaussian":
            self.theta = nn.Linear(in_channels, inter)
            self.phi = nn.Linear(in_channels, inter)
        if mode == "concatenate":
            self.W_f = nn.Linear(2 * inter, 1)
        self.W_z = nn.Linear(inter, in_channels)
        if bn_layer:
            self.bn = BatchNorm(in_channels)
            with torch.no_grad():
                self.bn.weight.zero_()
        else:
            with torch.no_grad():
                self.W_z.weight.zero_()
                self.W_z.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        g_x = self.g(x)
        if self.mode == "gaussian":
            f = torch.einsum("bnc,bmc->bnm", x, x)
        elif self.mode in ("embedded", "dot"):
            f = torch.einsum("bnd,bmd->bnm", self.theta(x), self.phi(x))
        else:
            n = x.shape[1]
            theta = self.theta(x)[:, :, None, :].expand(-1, -1, n, -1)
            phi = self.phi(x)[:, None, :, :].expand(-1, n, -1, -1)
            f = F.relu(self.W_f(torch.cat([theta, phi], dim=-1)))[..., 0]
        f_div = f.softmax(-1) if self.mode in ("gaussian", "embedded") else f / f.shape[-1]
        w = self.W_z(torch.einsum("bnm,bmd->bnd", f_div, g_x))
        if self.bn_layer:
            w = self.bn(w, train)
        return w + x, f_div
