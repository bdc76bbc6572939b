"""DGCNN backbone, BaseLearner, SelfAttention and the 192-d feature
extractor (counterpart of `r3dfsseg_tpu/nn/dgcnn.py`).

Channels-last (B, N, C) throughout; every 1x1 conv is an `nn.Linear`;
activations are LeakyReLU(0.2).  `train=True` normalises with batch
statistics (per episode group, as the JAX package's `GroupedBatchNorm`)
and updates the running statistics; `train=False` uses the running ones.
Submodule names follow the JAX package's Flax tree, so
`utils/convert.py:state_dict_from_jax` maps weights one to one.

The bf16 encoder (``dtype=torch.bfloat16``, the config's
`compute_dtype="bfloat16"`) follows the JAX package's Flax modules:
every 1x1 conv casts its input, weight and bias to bf16 (Flax's
`promote_dtype`; the product accumulates in f32 and rounds once, the bias
adds in bf16), BatchNorm takes its statistics in f32 and writes f32 or
bf16 by `bn_mode` (`BN_MODES`, resolved per layer by `resolve_bn_modes`),
and the attention takes bf16 q, k, v unless ``attn_f32``.  Parameters,
running statistics and the embedding stay f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn
from r3dfsseg_tpu_torch.ops.fast_gather import gather_neighbors_fast
from r3dfsseg_tpu_torch.ops.knn import knn_indices


BN_MODES = ("exact", "fastvar", "stats", "relaxed", "hybrid")


def resolve_bn_modes(bn_mode: str, edgeconv_widths: Sequence[Sequence[int]],
                     mlp_widths: Sequence[int], base_widths: Sequence[int]) -> Dict[str, str]:
    """Each BatchNorm's mode, keyed by its layer's path under the feature
    extractor ('encoder.edgeconv0.layer0', ..., 'encoder.mlp1',
    'base_learner.conv1'), as the JAX package's `DGCNN` and `BaseLearner`
    resolve them: every mode but 'hybrid' applies to every layer; 'hybrid'
    keeps f32 outputs only where a BN output joins the embedding without
    being renormalised downstream: edgeconv0's last layer 'exact', the
    MLP's and the BaseLearner's last layers 'fastvar', 'relaxed' elsewhere."""
    if bn_mode not in BN_MODES:
        raise NotImplementedError(f"bn_mode {bn_mode!r}: one of {BN_MODES}")
    hybrid = bn_mode == "hybrid"
    modes = {}
    for i, widths in enumerate(edgeconv_widths):
        for j in range(len(widths)):
            last = j == len(widths) - 1
            modes[f"encoder.edgeconv{i}.layer{j}"] = (
                ("exact" if i == 0 and last else "relaxed") if hybrid else bn_mode)
    for name, widths in (("encoder.mlp", mlp_widths), ("base_learner.conv", base_widths)):
        for j in range(len(widths)):
            modes[f"{name}{j}"] = (("fastvar" if j == len(widths) - 1 else "relaxed")
                                   if hybrid else bn_mode)
    return modes


def dense(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)``; with a ``dtype``, Flax's `Dense(dtype=...)`: input,
    weight and bias cast to it, the product rounded once, the bias added
    in it."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis,
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, the Flax order,
    computed in f32 and written in ``out_dtype``.

    train=False uses the running statistics.  train=True uses the batch's:
    per channel the mean and the biased variance in f32, over the leading
    axis split into ``groups`` equal groups of rows (one group per
    episode, `GroupedBatchNorm` in the JAX package), and then updates the
    running statistics in place, ra = 0.9 ra + 0.1 * (mean over groups of
    the batch statistic), as Flax does (momentum 0.9, biased variance).
    The variance is two-pass, or with ``fast`` E[x^2] - E[x]^2, clipped at
    0 for one group as Flax's `BatchNorm` clips it (`GroupedBatchNorm`
    does not)."""

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float = 1e-5,
                 out_dtype: torch.dtype = torch.float32, fast: bool = False):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.fast = fast
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean) * mul + self.bias).to(self.out_dtype)
        b, c = x.shape[0], x.shape[-1]
        if b % groups:
            raise ValueError(f"BatchNorm: {b} rows do not split into {groups} groups")
        xg = x.float().reshape(groups, -1, c)
        mean = xg.mean(1, keepdim=True)                              # (G, 1, C)
        if self.fast:
            var = xg.square().mean(1, keepdim=True) - mean.square()
            if groups == 1:
                var = var.clamp_min(0.0)
        else:
            var = (xg - mean).square().mean(1, keepdim=True)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean.mean(0)[0], alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.mean(0)[0], alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xg - mean) * mul + self.bias).reshape(x.shape).to(self.out_dtype)


def _batch_norm(features: int, dtype: Optional[torch.dtype], bn_mode: str) -> BatchNorm:
    """The JAX package's BN of one layer (`ConvBN`): f32 output under
    'exact' and 'fastvar' or without a compute dtype, else the compute
    dtype's; the single-pass variance under 'relaxed' and 'fastvar' with a
    compute dtype only."""
    out = torch.float32 if dtype is None or bn_mode in ("exact", "fastvar") else dtype
    fast = dtype is not None and bn_mode in ("relaxed", "fastvar")
    return BatchNorm(features, out_dtype=out, fast=fast)


class ConvBN(nn.Module):
    """1x1 conv (Linear) + BatchNorm [+ LeakyReLU(0.2)]; ``dtype`` and
    ``bn_mode`` as the JAX package's `ConvBN` (module docstring)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 relu: bool = True, dtype: Optional[torch.dtype] = None,
                 bn_mode: str = "exact"):
        super().__init__()
        self.conv = nn.Linear(in_features, features, bias=use_bias)
        self.bn = _batch_norm(features, dtype, bn_mode)
        self.relu = relu
        self.dtype = dtype
        self.bn_mode = bn_mode

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        x = self.bn(dense(x, self.conv, self.dtype), train, groups)
        return F.leaky_relu(x, 0.2) if self.relu else x


class _EdgeFirstLayer(nn.Module):
    """Factored first EdgeConv layer.  With the (C1, 2C) weight W = [W_n | W_c]
    acting on the edge feature concat(nbr - centre, centre):
        conv(edge) = gather(x W_n^T, idx) + x (W_c - W_n)^T,
    so the (B, N, K, 2C) edge tensor is never built.  The gather's backward
    is the scatter-add kernel (impl 'auto') or `index_add_` ('xla').

    With a ``dtype`` the JAX package's form runs in it: a = conv([x, 0])
    and b = conv([-x, x]) with the weight and x cast to it, the gather and
    the sum in it, then BN."""

    def __init__(self, in_features: int, features: int, impl: str = "auto",
                 dtype: Optional[torch.dtype] = None, bn_mode: str = "exact"):
        super().__init__()
        self.conv = nn.Linear(2 * in_features, features, bias=False)
        self.bn = _batch_norm(features, dtype, bn_mode)
        self.impl = impl
        self.dtype = dtype
        self.bn_mode = bn_mode

    def forward(self, x: torch.Tensor, idx: torch.Tensor, train: bool = False,
                groups: int = 1) -> torch.Tensor:
        if self.dtype is None:
            c = x.shape[-1]
            w_n, w_c = self.conv.weight[:, :c], self.conv.weight[:, c:]
            a = F.linear(x, w_n)
            b = F.linear(x, w_c - w_n)
        else:
            xd = x.to(self.dtype)
            a = dense(torch.cat([xd, torch.zeros_like(xd)], -1), self.conv, self.dtype)
            b = dense(torch.cat([-xd, xd], -1), self.conv, self.dtype)
        e = gather_neighbors_fast(a, idx, impl=self.impl) + b[:, :, None, :]
        return F.leaky_relu(self.bn(e, train, groups), 0.2)


class EdgeConv(nn.Module):
    """kNN on the current (detached) features -> edge MLP -> max over the k
    neighbours.  knn_impl 'auto' (or 'pallas_exact') runs the kNN kernels
    on CUDA tensors, 'pallas' the kNN in the TPU kernel's packed-key mode
    (its plain version on CPU tensors), 'xla' the plain version;
    ``gather_impl`` 'auto' runs the scatter-add kernel in the backward,
    'xla' `index_add_` (`R3DConfig.follower_impl`).  A bf16 input (a bf16 block's
    output under 'stats', 'relaxed' or 'hybrid') is searched in its exact
    f32 upcast, as the TPU kernel loads it.  ``bn_modes`` gives each
    layer's BN mode (default 'exact')."""

    def __init__(self, in_features: int, widths: Sequence[int], k: int = 20,
                 knn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bn_modes: Optional[Sequence[str]] = None, gather_impl: str = "auto"):
        super().__init__()
        if knn_impl not in cuda_knn.IMPLS:
            raise NotImplementedError(f"knn_impl {knn_impl!r}: the port has {cuda_knn.IMPLS}")
        modes = tuple(bn_modes or ("exact",) * len(widths))
        self.k = k
        self.knn_impl = knn_impl
        self.layer0 = _EdgeFirstLayer(in_features, widths[0], gather_impl, dtype, modes[0])
        for i in range(1, len(widths)):
            self.add_module(f"layer{i}", ConvBN(widths[i - 1], widths[i], dtype=dtype,
                                                bn_mode=modes[i]))
        self.n_layers = len(widths)

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        xd = x.detach()
        if self.knn_impl == "xla":
            idx = knn_indices(xd.float(), self.k)
        elif self.knn_impl == "pallas":
            idx = cuda_knn.knn(xd, self.k, packed=True)
        else:
            idx = cuda_knn.knn(xd, self.k)
        e = self.layer0(x, idx, train, groups)
        for i in range(1, self.n_layers):
            e = getattr(self, f"layer{i}")(e, train, groups)
        return e.amax(dim=2)


class DGCNN(nn.Module):
    """Stacked EdgeConv blocks + pointwise MLP.  Returns (level-1 features,
    final features).  ``bn_modes`` maps each layer's path under the
    feature extractor to its BN mode (`resolve_bn_modes`; default 'exact')."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 mlp_widths: Sequence[int] = (512, 256), k: int = 20,
                 knn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bn_modes: Optional[Dict[str, str]] = None, gather_impl: str = "auto"):
        super().__init__()
        modes = bn_modes or {}
        c = in_features
        for i, widths in enumerate(edgeconv_widths):
            layer_modes = [modes.get(f"encoder.edgeconv{i}.layer{j}", "exact")
                           for j in range(len(widths))]
            self.add_module(f"edgeconv{i}", EdgeConv(c, widths, k=k, knn_impl=knn_impl,
                                                     dtype=dtype, bn_modes=layer_modes,
                                                     gather_impl=gather_impl))
            c = widths[-1]
        c = sum(w[-1] for w in edgeconv_widths)
        for i, w in enumerate(mlp_widths):
            self.add_module(f"mlp{i}", ConvBN(c, w, dtype=dtype,
                                              bn_mode=modes.get(f"encoder.mlp{i}", "exact")))
            c = w
        self.n_edgeconv = len(edgeconv_widths)
        self.n_mlp = len(mlp_widths)

    def forward(self, x: torch.Tensor, train: bool = False,
                groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = []
        h = x
        for i in range(self.n_edgeconv):
            h = getattr(self, f"edgeconv{i}")(h, train, groups)
            outs.append(h)
        h = torch.cat(outs, dim=-1)
        for i in range(self.n_mlp):
            h = getattr(self, f"mlp{i}")(h, train, groups)
        return outs[0], h


class BaseLearner(nn.Module):
    """Conv1d+BN stack with biases, ReLU between layers and none after the
    last; ``bn_modes`` as `DGCNN`'s."""

    def __init__(self, in_features: int, widths: Sequence[int] = (128, 64),
                 dtype: Optional[torch.dtype] = None,
                 bn_modes: Optional[Dict[str, str]] = None):
        super().__init__()
        modes = bn_modes or {}
        c = in_features
        for i, w in enumerate(widths):
            self.add_module(f"conv{i}", ConvBN(
                c, w, use_bias=True, relu=False, dtype=dtype,
                bn_mode=modes.get(f"base_learner.conv{i}", "exact")))
            c = w
        self.n_layers = len(widths)

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, train, groups)
            if i != self.n_layers - 1:
                x = F.relu(x)
        return x


class SelfAttention(nn.Module):
    """Single-head attention over all points of a cloud:
    softmax(q k^T / sqrt(d)) v with bias-free q, k, v maps and, in
    training, dropout on the attention map.  attn_impl 'auto' (or
    'pallas') runs the attention kernels on CUDA tensors, 'xla' the plain
    versions.

    In training with dropout each call draws its mask seed from
    ``generator`` (a CPU `torch.Generator`, so no device sync), as the JAX
    module draws `make_rng("dropout")`.

    With a bf16 ``dtype`` the maps give bf16 q, k, v, which go to the
    attention as they are (the kernels' bf16 forms, or their plain
    versions), or in f32 with ``attn_f32``; the output takes the input's
    dtype, as in the JAX package."""

    def __init__(self, in_features: int, out_channel: int, attn_impl: str = "auto",
                 attn_dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 attn_f32: bool = False):
        super().__init__()
        if attn_impl not in cuda_attention.IMPLS:
            raise NotImplementedError(f"attn_impl {attn_impl!r}: the port has "
                                      f"{cuda_attention.IMPLS}")
        self.q_map = nn.Linear(in_features, out_channel, bias=False)
        self.k_map = nn.Linear(in_features, out_channel, bias=False)
        self.v_map = nn.Linear(in_features, out_channel, bias=False)
        self.attn_impl = attn_impl
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        self.attn_f32 = attn_f32

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = (dense(x, m, self.dtype) for m in (self.q_map, self.k_map, self.v_map))
        if self.attn_f32:
            q, k, v = q.float(), k.float(), v.float()
        tau = float(q.shape[-1]) ** 0.5
        seed = 0
        if train and self.attn_dropout > 0.0:
            if generator is None:
                raise ValueError("SelfAttention: training with dropout needs a generator "
                                 "for the mask seed")
            seed = int(torch.randint(0, 2**62, (), generator=generator))
        y = cuda_attention.fused_attention(q, k, v, seed, tau, self.attn_dropout, train,
                                           self.attn_impl)
        return y.to(x.dtype)


class FeatureExtractor(nn.Module):
    """The few-shot embedding concat(level1, attention | mapper, base),
    (B, N, C_in) -> (B, N, feat_dim) float32.  ``dtype`` (None or
    torch.bfloat16), ``bn_mode``, ``attn_f32`` and ``gather_impl`` as the
    config's `compute_dtype`, `bn_mode`, `attn_f32` and `follower_impl`."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 dgcnn_mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64), output_dim: int = 64,
                 dgcnn_k: int = 20, use_attention: bool = True,
                 knn_impl: str = "auto", attn_impl: str = "auto", attn_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, bn_mode: str = "exact",
                 attn_f32: bool = False, gather_impl: str = "auto"):
        super().__init__()
        modes = resolve_bn_modes(bn_mode, edgeconv_widths, dgcnn_mlp_widths, base_widths)
        self.encoder = DGCNN(in_features, edgeconv_widths, dgcnn_mlp_widths, k=dgcnn_k,
                             knn_impl=knn_impl, dtype=dtype, bn_modes=modes,
                             gather_impl=gather_impl)
        c = dgcnn_mlp_widths[-1]
        self.base_learner = BaseLearner(c, base_widths, dtype=dtype, bn_modes=modes)
        if use_attention:
            self.att_learner = SelfAttention(c, output_dim, attn_impl, attn_dropout, dtype,
                                             attn_f32)
        else:
            self.linear_mapper = nn.Linear(c, output_dim, bias=False)
        self.use_attention = use_attention

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``groups`` > 1 (episode batching) keeps BatchNorm's statistics
        per episode; ``generator`` seeds the attention dropout."""
        feat1, feat2 = self.encoder(x, train, groups)
        feat3 = self.base_learner(feat2, train, groups)
        if self.use_attention:
            mid = self.att_learner(feat2, train, generator)
        else:
            mid = self.linear_mapper(feat2.float())     # a Dense without dtype: f32
        return torch.cat([feat1, mid, feat3], dim=-1).float()
