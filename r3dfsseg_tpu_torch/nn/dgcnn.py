"""DGCNN backbone, BaseLearner, SelfAttention, the 192-d feature
extractor and the pretraining segmentation model `DGCNNSegAttention`
(counterpart of `r3dfsseg_tpu/nn/dgcnn.py`).

Channels-last (B, N, C) throughout; every 1x1 conv is an `nn.Linear`;
activations are LeakyReLU(0.2).  `train=True` normalises with batch
statistics (per episode group, as the JAX package's `GroupedBatchNorm`, or
over the whole data-parallel batch with ``sync``) and updates the running
statistics; `train=False` uses the running ones.  Under data parallelism a
module takes its rows' place in the whole batch as an argument
(``shard``, `parallel/mesh.py:Shard`), so its dropout masks are the whole
batch's rows.
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
from r3dfsseg_tpu_torch.parallel.mesh import Shard


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
    does not).

    ``sync`` (a process group; one group of rows) takes the statistics over
    every rank's rows, as GSPMD takes them over a sharded batch: the sums
    go through `torch.distributed.nn.functional.all_reduce`, whose backward
    all-reduces the cotangent, so the gradient flows across ranks.  The
    two-pass variance sums first x, then the squared deviations from the
    global mean; ``fast`` sums x and x^2 in one all-reduce."""

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

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1,
                sync=None) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean) * mul + self.bias).to(self.out_dtype)
        if sync is not None:
            return self._synced(x, sync)
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

    def _synced(self, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        xf = x.float().reshape(-1, x.shape[-1])
        count = xf.shape[0] * dist.get_world_size(group)         # equal rows on every rank
        if self.fast:
            sums = all_reduce(torch.stack([xf.sum(0), xf.square().sum(0)]), group=group)
            mean = sums[0] / count
            var = (sums[1] / count - mean.square()).clamp_min(0.0)
        else:
            mean = all_reduce(xf.sum(0), group=group) / count
            var = all_reduce((xf - mean).square().sum(0), group=group) / count
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).reshape(x.shape).to(self.out_dtype)


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

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1,
                sync=None) -> torch.Tensor:
        x = self.bn(dense(x, self.conv, self.dtype), train, groups, sync)
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

    def operands(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b), (B, N, C1) each in the layer's compute type, with conv(edge)
        = gather(a, idx) + b: the table the neighbour gather reads and the
        centre term."""
        if self.dtype is None:
            c = x.shape[-1]
            w_n, w_c = self.conv.weight[:, :c], self.conv.weight[:, c:]
            return F.linear(x, w_n), F.linear(x, w_c - w_n)
        xd = x.to(self.dtype)
        return (dense(torch.cat([xd, torch.zeros_like(xd)], -1), self.conv, self.dtype),
                dense(torch.cat([-xd, xd], -1), self.conv, self.dtype))

    def forward(self, x: torch.Tensor, idx: torch.Tensor, train: bool = False,
                groups: int = 1, sync=None) -> torch.Tensor:
        a, b = self.operands(x)
        e = gather_neighbors_fast(a, idx, impl=self.impl) + b[:, :, None, :]
        return F.leaky_relu(self.bn(e, train, groups, sync), 0.2)


class EdgeConv(nn.Module):
    """kNN on the current (detached) features -> edge MLP -> max over the k
    neighbours.  knn_impl 'auto' (or 'pallas_exact') runs the kNN kernels
    on CUDA tensors, 'pallas' the kNN in the TPU kernel's packed-key mode
    (its plain version on CPU tensors), 'xla' the plain version;
    ``gather_impl`` 'auto' runs the scatter-add kernel in the backward,
    'xla' `index_add_` (`R3DConfig.follower_impl`).  A bf16 input (a bf16 block's
    output under 'stats', 'relaxed' or 'hybrid') is searched as its exact
    f32 upcast, as the TPU kernel loads it: on the card by the kNN
    kernel's bf16 route with no f32 copy (bit for bit the f32 route on the
    upcast), past k = 32 or C = 256 by the general kernel on the upcast.  ``bn_modes`` gives each
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

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1,
                sync=None) -> torch.Tensor:
        xd = x.detach()
        if self.knn_impl == "xla":
            idx = knn_indices(xd.float(), self.k)
        elif self.knn_impl == "pallas":
            idx = cuda_knn.knn(xd, self.k, packed=True)
        else:
            idx = cuda_knn.knn(xd, self.k)
        e = self.layer0(x, idx, train, groups, sync)
        for i in range(1, self.n_layers):
            e = getattr(self, f"layer{i}")(e, train, groups, sync)
        return e.amax(dim=2)


class DGCNN(nn.Module):
    """Stacked EdgeConv blocks + pointwise MLP.  Returns (level-1 features,
    final features), or with ``return_edgeconvs`` (every block's output,
    final features).  ``bn_modes`` maps each layer's path under the
    feature extractor to its BN mode (`resolve_bn_modes`; default 'exact')."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 mlp_widths: Sequence[int] = (512, 256), k: int = 20,
                 knn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bn_modes: Optional[Dict[str, str]] = None, gather_impl: str = "auto",
                 return_edgeconvs: bool = False):
        super().__init__()
        self.return_edgeconvs = return_edgeconvs
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

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1, sync=None):
        outs = []
        h = x
        for i in range(self.n_edgeconv):
            h = getattr(self, f"edgeconv{i}")(h, train, groups, sync)
            outs.append(h)
        h = torch.cat(outs, dim=-1)
        for i in range(self.n_mlp):
            h = getattr(self, f"mlp{i}")(h, train, groups, sync)
        return (outs if self.return_edgeconvs else outs[0]), h


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
    module draws `make_rng("dropout")`; with a ``shard`` (x is rows of a
    data-parallel batch) the mask is those rows of the whole batch's.

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
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
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
                                           self.attn_impl, 0 if shard is None else shard.offset)
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

    @classmethod
    def from_config(cls, c) -> "FeatureExtractor":
        """The feature extractor of an `R3DConfig` ``c``, as every model of
        the JAX package builds it."""
        return cls(c.pc_in_dim, c.edgeconv_widths, c.dgcnn_mlp_widths, c.base_widths,
                   c.output_dim, dgcnn_k=c.dgcnn_k, use_attention=c.use_attention,
                   knn_impl=c.knn_impl, attn_impl=c.attn_impl, attn_dropout=c.attn_dropout,
                   dtype=torch.bfloat16 if c.compute_dtype == "bfloat16" else None,
                   bn_mode=c.bn_mode, attn_f32=c.attn_f32, gather_impl=c.follower_impl)

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        """``groups`` > 1 (episode batching) keeps BatchNorm's statistics
        per episode; ``generator`` seeds the attention dropout; ``shard``
        places x's clouds in a data-parallel batch."""
        feat1, feat2 = self.encoder(x, train, groups)
        feat3 = self.base_learner(feat2, train, groups)
        if self.use_attention:
            mid = self.att_learner(feat2, train, generator, shard)
        else:
            mid = self.linear_mapper(feat2.float())     # a Dense without dtype: f32
        return torch.cat([feat1, mid, feat3], dim=-1).float()


@torch.no_grad()
def init_linear_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Every Linear's weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (PyTorch's default bound), drawn from ``generator`` in module order;
    BatchNorm stays at identity."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = m.in_features ** -0.5
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)


def seeded_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                   shape: Optional[Sequence[int]] = None,
                   shard: Optional[Shard] = None) -> torch.Tensor:
    """Flax's `Dropout` in training: each entry kept with probability
    1 - ``rate`` and scaled by 1 / (1 - rate), else 0.  The mask comes from
    a generator on ``x``'s device seeded from ``generator`` (a CPU one, so
    no device sync), as the attention draws its mask seed; it has
    ``shape`` (default x's) and broadcasts against x, as Flax's
    `broadcast_dropout` mask does.  With a ``shard`` (x is rows of a
    data-parallel batch along its leading axis) the mask of x's shape is
    drawn for the whole batch and x's rows taken from it, so the shards
    draw the unsharded call's mask."""
    if rate <= 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))
    if shape is None and shard is not None:
        keep = torch.rand((shard.total, *x.shape[1:]), generator=g, device=x.device)
        keep = keep[shard.offset:shard.offset + x.shape[0]] >= rate
    else:
        keep = torch.rand(x.shape if shape is None else tuple(shape), generator=g,
                          device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DGCNNSegAttention(nn.Module):
    """The pretraining segmentation model (counterpart of the JAX
    package's `DGCNNSegAttention`, the original `DGCNNSeg_attention`):
    the DGCNN trunk (`encoder`), a `SelfAttention` over its final
    features (`att_learner`, ``mlp_widths[-1]`` -> ``atten_dim``), and a
    segmenter of two ConvBN layers (`seg0` 256, `seg1` 128 with a bias),
    dropout and a Linear to the classes (`seg_out`).  The segmenter reads
    every block's output and the attention features' max over the points
    broadcast to each point (v1), or with ``v2`` the first block's output
    and the attention features.  (B, N, C_in) -> (B, N, num_classes)
    logits; with ``return_feat`` also the few-shot features
    concat(first block, attention).  In training the attention's and the
    segmenter's dropout masks come from ``generator``.  Under scene-batch
    data parallelism x is a rank's rows of the batch: ``shard`` places them
    (the dropout masks are the whole batch's rows), and ``sync``, a process
    group, takes every BatchNorm's statistics over the whole batch.
    knn_impl, attn_impl and gather_impl as `FeatureExtractor`'s."""

    def __init__(self, in_features: int, num_classes: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 dgcnn_mlp_widths: Sequence[int] = (512, 256), dgcnn_k: int = 20,
                 atten_dim: int = 128, dropout: float = 0.3, attn_dropout: float = 0.1,
                 v2: bool = False, knn_impl: str = "auto", attn_impl: str = "auto",
                 gather_impl: str = "auto"):
        super().__init__()
        self.encoder = DGCNN(in_features, edgeconv_widths, dgcnn_mlp_widths, k=dgcnn_k,
                             knn_impl=knn_impl, gather_impl=gather_impl, return_edgeconvs=True)
        self.att_learner = SelfAttention(dgcnn_mlp_widths[-1], atten_dim, attn_impl,
                                         attn_dropout)
        seg_in = (edgeconv_widths[0][-1] if v2 else sum(w[-1] for w in edgeconv_widths)) \
            + atten_dim
        self.seg0 = ConvBN(seg_in, 256)
        self.seg1 = ConvBN(256, 128, use_bias=True)
        self.seg_out = nn.Linear(128, num_classes)
        self.dropout = dropout
        self.v2 = v2

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, return_feat: bool = False,
                shard: Optional[Shard] = None, sync=None):
        outs, h = self.encoder(x, train, sync=sync)
        h = self.att_learner(h, train, generator, shard)
        if self.v2:
            pc_feat = torch.cat([outs[0], h], dim=-1)
        else:
            g = h.amax(dim=1, keepdim=True).expand_as(h)        # the global feature
            pc_feat = torch.cat([*outs, g], dim=-1)
        z = self.seg1(self.seg0(pc_feat, train, sync=sync), train, sync=sync)
        if train and self.dropout > 0.0:
            if generator is None:
                raise ValueError("DGCNNSegAttention: training with dropout needs a generator")
            z = seeded_dropout(z, self.dropout, generator, shard=shard)
        logits = self.seg_out(z)
        if return_feat:
            return logits, torch.cat([outs[0], h], dim=-1)
        return logits
