"""DGCNN backbone, BaseLearner, SelfAttention and the 192-d feature
extractor (counterpart of `r3dfsseg_tpu/nn/dgcnn.py`).

Channels-last (B, N, C) throughout; every 1x1 conv is an `nn.Linear`;
activations are LeakyReLU(0.2).  `train=True` normalises with batch
statistics (per episode group, as the JAX package's `GroupedBatchNorm`)
and updates the running statistics; `train=False` uses the running ones.
Submodule names follow the JAX package's Flax tree, so
`utils/convert.py:state_dict_from_jax` maps weights one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn
from r3dfsseg_tpu_torch.ops.fast_gather import gather_neighbors_fast
from r3dfsseg_tpu_torch.ops.knn import knn_indices


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis,
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, the Flax order.

    train=False uses the running statistics.  train=True uses the batch's:
    per channel the mean and the two-pass biased variance in f32, over the
    leading axis split into ``groups`` equal groups of rows (one group per
    episode, `GroupedBatchNorm` in the JAX package), and then updates the
    running statistics in place, ra = 0.9 ra + 0.1 * (mean over groups of
    the batch statistic), as Flax does (momentum 0.9, biased variance)."""

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * mul + self.bias
        b, c = x.shape[0], x.shape[-1]
        if b % groups:
            raise ValueError(f"BatchNorm: {b} rows do not split into {groups} groups")
        xg = x.float().reshape(groups, -1, c)
        mean = xg.mean(1, keepdim=True)                              # (G, 1, C)
        var = (xg - mean).square().mean(1, keepdim=True)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean.mean(0)[0], alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.mean(0)[0], alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xg - mean) * mul + self.bias).reshape(x.shape)


class ConvBN(nn.Module):
    """1x1 conv (Linear) + BatchNorm [+ LeakyReLU(0.2)]."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Linear(in_features, features, bias=use_bias)
        self.bn = BatchNorm(features)
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        x = self.bn(self.conv(x), train, groups)
        return F.leaky_relu(x, 0.2) if self.relu else x


class _EdgeFirstLayer(nn.Module):
    """Factored first EdgeConv layer.  With the (C1, 2C) weight W = [W_n | W_c]
    acting on the edge feature concat(nbr - centre, centre):
        conv(edge) = gather(x W_n^T, idx) + x (W_c - W_n)^T,
    so the (B, N, K, 2C) edge tensor is never built.  The gather's backward
    is the scatter-add kernel (impl 'auto') or `index_add_` ('xla')."""

    def __init__(self, in_features: int, features: int, impl: str = "auto"):
        super().__init__()
        self.conv = nn.Linear(2 * in_features, features, bias=False)
        self.bn = BatchNorm(features)
        self.impl = impl

    def forward(self, x: torch.Tensor, idx: torch.Tensor, train: bool = False,
                groups: int = 1) -> torch.Tensor:
        c = x.shape[-1]
        w_n, w_c = self.conv.weight[:, :c], self.conv.weight[:, c:]
        a = F.linear(x, w_n)
        b = F.linear(x, w_c - w_n)
        e = gather_neighbors_fast(a, idx, impl=self.impl) + b[:, :, None, :]
        return F.leaky_relu(self.bn(e, train, groups), 0.2)


class EdgeConv(nn.Module):
    """kNN on the current (detached) features -> edge MLP -> max over the k
    neighbours.  knn_impl 'auto' runs the kNN and scatter-add kernels on
    CUDA tensors, 'xla' the plain versions."""

    def __init__(self, in_features: int, widths: Sequence[int], k: int = 20,
                 knn_impl: str = "auto"):
        super().__init__()
        if knn_impl not in ("auto", "xla"):
            raise NotImplementedError(f"knn_impl {knn_impl!r}: the port has 'auto' and 'xla'")
        self.k = k
        self.knn_impl = knn_impl
        self.layer0 = _EdgeFirstLayer(in_features, widths[0], knn_impl)
        for i in range(1, len(widths)):
            self.add_module(f"layer{i}", ConvBN(widths[i - 1], widths[i]))
        self.n_layers = len(widths)

    def forward(self, x: torch.Tensor, train: bool = False, groups: int = 1) -> torch.Tensor:
        xd = x.detach()
        idx = cuda_knn.knn(xd, self.k) if self.knn_impl == "auto" else knn_indices(xd, self.k)
        e = self.layer0(x, idx, train, groups)
        for i in range(1, self.n_layers):
            e = getattr(self, f"layer{i}")(e, train, groups)
        return e.amax(dim=2)


class DGCNN(nn.Module):
    """Stacked EdgeConv blocks + pointwise MLP.  Returns (level-1 features,
    final features)."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 mlp_widths: Sequence[int] = (512, 256), k: int = 20,
                 knn_impl: str = "auto"):
        super().__init__()
        c = in_features
        for i, widths in enumerate(edgeconv_widths):
            self.add_module(f"edgeconv{i}", EdgeConv(c, widths, k=k, knn_impl=knn_impl))
            c = widths[-1]
        c = sum(w[-1] for w in edgeconv_widths)
        for i, w in enumerate(mlp_widths):
            self.add_module(f"mlp{i}", ConvBN(c, w))
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
    """Conv1d+BN stack with biases, ReLU between layers and none after the last."""

    def __init__(self, in_features: int, widths: Sequence[int] = (128, 64)):
        super().__init__()
        c = in_features
        for i, w in enumerate(widths):
            self.add_module(f"conv{i}", ConvBN(c, w, use_bias=True, relu=False))
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
    training, dropout on the attention map.  attn_impl 'auto' runs the
    attention kernels on CUDA tensors, 'xla' the plain versions.

    In training with dropout each call draws its mask seed from
    ``generator`` (a CPU `torch.Generator`, so no device sync), as the JAX
    module draws `make_rng("dropout")`."""

    def __init__(self, in_features: int, out_channel: int, attn_impl: str = "auto",
                 attn_dropout: float = 0.1):
        super().__init__()
        if attn_impl not in ("auto", "xla"):
            raise NotImplementedError(f"attn_impl {attn_impl!r}: the port has 'auto' and 'xla'")
        self.q_map = nn.Linear(in_features, out_channel, bias=False)
        self.k_map = nn.Linear(in_features, out_channel, bias=False)
        self.v_map = nn.Linear(in_features, out_channel, bias=False)
        self.attn_impl = attn_impl
        self.attn_dropout = attn_dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.q_map(x), self.k_map(x), self.v_map(x)
        tau = float(q.shape[-1]) ** 0.5
        seed = 0
        if train and self.attn_dropout > 0.0:
            if generator is None:
                raise ValueError("SelfAttention: training with dropout needs a generator "
                                 "for the mask seed")
            seed = int(torch.randint(0, 2**62, (), generator=generator))
        return cuda_attention.fused_attention(q, k, v, seed, tau, self.attn_dropout, train,
                                              self.attn_impl)


class FeatureExtractor(nn.Module):
    """The few-shot embedding concat(level1, attention | mapper, base),
    (B, N, C_in) -> (B, N, feat_dim) float32."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 dgcnn_mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64), output_dim: int = 64,
                 dgcnn_k: int = 20, use_attention: bool = True,
                 knn_impl: str = "auto", attn_impl: str = "auto", attn_dropout: float = 0.1):
        super().__init__()
        self.encoder = DGCNN(in_features, edgeconv_widths, dgcnn_mlp_widths, k=dgcnn_k,
                             knn_impl=knn_impl)
        c = dgcnn_mlp_widths[-1]
        self.base_learner = BaseLearner(c, base_widths)
        if use_attention:
            self.att_learner = SelfAttention(c, output_dim, attn_impl, attn_dropout)
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
            mid = self.linear_mapper(feat2)
        return torch.cat([feat1, mid, feat3], dim=-1).float()
