"""DGCNN backbone, BaseLearner, SelfAttention and the 192-d feature
extractor, eval mode (counterpart of `r3dfsseg_tpu/nn/dgcnn.py`).

Channels-last (B, N, C) throughout; every 1x1 conv is an `nn.Linear`.
BatchNorm uses its running statistics (eps 1e-5); activations are
LeakyReLU(0.2).  Submodule names follow the JAX package's Flax tree, so
`utils/convert.py:state_dict_from_jax` maps weights one to one.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn
from r3dfsseg_tpu_torch.ops.fast_gather import flat_take
from r3dfsseg_tpu_torch.ops.knn import knn_indices

TRAIN_TODO = ("training mode (batch-statistics BatchNorm, attention dropout, "
              "backward kernels) comes with ROADMAP.md queue item 1")


def _eval_only(train: bool) -> None:
    if train:
        raise NotImplementedError(TRAIN_TODO)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis with running statistics,
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, the Flax order."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class ConvBN(nn.Module):
    """1x1 conv (Linear) + BatchNorm [+ LeakyReLU(0.2)]."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Linear(in_features, features, bias=use_bias)
        self.bn = BatchNorm(features)
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _eval_only(train)
        x = self.bn(self.conv(x))
        return F.leaky_relu(x, 0.2) if self.relu else x


class _EdgeFirstLayer(nn.Module):
    """Factored first EdgeConv layer.  With the (C1, 2C) weight W = [W_n | W_c]
    acting on the edge feature concat(nbr - centre, centre):
        conv(edge) = gather(x W_n^T, idx) + x (W_c - W_n)^T,
    so the (B, N, K, 2C) edge tensor is never built."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Linear(2 * in_features, features, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        w_n, w_c = self.conv.weight[:, :c], self.conv.weight[:, c:]
        a = F.linear(x, w_n)
        b = F.linear(x, w_c - w_n)
        e = flat_take(a, idx) + b[:, :, None, :]
        return F.leaky_relu(self.bn(e), 0.2)


class EdgeConv(nn.Module):
    """kNN on the current features -> edge MLP -> max over the k neighbours.
    knn_impl 'auto' runs the kNN kernel on CUDA tensors, 'xla' the plain
    version."""

    def __init__(self, in_features: int, widths: Sequence[int], k: int = 20,
                 knn_impl: str = "auto"):
        super().__init__()
        if knn_impl not in ("auto", "xla"):
            raise NotImplementedError(f"knn_impl {knn_impl!r}: the port has 'auto' and 'xla'")
        self.k = k
        self.knn_impl = knn_impl
        self.layer0 = _EdgeFirstLayer(in_features, widths[0])
        for i in range(1, len(widths)):
            self.add_module(f"layer{i}", ConvBN(widths[i - 1], widths[i]))
        self.n_layers = len(widths)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _eval_only(train)
        if self.knn_impl == "auto":
            idx = cuda_knn.knn(x, self.k)
        else:
            idx = knn_indices(x, self.k)
        e = self.layer0(x, idx)
        for i in range(1, self.n_layers):
            e = getattr(self, f"layer{i}")(e)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        _eval_only(train)
        outs = []
        h = x
        for i in range(self.n_edgeconv):
            h = getattr(self, f"edgeconv{i}")(h)
            outs.append(h)
        h = torch.cat(outs, dim=-1)
        for i in range(self.n_mlp):
            h = getattr(self, f"mlp{i}")(h)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _eval_only(train)
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x)
            if i != self.n_layers - 1:
                x = F.relu(x)
        return x


class SelfAttention(nn.Module):
    """Single-head attention over all points of a cloud:
    softmax(q k^T / sqrt(d)) v with bias-free q, k, v maps.  attn_impl
    'auto' runs the attention kernel on CUDA tensors, 'xla' the plain
    version."""

    def __init__(self, in_features: int, out_channel: int, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ("auto", "xla"):
            raise NotImplementedError(f"attn_impl {attn_impl!r}: the port has 'auto' and 'xla'")
        self.q_map = nn.Linear(in_features, out_channel, bias=False)
        self.k_map = nn.Linear(in_features, out_channel, bias=False)
        self.v_map = nn.Linear(in_features, out_channel, bias=False)
        self.attn_impl = attn_impl

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _eval_only(train)
        q, k, v = self.q_map(x), self.k_map(x), self.v_map(x)
        tau = float(q.shape[-1]) ** 0.5
        if self.attn_impl == "auto":
            return cuda_attention.attention(q, k, v, tau)
        return cuda_attention.attention_reference(q, k, v, tau)


class FeatureExtractor(nn.Module):
    """The few-shot embedding concat(level1, attention | mapper, base),
    (B, N, C_in) -> (B, N, feat_dim) float32."""

    def __init__(self, in_features: int,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64), (64, 64), (64, 64)),
                 dgcnn_mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64), output_dim: int = 64,
                 dgcnn_k: int = 20, use_attention: bool = True,
                 knn_impl: str = "auto", attn_impl: str = "auto"):
        super().__init__()
        self.encoder = DGCNN(in_features, edgeconv_widths, dgcnn_mlp_widths, k=dgcnn_k,
                             knn_impl=knn_impl)
        c = dgcnn_mlp_widths[-1]
        self.base_learner = BaseLearner(c, base_widths)
        if use_attention:
            self.att_learner = SelfAttention(c, output_dim, attn_impl)
        else:
            self.linear_mapper = nn.Linear(c, output_dim, bias=False)
        self.use_attention = use_attention

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _eval_only(train)
        feat1, feat2 = self.encoder(x)
        feat3 = self.base_learner(feat2)
        mid = self.att_learner(feat2) if self.use_attention else self.linear_mapper(feat2)
        return torch.cat([feat1, mid, feat3], dim=-1).float()
