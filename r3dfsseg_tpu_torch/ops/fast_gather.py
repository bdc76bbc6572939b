"""Neighbour gather with a scatter-add backward (counterpart of
`r3dfsseg_tpu/ops/fast_gather.py`).

The forward is one row take from the flattened (B*N, C) table
(`flat_take`, the JAX package's `_flat_take`).  The backward is the
scatter-add of `ops/cuda_scatter.py`: its Hopper kernel on CUDA tensors
with impl 'auto', `index_add_` on CPU tensors and with impl 'xla'.  Like
the kNN and k-th kernels, the gather follows `knn_impl`, so the plain path
launches no kernel.

The config's `exact_grad_gather` changes nothing here: the JAX package's
default backward rounds the cotangent to bf16 for the TPU's matrix unit
and `exact_grad_gather=True` asks for the f32 segment sum, and the kernel
sums in f32 either way.  Under the bf16 encoder the table and its
cotangent are bf16: the kernel reads the bf16 cotangent (the plain
version its f32 upcast), sums in f32, and the gradient is cast to the
table's dtype, as the JAX package's `_bwd` returns `dx.astype(token.dtype)`.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops import cuda_scatter


def flat_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, NQ, K) -> (B, NQ, K, C), as one row take from
    the flattened (B*N, C) table."""
    b, n, c = x.shape
    off = (torch.arange(b, device=idx.device, dtype=idx.dtype) * n)[:, None, None]
    flat = (idx + off).reshape(-1).long()
    return x.reshape(b * n, c).index_select(0, flat).reshape(*idx.shape, c)


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, impl):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        ctx.impl = impl
        ctx.dtype = x.dtype
        return flat_take(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        scatter = (cuda_scatter.scatter_add if ctx.impl == "auto"
                   else cuda_scatter.scatter_add_reference)
        return scatter(g.contiguous(), idx, ctx.n).to(ctx.dtype), None, None


def gather_neighbors_fast(x: torch.Tensor, idx: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """x (B, N, C), idx (B, NQ, K) int32 -> (B, NQ, K, C) with the
    scatter-add backward.  impl 'auto' | 'xla' as `knn_impl`."""
    if impl not in ("auto", "xla"):
        raise NotImplementedError(f"knn_impl {impl!r}: the port has 'auto' and 'xla'")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return flat_take(x, idx)
    return _GatherNeighbors.apply(x, idx, impl)
