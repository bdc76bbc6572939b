"""The fused EdgeConv tail, BN0 -> leaky -> W1 -> BN1 -> leaky -> max over
k, over the raw edge tensor (counterpart of `scripts/archive/fused_edge.py`).

`fused_edge_tail` reads ``e_raw = gather(a, idx) + b`` once per pass and
keeps every intermediate of the chain out of device memory: the forward is
one pass (`cuda_fused_edge.fwd`), the backward three (`bwd1`-`bwd3`), and
`edge_batch_stats` adds one more (`stats1`) for BN1's batch statistics.
`edge_gather` builds e_raw's gather term with kernel 8 and the
scatter-add backward.
BN follows the JAX package (eps 1e-5; batch statistics over (B, N, K) in
train, running statistics in eval), and in train the backward is the full
batch-norm gradient, so the statistics passed in get a zero gradient.

impl 'auto' runs the kernels on CUDA tensors and the plain versions on CPU
tensors; 'xla' runs the plain versions everywhere (as `knn_impl`).  The
port's `EdgeConv` does not take this route (the JAX package's refuses
`fuse_edge='on'`); `chip_smoke.py` holds it against the module.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from r3dfsseg_tpu_torch.ops import cuda_fused_edge as cfe
from r3dfsseg_tpu_torch.ops import cuda_gather, cuda_scatter

EPS = 1e-5

_PLAIN = SimpleNamespace(stats1=cfe.stats1_reference, fwd=cfe.fwd_reference,
                         bwd1=cfe.bwd1_reference, bwd2=cfe.bwd2_reference,
                         bwd3=cfe.bwd3_reference)


def _passes(impl: str):
    if impl == "auto":
        return cfe
    if impl == "xla":
        return _PLAIN
    raise NotImplementedError(f"fused_edge impl {impl!r}: the port has 'auto' and 'xla'")


class _EdgeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, idx, impl):
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = a.shape[1], impl
        gather = (cuda_gather.gather_onehot if impl == "auto"
                  else cuda_gather.gather_onehot_reference)
        return gather(a, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        scatter = (cuda_scatter.scatter_add if ctx.impl == "auto"
                   else cuda_scatter.scatter_add_reference)
        return scatter(g.contiguous(), idx, ctx.n), None, None


def edge_gather(a, idx, impl: str = "auto") -> torch.Tensor:
    """a (B, N, C), idx (B, NQ, K) int32 -> (B, NQ, K, C): the fused route's
    neighbour gather, kernel 8 (`cuda_gather.gather_onehot`) forward and
    the scatter-add (`cuda_scatter.scatter_add`) backward."""
    _passes(impl)                       # raises on an unknown impl
    return _EdgeGather.apply(a, idx, impl)


def bn_affines(gamma, beta, mean, var):
    """(aff, sh, inv) with BN(x) = x * aff + sh and inv = 1 / sqrt(var + eps)."""
    inv = 1.0 / torch.sqrt(var + EPS)
    aff = gamma * inv
    return aff, beta - mean * aff, inv


@torch.no_grad()
def edge_batch_stats(e_raw, gamma0, beta0, w1, impl: str = "auto"):
    """(m0, v0, m1, v1): the batch statistics of e_raw and of l1 =
    leaky(BN0(e_raw)) @ W1.  v0 is two-pass, as in the JAX package and the
    port's `BatchNorm` (raw edge features have mean >> std, where
    E[x^2] - m^2 cancels; and dbeta0, a small difference of large sums in
    train, moves by ~1e-3 relative under a variance that rounds
    otherwise); v1 is single pass, s2 / count - m1^2, the kernel's own
    form.  A bf16 e_raw goes to the stats1 pass as it is (2 bytes an
    entry); m0 and v0 are taken on its f32 upcast.  No gradient flows
    through them: the tail's backward accounts for the statistics'
    dependence on its inputs."""
    ops = _passes(impl)
    f = e_raw.float()
    m0 = f.mean((0, 1, 2))
    v0 = (f - m0).square().mean((0, 1, 2))
    aff0, sh0, _ = bn_affines(gamma0, beta0, m0, v0)
    s1, s2 = ops.stats1(e_raw, aff0, sh0, w1)   # e_raw in its own type, as the archive's _call
    count = e_raw.shape[0] * e_raw.shape[1] * e_raw.shape[2]
    m1 = s1 / count
    return m0, v0, m1, s2 / count - m1 * m1


class _FusedEdgeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e_raw, gamma0, beta0, w1, gamma1, beta1, m0, v0, m1, v1, train, impl):
        ops = _passes(impl)
        aff0, sh0, _ = bn_affines(gamma0, beta0, m0, v0)
        aff1, sh1, _ = bn_affines(gamma1, beta1, m1, v1)
        ctx.save_for_backward(e_raw, gamma0, beta0, w1, gamma1, beta1, m0, v0, m1, v1)
        ctx.train, ctx.ops = train, ops
        return ops.fwd(e_raw, aff0, sh0, aff1, sh1, w1)

    @staticmethod
    def backward(ctx, dout):
        e_raw, gamma0, beta0, w1, gamma1, beta1, m0, v0, m1, v1 = ctx.saved_tensors
        ops = ctx.ops
        dout = dout.contiguous()
        aff0, sh0, inv0 = bn_affines(gamma0, beta0, m0, v0)
        aff1, sh1, inv1 = bn_affines(gamma1, beta1, m1, v1)
        count = float(e_raw.shape[0] * e_raw.shape[1] * e_raw.shape[2])
        zero = torch.zeros_like(m0)

        dbeta1, dgamma1 = ops.bwd1(e_raw, dout, aff0, sh0, aff1, sh1, inv1, m1, w1)
        # running statistics are constants in eval
        mr1, mr2 = (dbeta1 / count, dgamma1 / count) if ctx.train else (zero, zero)
        g1inv = gamma1 * inv1
        dw1, dbeta0, dgamma0 = ops.bwd2(e_raw, dout, aff0, sh0, aff1, sh1, inv1, m1, g1inv,
                                        mr1, mr2, inv0, m0, w1)
        mq1, mq2 = (dbeta0 / count, dgamma0 / count) if ctx.train else (zero, zero)
        g0inv = gamma0 * inv0
        de = ops.bwd3(e_raw, dout, aff0, sh0, aff1, sh1, inv1, m1, g1inv, mr1, mr2, inv0, m0,
                      g0inv, mq1, mq2, w1)
        return (de, dgamma0, dbeta0, dw1, dgamma1, dbeta1, zero, zero.clone(), zero.clone(),
                zero.clone(), None, None)


def fused_edge_tail(e_raw, gamma0, beta0, w1, gamma1, beta1, m0, v0, m1, v1, train: bool,
                    impl: str = "auto") -> torch.Tensor:
    """pooled (B, N, C) f32 = max_k leaky(BN1(leaky(BN0(e_raw)) @ w1)).

    e_raw (B, N, K, C) f32 or bf16 (the bf16 encoder's; the chain runs on
    its f32 upcast and its gradient comes back in its type, rounded once,
    as the archive's `_bwd3_kernel` writes it); w1 (C_in, C_out) f32, so l1
    = h0 @ w1 (the port's `ConvBN.conv.weight.T`); the other arguments
    (C,) f32.  The statistics are inputs: batch statistics in train (from
    `edge_batch_stats`), running statistics in eval."""
    return _FusedEdgeTail.apply(e_raw, gamma0, beta0, w1, gamma1, beta1, m0, v0, m1, v1,
                                bool(train), impl)
