"""Affinity graph and label propagation (counterpart of
`r3dfsseg_tpu/ops/lp.py`): threshold selection and a Chebyshev solve, on a
float32 or a bf16 episode graph.

Gradients: the affinity is differentiable through the distances and the
gaussian weights, while neighbour selection sees a detached copy
(`lp.py:139`).  The solve has the JAX package's implicit
(`custom_linear_solve`) gradient, not the gradient of the unrolled loop.

The bf16 graph (``compare_dtype=torch.bfloat16``, the JAX package's relaxed
threshold path) takes its distances from a mean-centred bf16 Gram with f32
norms (`_CenteredSqdist`), selects neighbours on a bf16 compare copy with
16 bisection steps, rounds the similarity once to bf16 after an f32 exp and
returns a bf16 affinity.  `label_propagate` normalises such an affinity by
its own degrees into a bf16 S and solves on it with kernel 7
(`ops/cuda_cheby.py`); a float32 affinity keeps the float32 `torch.mm`
loop, as the JAX package leaves f32 to XLA."""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_kth
from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist

_BIG = cuda_kth.SENTINEL     # self/invalid exclusion sentinel
_EPS = 2.220446049250313e-16  # np.finfo(np.float64).eps, as the reference adds it
_IMPLS = ("auto", "xla")


class _CenteredSqdist(torch.autograd.Function):
    """max((xx + xx^T) - 2 xb xb^T, 0) for low-precision xb (N, C) and f32
    norms xx (N, 1), with f32 products and sums: the JAX package's
    `_centered_sqdist` and its custom backward, which clips the (N, N)
    cotangent and rounds it to xb's dtype before the two products."""

    @staticmethod
    def forward(ctx, xb, xx):
        xf = xb.float()
        # (xx + xx^T) - 2 inner, exactly symmetric (see ops/knn.py), in place
        out = (xx + xx.t()).sub_(torch.mm(xf, xf.t()).mul_(2.0)).clamp_min_(0.0)
        ctx.save_for_backward(xb, out)
        return out

    @staticmethod
    def backward(ctx, g):
        xb, out = ctx.saved_tensors
        gf = torch.where(out > 0.0, g, 0.0).to(xb.dtype).float()
        xf = xb.float()
        d_xb = (-2.0 * (torch.mm(gf, xf) + torch.mm(gf.t(), xf))).to(xb.dtype)
        return d_xb, (gf.sum(1) + gf.sum(0))[:, None]


def graph_distances(node_feat: torch.Tensor, valid: torch.Tensor | None = None,
                    compare_dtype: torch.dtype | None = None):
    """(sqd, sel): the f32 squared distances (N, N) that the gaussian
    weights differentiate, and the detached selection copy, in
    compare_dtype when one is given, with self and invalid columns at the
    sentinel."""
    f32 = node_feat.float()
    if compare_dtype is not None:
        xc = f32 - f32.mean(0, keepdim=True)
        sqd = _CenteredSqdist.apply(xc.to(compare_dtype), (xc * xc).sum(-1, keepdim=True))
        sel = sqd.detach().to(compare_dtype)
    else:
        sqd = pairwise_sqdist(f32)
        sel = sqd.detach()
    eye = torch.eye(len(sel), dtype=torch.bool, device=sel.device)
    sel = sel.masked_fill(eye, _BIG)
    if valid is not None:
        sel = sel.masked_fill(~valid[None, :], _BIG)
    return sqd, sel


def local_constrained_affinity(node_feat: torch.Tensor, k: int, sigma: float = 1.0, *,
                               valid: torch.Tensor | None = None,
                               compare_dtype: torch.dtype | None = None,
                               kth_impl: str = "auto") -> torch.Tensor:
    """Symmetric kNN affinity with zero diagonal, (N, C) -> (N, N): the JAX
    package's impl='threshold', method='gaussian'.

    Each row keeps the entries within its k-th-distance radius (found by
    the per-row bisection of `ops/cuda_kth.py`; ties at the radius are all
    admitted), weighted exp(-0.5 d^2 / sigma^2).  sigma <= 0 selects the
    auto bandwidth: sigma^2 = median valid-row radius / 4.  Invalid nodes
    get zero rows and columns and are never neighbours.  compare_dtype
    bf16 builds the bf16 graph (module docstring) and returns bf16; None
    builds it in float32.
    kth_impl 'auto' runs the kernel on CUDA tensors, 'xla' the plain version.
    """
    if kth_impl not in _IMPLS:
        raise NotImplementedError(f"kth impl {kth_impl!r}: the port has 'auto' and 'xla'")
    n = node_feat.shape[0]
    sqd, sel = graph_distances(node_feat, valid, compare_dtype)
    # 16 steps resolve a bf16 radius below bf16's own resolution
    iters, out_dtype = (32, torch.float32) if compare_dtype is None else (16, compare_dtype)
    kth = cuda_kth.kth_smallest_per_row if kth_impl == "auto" else \
        cuda_kth.kth_smallest_per_row_reference
    radius = kth(sel, k, iters)          # (N, 1) f32

    if sigma <= 0:
        ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=sqd.device)
        srt = torch.sort(torch.where(ok, radius.reshape(-1), torch.inf)).values
        mid = ((ok.sum() - 1) // 2).clamp(0, n - 1)
        sigma2 = (srt[mid] / 4.0).clamp_min(1e-12)
    else:
        sigma2 = sigma * sigma
    sim = torch.exp(-0.5 * sqd / sigma2).to(out_dtype)   # f32 exp, one rounding

    # Symmetrise without a transpose: sqd is exactly symmetric, so
    # (A_knn + A_knn^T)_ij = sim_ij * ((d_ij <= r_i) + (d_ij <= r_j)).
    # A bf16 compare copy is compared with the f32 radius in f32.
    cnt = (sel <= radius).to(out_dtype) + (sel <= radius.reshape(1, -1)).to(out_dtype)
    a = (sim * cnt).masked_fill(torch.eye(n, dtype=torch.bool, device=sim.device), 0.0)
    if valid is not None:
        v = valid.to(out_dtype)
        a = a * v[:, None] * v[None, :]
    return a


def propagation_matrix(a: torch.Tensor) -> torch.Tensor:
    """S = D^-1/2 A D^-1/2; zero-degree rows stay zero.  A bf16 A gives a
    bf16 S, normalised by its own degrees with f32 sums and scales and
    rounded once (the JAX package's `lp.py:369-382`)."""
    if a.dtype == torch.bfloat16:
        r = torch.sqrt(1.0 / (a.sum(1, dtype=torch.float32) + _EPS))
        return (a.float() * r[:, None] * r[None, :]).to(torch.bfloat16)
    a = a.float()
    r = torch.sqrt(1.0 / (a.sum(1) + _EPS))
    return a * r[:, None] * r[None, :]


def _solve(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int,
           impl: str) -> torch.Tensor:
    """`iters` Chebyshev steps of (I - alpha S) x = b: kernel 7 for a bf16
    S under impl 'auto' (more than 8 columns as groups), else the plain
    `torch.mm` loop.  A CUDA graph that kernel 7 does not fit takes the
    plain loop too: past 64 MiB of S, where the JAX package leaves its
    Pallas solve for its XLA loop (`r3dfsseg_tpu/ops/lp.py:412-418`)."""
    if s.dtype == torch.bfloat16 and impl == "auto" and (
            s.device.type != "cuda" or cuda_cheby.fits(*b.shape, s.device)):
        return cuda_cheby.cheby_solve(s, b.contiguous(), alpha, iters)
    return cuda_cheby.cheby_solve_reference(s, b, alpha, iters)


class _ChebySolve(torch.autograd.Function):
    """x = (I - alpha S)^-1 y with the implicit gradient: for the symmetric
    system, lambda = (I - alpha S)^-1 g (solved with `adjoint_iters`
    steps), dS = alpha * lambda x^T and dy = lambda, as the JAX package's
    `custom_linear_solve(..., symmetric=True)` differentiates it.  A bf16 S
    is saved as it is, and dS is formed in f32 and rounded to bf16, the
    dtype of JAX's cotangent of the bf16 S."""

    @staticmethod
    def forward(ctx, s, y, alpha, iters, adjoint_iters, impl):
        x = _solve(s, y, alpha, iters, impl)
        ctx.save_for_backward(s, x)
        ctx.alpha, ctx.adjoint_iters, ctx.impl = alpha, adjoint_iters, impl
        return x

    @staticmethod
    def backward(ctx, g):
        s, x = ctx.saved_tensors
        lam = _solve(s, g, ctx.alpha, ctx.adjoint_iters, ctx.impl)
        ds = ((ctx.alpha * lam) @ x.t()).to(s.dtype) if ctx.needs_input_grad[0] else None
        return ds, lam, None, None, None, None


def label_propagate(a: torch.Tensor, y: torch.Tensor, alpha: float = 0.99, *,
                    cg_iters: int = 50, adjoint_iters: int | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """Z ~= (I - alpha S)^-1 Y by `cg_iters` Chebyshev steps (the JAX
    package's solver='cheby').  The gradient solves the adjoint system with
    `adjoint_iters` steps (None: `cg_iters`).  A bf16 affinity is solved on
    a bf16 S (the JAX package's matvec_dtype=bf16), by kernel 7 on a CUDA
    tensor under impl 'auto' and by the plain version under 'xla'."""
    if impl not in _IMPLS:
        raise NotImplementedError(f"solve impl {impl!r}: the port has 'auto' and 'xla'")
    s = propagation_matrix(a)
    y = y.float()
    t_iters = cg_iters if adjoint_iters is None else adjoint_iters
    if not (torch.is_grad_enabled() and (s.requires_grad or y.requires_grad)):
        return _solve(s, y, alpha, cg_iters, impl)
    return _ChebySolve.apply(s, y, alpha, cg_iters, t_iters, impl)
