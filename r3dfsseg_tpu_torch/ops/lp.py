"""Affinity graph and label propagation (counterpart of
`r3dfsseg_tpu/ops/lp.py`): threshold or exact top-k neighbour selection and
a Chebyshev, CG or dense solve, on a float32 or a bf16 episode graph.

Gradients: the affinity is differentiable through the distances and the
gaussian weights, while neighbour selection sees a detached copy
(`lp.py:139`).  The Chebyshev and CG solves have the JAX package's implicit
(`custom_linear_solve`) gradient, not the gradient of the unrolled loop;
the dense solve has autograd's, as JAX differentiates its own.

The bf16 graph (``compare_dtype=torch.bfloat16``) takes its distances from
a mean-centred bf16 Gram with f32 norms (`_CenteredSqdist`).  Under the
threshold selection (the JAX package's relaxed path) it selects neighbours
on a bf16 compare copy with 16 bisection steps, rounds the similarity once
to bf16 after an f32 exp and returns a bf16 affinity, which
`label_propagate` normalises by its own degrees into a bf16 S for the
Chebyshev (kernel 7, `ops/cuda_cheby.py`) and CG steps.  Under the top-k
selection it selects on the f32 distances and returns an f32 affinity,
whose f32 S the Chebyshev and CG steps read as bf16(S).  The dense solve
takes the f32 S on either graph.  The top-k selection, CG and the dense
solve are plain PyTorch ops, as the JAX package computes them in XLA."""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_kth
from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist

_BIG = cuda_kth.SENTINEL     # self/invalid exclusion sentinel
_EPS = 2.220446049250313e-16  # np.finfo(np.float64).eps, as the reference adds it
_IMPLS = ("auto", "xla")
AFFINITY_IMPLS = ("threshold", "topk")
AFFINITY_METHODS = ("gaussian", "cosine")
SOLVERS = ("cheby", "cg", "solve")


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


def _sqdist(node_feat: torch.Tensor, compare_dtype: torch.dtype | None) -> torch.Tensor:
    """The f32 squared distances (N, N) that the gaussian weights
    differentiate: of the mean-centred Gram in compare_dtype with f32 norms
    when one is given, else of the f32 features."""
    f32 = node_feat.float()
    if compare_dtype is None:
        return pairwise_sqdist(f32)
    xc = f32 - f32.mean(0, keepdim=True)
    return _CenteredSqdist.apply(xc.to(compare_dtype), (xc * xc).sum(-1, keepdim=True))


def _masked(d: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """d with self and invalid columns at the sentinel."""
    d = d.masked_fill(torch.eye(len(d), dtype=torch.bool, device=d.device), _BIG)
    return d if valid is None else d.masked_fill(~valid[None, :], _BIG)


def auto_sigma2(radius: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The auto bandwidth: sigma^2 = the median of the valid rows' k-th
    distances (radius (N,)) / 4, floored at 1e-12 (the lower median, as
    the JAX package takes it)."""
    srt = torch.sort(torch.where(valid, radius, torch.inf)).values
    mid = ((valid.sum() - 1) // 2).clamp(0, radius.shape[0] - 1)
    return (srt[mid] / 4.0).clamp_min(1e-12)


def cosine_rows(f32: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm + 1e-12: the cosine weights' factors."""
    return f32 / (torch.linalg.vector_norm(f32, dim=-1, keepdim=True) + 1e-12)


def graph_distances(node_feat: torch.Tensor, valid: torch.Tensor | None = None,
                    compare_dtype: torch.dtype | None = None):
    """(sqd, sel): the f32 squared distances (N, N) that the gaussian
    weights differentiate, and the detached selection copy, in
    compare_dtype when one is given, with self and invalid columns at the
    sentinel."""
    sqd = _sqdist(node_feat, compare_dtype)
    sel = sqd.detach()
    return sqd, _masked(sel if compare_dtype is None else sel.to(compare_dtype), valid)


def exact_topk_select(sel: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask (N, N) bool, kth (N, 1) f32) of a non-negative f32 distance
    matrix: exactly k entries a row, the k smallest, ties at the k-th value
    admitted lowest index first (`lax.top_k`'s stable rule), and each row's
    exact k-th value: the JAX package's `_exact_topk_select`.

    A non-negative f32's bit pattern orders as an int32, so 31 bisection
    steps on the bits converge to the k-th value exactly; the tie budget
    k - |{d < kth}| goes to the lowest tied indices by one row cumsum."""
    bits = sel.contiguous().view(torch.int32)
    lo = torch.full((sel.shape[0], 1), -1, dtype=torch.int32, device=sel.device)
    hi = bits.amax(1, keepdim=True)
    # invariant: count(<= lo) < k <= count(<= hi)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        ge = (bits <= mid).sum(1, keepdim=True) >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    less, tie = bits < hi, bits == hi
    budget = k - less.sum(1, keepdim=True)
    mask = less | (tie & (tie.cumsum(1, dtype=torch.int32) <= budget))
    return mask, hi.view(torch.float32)


def local_constrained_affinity(node_feat: torch.Tensor, k: int, sigma: float = 1.0, *,
                               valid: torch.Tensor | None = None,
                               compare_dtype: torch.dtype | None = None,
                               impl: str = "threshold",
                               kth_impl: str = "auto",
                               method: str = "gaussian") -> torch.Tensor:
    """Symmetric kNN affinity with zero diagonal, (N, C) -> (N, N): the JAX
    package's method 'gaussian' or 'cosine' with impl 'threshold' or 'topk'.

    'threshold': each row keeps the entries within its k-th-distance radius
    (found by the per-row bisection of `ops/cuda_kth.py`; ties at the radius
    are all admitted).  compare_dtype bf16 builds the bf16 graph (module
    docstring) and returns bf16; None builds it in float32.  kth_impl
    'auto' runs kernel 4 on CUDA tensors, 'xla' the plain version.

    'topk': each row keeps exactly its k nearest (`exact_topk_select`, on
    the f32 masked distances even when compare_dtype gives the bf16 Gram's
    distances), symmetrised as A + A^T; the affinity is f32 and kernel 4
    is not called, as in the JAX package.

    The gaussian weights are exp(-0.5 d^2 / sigma^2); sigma <= 0 selects
    the auto bandwidth: sigma^2 = median valid-row k-th distance / 4.  The
    cosine weights are the inner products of the f32 rows scaled to unit
    norm (+ 1e-12), and ignore sigma.  Invalid nodes get zero rows and
    columns and are never neighbours.
    """
    if impl not in AFFINITY_IMPLS:
        raise NotImplementedError(f"affinity impl {impl!r}: one of {AFFINITY_IMPLS}")
    if method not in AFFINITY_METHODS:
        raise NotImplementedError(f"affinity method {method!r}: one of {AFFINITY_METHODS}")
    if kth_impl not in _IMPLS:
        raise NotImplementedError(f"kth impl {kth_impl!r}: the port has 'auto' and 'xla'")
    n = node_feat.shape[0]
    if impl == "threshold":
        sqd, sel = graph_distances(node_feat, valid, compare_dtype)
        # 16 steps resolve a bf16 radius below bf16's own resolution
        iters, out_dtype = (32, torch.float32) if compare_dtype is None else (16, compare_dtype)
        kth = cuda_kth.kth_smallest_per_row if kth_impl == "auto" else \
            cuda_kth.kth_smallest_per_row_reference
        radius = kth(sel, k, iters)          # (N, 1) f32
    else:
        sqd = _sqdist(node_feat, compare_dtype)
        sel = _masked(sqd.detach(), valid)
        topk_mask, radius = exact_topk_select(sel, k)
        out_dtype = torch.float32

    if method == "cosine":
        unit = cosine_rows(node_feat.float())
        sim = torch.mm(unit, unit.t()).to(out_dtype)
    else:
        if sigma <= 0:
            ok = valid if valid is not None else torch.ones(n, dtype=torch.bool,
                                                            device=sqd.device)
            sigma2 = auto_sigma2(radius.reshape(-1), ok)
        else:
            sigma2 = sigma * sigma
        sim = torch.exp(-0.5 * sqd / sigma2).to(out_dtype)   # f32 exp, one rounding

    if impl == "threshold":
        # Symmetrise without a transpose: sqd is exactly symmetric, so
        # (A_knn + A_knn^T)_ij = sim_ij * ((d_ij <= r_i) + (d_ij <= r_j)).
        # A bf16 compare copy is compared with the f32 radius in f32.
        cnt = (sel <= radius).to(out_dtype) + (sel <= radius.reshape(1, -1)).to(out_dtype)
        a = sim * cnt
    else:
        a_knn = sim * topk_mask.to(out_dtype)
        a = a_knn + a_knn.t()
    a = a.masked_fill(torch.eye(n, dtype=torch.bool, device=sim.device), 0.0)
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


def block_cg(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int,
             refresh: int = 25) -> torch.Tensor:
    """`iters` steps of conjugate gradients on (I - alpha S + eps J) x = b,
    all columns of b as one block (the JAX package's `_block_cg` with its
    matvec): f32 products of the upcast S (`torch.mm`, TF32 off), and every
    ``refresh`` steps the recurred residual replaced by the true one, which
    keeps f32 CG converging at this conditioning (cond ~ 1 / (1 - alpha))."""
    sf = s.float()
    tiny = 1e-30

    def matvec(z):
        return z - alpha * torch.mm(sf, z) + _EPS * z.sum(0, keepdim=True)

    z, r, p = torch.zeros_like(b), b, b
    rs = (b * b).sum()
    for i in range(iters):
        mp = matvec(p)
        step = rs / (p * mp).sum().clamp_min(tiny)
        z = z + step * p
        r = b - matvec(z) if (i + 1) % refresh == 0 else r - step * mp
        rs_new = (r * r).sum()
        p = r + (rs_new / rs.clamp_min(tiny)) * p
        rs = rs_new
    return z


class _ImplicitSolve(torch.autograd.Function):
    """x = M^-1 y for the symmetric M = I - alpha S (+ eps J under CG), by
    ``solve(s, y, iters)``, with the implicit gradient: lambda = M^-1 g
    (``solve`` with `adjoint_iters` steps), dS = alpha * lambda x^T and
    dy = lambda, as the JAX package's `custom_linear_solve(...,
    symmetric=True)` differentiates it.  A bf16 S is saved as it is, and dS
    is formed in f32 and rounded to bf16, the dtype of JAX's cotangent of
    the bf16 S."""

    @staticmethod
    def forward(ctx, s, y, solve, alpha, iters, adjoint_iters):
        x = solve(s, y, iters)
        ctx.save_for_backward(s, x)
        ctx.solve, ctx.alpha, ctx.adjoint_iters = solve, alpha, adjoint_iters
        return x

    @staticmethod
    def backward(ctx, g):
        s, x = ctx.saved_tensors
        lam = ctx.solve(s, g, ctx.adjoint_iters)
        ds = ((ctx.alpha * lam) @ x.t()).to(s.dtype) if ctx.needs_input_grad[0] else None
        return ds, lam, None, None, None, None


def label_propagate(a: torch.Tensor, y: torch.Tensor, alpha: float = 0.99, *,
                    solver: str = "cheby", cg_iters: int = 50, adjoint_iters: int | None = None,
                    matvec_dtype: torch.dtype | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """Z = (I - alpha S + eps)^-1 Y, S = D^-1/2 A D^-1/2: the JAX package's
    `label_propagate` with solver

    - 'cheby': `cg_iters` Chebyshev steps (eps dropped), by kernel 7 on a
      bf16 S on a CUDA tensor under impl 'auto', else the plain loop;
    - 'cg': `cg_iters` steps of block CG (`block_cg`);
    - 'solve': the dense solve, `torch.linalg.solve`, with eps added to
      every entry of the matrix as the original model adds it; its
      gradient is autograd's.

    Under 'cheby' and 'cg' the gradient solves the adjoint system with
    `adjoint_iters` steps (None: `cg_iters`; `_ImplicitSolve`).

    matvec_dtype is the dtype of the S that the 'cheby' and 'cg' steps
    read; None takes a's.  A bf16 affinity with a bf16 matvec is normalised
    by its own degrees into a bf16 S, rounded once (the JAX package's
    relaxed chain); otherwise S is normalised in f32 from the f32 affinity,
    and a bf16 matvec reads bf16(S).  'solve' always takes the f32 S.  (The
    JAX package's matvec_dtype None on a bf16 affinity, which no model
    path passes, is torch.float32 here.)"""
    if impl not in _IMPLS:
        raise NotImplementedError(f"solve impl {impl!r}: the port has 'auto' and 'xla'")
    if solver not in SOLVERS:
        raise NotImplementedError(f"LP solver {solver!r}: one of {SOLVERS}")
    mv = a.dtype if matvec_dtype is None else matvec_dtype
    relaxed = solver != "solve" and a.dtype == torch.bfloat16 and mv == torch.bfloat16
    s = propagation_matrix(a if relaxed else a.float())
    y = y.float()
    if solver == "solve":
        eye = torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
        return torch.linalg.solve(eye - alpha * s + _EPS, y)
    s = s.to(mv)
    if solver == "cheby":
        def solve(s_, b_, iters):
            return _solve(s_, b_, alpha, iters, impl)
    else:
        def solve(s_, b_, iters):
            return block_cg(s_, b_, alpha, iters)
    if not (torch.is_grad_enabled() and (s.requires_grad or y.requires_grad)):
        return solve(s, y, cg_iters)
    t_iters = max(cg_iters if adjoint_iters is None else adjoint_iters, 1)
    return _ImplicitSolve.apply(s, y, solve, alpha, cg_iters, t_iters)
