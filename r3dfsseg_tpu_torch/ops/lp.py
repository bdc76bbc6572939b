"""Affinity graph and label propagation (counterpart of
`r3dfsseg_tpu/ops/lp.py`), float32, threshold selection, Chebyshev solve,
forward only."""
from __future__ import annotations

from typing import Callable

import torch

from r3dfsseg_tpu_torch.ops import cuda_kth
from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist

_BIG = cuda_kth.SENTINEL     # self/invalid exclusion sentinel
_EPS = 2.220446049250313e-16  # np.finfo(np.float64).eps, as the reference adds it


def local_constrained_affinity(node_feat: torch.Tensor, k: int, sigma: float = 1.0, *,
                               valid: torch.Tensor | None = None,
                               kth_impl: str = "auto") -> torch.Tensor:
    """Symmetric kNN affinity with zero diagonal, (N, C) -> (N, N): the JAX
    package's impl='threshold', method='gaussian'.

    Each row keeps the entries within its k-th-distance radius (found by
    the per-row bisection of `ops/cuda_kth.py`; ties at the radius are all
    admitted), weighted exp(-0.5 d^2 / sigma^2).  sigma <= 0 selects the
    auto bandwidth: sigma^2 = median valid-row radius / 4.  Invalid nodes
    get zero rows and columns and are never neighbours.
    kth_impl 'auto' runs the kernel on CUDA tensors, 'xla' the plain version.
    """
    n = node_feat.shape[0]
    sqd = pairwise_sqdist(node_feat.float())
    eye = torch.eye(n, dtype=torch.bool, device=sqd.device)
    sel = sqd.masked_fill(eye, _BIG)
    if valid is not None:
        sel = sel.masked_fill(~valid[None, :], _BIG)

    if kth_impl == "auto":
        radius = cuda_kth.kth_smallest_per_row(sel, k, iters=32)
    elif kth_impl == "xla":
        radius = cuda_kth.kth_smallest_per_row_reference(sel, k, iters=32)
    else:
        raise NotImplementedError(f"kth impl {kth_impl!r}: the port has 'auto' and 'xla'")

    if sigma <= 0:
        ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=sqd.device)
        srt = torch.sort(torch.where(ok, radius.reshape(-1), torch.inf)).values
        mid = ((ok.sum() - 1) // 2).clamp(0, n - 1)
        sigma2 = (srt[mid] / 4.0).clamp_min(1e-12)
    else:
        sigma2 = sigma * sigma
    sim = torch.exp(-0.5 * sqd / sigma2)

    # Symmetrise without a transpose: sqd is exactly symmetric, so
    # (A_knn + A_knn^T)_ij = sim_ij * ((d_ij <= r_i) + (d_ij <= r_j)).
    cnt = (sel <= radius).float() + (sel <= radius.reshape(1, -1)).float()
    a = (sim * cnt).masked_fill(eye, 0.0)
    if valid is not None:
        v = valid.float()
        a = a * v[:, None] * v[None, :]
    return a


def _normalized_propagation_matrix(a: torch.Tensor) -> torch.Tensor:
    """S = D^-1/2 A D^-1/2; zero-degree rows stay zero."""
    r = torch.sqrt(1.0 / (a.sum(1) + _EPS))
    return a * r[:, None] * r[None, :]


def label_propagate(a: torch.Tensor, y: torch.Tensor, alpha: float = 0.99, *,
                    cg_iters: int = 50) -> torch.Tensor:
    """Z ~= (I - alpha S)^-1 Y by `cg_iters` Chebyshev steps (the JAX
    package's solver='cheby')."""
    s = _normalized_propagation_matrix(a.float())

    def matvec(z):
        # z column-major: for this (M, M) x (M, 3) product cuBLAS then picks
        # a kernel 2.5x faster on an H100 (0.089 vs 0.223 ms at M = 4396).
        return z - alpha * torch.mm(s, z.t().contiguous().t())

    return _chebyshev(matvec, y.float(), 1.0 - alpha, 1.0 + alpha, max(cg_iters, 1))


def _chebyshev(matvec: Callable, b: torch.Tensor, lmin: float, lmax: float,
               iters: int) -> torch.Tensor:
    """Chebyshev iteration for SPD systems with known eigenvalue bounds
    (Saad, Iterative Methods for Sparse Linear Systems, alg. 12.1).  The
    scalar recurrence runs on the host in double precision."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    r = b
    d = r / theta
    x = d
    rho = 1.0 / sigma1
    for _ in range(iters - 1):
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x
