"""Chebyshev solve of (I - alpha S) x = b on the bf16 episode graph: the
Hopper kernel `csrc/cheby.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_cheby.py:cheby_solve_pallas`
(`_cheby_kernel`): `iters` Chebyshev steps (Saad, alg. 12.1, spectral bounds
[1 - alpha, 1 + alpha]) on a bf16 S with f32 iterates.  The per-step
scalars come from `coefficients`, in double on the host, for both versions.

What bounds it on the H100: each of the iters - 1 steps reads all of S
(4396^2 bf16 = 38.65 MB at the flagship graph, which the 50 MB L2 can keep)
for 2 * ncols flops per entry.  A solve is one wrapper call: one launch
that sets up r, d and x, then one launch per step (a step needs all of the
previous step's d, and blocks of one launch cannot wait for each other).
`launches` counts solves.

The kernel multiplies each bf16 entry, upcast exactly, with the f32 d in
one FMA, so it computes what the plain version's f32 product of the upcast
S computes, in another summation order.

Dispatch: a CPU tensor takes `cheby_solve_reference`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from r3dfsseg_tpu_torch.kernels import build

MAX_COLS = 8                   # csrc/cheby.cu kMaxCols
SMEM_LIMIT = 232448

launches = 0


def coefficients(alpha: float, iters: int) -> tuple[float, list[tuple[float, float]]]:
    """theta and the (c1, c2) of each of the iters - 1 steps, in double:
    d <- c1 * d + c2 * r."""
    lmin, lmax = 1.0 - alpha, 1.0 + alpha
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    steps = []
    for _ in range(iters - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, steps


def chebyshev(matvec: Callable, b: torch.Tensor, alpha: float, iters: int) -> torch.Tensor:
    """`iters` Chebyshev steps of (I - alpha S) x = b with
    ``matvec(z) = (I - alpha S) z``."""
    theta, steps = coefficients(alpha, iters)
    r = b
    d = r / theta
    x = d
    for c1, c2 in steps:
        r = r - matvec(d)
        d = c1 * d + c2 * r
        x = x + d
    return x


def cheby_solve_reference(s: torch.Tensor, b: torch.Tensor, alpha: float,
                          iters: int) -> torch.Tensor:
    """s (M, M) bf16 or f32, b (M, C) f32 -> x (M, C) f32, the plain
    version: f32 products of the upcast S."""
    sf = s.float()

    def matvec(z):
        # z column-major: for this (M, M) x (M, 3) product cuBLAS then picks
        # a kernel 2.5x faster on an H100 (0.089 vs 0.223 ms at M = 4396).
        return z - alpha * torch.mm(sf, z.t().contiguous().t())

    return chebyshev(matvec, b, alpha, max(iters, 1))


def cheby_solve(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, C) f32 with C <= 8, both contiguous -> the
    solution after `iters` steps, (M, C) f32."""
    global launches
    if s.device.type == "cpu":
        return cheby_solve_reference(s, b, alpha, iters)
    if s.device.type != "cuda":
        raise ValueError(f"cheby_solve: no kernel for device {s.device}")
    if (s.dtype != torch.bfloat16 or b.dtype != torch.float32 or s.dim() != 2
            or b.dim() != 2 or s.shape != (b.shape[0], b.shape[0]) or b.device != s.device):
        raise ValueError(f"cheby_solve: want S (M, M) bfloat16 and b (M, C) float32 on one "
                         f"device, got {tuple(s.shape)} {s.dtype} {s.device}, "
                         f"{tuple(b.shape)} {b.dtype} {b.device}")
    if not (s.is_contiguous() and b.is_contiguous()):
        raise ValueError("cheby_solve: S and b must be contiguous")
    m, c = b.shape
    ldd = (m + 3) // 4 * 4
    if not (m > 0 and 1 <= c <= MAX_COLS and 4 * c * ldd <= SMEM_LIMIT):
        raise ValueError(f"cheby_solve: unsupported shape M={m} C={c}")
    iters = max(iters, 1)
    theta, steps = coefficients(alpha, iters)
    coef = (ctypes.c_float * max(2 * len(steps), 1))(*(v for st in steps for v in st))
    x = torch.empty_like(b)
    scratch = torch.zeros(2 * c * ldd + m * c, dtype=torch.float32, device=s.device)
    fn = build.function("r3d_cheby", [build.P, build.I, build.P, build.P, build.P, build.I,
                                      build.I, build.I, build.F, build.F,
                                      ctypes.POINTER(ctypes.c_float), build.P])
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), m, b.data_ptr(), x.data_ptr(), scratch.data_ptr(), m, c,
                 iters, alpha, theta, coef, build.stream_ptr(s.device))
    build.check(err, "r3d_cheby")
    launches += 1
    return x
