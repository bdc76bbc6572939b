"""Chebyshev solve of (I - alpha S) x = b on the bf16 episode graph: the
Hopper kernel `r3d_cheby` in `csrc/proto_cheby.cu` and its plain versions.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_cheby.py:cheby_solve_pallas`
(`_cheby_kernel`): `iters` Chebyshev steps (Saad, alg. 12.1, spectral bounds
[1 - alpha, 1 + alpha]) on a bf16 S with f32 iterates.  The per-step
scalars come from `coefficients`, in double on the host, for every version.

The arithmetic is the TPU kernel's `body_packed`: each step splits d into
hi = bf16(d) and lo = bf16(d - hi) and takes sd = (S hi) + (S lo), bf16 x
bf16 products (exact in f32) with f32 sums, the two sums added in f32.  The
TPU kernel packs hi and lo as the two halves of one operand so that one dot
gives both; the kernel here stages them as the columns of one `mma.sync`
B operand (`split_columns` gives the layout).  `cheby_solve_split_reference`
computes the same in PyTorch, up to the order of the sums.

What bounds it on the H100: each of the iters - 1 steps reads all of S
(4396^2 bf16 = 38.65 MB at the flagship graph) for 2 * 2c flops per entry.
Kernel 10's design (`cuda_proto_cheby`), shared with it: one cooperative
launch per solve, one block of 16 warps per SM, a grid barrier between
steps, r, d and x in shared memory, and as many rows of S as fit kept on
chip for the whole solve (all of them at the flagship graph: one tile in
the warps' registers, the rest in shared memory); partial tiles summed in
warp order, so a solve repeats bit for bit.  `launches` counts solves, one
launch each.

Shapes: 1 <= C <= 8 per launch, and the block's shared memory (both pieces
of d for every row, the reduction tile, r/d/x of its rows; the kernel's
`r3d_cheby_fits` says) must fit 227 KB.  More than 8 columns (an 8-way
episode has C = 9) take one launch per group of at most 8: the Chebyshev
scalars are fixed on the host, so each column's solve is independent.  That takes every main-path episode graph (one query per way: M =
4396, C = 3; 6544, 4; 8692, 5).  It refuses some shapes that the
one-launch-per-step kernel it replaced took (that kernel staged only d, 4 *
C * M bytes): on a 132-SM H100, M in 46465-58112 at C = 1, 25297-29056 at C
= 2, 17233-19368 at 3, 13137-14528 at 4, 10257-11620 at 5, 8529-9684 at 6,
7377-8300 at 7 and 6417-7264 at 8.

Dispatch: a CPU tensor takes `cheby_solve_reference`, f32 products of the
upcast S, as the JAX package takes its XLA loop off the TPU
(`r3dfsseg_tpu/ops/lp.py:_chebyshev`); a CUDA tensor launches the kernel
or raises.  Where the kernel does not fit a graph (`fits`), the caller
(`ops/lp.py:_solve`) takes `cheby_solve_reference` instead, as the JAX
package takes its XLA loop past 64 MiB of S (`r3dfsseg_tpu/ops/lp.py:412-418`):
every M the kernel refuses at C <= 8 is above 5792, where S passes 64 MiB.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from r3dfsseg_tpu_torch.kernels import build

MAX_COLS = 8                   # csrc/proto_cheby.cu kMaxCols

launches = 0

_coef_cache: dict = {}


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


def device_coefficients(alpha: float, iters: int, device) -> tuple[float, torch.Tensor]:
    """theta and the (c1, c2) of every step as a device tensor, kept per
    (alpha, iters, device) so that a call copies nothing from the host."""
    key = (alpha, iters, str(device))
    if key not in _coef_cache:
        theta, steps = coefficients(alpha, iters)
        flat = [v for st in steps for v in st] or [0.0]
        _coef_cache[key] = theta, torch.tensor(flat, dtype=torch.float32, device=device)
    return _coef_cache[key]


def ldk(m: int) -> int:
    """The bf16 iterate buffers' leading dimension: m rounded up to 16, then
    to 16 mod 64 (a warp's B-fragment loads hit distinct banks)."""
    k = (m + 15) // 16 * 16
    return k + (16 - k % 64) % 64


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


def _mm(sf: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    # z column-major: for this (M, M) x (M, 3) product cuBLAS then picks a
    # kernel 2.5x faster on an H100 (0.089 vs 0.223 ms at M = 4396).
    return torch.mm(sf, z.t().contiguous().t())


def cheby_solve_reference(s: torch.Tensor, b: torch.Tensor, alpha: float,
                          iters: int) -> torch.Tensor:
    """s (M, M) bf16 or f32, b (M, C) f32 -> x (M, C) f32: f32 products of
    the upcast S and the f32 d (the plain path, impl 'xla')."""
    sf = s.float()
    return chebyshev(lambda z: z - alpha * _mm(sf, z), b, alpha, max(iters, 1))


def split_columns(d: torch.Tensor) -> torch.Tensor:
    """d (M, C) f32 -> (M, 2C) bf16: hi = bf16(d) in columns 0 .. C - 1 and
    lo = bf16(d - hi) in C .. 2C - 1 (d - hi is exact in f32), the live
    columns of the kernel's B operand and the TPU kernel's packed operand."""
    hi = d.to(torch.bfloat16)
    return torch.cat([hi, (d - hi.float()).to(torch.bfloat16)], dim=1)


def cheby_solve_split_reference(s: torch.Tensor, b: torch.Tensor, alpha: float,
                                iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, C) f32 -> x (M, C) f32: the kernel's arithmetic,
    sd = (S hi) + (S lo) from one product with `split_columns(d)`, in
    PyTorch on any device."""
    sf = s.float()
    c = b.shape[1]

    def matvec(z):
        sd2 = _mm(sf, split_columns(z).float())
        return z - alpha * (sd2[:, :c] + sd2[:, c:])

    return chebyshev(matvec, b, alpha, max(iters, 1))


def _groups(c: int) -> list[tuple[int, int]]:
    """Column ranges of at most MAX_COLS, in order."""
    return [(i, min(i + MAX_COLS, c)) for i in range(0, c, MAX_COLS)]


def fits(m: int, c: int, device=None) -> bool:
    """Whether kernel 7 takes an (M, M) S with C columns, one launch per
    group of at most MAX_COLS (the kernel's `r3d_cheby_fits` for each
    group), on ``device`` (default: the current CUDA device)."""
    fit = build.function("r3d_cheby_fits", [build.I] * 3)
    with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
        return m > 0 and c > 0 and all(fit(m, hi - lo, ldk(m)) for lo, hi in _groups(c))


def _launch(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int) -> torch.Tensor:
    global launches
    m, c = b.shape
    theta, coef = device_coefficients(alpha, iters, s.device)
    x = torch.empty_like(b)
    dbuf = torch.zeros(2 * 8 * ((2 * c + 7) // 8) * ldk(m), dtype=torch.bfloat16,
                       device=s.device)
    fn = build.function("r3d_cheby", [build.P, build.I, build.P, build.P, build.P, build.I,
                                      build.I, build.I, build.I, build.F, build.F, build.P,
                                      build.P])
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), m, b.data_ptr(), x.data_ptr(), dbuf.data_ptr(), m, c, ldk(m),
                 iters, alpha, theta, coef.data_ptr(), build.stream_ptr(s.device))
    build.check(err, "r3d_cheby")
    launches += 1
    return x


def cheby_solve(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, C) f32, both contiguous -> the solution after
    `iters` steps, (M, C) f32: one cooperative launch per group of at most
    8 columns."""
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
    if not fits(m, c, s.device):
        raise ValueError(f"cheby_solve: unsupported shape M={m} C={c}")
    iters = max(iters, 1)
    if c <= MAX_COLS:
        return _launch(s, b, alpha, iters)
    return torch.cat([_launch(s, b[:, lo:hi].contiguous(), alpha, iters)
                      for lo, hi in _groups(c)], dim=1)
