"""The archived Chebyshev probes on a bf16 S: the single-launch Chebyshev
solve (kernel 10, `csrc/proto_cheby.cu`) and the S.d matvec probe (kernel
11, `csrc/matmul_probe.cu`), as persistent tensor-core kernels, each with
its plain version.  Kernel 10 runs the tile code of kernel 7 (`cuda_cheby`)
with one bf16 piece of d where kernel 7 takes two.

Replaces the TPU kernels `scripts/archive/proto_cheby_pallas.py:cheby_pallas`
(`_cheby_kernel`) and `scripts/archive/proto_cheby2.py:make_matmul_only`
(`kernel`).  Both round the iterate to bf16 before each product with S and
take a bf16 x bf16 -> f32 dot, which is the operand type of Hopper's
`mma.sync` bf16 instruction.

- `proto_cheby_solve(s, b, alpha, iters)`: `iters` Chebyshev steps of (I -
  alpha S) x = b, d rounded to bf16 before each S.d.  The TPU's rejected
  first version of kernel 7 (`cuda_cheby`), which splits d into bf16 hi +
  lo instead: rounding d to a single bf16 hurt meta-training there, so
  nothing on the serving or training path calls it, in the port as in the
  JAX package.  The per-step scalars are `cuda_cheby.coefficients`
  (double, on the host), as for kernel 7.  The archive pads b to 128
  columns, the TPU's lane width, so it takes up to 128 live ones: the
  kernel takes 1 to 8 and pads to the mma's n = 8 inside, and the wrapper
  runs more as groups of at most 8, one launch each, as kernel 7 does
  (the columns are independent, so each group is the solve on its columns
  alone).
- `matmul_only(s, b, iters)`: acc = b, then `iters` times acc = (S
  bf16(acc)) * 0.99.  The archive's `tile_rows` has no counterpart: it
  only cut the TPU's VMEM dot into row tiles and gives the same numbers.
  `iters` is the archive's module constant `ITERS`.  The kernel takes any
  1 to 128 columns (the archive takes any); a block computes 32, 64 or
  128 of them (`probe_cols`) and zero-fills the rest of its tile.

What bounds them on the H100: each step reads all of S (38.65 MB at m =
4396, 40.14 MB at the probe's M = 4480), kernel 10 from the registers and
shared memory where it keeps S across the steps (all of it at the flagship
graph), kernel 11 once from device memory or L2 at any column count.  Each
call is one cooperative launch of one block per SM with grid-wide barriers
between steps: kernel 10 splits the rows of S across the blocks and the
columns into groups of 8; kernel 11 splits S into units of 128 rows by
128 k dealt to the blocks as equal contiguous ranges (`probe_plan`), takes
their products on wgmma tiles, writes each block's sums per row group
into a slot of a partials buffer and adds them in block order after a
barrier (`probe_segments` mirrors that split; the sources say more).  `launches` counts kernel 10's solves and
`matmul_only_launches` kernel 11's calls.

On the CPU each bf16 x bf16 product is exact in f32, so the plain versions
compute the TPU kernels' arithmetic up to the order of the sums.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops import cuda_cheby

MAX_COLS = 8                   # csrc/proto_cheby.cu kMaxCols: kernel 10's columns per launch
MAX_PROBE_COLS = 128           # matmul_probe.cu kMaxCols; also the archive's padded width
SCALE = 0.99                   # the archive's per-step scale
WARPS = 16                     # kWarps
SMEM_LIMIT = 232448
PROBE_ROWS = 128               # matmul_probe.cu kRows: rows of S in a row group
PROBE_CHUNK = 128              # kChunk: k entries of a unit
MAX_PROBE_M = 13968            # the largest M with smem_bytes(1, M) <= SMEM_LIMIT

launches = 0
matmul_only_launches = 0

ldk = cuda_cheby.ldk


def smem_bytes(nt: int, m: int) -> int:
    """Shared memory of a block that stages 8 * nt columns of bf16(d) for
    every row, as kernel 10 does, and the warps' partial tiles.  Both
    wrappers take the M whose 8-column block fits (M <= MAX_PROBE_M);
    kernel 10 checks the rest.  Kernel 11's block does not grow with M
    (`probe_smem_bytes`), and its wrapper keeps the range it has always
    taken."""
    return 2 * 8 * nt * ldk(m) + 4 * WARPS * 4 * nt * 32


def probe_cols(ncols: int) -> int:
    """Columns a block of kernel 11 computes for ncols live ones: 32, 64 or
    128 (matmul_probe.cu `block_cols` of the NT that `r3d_matmul_only`
    launches)."""
    return 32 if ncols <= 32 else 64 if ncols <= 64 else 128


def probe_stages(ncols: int) -> int:
    """Stages of kernel 11's shared-memory ring (matmul_probe.cu
    `ring_stages`)."""
    return {32: 5, 64: 4, 128: 3}[probe_cols(ncols)]


def probe_smem_bytes(ncols: int) -> int:
    """Shared memory of one block of kernel 11: the ring of stages, each
    128 rows of S and probe_cols(ncols) columns of bf16(acc) by 128 k, and
    1 KB to align it."""
    return 2 * probe_stages(ncols) * (PROBE_ROWS + probe_cols(ncols)) * PROBE_CHUNK + 1024


def matmul_only_fits(m: int, ncols: int) -> bool:
    """Whether the kernel 11 wrapper takes (m, ncols)."""
    return (1 <= m <= MAX_PROBE_M and 1 <= ncols <= MAX_PROBE_COLS
            and probe_smem_bytes(ncols) <= SMEM_LIMIT)


class ProbePlan(NamedTuple):
    """Kernel 11's work split at (m, ncols) on `grid` blocks: `groups` row
    groups of 128 rows, `chunks` units of 128 k each, `units` = groups *
    chunks dealt as equal contiguous ranges, `cols` columns per block,
    `slots` slots of the partials buffer, `ldb` the bf16(acc) buffers'
    leading dimension."""
    groups: int
    chunks: int
    units: int
    grid: int
    cols: int
    slots: int
    ldb: int


def probe_plan(m: int, ncols: int, sms: int) -> ProbePlan:
    """The split matmul_probe.cu runs on a card with `sms` SMs: one block
    per SM, at most one per unit."""
    groups = -(-m // PROBE_ROWS)
    chunks = -(-m // PROBE_CHUNK)
    grid = min(sms, groups * chunks)
    return ProbePlan(groups, chunks, groups * chunks, grid, probe_cols(ncols), grid + groups,
                     -(-m // 8) * 8)


def probe_range(plan: ProbePlan, block: int) -> tuple[int, int]:
    """Units [lo, hi) of a block (matmul_probe.cu `block_range`)."""
    return block * plan.units // plan.grid, (block + 1) * plan.units // plan.grid


def probe_owner(plan: ProbePlan, u: int) -> int:
    """The block whose range holds unit u (matmul_probe.cu `owner`)."""
    return ((u + 1) * plan.grid - 1) // plan.units


def probe_segments(plan: ProbePlan) -> list[tuple[int, int, int, int, int]]:
    """Every segment of a step, in block order: (block, row group, first
    chunk, end chunk, slot); a block writes one slot per row group its
    range crosses, slot = block + row group."""
    out = []
    for blk in range(plan.grid):
        lo, hi = probe_range(plan, blk)
        for r in range(lo // plan.chunks, (hi - 1) // plan.chunks + 1):
            c0 = max(lo, r * plan.chunks) - r * plan.chunks
            c1 = min(hi, (r + 1) * plan.chunks) - r * plan.chunks
            out.append((blk, r, c0, c1, blk + r))
    return out


def probe_reduce_order(plan: ProbePlan, r: int) -> list[int]:
    """The slots whose partials make row group r's sums, in the order the
    kernel adds them (`reduce_quad`: block order, that is k order)."""
    b0 = probe_owner(plan, r * plan.chunks)
    b1 = probe_owner(plan, (r + 1) * plan.chunks - 1)
    return [blk + r for blk in range(b0, b1 + 1)]


def _matvec_bf16(sf: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """S (f32 copy of the bf16 S) times bf16(z), in f32."""
    zb = z.to(torch.bfloat16).float()
    return torch.mm(sf, zb.t().contiguous().t())    # column-major: see cuda_cheby


def proto_cheby_solve_reference(s: torch.Tensor, b: torch.Tensor, alpha: float,
                                iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, C) f32 -> x (M, C) f32, the plain version:
    `cuda_cheby.chebyshev` with matvec(d) = d - alpha * S bf16(d)."""
    sf = s.float()
    return cuda_cheby.chebyshev(lambda z: z - alpha * _matvec_bf16(sf, z), b, alpha,
                                max(iters, 1))


def matmul_only_reference(s: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, ncols) f32 -> acc after `iters` steps of acc =
    (S bf16(acc)) * 0.99, the plain version."""
    sf = s.float()
    acc = b
    for _ in range(iters):
        acc = _matvec_bf16(sf, acc) * SCALE
    return acc


def _check(name: str, s: torch.Tensor, b: torch.Tensor) -> None:
    if s.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {s.device}")
    if (s.dtype != torch.bfloat16 or b.dtype != torch.float32 or s.dim() != 2
            or b.dim() != 2 or s.shape != (b.shape[0], b.shape[0]) or b.device != s.device):
        raise ValueError(f"{name}: want S (M, M) bfloat16 and b (M, C) float32 on one "
                         f"device, got {tuple(s.shape)} {s.dtype} {s.device}, "
                         f"{tuple(b.shape)} {b.dtype} {b.device}")
    if not (s.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: S and b must be contiguous")


def proto_cheby_solve(s: torch.Tensor, b: torch.Tensor, alpha: float, iters: int,
                      resident_rows: int | None = None) -> torch.Tensor:
    """s (M, M) bf16, b (M, C) f32 with 1 <= C <= 128, both contiguous -> the
    solution after `iters` steps, (M, C) f32: one cooperative launch per
    group of at most 8 columns.  `resident_rows` caps the rows of S each
    block keeps on chip, in its warps' registers and its shared memory
    (None: as many as fit), to measure what that residency saves."""
    if s.device.type == "cpu":
        return proto_cheby_solve_reference(s, b, alpha, iters)
    _check("proto_cheby_solve", s, b)
    m, c = b.shape
    if not (m > 0 and 1 <= c <= MAX_PROBE_COLS and smem_bytes(1, m) <= SMEM_LIMIT):
        raise ValueError(f"proto_cheby_solve: unsupported shape M={m} C={c}")
    if c <= MAX_COLS:
        return _proto_cheby_launch(s, b, alpha, iters, resident_rows)
    return torch.cat([_proto_cheby_launch(s, b[:, lo:lo + MAX_COLS].contiguous(), alpha, iters,
                                          resident_rows) for lo in range(0, c, MAX_COLS)], 1)


def _proto_cheby_launch(s, b, alpha, iters, resident_rows):
    """One launch of kernel 10 on at most MAX_COLS columns."""
    global launches
    m, c = b.shape
    iters = max(iters, 1)
    theta, coef = cuda_cheby.device_coefficients(alpha, iters, s.device)
    x = torch.empty_like(b)
    dbuf = torch.zeros(2 * MAX_COLS * ldk(m), dtype=torch.bfloat16, device=s.device)
    fn = build.function("r3d_proto_cheby", [build.P, build.I, build.P, build.P, build.P,
                                            build.I, build.I, build.I, build.I, build.F,
                                            build.F, build.P, build.I, build.P])
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), m, b.data_ptr(), x.data_ptr(), dbuf.data_ptr(), m, c, ldk(m),
                 iters, alpha, theta, coef.data_ptr(),
                 -1 if resident_rows is None else resident_rows, build.stream_ptr(s.device))
    build.check(err, "r3d_proto_cheby")
    launches += 1
    return x


def matmul_only(s: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """s (M, M) bf16, b (M, ncols) f32 with 1 <= ncols <= 128, both
    contiguous, iters >= 1, M <= MAX_PROBE_M -> acc (M, ncols) f32: one
    cooperative launch."""
    global matmul_only_launches
    if s.device.type == "cpu":
        return matmul_only_reference(s, b, iters)
    _check("matmul_only", s, b)
    m, ncols = b.shape
    if not (iters >= 1 and matmul_only_fits(m, ncols)):
        raise ValueError(f"matmul_only: unsupported shape M={m} ncols={ncols} iters={iters}")
    plan = probe_plan(m, ncols, torch.cuda.get_device_properties(s.device).multi_processor_count)
    out = torch.empty_like(b)
    dbuf = torch.empty(2 * ncols * plan.ldb, dtype=torch.bfloat16, device=s.device)
    part = torch.empty(plan.slots * plan.cols * PROBE_ROWS, dtype=torch.float32, device=s.device)
    fn = build.function("r3d_matmul_only", [build.P, build.I, build.P, build.P, build.P, build.I,
                                            build.P, build.I, build.I, build.I, build.I, build.I,
                                            build.P])
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), m, b.data_ptr(), out.data_ptr(), dbuf.data_ptr(), plan.ldb,
                 part.data_ptr(), plan.slots, m, ncols, iters, plan.grid,
                 build.stream_ptr(s.device))
    build.check(err, "r3d_matmul_only")
    matmul_only_launches += 1
    return out
