"""Per-row k-th smallest distance: the Hopper kernel `csrc/kth.cu` and its
plain version.

Replaces the TPU kernel
`r3dfsseg_tpu/ops/pallas_kth.py:kth_smallest_per_row_pallas` (`_kth_kernel`):
a fixed-count bisection on count(d <= mid) >= k over the per-row bracket
[0, max(row max finite, 1e-6)], returning the upper bracket.  Entries at or
above 0.5 * 1e30 are the affinity's self/invalid sentinels.  The input is
f32 or, for the bf16 episode graph, the bf16 compare copy: as in the TPU
kernel, each bf16 entry is upcast to f32 and the bisection runs in f32.

What bounds it on the H100: the bytes of one read of the matrix (77 MB f32,
38.65 MB bf16 at the flagship 4396 x 4396).  The plain version re-reads the
whole (M, M) matrix on every step (32 x 77 MB).  The kernel reads each row
once: one block per row keeps the row's order-preserving keys in shared
memory, selects the k-th smallest finite entry v_k exactly (radix passes
over the live key range, then a direct rank of the last few entries), and
replays the bisection on scalars, since count(d <= mid) >= k exactly when
v_k <= mid (`csrc/kth.cu`).

The kernel equals the plain version bit for bit: exact upcasts, an exact
select and the same f32 mid-point arithmetic.

Rows too wide for one block's shared memory (`r3d_kth_fits` refuses them:
about 57.7k f32 or 115k bf16 entries; the TPU kernel shrinks its row tile
instead) go to the variant `kth_wide_kernel` in the same source
(`wide_launches`): the same select and replay, bit-equal too, with the row
read from device memory once per pass instead of into shared memory.

Dispatch: a CPU tensor takes `kth_smallest_per_row_reference`; a CUDA
tensor launches a kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build

SENTINEL = 1e30                # ops/lp.py _BIG

launches = 0
wide_launches = 0      # the wide-row variant


def kth_smallest_per_row_reference(d: torch.Tensor, k: int, iters: int,
                                   hi: torch.Tensor | None = None) -> torch.Tensor:
    """d (R, M) f32 or bf16 -> (R, 1) f32 upward-biased k-th smallest per
    row, the plain version.  ``hi`` (a 0-d f32 tensor) fixes every row's
    bracket to [0, hi] instead, as the JAX package's
    `_kth_smallest_per_row(..., hi=)` on the scene graph's row tiles
    (`ops/lp_blocked.py`), where the kernel does not run."""
    d = d.float()
    if hi is None:
        finite = d < 0.5 * SENTINEL
        hi = torch.where(finite, d, 0.0).amax(1, keepdim=True).clamp_min(1e-6)
    else:
        hi = torch.ones((d.shape[0], 1), dtype=torch.float32, device=d.device) * hi
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (d <= mid).sum(1, keepdim=True) >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def kth_smallest_per_row(d: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """d (R, M) f32 or bf16 -> (R, 1) f32 per-row radius admitting >= k
    entries."""
    global launches, wide_launches
    if d.device.type == "cpu":
        return kth_smallest_per_row_reference(d, k, iters)
    if d.device.type != "cuda":
        raise ValueError(f"kth_smallest_per_row: no kernel for device {d.device}")
    if d.dtype not in (torch.float32, torch.bfloat16) or d.dim() != 2:
        raise ValueError(f"kth_smallest_per_row: want (R, M) float32 or bfloat16, got "
                         f"{tuple(d.shape)} {d.dtype}")
    rows, m = d.shape
    if not (rows > 0 and m > 0 and iters >= 0):
        raise ValueError(f"kth_smallest_per_row: unsupported shape R={rows} M={m}")
    wide = not build.function("r3d_kth_fits", [build.I, build.I])(m, d.element_size())
    d = d.contiguous()
    out = torch.empty((rows, 1), dtype=torch.float32, device=d.device)
    name = ("r3d_kth_wide" if wide else "r3d_kth") + ("" if d.dtype == torch.float32 else "_bf16")
    fn = build.function(name, [build.P, build.P, build.I, build.I, build.I, build.I, build.P])
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), out.data_ptr(), rows, m, k, iters,
                 build.stream_ptr(d.device))
    build.check(err, name)
    if wide:
        wide_launches += 1
    else:
        launches += 1
    return out
