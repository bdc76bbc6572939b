"""EdgeConv kNN: the Hopper kernel `csrc/knn.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_knn.py:knn_indices_pallas`
(`_knn_kernel`) in its exact mode: equal to `ops.knn.knn_indices` (squared
L2, self included, ties to the lowest index).

What bounds it on the H100: at the flagship shape (10 + 2 clouds x 2048^2
distances at C = 64, k = 20) it is FP32 multiply-adds on CUDA cores (no
TF32) and the per-row top-k selection.  The plain version writes the
(B, N, N) distance matrix (168 MB for the 10 support clouds) to device
memory and sorts every row.  The kernel computes 64 x 64 distance tiles
with 4 x 4 register sub-tiles per thread and keeps every row's top-k
spread over the 32 lanes of one warp, inserting by warp-wide shifts, so
the matrix never leaves the SM and the selection does not diverge.

Dispatch: a CPU tensor takes `knn_reference`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops.knn import knn_indices

MAX_K = 32        # csrc/knn.cu: one lane per top-k slot
MAX_C = 256       # keeps the shared tiles under 227 KB

launches = 0


def knn_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) f32 -> (B, N, k) int32, the plain PyTorch version."""
    return knn_indices(x, k)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) f32 -> (B, N, k) int32 nearest-neighbour indices."""
    global launches
    if x.device.type == "cpu":
        return knn_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"knn: want (B, N, C) float32, got {tuple(x.shape)} {x.dtype}")
    b, n, c = x.shape
    if not (b > 0 and 0 < k <= min(n, MAX_K) and 0 < c <= MAX_C):
        raise ValueError(f"knn: unsupported shape B={b} N={n} C={c} k={k}")
    x = x.contiguous()
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    fn = build.function("r3d_knn", [build.P, build.P, build.I, build.I, build.I,
                                     build.I, build.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), b, n, c, k, build.stream_ptr(x.device))
    build.check(err, "r3d_knn")
    launches += 1
    return out
