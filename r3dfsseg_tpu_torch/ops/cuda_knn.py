"""EdgeConv kNN: the Hopper kernel `csrc/knn.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_knn.py:knn_indices_pallas`
(`_knn_kernel`) in its exact mode: equal to `ops.knn.knn_indices` (squared
L2, self included, ties to the lowest index).

What bounds it on the H100: the inner products (10 + 2 clouds x 2048^2 x
C multiply-adds per encoder block at the flagship shapes, C = 9 and 64,
k = 20), taken as three tf32 tensor-core passes each (3xTF32, f32-level
accuracy), and the per-row top-k selection.  The plain version writes the
(B, N, N) distance matrix (168 MB for the 10 support clouds) to device
memory and sorts every row.  The kernel computes 16 x 64 distance tiles per
warp in registers and compares each distance with its row's current k-th
distance; only survivors reach shared memory, and each tile's are merged
into per-row lists held in registers, so the matrix never leaves the SM.
Where B x ceil(N / 64) row tiles would leave SMs idle (the B = 2 query
batch), `splits` cuts each row tile's keys into S scans whose lists the
last block to finish merges.

A bf16 input (the bf16 encoder's EdgeConv output under the 'stats',
'relaxed' and 'hybrid' BN modes) is searched in its f32 upcast, as the TPU
kernel upcasts on load (`pallas_knn.py:52-53`).  The wrapper upcasts, which
gives the same bits as an upcast on the kernel's load (the upcast is
exact); `bf16_launches` counts those calls apart.

Dispatch: a CPU tensor takes `knn_reference`; a CUDA tensor launches the
kernel or raises (k > MAX_K or C > MAX_C raise: limits of this kernel
that the TPU kernel does not have).
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops.knn import knn_indices

MAX_K = 32        # csrc/knn.cu: a row's list of k keys in two lanes' registers
MAX_C = 256       # csrc/knn.cu kMaxC
ROWS = 64         # query rows per block, keys per staged tile
MAX_SPLITS = 8

launches = 0
bf16_launches = 0   # of them, calls on a bf16 input


def splits(b: int, n: int, sms: int) -> int:
    """Key splits per row tile: the smallest power of two that starts at
    least 0.9 x 2 blocks per SM, at most MAX_SPLITS, each split at least
    two key tiles.  B = 10, N = 2048 on 132 SMs takes 1 (320 blocks);
    B = 2 takes 4 (256)."""
    tiles = -(-n // ROWS)
    s = 1
    while s < MAX_SPLITS and 2 * s <= tiles and 5 * b * tiles * s < 9 * sms:
        s *= 2
    return s


def knn_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) f32 or bf16 -> (B, N, k) int32, the plain PyTorch
    version, on the f32 upcast."""
    return knn_indices(x.float(), k)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) f32 or bf16 -> (B, N, k) int32 nearest-neighbour indices."""
    global launches, bf16_launches
    if x.device.type == "cpu":
        return knn_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"knn: want (B, N, C) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, n, c = x.shape
    if not (b > 0 and 0 < k <= min(n, MAX_K) and 0 < c <= MAX_C):
        raise ValueError(f"knn: unsupported shape B={b} N={n} C={c} k={k}")
    bf16 = x.dtype == torch.bfloat16
    x = x.float().contiguous()
    dev = x.device
    out = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    s = splits(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        if s == 1:
            fn = build.function("r3d_knn", [build.P, build.P] + [build.I] * 4 + [build.P])
            err = fn(x.data_ptr(), out.data_ptr(), b, n, c, k, build.stream_ptr(dev))
        else:
            part = torch.empty((b, s, n, k), dtype=torch.int64, device=dev)
            arrived = torch.zeros((b, -(-n // ROWS)), dtype=torch.int32, device=dev)
            fn = build.function("r3d_knn_split", [build.P] * 4 + [build.I] * 5 + [build.P])
            err = fn(x.data_ptr(), out.data_ptr(), part.data_ptr(), arrived.data_ptr(), b, n, c,
                     k, s, build.stream_ptr(dev))
    build.check(err, "r3d_knn")
    launches += 1
    bf16_launches += bf16
    return out
