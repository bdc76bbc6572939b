"""EdgeConv kNN: the Hopper kernel `csrc/knn.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_knn.py:knn_indices_pallas`
(`_knn_kernel`) in its exact mode: equal to `ops.knn.knn_indices` (squared
L2, self included, ties to the lowest index).

What bounds it on the H100: the inner products (10 + 2 clouds x 2048^2 x
C multiply-adds per encoder block at the flagship shapes, C = 9 and 64,
k = 20), taken as three tf32 tensor-core passes each on f32 (3xTF32,
f32-level accuracy) and one on bf16, and the per-row top-k selection,
which sets the pace.  The plain version writes the
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
kernel upcasts on load (`pallas_knn.py:52-53`).  Up to MAX_K and MAX_C it
goes to the kernel's bf16 route (`r3d_knn_bf16`, `r3d_knn_split_bf16`)
with no f32 copy: bf16 key tiles staged as they are and one tf32
tensor-core pass a k-step on the widened values, which adds the same
products to the same sums as the f32 route's three passes on the upcast
(the lo parts of a bf16 value are zero), so its output is the f32
route's on `x.float()` bit for bit.  `bf16_launches` counts those calls
apart.  Past those limits a bf16 input goes, upcast, to the general kernel.

Shapes that kernel does not take (k > MAX_K or C > MAX_C; the TPU kernel
takes any k <= N and any C) go to the general kernel `csrc/knn_general.cu`
(`general_launches`), with exact keys bits(d) << 32 | col, so it equals
`knn_indices` wherever the distances agree.  The same kernel runs the TPU
kernel's packed mode (`packed=True`, knn_impl "pallas", `packed_launches`)
at every shape: d = max((qq - 2 inner) + kk, 0) with the low
bit_length(N - 1) bits of its f32 pattern replaced by the column, the k
smallest such keys in order (`knn_packed_reference`), so neighbours whose
distances agree to about 2^-12 relative may swap.  Its distances are FFMA
chains over the channels in order, from 64 x 64 register micro-tiles fed
by a cp.async ring; a key below its row's current k-th joins a batch that
is merged into the row's list after each key tile (in registers up to k =
64, in shared memory past it, in device memory past about k = 400), and
the same `splits` cut the keys of small batches, the last block of a row
tile merging the splits' lists by key.  Keys are unique within a row, so
the lists, and the output, do not depend on the order keys arrive in: it
is bit-equal to the simple kernel this design replaced.

Dispatch: a CPU tensor takes `knn_reference` (`knn_packed_reference` when
packed); a CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops.knn import knn_indices

MAX_K = 32        # csrc/knn.cu: a row's list of k keys in two lanes' registers
MAX_C = 256       # csrc/knn.cu kMaxC
ROWS = 64         # query rows per block, keys per staged tile
MAX_SPLITS = 8

# knn_impl values, as the JAX package's (`r3dfsseg_tpu/nn/dgcnn.py:199-206`)
# less 'approx': 'auto' and 'pallas_exact' the exact kernels on CUDA
# tensors, 'pallas' the packed mode, 'xla' the plain versions everywhere
IMPLS = ("auto", "pallas_exact", "pallas", "xla")

launches = 0
bf16_launches = 0   # of them, calls on a bf16 input
general_launches = 0    # csrc/knn_general.cu, exact keys
packed_launches = 0     # csrc/knn_general.cu, packed keys


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


def packed_bits(n: int) -> int:
    """Low bits of a packed key that hold the column: bit_length(N - 1), at
    least 1 (`pallas_knn.py:88`)."""
    return max((n - 1).bit_length(), 1)


def knn_packed_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) f32 or bf16 -> (B, N, k) int32, the packed mode's plain
    version on the f32 upcast: d = max((qq - 2 inner) + kk, 0), the key
    (bits(d) & ~low) | col as an int32, the k smallest keys in order, each
    key's low bits."""
    x = x.float()
    n = x.shape[-2]
    xx = (x * x).sum(-1, keepdim=True)
    d = ((xx - 2.0 * torch.matmul(x, x.transpose(-1, -2))) + xx.transpose(-1, -2))
    low = (1 << packed_bits(n)) - 1
    col = torch.arange(n, dtype=torch.int32, device=x.device)
    key = (d.clamp_min(0.0).view(torch.int32) & ~low) | col
    return torch.sort(key, dim=-1).values[..., :k] & low


def knn(x: torch.Tensor, k: int, packed: bool = False) -> torch.Tensor:
    """x (B, N, C) f32 or bf16 -> (B, N, k) int32 nearest-neighbour indices;
    ``packed``: the TPU kernel's packed keys."""
    global launches, bf16_launches, general_launches, packed_launches
    if x.device.type == "cpu":
        return (knn_packed_reference if packed else knn_reference)(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"knn: want (B, N, C) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, n, c = x.shape
    if not (b > 0 and 0 < k <= n and c > 0):
        raise ValueError(f"knn: unsupported shape B={b} N={n} C={c} k={k}")
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    if packed or k > MAX_K or c > MAX_C:
        out = _knn_general(x.float().contiguous(), k, packed)
        packed_launches += packed
        general_launches += not packed
        return out
    x = x.contiguous()
    route = "_bf16" if bf16 else ""
    out = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    s = splits(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        if s == 1:
            fn = build.function(f"r3d_knn{route}", [build.P, build.P] + [build.I] * 4 + [build.P])
            err = fn(x.data_ptr(), out.data_ptr(), b, n, c, k, build.stream_ptr(dev))
        else:
            part = torch.empty((b, s, n, k), dtype=torch.int64, device=dev)
            arrived = torch.zeros((b, -(-n // ROWS)), dtype=torch.int32, device=dev)
            fn = build.function(f"r3d_knn_split{route}", [build.P] * 4 + [build.I] * 5 + [build.P])
            err = fn(x.data_ptr(), out.data_ptr(), part.data_ptr(), arrived.data_ptr(), b, n, c,
                     k, s, build.stream_ptr(dev))
    build.check(err, f"r3d_knn{route}")
    launches += 1
    bf16_launches += bf16
    return out


def kernel_attributes(k: int, bf16: bool) -> dict:
    """The registers a thread, local (spill) bytes a thread and blocks an
    SM of the kernel a call with this k launches, on its route (f32 or
    bf16), from `cudaFuncGetAttributes` and the occupancy API on the
    current card."""
    regs, local, blocks = (ctypes.c_int() for _ in range(3))
    fn = build.function("r3d_knn_attributes", [build.I, build.I] + [build.P] * 3)
    build.check(fn(int(bf16), k, ctypes.addressof(regs), ctypes.addressof(local),
                   ctypes.addressof(blocks)), "r3d_knn_attributes")
    return dict(registers=regs.value, local_bytes=local.value, blocks_per_sm=blocks.value)


def _knn_general(x: torch.Tensor, k: int, packed: bool) -> torch.Tensor:
    """One call of `csrc/knn_general.cu` on a contiguous f32 CUDA x, with
    `splits` key splits per row tile."""
    b, n, c = x.shape
    dev = x.device
    s = splits(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    nrm = torch.empty((b, n), dtype=torch.float32, device=dev)
    nbytes = build.function("r3d_knn_general_scratch", [build.I] * 6, ctypes.c_longlong)(
        b, n, c, k, int(packed), s)
    part = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    arrived = torch.zeros((b, -(-n // ROWS)), dtype=torch.int32, device=dev) if s > 1 else None
    fn = build.function("r3d_knn_general", [build.P] * 5 + [build.I] * 6 + [build.P])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), out.data_ptr(), nrm.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 arrived.data_ptr() if arrived is not None else None, b, n, c, k, int(packed), s,
                 build.stream_ptr(dev))
    build.check(err, "r3d_knn_general")
    return out
