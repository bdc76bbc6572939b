"""Row gather ``out[b, i, k] = x[b, idx[b, i, k]]``: the Hopper kernel
`csrc/gather.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/fast_gather.py:gather_onehot_pallas`
(`_gather_kernel`), a one-hot matrix product that puts the gather on the
TPU's matrix unit.  On the H100 the same function is a row copy: the
kernel moves each row's bytes, so it is exact for f32 and bf16 tables.
What bounds it: bytes (the (B, NQ, K, C) output, 105 MB in f32 at the
flagship support batch B = 10, N = NQ = 2048, K = 20, C = 64).  Rows of a
multiple of 16 bytes move in 16-byte pieces (`launches`); any other C, as
the TPU kernel takes, in 4- or 2-byte pieces (`r3d_gather_rows_narrow`,
counted in `narrow_launches`).

Like the JAX package, the port's main path does not call it: its forward
gather is `fast_gather.flat_take`.  `chip_smoke.py` runs it on the fused
EdgeConv route.

Dispatch: a CPU tensor takes `gather_onehot_reference`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops.fast_gather import flat_take

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
narrow_launches = 0     # rows not a multiple of 16 bytes


def gather_onehot_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, NQ, K) -> (B, NQ, K, C): the plain version,
    one row take from the flattened table (`flat_take`)."""
    return flat_take(x, idx)


def gather_onehot(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) f32 or bf16, idx (B, NQ, K) int32 with ids in [0, N) ->
    (B, NQ, K, C) of x's type."""
    global launches, narrow_launches
    if x.device.type == "cpu":
        return gather_onehot_reference(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_onehot: no kernel for device {x.device}")
    if x.dtype not in DTYPES or x.dim() != 3:
        raise ValueError(f"gather_onehot: want a (B, N, C) float32 or bfloat16 table, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, n, c = x.shape
    if idx.dim() != 3 or idx.shape[0] != b or idx.dtype != torch.int32 or idx.device != x.device:
        raise ValueError(f"gather_onehot: want a ({b}, NQ, K) int32 idx on {x.device}")
    row_bytes = c * x.element_size()
    m = idx.shape[1] * idx.shape[2]
    wide = row_bytes % 16 == 0
    piece = 16 if wide else 4 if row_bytes % 4 == 0 else 2
    if not (b > 0 and n > 0 and c > 0 and b * m * row_bytes // piece < 2**31 * 256):
        raise ValueError(f"gather_onehot: unsupported shape B={b} N={n} C={c} {x.dtype}")
    x, idx = x.contiguous(), idx.contiguous()
    out = torch.empty((*idx.shape, c), dtype=x.dtype, device=x.device)
    entry = "r3d_gather_rows" if wide else "r3d_gather_rows_narrow"
    fn = build.function(entry, [build.P] * 3 + [build.I] * 4 + [build.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, row_bytes,
                 build.stream_ptr(x.device))
    build.check(err, entry)
    if wide:
        launches += 1
    else:
        narrow_launches += 1
    return out
