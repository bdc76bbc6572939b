"""Row gather ``out[b, i, k] = x[b, idx[b, i, k]]``: the Hopper kernel
`csrc/gather.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/fast_gather.py:gather_onehot_pallas`
(`_gather_kernel`), a one-hot matrix product that puts the gather on the
TPU's matrix unit.  On the H100 the same function is a row copy: the
kernel moves each row's bytes, so it is exact for f32 and bf16 tables.
What bounds it: bytes (the (B, NQ, K, C) output, 105 MB in f32 at the
flagship support batch B = 10, N = NQ = 2048, K = 20, C = 64).  Rows of a
multiple of 16 bytes move in 16-byte pieces (`launches`).  Any other C, as
the TPU kernel takes, goes to `r3d_gather_rows_narrow` (counted in
`narrow_launches`): the output is cut into groups of G = 16 / gcd(row
bytes, 16) rows, each a whole number of aligned 16-byte chunks, and
written in 16-byte stores; each chunk's bytes come from aligned 4-byte
loads of the table shifted into place, each row's index loaded once per
warp.  `narrow_plan` and `narrow_words` mirror that plan and the kernel's
cursor for the CPU tests.

Like the JAX package, the port's main path does not call it: its forward
gather is `fast_gather.flat_take`.  `chip_smoke.py` runs it on the fused
EdgeConv route.

Dispatch: a CPU tensor takes `gather_onehot_reference`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from r3dfsseg_tpu_torch.kernels import build
from r3dfsseg_tpu_torch.ops.fast_gather import flat_take

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
narrow_launches = 0     # rows not a multiple of 16 bytes


def narrow_plan(row_bytes: int, base: int = 0) -> dict:
    """The narrow kernel's plan for rows of an even `row_bytes` that is not
    a multiple of 16, on a table whose first byte is `base` mod 4, as
    `r3d_gather_rows_narrow` computes it: G rows a group, the group's
    16-byte chunks, the chunks each lane writes in a warp's run of 32 x
    `steps` chunks (4; fewer under 8-byte rows, so a run spans at most 258
    rows), the cursor's move to a lane's next chunk 512 bytes on (`dq`
    rows and `dr` bytes), and whether every row starts 4-byte aligned."""
    g = 16 // math.gcd(row_bytes, 16)
    return dict(group_rows=g, group_chunks=g * row_bytes // 16,
                steps=4 if row_bytes >= 8 else row_bytes // 2,
                dq=512 // row_bytes, dr=512 % row_bytes,
                aligned=row_bytes % 4 == 0 and base % 4 == 0)


def narrow_words(row_bytes: int, slot: int, off: int, src, aligned: bool) -> tuple[list, int, int]:
    """The four 4-byte words of the output chunk that starts at byte `off`
    of the row in `slot`, as the kernel's `Cursor` walks them, and the
    cursor's (slot, off) past the chunk.  `src(slot)` is the row's first
    source byte address, or None for a zero row.  On `aligned` rows each
    word is ("word", a), one aligned 4-byte load; else ("halves", a, b):
    the halfwords at a and b, each from the aligned word that holds it,
    joined by a byte permute, b in the next row where a row ends between
    them.  A None address reads zeros."""
    words = []
    for _ in range(4):
        addrs = []
        for _ in range(1 if aligned else 2):
            s = src(slot)
            addrs.append(None if s is None else s + off)
            off += 4 if aligned else 2
            if off == row_bytes:
                slot, off = slot + 1, 0
        words.append(("word" if aligned else "halves", *addrs))
    return words, slot, off


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
    if not (b > 0 and n > 0 and c > 0 and b * m * row_bytes // 16 < 2**31 * 256
            and (wide or (b * m < 2**31 and b * n < 2**31))):
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
