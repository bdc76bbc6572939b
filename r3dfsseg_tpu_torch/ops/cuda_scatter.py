"""Scatter-add, the backward of the neighbour gather: the Hopper kernel
`csrc/scatter_add.cu` and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/fast_gather.py:scatter_add_pallas`
(`_scatter_kernel`): dx[b, j] = sum of g[b, n, k, :] over idx[b, n, k] = j.
The TPU kernel rounds g to bf16 for its one-hot matrix product; the kernel
here sums in f32, which is what the JAX package's `exact_grad_gather=True`
(`_scatter_exact`, a segment sum) computes.

What bounds it on the H100: bytes (g is 105 MB at the flagship support
batch, B = 10, N = 2048, K = 20, C = 64).  One block per (cloud, 8-channel
slice) keeps its slice of dx in shared memory and adds with shared-memory
atomics, then writes it once.  The order of the adds varies from run to
run: the kernel agrees with the plain version to f32 rounding of the sum,
|got - want| <= 1e-5 * sum |g| over the same rows.

Dispatch: a CPU tensor takes `scatter_add_reference`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build

SLICE = 8                    # csrc/scatter_add.cu kSlice: channels per block
SMEM_LIMIT = 232448

launches = 0


def scatter_add_reference(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g (B, NQ, K, C), idx (B, NQ, K) -> (B, n, C): `index_add_` of the
    rows into the flattened (B * n, C) table, the plain version."""
    b, c = g.shape[0], g.shape[-1]
    off = (torch.arange(b, device=idx.device, dtype=torch.int64) * n)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    out = g.new_zeros((b * n, c))
    return out.index_add_(0, flat, g.reshape(-1, c)).reshape(b, n, c)


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g (B, NQ, K, C) f32, idx (B, NQ, K) int32 -> dx (B, n, C) f32."""
    global launches
    if g.device.type == "cpu":
        return scatter_add_reference(g, idx, n)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {g.device}")
    if g.dtype != torch.float32 or g.dim() != 4:
        raise ValueError(f"scatter_add: want (B, NQ, K, C) float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    b, nq, k, c = g.shape
    if idx.shape != (b, nq, k) or idx.dtype != torch.int32 or idx.device != g.device:
        raise ValueError(f"scatter_add: want a ({b}, {nq}, {k}) int32 idx on {g.device}")
    if not (b > 0 and 0 < n and c % SLICE == 0 and 4 * n * SLICE <= SMEM_LIMIT
            and b < 65536):
        raise ValueError(f"scatter_add: unsupported shape B={b} N={n} C={c}")
    g, idx = g.contiguous(), idx.contiguous()
    dx = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    fn = build.function("r3d_scatter_add", [build.P] * 3 + [build.I] * 4 + [build.P])
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), idx.data_ptr(), dx.data_ptr(), b, n, nq * k, c,
                 build.stream_ptr(g.device))
    build.check(err, "r3d_scatter_add")
    launches += 1
    return dx
