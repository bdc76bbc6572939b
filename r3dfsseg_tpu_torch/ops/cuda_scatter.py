"""Scatter-add, the backward of the neighbour gather: the Hopper kernel
`csrc/scatter_add.cu` and its plain versions.

Replaces the TPU kernel `r3dfsseg_tpu/ops/fast_gather.py:scatter_add_pallas`
(`_scatter_kernel`): dx[b, j] = sum of g[b, n, k, :] over idx[b, n, k] = j.
The TPU kernel rounds g to bf16 for its one-hot matrix product; the kernel
here sums in f32, which is what the JAX package's `exact_grad_gather=True`
(`_scatter_exact`, a segment sum) computes.  Ids outside [0, N) are dropped.

What bounds it on the H100: bytes (g is 105 MB at the flagship support
batch, B = 10, N = 2048, K = 20, C = 64).  The kernel inverts the graph
(`inverse_graph_reference` builds the same CSR by target, rows in source
order) with every SM taking a unit of a cloud's rows, and lets warps sum
each target's rows in pieces of at most `PIECE` rows, a hub's pieces
merged in piece order, all in one cooperative launch (`csrc/scatter_add.cu`
says how).  No float atomics: a call repeats bit for bit, and
`scatter_add_ordered_reference` takes its sums in its order, so on the card
it equals the kernel bit for bit.  `launches` counts calls.

A bf16 cotangent (the bf16 encoder's) is read at its own width, 2 bytes an
entry, as the TPU kernel reads it ("upcasting before the kernel would
double the HBM read", `fast_gather.py:63-66`): each pair of channels is
widened to f32 in registers and summed in the same order, so the bf16 form
equals the f32 form on ``g.float()`` bit for bit; dx is f32, and the
caller casts it to bf16.  `bf16_launches` counts those calls apart.

An odd C, or more targets than the build's histograms hold in one block's
shared memory (about 28k, `r3d_scatter_add_warps`; the TPU kernel takes
any C and n), goes to `csrc/scatter_general.cu` (`general_launches`): the
same function and order of sums (bit-equal to
`scatter_add_ordered_reference` too) and the same design, one cooperative
launch per call, with two changes: a lane reads channels lane and lane +
32 of a row (4-byte or 2-byte loads, any C), and past one histogram row
of shared memory the inverse graph is built by a stable LSD radix sort
over the target's bits (`wide_plan` there) and the records placed by binary
searches (the CSR is `inverse_graph_reference`'s either way).
`general_phases` times one call's phases by block 0's clock.

Dispatch: a CPU tensor takes `scatter_add_reference` (`index_add_` in
f32); a CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from r3dfsseg_tpu_torch.kernels import build

PIECE = 32                   # csrc/scatter.cuh kPiece: rows per piece

launches = 0
bf16_launches = 0          # of them, calls on a bf16 cotangent
general_launches = 0       # csrc/scatter_general.cu (odd C, wide n)


def scatter_add_reference(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g (B, NQ, K, C) f32 or bf16, idx (B, NQ, K) -> (B, n, C) f32:
    `index_add_` of the f32 rows into the flattened (B * n, C) table, the
    plain version."""
    b, c = g.shape[0], g.shape[-1]
    off = (torch.arange(b, device=idx.device, dtype=torch.int64) * n)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    out = torch.zeros((b * n, c), dtype=torch.float32, device=g.device)
    return out.index_add_(0, flat, g.reshape(-1, c).float()).reshape(b, n, c)


def inverse_graph_reference(idx: torch.Tensor, n: int):
    """idx (B, M) -> the inverse graph as a CSR by target, as the kernel's
    build makes it: counts (B, n), offsets (B, n + 1) and perm (B, M), all
    int64; perm[b, offsets[b, j]:offsets[b, j + 1]] lists the rows m with
    idx[b, m] == j in increasing m, and -1 fills perm past the rows whose
    id lies in [0, n)."""
    idx = idx.long()
    b, m = idx.shape
    valid = (idx >= 0) & (idx < n)
    key = torch.where(valid, idx, torch.full_like(idx, n))
    perm = torch.sort(key, dim=1, stable=True).indices
    counts = torch.zeros((b, n + 1), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    counts = counts[:, :n]
    offsets = torch.cat([counts.new_zeros((b, 1)), counts.cumsum(1)], dim=1)
    perm = torch.where(torch.arange(m, device=idx.device) < offsets[:, -1:], perm,
                       torch.full_like(perm, -1))
    return counts, offsets, perm


def scatter_add_ordered_reference(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g (B, NQ, K, C) f32 or bf16, idx (B, NQ, K) -> dx (B, n, C) f32 with the kernel's
    f32 sums in the kernel's order: each target's rows (source order) cut
    into pieces of PIECE rows (one piece for a target with none), each piece
    summed in order from 0, the pieces added in order from 0."""
    b, nq, k, c = g.shape
    gf = g.reshape(b, nq * k, c).float()
    counts, offsets, perm = inverse_graph_reference(idx.reshape(b, nq * k), n)
    out = gf.new_empty((b, n, c))
    for cb in range(b):
        cnt = counts[cb]
        npc = ((cnt + PIECE - 1) // PIECE).clamp_min(1)
        first = npc.cumsum(0) - npc
        target = torch.repeat_interleave(torch.arange(n, device=g.device), npc)
        q = torch.arange(len(target), device=g.device) - first[target]
        start = offsets[cb, target] + q * PIECE
        rows = (cnt[target] - q * PIECE).clamp(0, PIECE)
        part = gf.new_zeros((len(target), c))
        for r in range(PIECE):
            sel = rows > r
            part[sel] = part[sel] + gf[cb, perm[cb, start[sel] + r]]
        total = gf.new_zeros((n, c))
        for p in range(int(npc.max())):
            sel = npc > p
            total[sel] = total[sel] + part[first[sel] + p]
        out[cb] = total
    return out


def kernel_attributes(bf16: bool) -> dict:
    """The general kernel's registers and local (spill) bytes a thread, f32
    or bf16 g, from `cudaFuncGetAttributes` on the current card."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    fn = build.function("r3d_scatter_general_attributes", [build.I] + [build.P] * 2)
    build.check(fn(int(bf16), ctypes.addressof(regs), ctypes.addressof(local)),
                 "r3d_scatter_general_attributes")
    return dict(registers=regs.value, local_bytes=local.value)


MARKS = 16                   # csrc/scatter.cuh kMarks: a timed call's clock stamps


def _general(g: torch.Tensor, idx: torch.Tensor, n: int,
             stamps: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of `csrc/scatter_general.cu` on contiguous CUDA g (B, NQ,
    K, C) and idx (B, NQ, K) int32; with `stamps` (MARKS int64 on the
    device), its phases timed (`r3d_scatter_general_phases`)."""
    global general_launches
    b, nq, k, c = g.shape
    m = nq * k
    bf16 = g.dtype == torch.bfloat16
    if stamps is None:
        name = "r3d_scatter_general" + ("_bf16" if bf16 else "")
        fn = build.function(name, [build.P] * 4 + [build.I] * 4 + [build.P])
    else:
        name = "r3d_scatter_general_phases"
        fn = build.function(name, [build.P] * 4 + [build.I] * 5 + [build.P] * 2)
    with torch.cuda.device(g.device):
        nbytes = build.function("r3d_scatter_general_scratch", [build.I] * 4,
                                ctypes.c_longlong)(b, n, m, c)
        if nbytes < 0:
            raise RuntimeError("scatter_add: the device takes no cooperative launch")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=g.device)
        dx = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
        args = [g.data_ptr(), idx.data_ptr(), dx.data_ptr(), scratch.data_ptr(), b, n, m, c]
        if stamps is not None:
            args += [int(bf16), stamps.data_ptr()]
        err = fn(*args, build.stream_ptr(g.device))
    build.check(err, name)
    general_launches += 1
    return dx


def general_phases(g: torch.Tensor, idx: torch.Tensor, n: int) -> dict:
    """One call of the general kernel (`csrc/scatter_general.cu`) with its
    phases timed by block 0's clock after each grid barrier: ms by phase,
    the narrow build's count, reduce, scan and fill, or the wide build's
    count, starts and place of each radix pass and its records, then the
    sum.  g and idx as `scatter_add` takes them, on the card."""
    stamps = torch.zeros(MARKS, dtype=torch.int64, device=g.device)
    _general(g.contiguous(), idx.contiguous(), n, stamps)
    t = stamps.tolist()
    if build.function("r3d_scatter_add_warps", [build.I])(n) >= 1:
        names = ["count", "reduce", "scan", "fill"]
    else:
        passes = (max(i for i in range(MARKS - 1) if t[i]) - 1) // 3
        names = [f"{s} {p}" for p in range(passes) for s in ("count", "starts", "place")]
        names.append("records")
    out = {name: (t[i + 1] - t[i]) / 1e6 for i, name in enumerate(names)}
    out["sum"] = (t[MARKS - 1] - t[len(names)]) / 1e6
    return out


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g (B, NQ, K, C) f32 or bf16, idx (B, NQ, K) int32 -> dx (B, n, C)
    f32: one cooperative launch of the tuned kernel where C is even and n
    fits its build, else the general kernel."""
    global launches, bf16_launches
    if g.device.type == "cpu":
        return scatter_add_reference(g, idx, n)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {g.device}")
    if g.dtype not in (torch.float32, torch.bfloat16) or g.dim() != 4:
        raise ValueError(f"scatter_add: want (B, NQ, K, C) float32 or bfloat16, got "
                         f"{tuple(g.shape)} {g.dtype}")
    b, nq, k, c = g.shape
    if idx.shape != (b, nq, k) or idx.dtype != torch.int32 or idx.device != g.device:
        raise ValueError(f"scatter_add: want a ({b}, {nq}, {k}) int32 idx on {g.device}")
    if not (b > 0 and n > 0 and c > 0):
        raise ValueError(f"scatter_add: unsupported shape B={b} N={n} C={c}")
    g, idx = g.contiguous(), idx.contiguous()
    m = nq * k
    if c % 2 or build.function("r3d_scatter_add_warps", [build.I])(n) < 1:
        return _general(g, idx, n)
    if g.data_ptr() % 16:                 # a view: the kernel loads g in 4- or 8-byte pairs
        g = g.clone()
    nbytes = build.function("r3d_scatter_add_scratch", [build.I] * 4, ctypes.c_longlong)
    scratch = torch.empty(nbytes(b, n, m, c), dtype=torch.uint8, device=g.device)
    dx = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    name = "r3d_scatter_add" if g.dtype == torch.float32 else "r3d_scatter_add_bf16"
    fn = build.function(name, [build.P] * 4 + [build.I] * 4 + [build.P])
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), idx.data_ptr(), dx.data_ptr(), scratch.data_ptr(), b, n, m, c,
                 build.stream_ptr(g.device))
    build.check(err, name)
    launches += 1
    bf16_launches += g.dtype == torch.bfloat16
    return dx
