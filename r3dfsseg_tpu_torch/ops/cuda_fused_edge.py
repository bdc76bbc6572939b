"""The fused EdgeConv tail's five passes: the Hopper kernels
`csrc/fused_edge.cu` (tuned) and `csrc/fused_edge_general.cu` (any shape)
and, beside each pass, its plain PyTorch version.

Replaces the TPU kernel `scripts/archive/fused_edge.py:_call` with its
bodies `_stats1_kernel`, `_fwd_kernel`, `_bwd1_kernel`, `_bwd2_kernel` and
`_bwd3_kernel`.  Over the raw edge tensor e (B, N, K, C), with the BN
affines and statistics as (C,) vectors and W1 (C_in, C_out):

    h0 = leaky(e * aff0 + sh0),  l1 = h0 @ W1,  z1 = l1 * aff1 + sh1,
    out = max_k leaky(z1)                                     (fwd)
    s1, s2 = sum l1, sum l1^2                                 (stats1)
    dz1 = dout routed to the lowest arg-max k, times leaky'(z1),
    r1, r2 = sum dz1, sum dz1 * xhat1                         (bwd1)
    dl1 = g1inv * (dz1 - mr1 - xhat1 * mr2),
    dz0 = (dl1 @ W1^T) * leaky'(z0),
    dW1, q1, q2 = h0^T dl1, sum dz0, sum dz0 * xhat0          (bwd2)
    d_e = g0inv * (dz0 - mq1 - xhat0 * mq2)                   (bwd3)

with xhat1 = (l1 - mu1) * inv1, xhat0 = (e - mu0) * inv0, sums over all
B * N * K edge rows, and leaky slope 0.2.  `ops/fused_edge.py` builds the
tail's forward and backward from them.

e is f32 or bf16 (the bf16 encoder's e_raw, as the archive's bodies take
it): the passes work on its f32 upcast, and bwd3 returns d_e in e's type,
rounded once.  dout, W1 and the vectors are f32.

What bounds the kernels on the H100: operations, one to three f32 (C x C)
products per edge row (3.36 GFLOP each at B = 10, N = 2048, K = 20,
C = 64).  The tuned kernel takes C = 64, B * N a multiple of 8, a K whose
tile fits in shared memory (`r3d_fused_edge_blocks` answers 0 blocks past
K = 47 for bwd2 and bwd3, 51 for the others) and a 16-byte aligned e; in
f32 (`r3d_fused_edge`) as before, and in bf16 (`r3d_fused_edge_bf16`: the
same code on the widened entries, so the f32 form's bits on e's upcast).
Every other shape, any square C up to GENERAL_MAX_C (past every width the
TPU kernel's VMEM holds: W1 alone is 36 MB at C = 3000), any K >= 1 and
any B * N >= 1, takes the general kernel.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches a
kernel or raises.  Launch counters per pass: ``<pass>_launches`` (the
tuned kernel, f32 and bf16), ``bf16_<pass>_launches`` (of them, on a bf16
e) and ``general_<pass>_launches`` (the general kernel).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from r3dfsseg_tpu_torch.kernels import build

NEG_SLOPE = 0.2
C = 64                 # csrc/fused_edge.cu kC
TILE_POINTS = 8        # csrc/fused_edge.cu kPoints
GENERAL_MAX_C = 3072   # csrc/fused_edge_general.cu kMaxC
DTYPES = (torch.float32, torch.bfloat16)
PASSES = ("stats1", "fwd", "bwd1", "bwd2", "bwd3")
# csrc/fused_edge.cu Vec: the rows of the packed (len(VECS), C) vector table
VECS = ("aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1", "mr2", "inv0", "mu0",
        "g0inv", "mq1", "mq2")

stats1_launches = 0
fwd_launches = 0
bwd1_launches = 0
bwd2_launches = 0
bwd3_launches = 0
bf16_stats1_launches = 0     # of the tuned kernel's, on a bf16 e
bf16_fwd_launches = 0
bf16_bwd1_launches = 0
bf16_bwd2_launches = 0
bf16_bwd3_launches = 0
general_stats1_launches = 0  # csrc/fused_edge_general.cu
general_fwd_launches = 0
general_bwd1_launches = 0
general_bwd2_launches = 0
general_bwd3_launches = 0


# ------------------------------------------------------------ plain versions
def _leaky(x):
    return torch.where(x > 0, x, NEG_SLOPE * x)


def _dleaky(x):
    return torch.where(x > 0, 1.0, NEG_SLOPE)


def forward_chain(e, aff0, sh0, w1, aff1, sh1):
    """z0, h0, l1, z1, h1 of the forward chain, (B, N, K, C) each."""
    z0 = e * aff0 + sh0
    h0 = _leaky(z0)
    l1 = (h0.reshape(-1, h0.shape[-1]) @ w1).reshape(h0.shape)
    z1 = l1 * aff1 + sh1
    return z0, h0, l1, z1, _leaky(z1)


def _route_dz1(e, dout, aff0, sh0, w1, aff1, sh1):
    """z0, h0, l1 and dz1: dout routed through the max (to the lowest k
    among ties) and leaky'(z1)."""
    z0, h0, l1, z1, h1 = forward_chain(e, aff0, sh0, w1, aff1, sh1)
    k = e.shape[2]
    rowmax = h1.amax(2, keepdim=True)
    kio = torch.arange(k, device=e.device).view(1, 1, k, 1).expand_as(h1)
    kstar = torch.where(h1 >= rowmax, kio, k).amin(2, keepdim=True)
    dh1 = dout[:, :, None, :] * (kio == kstar)
    return z0, h0, l1, dh1 * _dleaky(z1)


def stats1_reference(e, aff0, sh0, w1):
    """(s1, s2): per-channel sums of l1 and l1^2 over every edge row."""
    z0 = e.float() * aff0 + sh0
    l1 = _leaky(z0).reshape(-1, e.shape[-1]) @ w1
    return l1.sum(0), (l1 * l1).sum(0)


def fwd_reference(e, aff0, sh0, aff1, sh1, w1):
    """out (B, N, C) = max over k of leaky(BN1(leaky(BN0(e)) @ W1))."""
    return forward_chain(e.float(), aff0, sh0, w1, aff1, sh1)[-1].amax(2)


def bwd1_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1):
    """(r1, r2) = (sum dz1, sum dz1 * xhat1): dbeta1 and dgamma1."""
    _, _, l1, dz1 = _route_dz1(e.float(), dout.float(), aff0, sh0, w1, aff1, sh1)
    xhat1 = (l1 - mu1) * inv1
    return dz1.sum((0, 1, 2)), (dz1 * xhat1).sum((0, 1, 2))


def _dz0(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1):
    e = e.float()
    z0, h0, l1, dz1 = _route_dz1(e, dout.float(), aff0, sh0, w1, aff1, sh1)
    xhat1 = (l1 - mu1) * inv1
    dl1 = g1inv * (dz1 - mr1 - xhat1 * mr2)
    c = e.shape[-1]
    dh0 = (dl1.reshape(-1, c) @ w1.T).reshape(e.shape)
    return h0, dl1, dh0 * _dleaky(z0), (e - mu0) * inv0


def bwd2_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1):
    """(dW1, q1, q2) = (h0^T dl1, sum dz0, sum dz0 * xhat0)."""
    h0, dl1, dz0, xhat0 = _dz0(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2,
                               inv0, mu0, w1)
    c = e.shape[-1]
    return (h0.reshape(-1, c).T @ dl1.reshape(-1, c), dz0.sum((0, 1, 2)),
            (dz0 * xhat0).sum((0, 1, 2)))


def bwd3_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0,
                   g0inv, mq1, mq2, w1):
    """d_e (B, N, K, C) = g0inv * (dz0 - mq1 - xhat0 * mq2), in e's type
    (from f32, rounded once)."""
    _, _, dz0, xhat0 = _dz0(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                            mu0, w1)
    return (g0inv * (dz0 - mq1 - xhat0 * mq2)).to(e.dtype)


# -------------------------------------------------------------------- kernel
_grid_cap: dict = {}
_general_grid: dict = {}
_general_only = False


@contextlib.contextmanager
def general_only():
    """Within it every pass on a CUDA tensor takes the general kernel, at
    shapes the tuned one takes too (to hold the two against each other)."""
    global _general_only
    before, _general_only = _general_only, True
    try:
        yield
    finally:
        _general_only = before


def _tuned_grid(pass_id: int, k: int, bf16: bool, n_tiles: int, device) -> int:
    """The tuned kernel's grid for this pass, or 0 where its tile of K rows
    per point does not fit."""
    key = (device.index, pass_id, k, bf16)
    if key not in _grid_cap:
        blocks = ctypes.c_int(0)
        name = "r3d_fused_edge_bf16_blocks" if bf16 else "r3d_fused_edge_blocks"
        fn = build.function(name, [build.I, build.I, ctypes.POINTER(ctypes.c_int)])
        with torch.cuda.device(device):
            build.check(fn(pass_id, k, ctypes.byref(blocks)), name)
        _grid_cap[key] = blocks.value
    return min(n_tiles, _grid_cap[key])


def _general_grids(pass_id: int, bf16: bool, points: int, k: int, c: int, device):
    """(route blocks, rows blocks) of the general kernel's launches."""
    key = (device.index, pass_id, bf16, points, k, c)
    if key not in _general_grid:
        blocks = (ctypes.c_int * 2)()
        fn = build.function("r3d_fused_edge_general_blocks",
                            [build.I, build.I, build.L, build.I, build.I,
                             ctypes.POINTER(ctypes.c_int)])
        with torch.cuda.device(device):
            build.check(fn(pass_id, int(bf16), points, k, c, blocks),
                        "r3d_fused_edge_general_blocks")
        _general_grid[key] = (blocks[0], blocks[1])
    return _general_grid[key]


def _uses_tuned(e, name: str) -> bool:
    """Whether pass ``name`` on the CUDA tensor e (B, N, K, C) takes the
    tuned kernel: C = 64, B * N a multiple of 8, a 16-byte aligned e and a
    tile of K rows per point that fits (the kernel's own answer)."""
    b, n, k, c = e.shape
    points = b * n
    return (not _general_only and c == C and points % TILE_POINTS == 0 and points * k * C < 2**31
            and e.data_ptr() % 16 == 0
            and _tuned_grid(PASSES.index(name), k, e.dtype == torch.bfloat16,
                            points // TILE_POINTS, e.device) > 0)


def _launch(name: str, e, dout, w1, vecs: dict):
    """Run pass ``name`` on CUDA tensors; returns its output tensor (fwd:
    (B, N, C) f32, bwd3: e's shape and type) or its flat sums (stats1,
    bwd1: 2C; bwd2: C*C + 2C)."""
    if e.device.type != "cuda":
        raise ValueError(f"fused_edge {name}: no kernel for device {e.device}")
    if e.dim() != 4 or e.dtype not in DTYPES:
        raise ValueError(f"fused_edge {name}: want e (B, N, K, C) float32 or bfloat16, got "
                         f"{tuple(e.shape)} {e.dtype}")
    b, n, k, c = e.shape
    points = b * n
    if points == 0 or k == 0 or not 1 <= c <= GENERAL_MAX_C:
        raise ValueError(f"fused_edge {name}: unsupported shape B * N = {points}, K = {k}, "
                         f"C = {c} (C at most {GENERAL_MAX_C})")
    dev = e.device
    for t in [w1, *vecs.values()]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"fused_edge {name}: W1 and the vectors must be float32 on {dev}")
    if w1.shape != (c, c) or (dout is not None and (dout.shape != (b, n, c) or dout.device != dev
                                                    or not dout.is_floating_point())):
        raise ValueError(f"fused_edge {name}: want W1 ({c}, {c}) and dout ({b}, {n}, {c}) on "
                         f"{dev}")
    if any(v.shape != (c,) for v in vecs.values()):
        raise ValueError(f"fused_edge {name}: want ({c},) vectors")
    e, w1 = e.contiguous(), w1.contiguous()
    dout = dout.float().contiguous() if dout is not None else None    # exact for bf16
    zero = torch.zeros((c,), dtype=torch.float32, device=dev)
    table = torch.stack([vecs.get(key, zero) for key in VECS])   # one launch
    pass_id = PASSES.index(name)
    bf16 = e.dtype == torch.bfloat16
    n_sums = {"stats1": 2 * c, "bwd1": 2 * c, "bwd2": c * c + 2 * c}.get(name, 0)
    out = sums = partial = None
    if name == "fwd":
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    elif name == "bwd3":
        out = torch.empty_like(e)
    else:
        sums = torch.empty((n_sums,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if _uses_tuned(e, name):
        grid = _tuned_grid(pass_id, k, bf16, points // TILE_POINTS, dev)
        if sums is not None:
            partial = torch.empty((grid, n_sums), dtype=torch.float32, device=dev)
        entry = "r3d_fused_edge_bf16" if bf16 else "r3d_fused_edge"
        fn = build.function(entry, [build.I] + [build.P] * 7 + [build.I] * 3 + [build.P])
        with torch.cuda.device(dev):
            err = fn(pass_id, e.data_ptr(), ptr(dout), w1.data_ptr(), table.data_ptr(), ptr(out),
                     ptr(partial), ptr(sums), points, k, grid, build.stream_ptr(dev))
        build.check(err, f"{entry} {name}")
        globals()[f"{name}_launches"] += 1
        if bf16:
            globals()[f"bf16_{name}_launches"] += 1
    else:
        route, rows = _general_grids(pass_id, bf16, points, k, c, dev)
        if sums is not None:
            blocks = route if name == "bwd1" else rows
            partial = torch.zeros((blocks, n_sums), dtype=torch.float32, device=dev)
        kstar = dzr = None
        if name in ("bwd2", "bwd3"):     # the route kernel's (P, C) scratch
            kstar = torch.empty((points, c), dtype=torch.int32, device=dev)
            dzr = torch.empty((points, c), dtype=torch.float32, device=dev)
        fn = build.function("r3d_fused_edge_general",
                            [build.I, build.I] + [build.P] * 9 + [build.L, build.I, build.I,
                                                                  build.I, build.I, build.P])
        with torch.cuda.device(dev):
            err = fn(pass_id, int(bf16), e.data_ptr(), ptr(dout), w1.data_ptr(),
                     table.data_ptr(), ptr(out), ptr(partial), ptr(sums), ptr(kstar), ptr(dzr),
                     points, k, c, route, rows, build.stream_ptr(dev))
        build.check(err, f"r3d_fused_edge_general {name}")
        globals()[f"general_{name}_launches"] += 1
    return out if out is not None else sums


def stats1(e, aff0, sh0, w1):
    if e.device.type == "cpu":
        return stats1_reference(e, aff0, sh0, w1)
    s = _launch("stats1", e, None, w1, dict(aff0=aff0, sh0=sh0))
    c = e.shape[-1]
    return s[:c], s[c:]


def fwd(e, aff0, sh0, aff1, sh1, w1):
    if e.device.type == "cpu":
        return fwd_reference(e, aff0, sh0, aff1, sh1, w1)
    return _launch("fwd", e, None, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1))


def bwd1(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1):
    if e.device.type == "cpu":
        return bwd1_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1)
    s = _launch("bwd1", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                          mu1=mu1))
    c = e.shape[-1]
    return s[:c], s[c:]


def bwd2(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1):
    if e.device.type == "cpu":
        return bwd2_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                              mu0, w1)
    s = _launch("bwd2", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                          mu1=mu1, g1inv=g1inv, mr1=mr1, mr2=mr2, inv0=inv0,
                                          mu0=mu0))
    c = e.shape[-1]
    return s[:c * c].view(c, c), s[c * c:c * c + c], s[c * c + c:]


def bwd3(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, g0inv, mq1, mq2,
         w1):
    if e.device.type == "cpu":
        return bwd3_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                              mu0, g0inv, mq1, mq2, w1)
    return _launch("bwd3", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                             mu1=mu1, g1inv=g1inv, mr1=mr1, mr2=mr2, inv0=inv0,
                                             mu0=mu0, g0inv=g0inv, mq1=mq1, mq2=mq2))
