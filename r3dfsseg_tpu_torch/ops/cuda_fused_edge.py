"""The fused EdgeConv tail's five passes: the Hopper kernel
`csrc/fused_edge.cu` and, beside each pass, its plain PyTorch version.

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

What bounds the kernel on the H100: operations, one to three f32 (C x C)
products per edge row (3.36 GFLOP each at B = 10, N = 2048, K = 20,
C = 64).  It takes C = 64 and B * N a multiple of 8, f32 only.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  One launch counter per pass, ``<pass>_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from r3dfsseg_tpu_torch.kernels import build

NEG_SLOPE = 0.2
C = 64                 # csrc/fused_edge.cu kC
TILE_POINTS = 8        # csrc/fused_edge.cu kPoints
PASSES = ("stats1", "fwd", "bwd1", "bwd2", "bwd3")
# csrc/fused_edge.cu Vec: the rows of the packed (len(VECS), C) vector table
VECS = ("aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1", "mr2", "inv0", "mu0",
        "g0inv", "mq1", "mq2")

stats1_launches = 0
fwd_launches = 0
bwd1_launches = 0
bwd2_launches = 0
bwd3_launches = 0

_grid_cap: dict = {}


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
    z0 = e * aff0 + sh0
    l1 = _leaky(z0).reshape(-1, e.shape[-1]) @ w1
    return l1.sum(0), (l1 * l1).sum(0)


def fwd_reference(e, aff0, sh0, aff1, sh1, w1):
    """out (B, N, C) = max over k of leaky(BN1(leaky(BN0(e)) @ W1))."""
    return forward_chain(e, aff0, sh0, w1, aff1, sh1)[-1].amax(2)


def bwd1_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1):
    """(r1, r2) = (sum dz1, sum dz1 * xhat1): dbeta1 and dgamma1."""
    _, _, l1, dz1 = _route_dz1(e, dout, aff0, sh0, w1, aff1, sh1)
    xhat1 = (l1 - mu1) * inv1
    return dz1.sum((0, 1, 2)), (dz1 * xhat1).sum((0, 1, 2))


def _dz0(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1):
    z0, h0, l1, dz1 = _route_dz1(e, dout, aff0, sh0, w1, aff1, sh1)
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
    """d_e (B, N, K, C) = g0inv * (dz0 - mq1 - xhat0 * mq2)."""
    _, _, dz0, xhat0 = _dz0(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                            mu0, w1)
    return g0inv * (dz0 - mq1 - xhat0 * mq2)


# -------------------------------------------------------------------- kernel
def _grid(pass_id: int, k: int, n_tiles: int, device) -> int:
    key = (device.index, pass_id, k)
    if key not in _grid_cap:
        blocks = ctypes.c_int(0)
        fn = build.function("r3d_fused_edge_blocks",
                            [build.I, build.I, ctypes.POINTER(ctypes.c_int)])
        with torch.cuda.device(device):
            build.check(fn(pass_id, k, ctypes.byref(blocks)), "r3d_fused_edge_blocks")
        _grid_cap[key] = blocks.value
    return min(n_tiles, _grid_cap[key])


def _launch(name: str, e, dout, w1, vecs: dict):
    """Run pass ``name`` on CUDA tensors; returns its output tensor (fwd:
    (B, N, C), bwd3: e's shape) or its flat sums (stats1, bwd1: 2C; bwd2:
    C*C + 2C)."""
    if e.device.type != "cuda":
        raise ValueError(f"fused_edge {name}: no kernel for device {e.device}")
    if e.dim() != 4 or e.dtype != torch.float32 or e.shape[-1] != C:
        raise ValueError(f"fused_edge {name}: want e (B, N, K, {C}) float32, got "
                         f"{tuple(e.shape)} {e.dtype}")
    b, n, k, _ = e.shape
    points = b * n
    if points == 0 or points % TILE_POINTS or k < 1 or points * k * C >= 2**31:
        raise ValueError(f"fused_edge {name}: B * N = {points} must be a positive multiple of "
                         f"{TILE_POINTS} (K = {k})")
    dev = e.device
    for t in [w1, dout, *vecs.values()]:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"fused_edge {name}: every input must be float32 on {dev}")
    if w1.shape != (C, C) or (dout is not None and dout.shape != (b, n, C)):
        raise ValueError(f"fused_edge {name}: want W1 ({C}, {C}) and dout ({b}, {n}, {C})")
    e, w1 = e.contiguous(), w1.contiguous()
    dout = dout.contiguous() if dout is not None else None
    if e.data_ptr() % 16:
        raise ValueError(f"fused_edge {name}: e must be 16-byte aligned")
    if any(v.shape != (C,) for v in vecs.values()):
        raise ValueError(f"fused_edge {name}: want ({C},) vectors")
    zero = torch.zeros((C,), dtype=torch.float32, device=dev)
    table = torch.stack([vecs.get(key, zero) for key in VECS])   # one launch
    pass_id = PASSES.index(name)
    grid = _grid(pass_id, k, points // TILE_POINTS, dev)
    n_sums = {"stats1": 2 * C, "bwd1": 2 * C, "bwd2": C * C + 2 * C}.get(name, 0)
    out = sums = partial = None
    if name == "fwd":
        out = torch.empty((b, n, C), dtype=torch.float32, device=dev)
    elif name == "bwd3":
        out = torch.empty_like(e)
    else:
        partial = torch.empty((grid, n_sums), dtype=torch.float32, device=dev)
        sums = torch.empty((n_sums,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = build.function("r3d_fused_edge", [build.I] + [build.P] * 7 + [build.I] * 3 + [build.P])
    with torch.cuda.device(dev):
        err = fn(pass_id, e.data_ptr(), ptr(dout), w1.data_ptr(), table.data_ptr(), ptr(out),
                 ptr(partial), ptr(sums), points, k, grid, build.stream_ptr(dev))
    build.check(err, f"r3d_fused_edge {name}")
    globals()[f"{name}_launches"] += 1
    return out if out is not None else sums


def stats1(e, aff0, sh0, w1):
    if e.device.type == "cpu":
        return stats1_reference(e, aff0, sh0, w1)
    s = _launch("stats1", e, None, w1, dict(aff0=aff0, sh0=sh0))
    return s[:C], s[C:]


def fwd(e, aff0, sh0, aff1, sh1, w1):
    if e.device.type == "cpu":
        return fwd_reference(e, aff0, sh0, aff1, sh1, w1)
    return _launch("fwd", e, None, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1))


def bwd1(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1):
    if e.device.type == "cpu":
        return bwd1_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1)
    s = _launch("bwd1", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                          mu1=mu1))
    return s[:C], s[C:]


def bwd2(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1):
    if e.device.type == "cpu":
        return bwd2_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                              mu0, w1)
    s = _launch("bwd2", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                          mu1=mu1, g1inv=g1inv, mr1=mr1, mr2=mr2, inv0=inv0,
                                          mu0=mu0))
    return s[:C * C].view(C, C), s[C * C:C * C + C], s[C * C + C:]


def bwd3(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, g0inv, mq1, mq2,
         w1):
    if e.device.type == "cpu":
        return bwd3_reference(e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0,
                              mu0, g0inv, mq1, mq2, w1)
    return _launch("bwd3", e, dout, w1, dict(aff0=aff0, sh0=sh0, aff1=aff1, sh1=sh1, inv1=inv1,
                                             mu1=mu1, g1inv=g1inv, mr1=mr1, mr2=mr2, inv0=inv0,
                                             mu0=mu0, g0inv=g0inv, mq1=mq1, mq2=mq2))
