"""Single-head attention with dropout, forward and backward: the Hopper
kernels `csrc/attention_fwd.cu` and `csrc/attention_bwd.cu` (f32) and
`csrc/attention_fwd_bf16.cu` and `csrc/attention_bwd_bf16.cu` (bf16) at D
<= 64, `csrc/attention_wide_bf16.cu` (bf16, 64 < D <= 256),
`csrc/attention_group_bf16.cu` (bf16, D > 256) and `csrc/attention_wide.cu`
(f32, D > 64, 3xTF32 tiles in channel groups), and their plain versions.

Replaces the TPU kernels `r3dfsseg_tpu/ops/pallas_attention.py:_fwd_impl`
(`_attn_fwd_kernel`) and `_bwd_impl` (`_attn_bwd_kernel`), with
`fused_attention` as the `torch.autograd.Function` that `jax.custom_vjp`
makes of them there.

The dropout mask (`csrc/philox.cuh`) is a pure function of (seed, b, i, j):
Philox4x32-10 at counter (j // 4, i, b, 0) with key (seed_lo, seed_hi),
word j % 4; keep iff (word >> 8) >= ceil(rate * 2^24); a kept entry is
scaled by 1 / (1 - rate).  The TPU kernel seeds per (batch, query tile)
instead, so its bits differ: the port's tests compare with JAX at rate 0
and test the mask inside the port.  `dropout_words_reference` computes the
same bits in plain PyTorch on any device.

What bounds the f32 kernels on the H100: the products, which run on the
tensor cores as 3xTF32 `mma.sync.m16n8k8` tiles (`csrc/common.cuh`,
`csrc/attention.cuh`).  Each f32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi) (`split_tf32` below), and a b is taken as a_hi b_hi +
a_hi b_lo + a_lo b_hi with f32 sums: f32-level accuracy, where one tf32
pass would round q and k to 11 bits and move the scores by ~1e-3 of
themselves, past the gates (`tests/test_torch_attention.py` emulates both).
Forward: 2 products of B x N^2 x D multiply-adds, 3 tensor-core passes
each, 12 B N^2 D operations against 495 TFLOP/s of dense tf32; backward:
5 products (the kernels recompute 2 more).  The plain versions write the
(B, N, N) scores, probabilities and mask to device memory (168 MB each at
B = 10, N = 2048); the kernels keep them per tile in registers, 16 rows
per warp: an online softmax in the forward, and in the backward a
recomputation of P from the forward's row log-sum-exp (`lse`).  The
backward is two kernels with no float atomics (one sums dK and dV per key
tile, the other dQ per query tile), so it repeats bit for bit.

Numerics: the kernels multiply q by 1/tau (as the TPU kernel does); the
plain version divides q by tau (as the JAX package's XLA path does).  At
the flagship D = 64, tau = 8 and the two are bit-identical; sums run in
another order (forward: rtol 1e-4, atol 1e-5).

The bf16 form (q, k, v bf16, the bf16 encoder's; `bf16_launches` and
`bwd_bf16_launches` count its calls apart) takes the TPU kernel's `lowp`
arithmetic (`pallas_attention.py:54-125`): q * bf16(1/tau) rounded to bf16,
bf16 products with f32 sums in place of the 3xTF32 split, the softmax and
the mask in f32, the normalised P rounded to bf16 before P V (the forward
takes a first pass over the keys for each row's max and sum), an f32
output.  At D <= 64 the forward runs `wgmma` tiles, one warpgroup of 64
query rows a block, with the keys cut over the 1, 2 or 4 blocks of a
thread block cluster (`fwd_bf16_cluster` chooses C from the card's SM
count and the wrapper passes it; `fwd_bf16_plan` mirrors the launch),
whose statistics and partial outputs are merged in rank order through
distributed shared memory.  The backward at D <= 64 runs `wgmma` tiles
too: a dK/dV kernel whose blocks own 64 keys (the query tiles cut over
the two blocks of a cluster, `bwd_bf16_plan`, partials merged in rank
order) computes each score, mask and dS once and writes bf16(dS) to a
scratch of B N^2 entries (`bwd_bf16_ds_offset`), which a dQ kernel
reads; the wider forms run
`mma.sync.m16n8k16` tiles.  The backward rounds dY, Pd and dS to bf16
before their products, takes dQ = dS K / tau and dK = dS^T q / tau with
the unscaled q, and `fused_attention` casts the f32 cotangents to bf16.
One difference from the TPU kernel: the backward takes rowsum(dP * P) as
rowsum(dY * Y), as the f32 form does.  The plain versions compute the
same in PyTorch, the scores as the JAX package's XLA path does (q /
bf16(tau) in bf16), or with ``kernel_scale`` as the kernels do (q *
bf16(1/tau)); the two agree wherever 1/tau is a power of two.

Head widths the TPU kernel takes and these kernels do not (`_layout`,
`_route`):
- D not a multiple of 4 (f32) or 8 (bf16): the wrapper zero-pads q, k, v
  (and y, dy in the backward) to the next multiple and slices the outputs
  back.  This is exact: zero columns add exact zeros to q k^T and to
  rowsum(dY * Y), and the padded columns of y, dq, dk, dv are zero; tau
  stays the caller's (sqrt of the unpadded D).
- bf16 q, k, v at 64 < D <= 256: `csrc/attention_wide_bf16.cu`, the bf16
  forms' tensor-core tiles widened to 2 or 4 channel tiles of 64, any D
  that is a multiple of 8 (`wide_tc_bf16_launches`,
  `wide_tc_bwd_bf16_launches`).
- bf16 q, k, v at D > 256: `csrc/attention_group_bf16.cu`, the same tiles
  with the outputs' channels cut into groups of at most 4 tiles, one
  group per block, and the contractions over D summed in chunks, any D
  that is a multiple of 8 (`wide_group_bf16_launches`,
  `wide_group_bwd_bf16_launches`).
- f32 at D > 64: `csrc/attention_wide.cu`, the tuned f32 kernels' 3xTF32
  tiles with the contractions over D summed in chunks (64 channels in the
  forward, 32 in the backward) and the outputs' channels cut into groups
  of at most 128, one group per block, any D that is a multiple of 4
  (`wide_tf32_launches`, `wide_tf32_bwd_launches`).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches a
kernel or raises.  `fused_attention(..., impl="xla")` takes the plain
version on every device; "pallas" is the same as "auto", as in the JAX
package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from r3dfsseg_tpu_torch.kernels import build

MAX_D = 64        # head width: one 64-channel staged tile in csrc/attention.cuh
MAX_D_WIDE_TC = 256  # bf16: four 64-channel tiles in csrc/attention_wide_bf16.cu

launches = 0       # forward kernel launches
bwd_launches = 0   # backward kernel launches (one per call: Delta, dK/dV, dQ)
bf16_launches = 0      # of the forward's, calls on bf16 q, k, v
bwd_bf16_launches = 0  # of the backward's, calls on bf16 q, k, v
wide_tf32_launches = 0          # csrc/attention_wide.cu forward (f32, D > MAX_D)
wide_tf32_bwd_launches = 0      # csrc/attention_wide.cu backward
wide_tc_bf16_launches = 0      # csrc/attention_wide_bf16.cu forward (bf16, MAX_D < D <= 256)
wide_tc_bwd_bf16_launches = 0  # csrc/attention_wide_bf16.cu backward
wide_group_bf16_launches = 0      # csrc/attention_group_bf16.cu forward (bf16, D > 256)
wide_group_bwd_bf16_launches = 0  # csrc/attention_group_bf16.cu backward
IMPLS = ("auto", "pallas", "xla")

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ------------------------------------------------------------- dropout --
def dropout_threshold(rate: float) -> int:
    """Keep iff (word >> 8) >= this: the integer form of u >= rate with
    u = (word >> 8) * 2^-24."""
    return min(max(math.ceil(rate * (1 << 24)), 0), 1 << 24)


def keep_scale(rate: float) -> float:
    """The factor of a kept entry, 1 / (1 - rate) rounded to f32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _seed_words(seed: int) -> tuple[int, int]:
    return seed & _U32, (seed >> 32) & _U32


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x for x in [0, 2^32) as int64: the
    64-bit product overflows int64, so x is split into 16-bit halves."""
    pl = m * (x & 0xFFFF)                  # < 2^48
    ph = m * (x >> 16)                     # < 2^48
    return (ph + (pl >> 16)) >> 16, (((ph & 0xFFFF) << 16) + pl) & _U32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    counter (c0, c1, c2, c3), key (k0, k1) -> four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_words_reference(b: int, n: int, seed: int, device) -> torch.Tensor:
    """The mask's Philox words, (B, N, N) int64 in [0, 2^32): word (b, i, j)
    is element j % 4 of Philox4x32-10 at counter (j // 4, i, b, 0)."""
    kw = dict(dtype=torch.int64, device=device)
    j4 = torch.arange((n + 3) // 4, **kw)[None, None, :]
    i = torch.arange(n, **kw)[None, :, None]
    bb = torch.arange(b, **kw)[:, None, None]
    zero = torch.zeros((), **kw)
    c0, c1, c2, c3 = torch.broadcast_tensors(j4, i, bb, zero)
    words = philox4x32_10((c0, c1, c2, c3), _seed_words(seed))
    return torch.stack(words, -1).reshape(b, n, -1)[..., :n]


def dropout_mask_reference(b: int, n: int, rate: float, seed: int, device) -> torch.Tensor:
    """(B, N, N) f32 mask factors: 0 for a dropped entry, 1 / (1 - rate)
    for a kept one."""
    keep = (dropout_words_reference(b, n, seed, device) >> 8) >= dropout_threshold(rate)
    return keep.float() * keep_scale(rate)


def dropout_words(b: int, n: int, seed: int, device) -> torch.Tensor:
    """The same words from the kernel `r3d_dropout_mask`, (B, N, N) int32
    holding the uint32 bits.  For checking the kernel's bits; the model
    never calls it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"dropout_words: no kernel for device {device}")
    out = torch.empty((b, n, n), dtype=torch.int32, device=device)
    fn = build.function("r3d_dropout_mask", [build.P, build.I, build.I, build.U, build.U,
                                             build.P])
    lo, hi = _seed_words(seed)
    with torch.cuda.device(device):
        err = fn(out.data_ptr(), b, n, lo, hi, build.stream_ptr(device))
    build.check(err, "r3d_dropout_mask")
    return out


# ----------------------------------------------------------------- tf32 --
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 and the kernels' split do it: half a
    unit of the last kept bit is added to the magnitude's bits and the 13
    low bits are cleared.  For finite x."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    r = (u + 0x1000) & 0xFFFFE000
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)): the operand split of the
    kernels' 3xTF32 products, hi + lo within 2^-22 of x relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# --------------------------------------------------------- plain versions --
def bf16_value(x: float) -> float:
    """x rounded to bf16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def _scores(q, k, tau, kernel_scale=False):
    if q.dtype == torch.bfloat16:
        # the JAX package's XLA path: q / tau in q's dtype (the kernels: q *
        # bf16(1 / tau)), then bf16 products (exact in f32) with f32 sums
        qs = q.float() * bf16_value(1.0 / tau) if kernel_scale else q.float() / bf16_value(tau)
        return torch.matmul(qs.to(torch.bfloat16).float(), k.float().transpose(-1, -2))
    return torch.matmul(q / tau, k.transpose(-1, -2))


def _pv(p, v):
    """P V; for bf16 v, P rounded to bf16 first and f32 sums."""
    if v.dtype == torch.bfloat16:
        return torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return torch.matmul(p, v)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tau: float,
                        rate: float = 0.0, seed: int = 0,
                        kernel_scale: bool = False) -> torch.Tensor:
    """softmax(q k^T / tau) [* mask] v for (B, N, D) tensors, f32 or bf16,
    -> f32, the plain version (differentiable by torch autograd; no
    log-sum-exp pass).  ``kernel_scale``: bf16 q scaled as the kernels
    scale it."""
    p = torch.softmax(_scores(q, k, tau, kernel_scale), dim=-1)
    if rate > 0.0:
        p = p * dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
    return _pv(p, v)


def attention_fwd_reference(q, k, v, tau: float, rate: float = 0.0, seed: int = 0,
                            kernel_scale: bool = False):
    """(y, lse): the output and the (B, N) row log-sum-exp of the scores."""
    s = _scores(q, k, tau, kernel_scale)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
    return _pv(p, v), torch.logsumexp(s, dim=-1)


def attention_bwd_reference(q, k, v, y, dy, lse, tau: float, rate: float = 0.0,
                            seed: int = 0, kernel_scale: bool = False):
    """(dq, dk, dv), f32, by the kernel's algebra: P = exp(s - lse), Pd = P
    * M, dV = Pd^T dY, dS = P * (dY V^T * M - rowsum(dY * Y)), dQ = dS K /
    tau, dK = dS^T Q / tau.  For bf16 q, k, v: dY, Pd and dS rounded to
    bf16 before their products, f32 sums, and 1 / tau an f32 factor, as in
    the TPU kernel."""
    p = torch.exp(_scores(q, k, tau, kernel_scale) - lse[..., None])
    m = (dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
         if rate > 0.0 else None)
    pd = p if m is None else p * m
    lowp = q.dtype == torch.bfloat16
    if lowp:
        dy = dy.to(torch.bfloat16).float()
        q, k, v = q.float(), k.float(), v.float()
        pd = pd.to(torch.bfloat16).float()
    dpd = torch.matmul(dy, v.transpose(-1, -2))
    if m is not None:
        dpd = dpd * m
    delta = (dy * y).sum(-1, keepdim=True)
    ds = p * (dpd - delta)
    dv = torch.matmul(pd.transpose(-1, -2), dy)
    if lowp:
        ds = ds.to(torch.bfloat16).float()
        inv = 1.0 / tau
        return torch.matmul(ds, k) * inv, torch.matmul(ds.transpose(-1, -2), q) * inv, dv
    return torch.matmul(ds, k) / tau, torch.matmul(ds.transpose(-1, -2), q) / tau, dv


# ---------------------------------------------------------------- kernels --
def _check(name: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if not (all(t.shape == q.shape for t in ts) and q.dim() == 3):
        raise ValueError(f"{name}: want equal (B, N, D) shapes, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not (all(t.dtype == q.dtype for t in ts[:3]) and q.dtype in (torch.float32, torch.bfloat16)
            and all(t.dtype == torch.float32 for t in ts[3:])):
        raise ValueError(f"{name}: want float32 or bfloat16 q, k, v (and float32 y, dy)")
    b, n, d = q.shape
    if not (b > 0 and n > 0 and d > 0):
        raise ValueError(f"{name}: unsupported shape B={b} N={n} D={d} ({q.dtype})")


def _layout(q: torch.Tensor) -> int:
    """The zero columns that take a CUDA call's head width D to its
    kernels' alignment (a multiple of 4 in f32, of 8 in bf16), 0 when
    aligned."""
    return -q.shape[-1] % (8 if q.dtype == torch.bfloat16 else 4)


def _route(q: torch.Tensor) -> str:
    """The kernels a CUDA call runs after `_layout`'s pad: 'tuned'
    (`attention_fwd.cu` and `attention_bwd.cu`, or `attention_fwd_bf16.cu`
    and `attention_bwd_bf16.cu`; D <= MAX_D), 'wide_tc' (bf16,
    MAX_D < D <= MAX_D_WIDE_TC: `attention_wide_bf16.cu`), 'wide_group'
    (bf16, D > MAX_D_WIDE_TC: `attention_group_bf16.cu`) or 'wide_tf32'
    (f32, D > MAX_D: `attention_wide.cu`)."""
    d = q.shape[-1] + _layout(q)
    if d <= MAX_D:
        return "tuned"
    if q.dtype != torch.bfloat16:
        return "wide_tf32"
    return "wide_tc" if d <= MAX_D_WIDE_TC else "wide_group"


def _pad(pad: int, *ts: torch.Tensor):
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary, as the kernels'
    16-byte copies and loads need (a view may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# csrc/attention_fwd_bf16.cu's tiles
FWD_BF16_BLOCK_ROWS = 64    # query rows of a block (one warpgroup)
FWD_BF16_KEYS = 64          # keys of a staged tile


def fwd_bf16_cluster(b: int, n: int, sms: int = 132) -> int:
    """The cluster size C (1, 2 or 4) that `_kernel_fwd` passes to the
    bf16 forward at D <= 64 (`attention_fwd_bf16.cu`): the smallest C whose
    B * ceil(N / 64) * C blocks start at least four on each of ``sms`` SMs,
    else 4."""
    tiles = b * -(-n // FWD_BF16_BLOCK_ROWS)
    return next((c for c in (1, 2) if tiles * c >= 4 * sms), 4)


def fwd_bf16_plan(b: int, n: int, sms: int = 132):
    """(C, blocks): the launch of the bf16 forward at D <= 64, one entry
    (cloud, first row, first key tile, key tile past the last) per block,
    in the grid's order: block x of cloud b is rank x % C of the cluster
    of row tile x // C, and takes the key tiles [r T / C, (r + 1) T / C)
    of the T = ceil(N / 64)."""
    c = fwd_bf16_cluster(b, n, sms)
    tiles = -(-n // FWD_BF16_KEYS)
    rows = -(-n // FWD_BF16_BLOCK_ROWS)
    return c, [(bb, (x // c) * FWD_BF16_BLOCK_ROWS, (x % c) * tiles // c,
                (x % c + 1) * tiles // c) for bb in range(b) for x in range(rows * c)]


# csrc/attention_bwd_bf16.cu's tiles: 64 keys a dK/dV block, 64 queries a
# staged tile and a dQ block; the dK/dV blocks of a key tile, one cluster
# (its kCluster)
BWD_BF16_TILE = 64
BWD_BF16_CLUSTER = 2


def bwd_bf16_plan(b: int, n: int):
    """The dK/dV launch of the bf16 backward at D <= 64, one entry (cloud,
    first key, first query tile, query tile past the last) per block in
    the grid's order: block x of cloud b is rank r = x % C of the cluster
    of key tile x // C (C = `BWD_BF16_CLUSTER`), and takes the query tiles
    [r T / C, (r + 1) T / C) of the T = ceil(N / 64)."""
    c = BWD_BF16_CLUSTER
    tiles = -(-n // BWD_BF16_TILE)
    return [(bb, (x // c) * BWD_BF16_TILE, (x % c) * tiles // c, (x % c + 1) * tiles // c)
            for bb in range(b) for x in range(tiles * c)]


def bwd_bf16_ds_elems(b: int, n: int) -> int:
    """bf16 entries of the backward's dS scratch: B T^2 tiles of 64 x 64,
    T = ceil(N / 64).  The scratch grows as B N^2: 2 B T^2 4096 bytes,
    83.9 MB at B = 10, N = 2048 (the training step's support call; no
    configuration and no check of `chip_smoke.py` sends a larger N to this
    route, the card tests 2049), 537 MB per cloud at N = 16384."""
    tiles = -(-n // BWD_BF16_TILE)
    return b * tiles * tiles * BWD_BF16_TILE * BWD_BF16_TILE


def bwd_bf16_ds_offset(b, key, query, n: int):
    """The scratch entry of dS (b, query, key) (ints or integer tensors):
    tile (b, key // 64, query // 64) of T = ceil(N / 64), 4096 entries each
    in the order ((b T + key tile) T + query tile); in the tile, key row r =
    key % 64 of 64 queries, its 16-byte piece c (queries 8c .. 8c + 7) at
    piece c ^ (r % 8): the 128-byte swizzle in which the dQ kernel's
    products read dS^T."""
    t = BWD_BF16_TILE
    tiles = -(-n // t)
    r, col = key % t, query % t
    tile = (b * tiles + key // t) * tiles + query // t
    return tile * t * t + r * t + (((col // 8) ^ (r % 8)) * 8) + col % 8


_FWD_NAMES = {("tuned", False): "r3d_attn_fwd", ("tuned", True): "r3d_attn_fwd_bf16",
              ("wide_tc", True): "r3d_attn_wide_tc_fwd_bf16",
              ("wide_group", True): "r3d_attn_group_fwd_bf16",
              ("wide_tf32", False): "r3d_attn_wide_tf32_fwd"}


def _kernel_fwd(q, k, v, tau, rate, seed, want_lse):
    global launches, bf16_launches, wide_tf32_launches, wide_tc_bf16_launches
    global wide_group_bf16_launches
    pad = _layout(q)
    if pad > 0:
        y, lse = _kernel_fwd(*_pad(pad, q, k, v), tau, rate, seed, want_lse)
        return y[..., :q.shape[-1]].contiguous(), lse
    q, k, v = _staged(q), _staged(k), _staged(v)
    b, n, d = q.shape
    lowp = q.dtype == torch.bfloat16
    y = torch.empty((b, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device) if want_lse else None
    route = _route(q)
    name = _FWD_NAMES[route, lowp]
    # the grouped kernels' scratch: the scaled q
    scratch = [torch.empty_like(q)] if route == "wide_group" else []
    # the wgmma bf16 forward's cluster size
    cluster = [fwd_bf16_cluster(b, n, torch.cuda.get_device_properties(q.device)
                                .multi_processor_count)] if (route, lowp) == ("tuned", True) else []
    fn = build.function(name, [build.P] * (5 + len(scratch)) + [build.I] * (3 + len(cluster))
                        + [build.F, build.I] + [build.U] * 3 + [build.F, build.P])
    lo, hi = _seed_words(seed)
    scale = bf16_value(1.0 / tau) if lowp else 1.0 / tau
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
                 lse.data_ptr() if want_lse else None, *(t.data_ptr() for t in scratch),
                 b, n, d, *cluster, scale, int(rate > 0.0), lo, hi, dropout_threshold(rate),
                 keep_scale(rate), build.stream_ptr(q.device))
    build.check(err, name)
    if route == "wide_tf32":
        wide_tf32_launches += 1
    elif route == "wide_tc":
        wide_tc_bf16_launches += 1
    elif route == "wide_group":
        wide_group_bf16_launches += 1
    else:
        launches += 1
        bf16_launches += lowp
    return y, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tau: float,
              rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """softmax(q k^T / tau) [* mask] v; q, k, v (B, N, D) f32 or bf16 ->
    (B, N, D) f32, forward only."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, tau, rate, seed)
    _check("attention", q, k, v)
    return _kernel_fwd(q, k, v, tau, rate, seed, want_lse=False)[0]


def attention_fwd(q, k, v, tau: float, rate: float = 0.0, seed: int = 0):
    """(y, lse (B, N) f32), the forward that training saves for the
    backward."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, tau, rate, seed)
    _check("attention", q, k, v)
    return _kernel_fwd(q, k, v, tau, rate, seed, want_lse=True)


def attention_bwd(q, k, v, y, dy, lse, tau: float, rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv), f32, of the forward's f32 output cotangent dy.  On
    bf16 q, k, v at D <= 64 the call takes a scratch of B ceil(N / 64)^2
    4096 bf16 entries for dS (`bwd_bf16_ds_elems`: memory that grows as B
    N^2, 83.9 MB at B = 10, N = 2048), freed when it returns."""
    global bwd_launches, bwd_bf16_launches, wide_tf32_bwd_launches, wide_tc_bwd_bf16_launches
    global wide_group_bwd_bf16_launches
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed)
    _check("attention_bwd", q, k, v, y, dy)
    b, n, d = q.shape
    if lse.shape != (b, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"attention_bwd: want a ({b}, {n}) float32 lse on {q.device}")
    pad = _layout(q)
    if pad > 0:
        grads = attention_bwd(*_pad(pad, q, k, v, y, dy), lse, tau, rate, seed)
        return tuple(g[..., :d].contiguous() for g in grads)
    lowp = q.dtype == torch.bfloat16
    route = _route(q)
    q, k, v, y, dy, lse = (_staged(t) for t in (q, k, v, y, dy, lse))
    dq, dk, dv = (torch.empty((b, n, d), dtype=torch.float32, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lo, hi = _seed_words(seed)
    tail = (int(rate > 0.0), lo, hi, dropout_threshold(rate), keep_scale(rate),
            build.stream_ptr(q.device))
    if lowp:
        # the bf16 routes' backward kernels: the prep pass's scratch, and at
        # D <= 64 the dS scratch
        name = {"tuned": "r3d_attn_bwd_bf16", "wide_tc": "r3d_attn_wide_tc_bwd_bf16",
                "wide_group": "r3d_attn_group_bwd_bf16"}[route]
        qs, dyb = torch.empty_like(q), torch.empty_like(q)
        ptrs = (q, k, v, y, dy, lse, delta, qs, dyb)
        if route == "tuned":
            ptrs += (torch.empty(bwd_bf16_ds_elems(b, n), dtype=torch.bfloat16, device=q.device),)
        ptrs += (dq, dk, dv)
        scales = (1.0 / tau, bf16_value(1.0 / tau))
    else:
        # the two f32 routes' backward kernels take the same arguments
        name = "r3d_attn_wide_tf32_bwd" if route == "wide_tf32" else "r3d_attn_bwd"
        ptrs = (q, k, v, y, dy, lse, delta, dq, dk, dv)
        scales = (1.0 / tau,)
    fn = build.function(name, [build.P] * len(ptrs) + [build.I] * 3
                        + [build.F] * len(scales) + [build.I] + [build.U] * 3
                        + [build.F, build.P])
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in ptrs), b, n, d, *scales, *tail)
    build.check(err, name)
    if route == "wide_tf32":
        wide_tf32_bwd_launches += 1
    elif route == "wide_tc":
        wide_tc_bwd_bf16_launches += 1
    elif route == "wide_group":
        wide_group_bwd_bf16_launches += 1
    else:
        bwd_launches += 1
        bwd_bf16_launches += lowp
    return dq, dk, dv


# --------------------------------------------------------------- autograd --
class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, tau, rate, plain):
        fwd = attention_fwd_reference if plain else attention_fwd
        y, lse = fwd(q, k, v, tau, rate, seed)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.args = (seed, tau, rate, plain)
        return y

    @staticmethod
    def backward(ctx, dy):
        seed, tau, rate, plain = ctx.args
        bwd = attention_bwd_reference if plain else attention_bwd
        q, k, v, y, lse = ctx.saved_tensors
        dq, dk, dv = bwd(q, k, v, y, dy.float().contiguous(), lse, tau, rate, seed)
        # f32 sums, cotangents in the primal dtype (pallas_attention.py:233-237)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
                    tau: float, rate: float, train: bool, impl: str = "auto") -> torch.Tensor:
    """softmax(q k^T / tau) [dropout] v, f32, with the kernels' backward,
    the counterpart of the JAX package's `fused_attention`: q, k, v f32, or
    bf16 for the bf16 forms (cotangents in bf16).  Dropout runs when
    ``train`` and ``rate > 0``, its mask drawn from ``seed``.  impl 'auto'
    (or 'pallas') takes the kernels on CUDA tensors, 'xla' the plain
    versions everywhere.
    Without autograd only the forward runs (no lse)."""
    if impl not in IMPLS:
        raise NotImplementedError(f"attn_impl {impl!r}: the port has {IMPLS}")
    rate = rate if train else 0.0
    plain = impl == "xla"
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return (attention_reference if plain else attention)(q, k, v, tau, rate, seed)
    return _FusedAttention.apply(q, k, v, seed, tau, rate, plain)
