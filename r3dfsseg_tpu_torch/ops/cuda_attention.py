"""Single-head attention with dropout, forward and backward: the Hopper
kernels `csrc/attention_fwd.cu` and `csrc/attention_bwd.cu` and their
plain versions.

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

What bounds the kernels on the H100: the products, which run on the
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

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  `fused_attention(..., impl="xla")` takes the plain
version on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from r3dfsseg_tpu_torch.kernels import build

MAX_D = 64        # head width: one 64-channel staged tile in csrc/attention.cuh

launches = 0       # forward kernel launches
bwd_launches = 0   # backward kernel launches (one per call: Delta, dK/dV, dQ)

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
def _scores(q, k, tau):
    return torch.matmul(q / tau, k.transpose(-1, -2))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tau: float,
                        rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """softmax(q k^T / tau) [* mask] v for (B, N, D) tensors, the plain
    version (differentiable by torch autograd; no log-sum-exp pass)."""
    p = torch.softmax(_scores(q, k, tau), dim=-1)
    if rate > 0.0:
        p = p * dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
    return torch.matmul(p, v)


def attention_fwd_reference(q, k, v, tau: float, rate: float = 0.0, seed: int = 0):
    """(y, lse): the output and the (B, N) row log-sum-exp of the scores."""
    s = _scores(q, k, tau)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
    return torch.matmul(p, v), torch.logsumexp(s, dim=-1)


def attention_bwd_reference(q, k, v, y, dy, lse, tau: float, rate: float = 0.0,
                            seed: int = 0):
    """(dq, dk, dv) by the kernel's algebra: P = exp(s - lse), Pd = P * M,
    dV = Pd^T dY, dS = P * (dY V^T * M - rowsum(dY * Y)), dQ = dS K / tau,
    dK = dS^T Q / tau."""
    p = torch.exp(_scores(q, k, tau) - lse[..., None])
    m = (dropout_mask_reference(q.shape[0], q.shape[1], rate, seed, q.device)
         if rate > 0.0 else None)
    pd = p if m is None else p * m
    dpd = torch.matmul(dy, v.transpose(-1, -2))
    if m is not None:
        dpd = dpd * m
    delta = (dy * y).sum(-1, keepdim=True)
    ds = p * (dpd - delta)
    dq = torch.matmul(ds, k) / tau
    dk = torch.matmul(ds.transpose(-1, -2), q) / tau
    dv = torch.matmul(pd.transpose(-1, -2), dy)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels --
def _check(name: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if not (all(t.shape == q.shape for t in ts) and q.dim() == 3):
        raise ValueError(f"{name}: want equal (B, N, D) shapes, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"{name}: want float32 tensors")
    b, n, d = q.shape
    if not (b > 0 and n > 0 and 0 < d <= MAX_D and d % 4 == 0):
        raise ValueError(f"{name}: unsupported shape B={b} N={n} D={d}")


def _kernel_fwd(q, k, v, tau, rate, seed, want_lse):
    global launches
    _check("attention", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, n, d = q.shape
    y = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device) if want_lse else None
    fn = build.function("r3d_attn_fwd", [build.P] * 5 + [build.I] * 3 + [build.F, build.I]
                        + [build.U] * 3 + [build.F, build.P])
    lo, hi = _seed_words(seed)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
                 lse.data_ptr() if want_lse else None, b, n, d, 1.0 / tau,
                 int(rate > 0.0), lo, hi, dropout_threshold(rate), keep_scale(rate),
                 build.stream_ptr(q.device))
    build.check(err, "r3d_attn_fwd")
    launches += 1
    return y, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tau: float,
              rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """softmax(q k^T / tau) [* mask] v; q, k, v (B, N, D) f32 -> (B, N, D)
    f32, forward only."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, tau, rate, seed)
    return _kernel_fwd(q, k, v, tau, rate, seed, want_lse=False)[0]


def attention_fwd(q, k, v, tau: float, rate: float = 0.0, seed: int = 0):
    """(y, lse (B, N) f32), the forward that training saves for the
    backward."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, tau, rate, seed)
    return _kernel_fwd(q, k, v, tau, rate, seed, want_lse=True)


def attention_bwd(q, k, v, y, dy, lse, tau: float, rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of the forward's output cotangent dy."""
    global bwd_launches
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed)
    _check("attention_bwd", q, k, v, y, dy)
    b, n, d = q.shape
    if lse.shape != (b, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"attention_bwd: want a ({b}, {n}) float32 lse on {q.device}")
    q, k, v, y, dy, lse = (t.contiguous() for t in (q, k, v, y, dy, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty((b, n), dtype=torch.float32, device=q.device)
    fn = build.function("r3d_attn_bwd", [build.P] * 10 + [build.I] * 3 + [build.F, build.I]
                        + [build.U] * 3 + [build.F, build.P])
    lo, hi = _seed_words(seed)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), dy.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, n, d, 1.0 / tau, int(rate > 0.0), lo, hi,
                 dropout_threshold(rate), keep_scale(rate), build.stream_ptr(q.device))
    build.check(err, "r3d_attn_bwd")
    bwd_launches += 1
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
        dq, dk, dv = bwd(*ctx.saved_tensors[:4], dy.contiguous(), ctx.saved_tensors[4],
                         tau, rate, seed)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
                    tau: float, rate: float, train: bool, impl: str = "auto") -> torch.Tensor:
    """softmax(q k^T / tau) [dropout] v with the kernels' backward, the
    counterpart of the JAX package's `fused_attention`.  Dropout runs when
    ``train`` and ``rate > 0``, its mask drawn from ``seed``.  impl 'auto'
    takes the kernels on CUDA tensors, 'xla' the plain versions everywhere.
    Without autograd only the forward runs (no lse)."""
    if impl not in ("auto", "xla"):
        raise NotImplementedError(f"attn_impl {impl!r}: the port has 'auto' and 'xla'")
    rate = rate if train else 0.0
    plain = impl == "xla"
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return (attention_reference if plain else attention)(q, k, v, tau, rate, seed)
    return _FusedAttention.apply(q, k, v, seed, tau, rate, plain)
