"""The wide attention kernels emulated on the CPU, and the emulations held
against the port's plain versions and the JAX package's Pallas kernels in
interpret mode: bf16 q, k, v at 64 < D <= 256 on bf16 tensor-core tiles
(`csrc/attention_wide_bf16.cu`) and past 256 in channel groups
(`csrc/attention_group_bf16.cu`); f32 q, k, v past 64 on 3xTF32 tiles in
channel groups of 128 (`csrc/attention_wide.cu`, the last section below).
Inputs are made from seeds with numpy.

The emulation repeats the kernels' arithmetic and order of sums:
- a product of bf16 operands (exact in f32) is summed over k-steps of 16
  (channels in q k^T, keys or queries in P V, dS K, dS^T q), each step's
  16 products summed exactly and rounded to f32 (a mma.sync.m16n8k16 tile),
  the steps added in order in f32;
- the columns of each tile of 64 are cut into S splits of 64 / S columns,
  each split summing its columns in tile order in passes of at most 32,
  and the splits merged in split order (forward: each split's running max
  and sum, then its P V);
- the forward takes two passes: each row's max and sum over all keys, then
  P = exp(s - m) * (1 / l) times the mask, rounded to bf16 before P V;
- the backward: bf16(dY), Delta = rowsum(bf16(dY) * Y), P = exp(s - lse),
  Pd and dS rounded to bf16 before their products, dV and dK in two
  sweeps over the queries (the dK/dV kernel at D > 128 takes at least two
  splits), dK from the unscaled q;
- past D = 256 (`emulate_group_fwd`, `emulate_group_bwd`): the outputs'
  channels in groups of at most 4 tiles of 64 (`group_plan`, as the
  launcher cuts them), each group summing S (and dPd) over all of D in
  chunks of 128 channels (forward) or 64 (backward), k-steps of 16 in
  channel order, with S >= 2 splits (a warp's columns of a tile are one
  pass of at most 32); each group computes its own m, l and P and its
  slice of the outputs.

The f32 emulation (`emulate_f32_fwd`, `emulate_f32_bwd`) repeats the 3xTF32
products (`tf32_ksteps`: per k-step of 8 the terms lo hi, hi lo, hi hi in
that order, in the k-steps' channel order), S and dPd summed over all of D
into one accumulator (the chunks, 64 channels forward and 32 backward,
change no bit), the group plan
(`f32_plan`), the S >= 2 splits of each column tile, the forward's online
softmax per split merged in split order, and dK from the unscaled q; it is
held to the card's f32 gates scaled to D and to the Pallas kernels at the
tuned f32 forms' CPU tolerance (rtol 1e-5, atol 1e-6).

Tolerances: against the plain versions the card's gates
(`chip_smoke.attention_gates`: y within ATTN_BF16_FWD_TOL of the largest
|y|, each gradient within ATTN_BF16_BWD_TOL of its largest entry, both
times sqrt(D / 64); lse within 1e-5): exp and the sums run in another
order, so a P or dS entry at a bf16 rounding boundary may round the other
way.  Against the JAX kernels as `tests/test_torch_f1.py` holds the plain
versions: the forward within ATTN_BF16_FWD_TOL of the largest entry, each
gradient within 2e-2 of its largest entry (the Pallas backward takes
rowsum(dP * P), the port rowsum(dY * Y))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_BF16_BWD_TOL, ATTN_BF16_FWD_TOL, ATTN_F32_BWD_TOL,
                        ATTN_F32_FWD_ATOL, ATTN_F32_FWD_RTOL)
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu_torch.ops import cuda_attention as ca

BF16 = torch.bfloat16
KSTEP = 16      # the k-step of a bf16 mma.sync tile
TILE = 64       # rows of a staged tile
PASS = 32       # columns of a warp's pass over a tile


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def _ksteps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (.., M, K) times b (.., K, N), f32: each k-step's 16 products summed
    exactly and rounded to f32, the steps added in order in f32."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], KSTEP):
        acc = acc + (a[..., k0:k0 + KSTEP].double() @ b[..., k0:k0 + KSTEP, :].double()).float()
    return acc


def _split_columns(n: int, splits: int) -> list:
    """Each split's columns in the order its warps take them: tile by tile,
    the split's 64 / S columns of each tile, cut at n."""
    w = TILE // splits
    return [torch.tensor([c for t0 in range(0, n, TILE) for c in range(t0 + sp * w, t0 + (sp + 1) * w)
                          if c < n]) for sp in range(splits)]


def _passes(idx: torch.Tensor, splits: int):
    """A split's columns in the passes of a warp (at most 32 columns each,
    never across a tile)."""
    w = min(TILE // splits, PASS)
    return [idx[i:i + w] for i in range(0, len(idx), w)]


def _split_sums(a: torch.Tensor, b: torch.Tensor, splits: int) -> torch.Tensor:
    """sum over columns c of a[..., c] b[c]: each split's columns summed in
    its order by k-steps, the splits added in split order."""
    out = None
    for idx in _split_columns(a.shape[-1], splits):
        part = _ksteps(a[..., idx], b[..., idx, :])
        out = part if out is None else out + part
    return out


def _row_stats(s: torch.Tensor, splits: int):
    """Each row's max m and sum l over the scores s (B, N, N): each split's
    running max and sum over its passes, merged in split order."""
    b, n, _ = s.shape
    ms, ls = [], []
    for idx in _split_columns(n, splits):           # 1. each split's running max and sum
        m = torch.full((b, n), -torch.inf)
        l = torch.zeros((b, n))
        for cols in _passes(idx, splits):
            sp = s[..., cols]
            mn = torch.maximum(m, sp.amax(-1))
            l = l * torch.exp(m - mn) + torch.exp(sp - mn[..., None]).sum(-1)
            m = mn
        ms.append(m)
        ls.append(l)
    m = torch.stack(ms).amax(0)                      # merged in split order
    l = torch.zeros((b, n))
    for mi, li in zip(ms, ls):
        l = l + torch.exp(mi - m) * li
    return m, l


def emulate_fwd(q, k, v, tau, rate=0.0, seed=0, splits=2):
    """(y, lse) of the wide forward: bf16 (B, N, D) q, k, v, D a multiple of 8."""
    b, n, _ = q.shape
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    s = _ksteps(qs, k.float().transpose(-1, -2))
    m, l = _row_stats(s, splits)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]   # 2. the normalised P
    if rate > 0.0:
        p = p * ca.dropout_mask_reference(b, n, rate, seed, "cpu")
    return _split_sums(_bf16(p), v.float(), splits), m + torch.log(l)


def emulate_bwd(q, k, v, y, dy, lse, tau, rate=0.0, seed=0, splits=2):
    """(dq, dk, dv) of the wide backward, f32."""
    b, n, d = q.shape
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    dyb = _bf16(dy)
    delta = (dyb * y).sum(-1, keepdim=True)          # the pre-pass
    mask = (ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0
            else torch.ones((b, n, n)))
    pe = torch.exp(_ksteps(qs, k.float().transpose(-1, -2)) - lse[..., None])
    dpd = _ksteps(dyb, v.float().transpose(-1, -2))
    ds = _bf16(pe * (dpd * mask - delta))
    # dK/dV (a warp owns keys; its columns are queries): two sweeps, dV then
    # dK, with the splits its shared memory allows
    kv_splits = max(splits, 2) if d > 2 * TILE else splits
    dv = _split_sums(_bf16(pe * mask).transpose(-1, -2), dyb, kv_splits)
    dk = _split_sums(ds.transpose(-1, -2), q.float(), kv_splits) * (1.0 / tau)
    dq = _split_sums(ds, k.float(), splits) * (1.0 / tau)   # dQ (a warp owns queries)
    return dq, dk, dv


def _inputs(seed, b, n, d):
    rng = np.random.default_rng(seed)
    q, k, v, dy = (torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
                   for _ in range(4))
    return q.to(BF16), k.to(BF16), v.to(BF16), dy


def _emulate_padded(q, k, v, dy, tau, rate, seed, splits):
    """The wrapper's route: D zero-padded to a multiple of 8, the kernels on
    the padded tensors, the outputs sliced back."""
    d = q.shape[-1]
    pad = ca._layout(q)
    assert pad >= 0 and ca._route(q) == "wide_tc"
    qp, kp, vp, dyp = ca._pad(pad, q, k, v, dy)
    y, lse = emulate_fwd(qp, kp, vp, tau, rate, seed, splits)
    grads = emulate_bwd(qp, kp, vp, y, dyp, lse, tau, rate, seed, splits)
    for x in (y, *grads):
        assert not bool(x[..., d:].any())
    return y[..., :d], lse, tuple(x[..., :d] for x in grads)


@pytest.mark.parametrize("d,splits", [(128, 2), (100, 4), (256, 1), (72, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_emulation_matches_plain_versions(d, splits, rate):
    """D = 128, 256, and 100 and 72 through the zero pad (to 104, 72), at
    B = 2 and a ragged N = 100 (two key tiles, the second cut): the
    emulated kernels' y and lse against `attention_fwd_reference`, and
    their gradients against `attention_bwd_reference` from the emulated y
    and lse, all with q scaled as the kernels scale it, within the card's
    gates scaled to D."""
    q, k, v, dy = _inputs(d + splits, 2, 100, d)
    tau = float(d) ** 0.5
    y, lse, grads = _emulate_padded(q, k, v, dy, tau, rate, 7, splits)
    want_y, want_lse = ca.attention_fwd_reference(q, k, v, tau, rate, 7, kernel_scale=True)
    want = ca.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, 7, kernel_scale=True)
    scale = (d / 64) ** 0.5
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert (y - want_y).abs().max() <= ATTN_BF16_FWD_TOL * scale * want_y.abs().max()
    for a, w in zip(grads, want):
        assert (a - w).abs().max() <= ATTN_BF16_BWD_TOL * scale * w.abs().max()


@pytest.mark.parametrize("d", [128, 100, 256])
def test_emulation_matches_pallas_kernels(monkeypatch, d):
    """The emulated kernels against `_attn_fwd_kernel` and `jax.grad`
    through `_attn_bwd_kernel` in interpret mode, bf16, rate 0 (the Pallas
    mask does not run in interpret mode), B = 2, N = 64."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    rng = np.random.default_rng(d)
    xs = [rng.normal(size=(2, 64, d)).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    q, k, v = (torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16) for j in (jq, jk, jv))
    dy = rng.normal(size=(2, 64, d)).astype(np.float32)
    tau = float(d) ** 0.5
    want_y = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention(q, k, v, 0, tau, 0.0, True) * dy)

    want_g = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    y, _, grads = _emulate_padded(q, k, v, torch.from_numpy(dy), tau, 0.0, 0, 2)
    assert np.abs(y.numpy() - want_y).max() <= ATTN_BF16_FWD_TOL * np.abs(want_y).max()
    for a, w in zip(grads, want_g):
        ref = np.asarray(w.astype(jnp.float32))
        got = a.to(BF16).float().numpy()     # cotangents in the primal dtype, as the JAX side
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_rounding_the_normalised_p_matters():
    """The forward rounds the normalised P to bf16, as the TPU kernel does.
    Rounding exp(s - m) before the division instead (what a one-pass online
    softmax rounds) is another function: at B = 2, N = 2048, D = 128 it lies
    about 5x further from the plain version than the emulated kernels do
    (0.93 against 0.18 of the card's forward gate on these inputs)."""
    q, k, v, _ = _inputs(5, 2, 2048, 128)
    tau = 128 ** 0.5
    y, _ = emulate_fwd(q, k, v, tau, splits=2)
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    s = qs @ k.float().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    unnorm = (_bf16(e) @ v.float()) / e.sum(-1, keepdim=True)
    want, _ = ca.attention_fwd_reference(q, k, v, tau, kernel_scale=True)
    bound = ATTN_BF16_FWD_TOL * 2 ** 0.5 * want.abs().max()
    err = (y - want).abs().max()
    assert err <= bound / 4
    assert (unnorm - want).abs().max() > 3 * err


# ------------------------------------------- D > 256: channel groups --
GROUP_TILES = 4   # channel tiles of an output group at most (attention_group_bf16.cu)
FWD_CHUNK = 128   # channels of a forward chunk of the contraction
BWD_CHUNK = 64    # of a backward chunk


def launcher_splits(b: int, n: int, sms: int = 132) -> int:
    """attention.cuh `splits`: the smallest of 1, 2, 4 that starts four
    blocks an SM (an H100 has 132 SMs)."""
    for s in (1, 2):
        if b * -(-n // (TILE // s)) >= 4 * sms:
            return s
    return 4


def group_plan(b: int, n: int, d: int):
    """(groups, group width in channels, splits) as attention_group_bf16.cu's
    `plan` picks them: ceil(tiles / 4) groups of ceil(tiles / groups) tiles,
    the splits over the groups' blocks, at least 2."""
    tiles = -(-d // TILE)
    groups = -(-tiles // GROUP_TILES)
    return groups, TILE * -(-tiles // groups), max(2, launcher_splits(min(b * groups, 1 << 24), n))


def _chunked(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """a (.., M, D) times b (.., D, N) as the grouped kernels sum it: the
    channels in chunks of `chunk` (the last cut at D), each chunk's k-steps
    of 16 added in order into one f32 accumulator."""
    d = a.shape[-1]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c0 in range(0, d, chunk):
        for k0 in range(c0, min(c0 + chunk, d), KSTEP):
            acc = acc + (a[..., k0:k0 + KSTEP].double() @ b[..., k0:k0 + KSTEP, :].double()).float()
    return acc


def _groups(d: int, gw: int):
    return [slice(c0, min(c0 + gw, d)) for c0 in range(0, d, gw)]


def emulate_group_fwd(q, k, v, tau, rate=0.0, seed=0, splits=None):
    """(y, lse, per-group (m, l, P)) of the grouped forward: bf16 (B, N, D)
    q, k, v, D > 256 a multiple of 8.  Each group sums the scores over all
    of D in chunks, takes its own statistics and P, and writes its slice of
    y; lse is group 0's."""
    b, n, d = q.shape
    _, gw, s_ = group_plan(b, n, d)
    s_ = splits or s_
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    mask = ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0 else None
    ys, per_group = [], []
    for sl in _groups(d, gw):
        s = _chunked(qs, k.float().transpose(-1, -2), FWD_CHUNK)
        m, l = _row_stats(s, s_)
        p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
        if mask is not None:
            p = p * mask
        ys.append(_split_sums(_bf16(p), v.float()[..., sl], s_))
        per_group.append((m, l, p))
    m, l, _ = per_group[0]
    return torch.cat(ys, -1), m + torch.log(l), per_group


def emulate_group_bwd(q, k, v, y, dy, lse, tau, rate=0.0, seed=0, splits=None):
    """(dq, dk, dv) of the grouped backward, f32: each group recomputes S
    and dPd over all of D in chunks and writes its slices of dQ, dK, dV
    (dK/dV and dQ take the same splits)."""
    b, n, d = q.shape
    _, gw, s_ = group_plan(b, n, d)
    s_ = splits or s_
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    dyb = _bf16(dy)
    delta = (dyb * y).sum(-1, keepdim=True)          # the pre-pass
    mask = (ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0
            else torch.ones((b, n, n)))
    outs = ([], [], [])
    for sl in _groups(d, gw):
        pe = torch.exp(_chunked(qs, k.float().transpose(-1, -2), BWD_CHUNK) - lse[..., None])
        dpd = _chunked(dyb, v.float().transpose(-1, -2), BWD_CHUNK)
        ds = _bf16(pe * (dpd * mask - delta))
        outs[0].append(_split_sums(ds, k.float()[..., sl], s_) * (1.0 / tau))
        outs[1].append(_split_sums(ds.transpose(-1, -2), q.float()[..., sl], s_) * (1.0 / tau))
        outs[2].append(_split_sums(_bf16(pe * mask).transpose(-1, -2), dyb[..., sl], s_))
    return tuple(torch.cat(o, -1) for o in outs)


def _emulate_group_padded(q, k, v, dy, tau, rate, seed, splits=None):
    """The wrapper's route past D = 256: D zero-padded to a multiple of 8,
    the grouped kernels on the padded tensors, the outputs sliced back."""
    d = q.shape[-1]
    pad = ca._layout(q)
    assert pad >= 0 and ca._route(q) == "wide_group"
    qp, kp, vp, dyp = ca._pad(pad, q, k, v, dy)
    y, lse, _ = emulate_group_fwd(qp, kp, vp, tau, rate, seed, splits)
    grads = emulate_group_bwd(qp, kp, vp, y, dyp, lse, tau, rate, seed, splits)
    for x in (y, *grads):
        assert not bool(x[..., d:].any())
    return y[..., :d], lse, tuple(x[..., :d] for x in grads)


def test_group_plan_cuts_channels_in_groups_of_at_most_four_tiles():
    """The launcher's groups: D = 320 is 3 + 2 tiles, 304 (300 padded) 3 + 2
    with the last cut at 304, 384 3 + 3, 512 4 + 4, 576 3 + 3 + 3; the
    splits at a training step's two calls (N = 2048) are 2 at B = 10 and 4
    at B = 2, and 4 at the tests' N = 100."""
    got = {d: group_plan(10, 2048, d)[:2] for d in (320, 304, 384, 512, 576, 1032)}
    assert got == {320: (2, 192), 304: (2, 192), 384: (2, 192), 512: (2, 256), 576: (3, 192),
                   1032: (5, 256)}
    assert [_groups(d, gw) for d, gw in ((304, 192), (1032, 256))][0] == [slice(0, 192),
                                                                           slice(192, 304)]
    assert all(s.stop - s.start <= GROUP_TILES * TILE for s in _groups(1032, 256))
    assert group_plan(10, 2048, 320)[2] == 2 and group_plan(2, 2048, 320)[2] == 4
    assert group_plan(2, 100, 512)[2] == 4


def test_chunked_contraction_sums_as_one_pass_over_d():
    """Chunks change no bit of the scores: their k-steps run in channel
    order into one accumulator, so S summed in chunks of 128 or 64 channels
    (the last cut at D = 304) is S summed over all of D at once, the sum
    the one-group kernels take."""
    q, k, _, _ = _inputs(3, 2, 100, 304)
    a, b = q.float(), k.float().transpose(-1, -2)
    want = _ksteps(a, b)
    assert torch.equal(_chunked(a, b, FWD_CHUNK), want)
    assert torch.equal(_chunked(a, b, BWD_CHUNK), want)


@pytest.mark.parametrize("d", [320, 304, 512])
def test_groups_take_bit_identical_statistics(d):
    """Every group sums the scores in the same chunk order with the same
    code, so its m, l and P are every other group's bit for bit, and the
    groups' slices of y are what one pass over all channels writes."""
    q, k, v, _ = _inputs(d, 2, 100, d)
    tau = float(d) ** 0.5
    y, lse, per_group = emulate_group_fwd(q, k, v, tau, 0.1, 3)
    assert len(per_group) == 2
    for m, l, p in per_group[1:]:
        assert torch.equal(m, per_group[0][0]) and torch.equal(l, per_group[0][1])
        assert torch.equal(p, per_group[0][2])
    p = per_group[0][2]
    assert torch.equal(y, _split_sums(_bf16(p), v.float(), group_plan(2, 100, d)[2]))


@pytest.mark.parametrize("d,splits", [(320, None), (300, None), (384, None), (512, None),
                                      (320, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_group_emulation_matches_plain_versions(d, splits, rate):
    """D = 320, 384, 512 and 300 through the zero pad (to 304), at B = 2 and
    a ragged N = 100, with the splits the launcher picks there (4) and, at
    D = 320, those it picks at a training step's B = 10 (2): the emulated
    grouped kernels' y and lse against `attention_fwd_reference`, their
    gradients against `attention_bwd_reference` from the emulated y and
    lse, q scaled as the kernels scale it, within the card's gates scaled
    to D."""
    q, k, v, dy = _inputs(d + (splits or 0), 2, 100, d)
    tau = float(d) ** 0.5
    y, lse, grads = _emulate_group_padded(q, k, v, dy, tau, rate, 7, splits)
    want_y, want_lse = ca.attention_fwd_reference(q, k, v, tau, rate, 7, kernel_scale=True)
    want = ca.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, 7, kernel_scale=True)
    scale = (d / 64) ** 0.5
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert (y - want_y).abs().max() <= ATTN_BF16_FWD_TOL * scale * want_y.abs().max()
    for a, w in zip(grads, want):
        assert (a - w).abs().max() <= ATTN_BF16_BWD_TOL * scale * w.abs().max()


def test_group_emulation_matches_pallas_kernels(monkeypatch):
    """The emulated grouped kernels at D = 320 against `_attn_fwd_kernel` and
    `jax.grad` through `_attn_bwd_kernel` in interpret mode, bf16, rate 0,
    B = 2, N = 256; tolerances as for the one-group kernels."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    d, n = 320, 256
    rng = np.random.default_rng(d)
    xs = [rng.normal(size=(2, n, d)).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    q, k, v = (torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16) for j in (jq, jk, jv))
    dy = rng.normal(size=(2, n, d)).astype(np.float32)
    tau = float(d) ** 0.5
    want_y = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention(q, k, v, 0, tau, 0.0, True) * dy)

    want_g = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    y, _, grads = _emulate_group_padded(q, k, v, torch.from_numpy(dy), tau, 0.0, 0)
    assert np.abs(y.numpy() - want_y).max() <= ATTN_BF16_FWD_TOL * np.abs(want_y).max()
    for a, w in zip(grads, want_g):
        ref = np.asarray(w.astype(jnp.float32))
        got = a.to(BF16).float().numpy()     # cotangents in the primal dtype, as the JAX side
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


# ----------------------------------- f32 past D = 64: 3xTF32 in groups --
# `csrc/attention_wide.cu`: every product a 3xTF32 mma.sync.m16n8k8 (each
# operand split into tf32 hi and lo; per k-step of 8 the terms lo hi, hi
# lo, hi hi added in that order), the contraction over D summed in chunks
# (64 channels in the forward, 32 in the backward) into one accumulator,
# the outputs' channels in groups of at most 128, S >= 2 splits of each
# 64-row column tile.
TF32_KSTEP = 8     # the k-step of a tf32 mma.sync tile
F32_CHUNKS = (64, 32)   # channels of a contraction chunk (kFwdCh, kBwdCh)
F32_GROUP = 128    # channels of an output group at most (kGroupW)
F32_BWD_SPLITS = 2  # the backward's splits (kBwdSplits)
F32_FWD_RTOL, F32_FWD_ATOL = ATTN_F32_FWD_RTOL, ATTN_F32_FWD_ATOL


def _channel_order(d: int) -> torch.Tensor:
    """The channels in the order the kernels' k-steps take them: within
    each 16, k-step 2kk takes channels 4t and 4t + 1 of t = 0..3, k-step 2kk +
    1 channels 4t + 2 and 4t + 3 (one float4 a lane feeds both;
    attention.cuh's layout note)."""
    base = [4 * t + 2 * h + e for h in (0, 1) for t in range(4) for e in (0, 1)]
    return torch.tensor([c0 + c for c0 in range(0, d, 16) for c in base])


def tf32_ksteps(a: torch.Tensor, b: torch.Tensor, acc=None, passes: int = 3) -> torch.Tensor:
    """acc + a (.., M, K) b (.., K, N) as the kernels' mma.sync tiles add it,
    K a multiple of 8: each operand split into tf32 hi and lo
    (`cuda_attention.split_tf32`, a function of the value alone, so a tile
    split once in shared memory and an entry split as it is loaded give the
    same halves), each k-step of 8 adding its terms lo hi, hi lo, hi hi in
    that order, each term's 8 products (exact in f32) summed exactly and
    rounded to f32; ``passes`` 1: the hi hi term alone."""
    ah, al = ca.split_tf32(a.contiguous())
    bh, bl = ca.split_tf32(b.contiguous())
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k0 in range(0, a.shape[-1], TF32_KSTEP):
        for x, y in terms:
            out = out + (x[..., k0:k0 + TF32_KSTEP].double()
                         @ y[..., k0:k0 + TF32_KSTEP, :].double()).float()
    return out


def f32_scores(q, k, scale, passes=3):
    """S = (q * scale) k^T summed over D in the kernels' channel order
    (zero channels to a multiple of 16 add nothing).  The kernels' chunks
    change no bit (`test_f32_chunked_contraction_sums_as_one_pass`).  The
    dK/dV kernel takes S^T = k (q * scale)^T with the
    operands' roles swapped and the terms ordered to match (kBLoFirst), so
    its scores are these, transposed."""
    d = q.shape[-1]
    pad = -d % 16
    qs = torch.nn.functional.pad(q * scale, (0, pad))
    kp = torch.nn.functional.pad(k, (0, pad))
    order = _channel_order(d + pad)
    return tf32_ksteps(qs[..., order], kp[..., order].transpose(-1, -2), passes=passes)


def f32_plan(b: int, n: int, d: int):
    """(groups, the forward's splits) as attention_wide.cu's `plan` picks
    them: ceil(D / 128) groups, the splits over the groups' blocks, at
    least 2.  The backward takes F32_BWD_SPLITS."""
    groups = -(-d // F32_GROUP)
    return groups, max(2, launcher_splits(min(b * groups, 1 << 24), n))


def _split_tiles(n: int, splits: int):
    """Each split's columns tile by tile: [(tile, columns)] in order."""
    w = TILE // splits
    return [[torch.arange(t0 + sp * w, min(t0 + (sp + 1) * w, n)) for t0 in range(0, n, TILE)
             if t0 + sp * w < n] for sp in range(splits)]


def _split_products(a, b, splits, passes=3):
    """sum over columns c of a[..., c] b[c] as the kernels' accumulators
    take it: each split's columns tile by tile in k-steps of 8 (a ragged
    tile's columns past n are zeros), the splits' sums added in split
    order."""
    out = None
    for cols in _split_tiles(a.shape[-1], splits):
        part = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for c in cols:
            pad = -len(c) % TF32_KSTEP
            part = tf32_ksteps(torch.nn.functional.pad(a[..., c], (0, pad)),
                               torch.nn.functional.pad(b[..., c, :], (0, 0, 0, pad)), part,
                               passes)
        out = part if out is None else out + part
    return out


def emulate_f32_fwd(q, k, v, tau, rate=0.0, seed=0, splits=None, passes=3, group=F32_GROUP):
    """(y, lse, per-group (m, l, P)) of the f32 wide forward: (B, N, D) f32
    q, k, v, D > 64 a multiple of 4, groups of ``group`` channels (the
    launcher's 128).  Each group sums S over all of D, runs
    the tuned forward's online softmax per split (a running max m, the sum
    l of exp(s - m) and the output o rescaled by exp(m_old - m) at each
    tile, o accumulating P * mask V tile by tile), the splits merged in
    split order, and writes its slice of y = o / l; lse is group 0's."""
    b, n, d = q.shape
    _, s_ = f32_plan(b, n, d)
    s_ = splits or s_
    scale = float(np.float32(1.0 / tau))
    mask = ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0 else None
    ys, per_group = [], []
    for sl in _groups(d, group):
        s = f32_scores(q, k, scale, passes)
        parts = []
        for cols in _split_tiles(n, s_):
            m = torch.full((b, n), -torch.inf)
            l = torch.zeros((b, n))
            o = torch.zeros((b, n, sl.stop - sl.start))
            for c in cols:
                mx = torch.maximum(m, s[..., c].amax(-1))
                f = torch.where(torch.isinf(m), torch.zeros(()), torch.exp(m - mx))
                p = torch.exp(s[..., c] - mx[..., None])
                l = l * f + p.sum(-1)
                if mask is not None:
                    p = p * mask[..., c]
                pad = -len(c) % TF32_KSTEP
                o = tf32_ksteps(torch.nn.functional.pad(p, (0, pad)),
                                torch.nn.functional.pad(v[..., c, sl], (0, 0, 0, pad)),
                                o * f[..., None], passes)
                m = mx
            parts.append((m, l, o))
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        l = torch.zeros((b, n))
        o = torch.zeros_like(parts[0][2])
        for m_i, l_i, o_i in parts:               # merged in split order
            f = torch.exp(m_i - mm)
            l = l + f * l_i
            o = o + f[..., None] * o_i
        ys.append(o / l[..., None])
        per_group.append((mm, l, torch.exp(s - mm[..., None]) / l[..., None]))
    m, l, _ = per_group[0]
    return torch.cat(ys, -1), m + torch.log(l), per_group


def emulate_f32_bwd(q, k, v, y, dy, lse, tau, rate=0.0, seed=0, splits=None, passes=3):
    """(dq, dk, dv) of the f32 wide backward: Delta = rowsum(dY * Y), P =
    exp(s - lse), dPd = dY V^T summed over D as S is, dS = P (dPd * M -
    Delta); each group's slices of dV = Pd^T dY and dK = dS^T q * scale
    (the unscaled q; the dK/dV blocks' splits over the queries) and of dQ
    = dS K * scale (the dQ blocks' over the keys), F32_BWD_SPLITS splits
    unless ``splits`` says otherwise."""
    b, n, d = q.shape
    s_ = splits or F32_BWD_SPLITS
    scale = float(np.float32(1.0 / tau))
    delta = (dy * y).sum(-1, keepdim=True)
    mask = (ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0
            else torch.ones((b, n, n)))
    ones = torch.ones(())
    outs = ([], [], [])
    for sl in _groups(d, F32_GROUP):
        p = torch.exp(f32_scores(q, k, scale, passes) - lse[..., None])
        dpd = f32_scores(dy, v, 1.0, passes)
        ds = p * (dpd * mask - delta)
        outs[0].append(_split_products(ds, k[..., sl], s_, passes) * scale)
        outs[1].append(_split_products(ds.transpose(-1, -2), q[..., sl], s_, passes) * scale)
        outs[2].append(_split_products((p * mask).transpose(-1, -2), dy[..., sl], s_, passes)
                       * ones)
    return tuple(torch.cat(o, -1) for o in outs)


def _f32_inputs(seed, b, n, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)) for _ in range(4)]


def _emulate_f32_padded(q, k, v, dy, tau, rate, seed, passes=3):
    """The wrapper's f32 route past D = 64: D zero-padded to a multiple of
    4, the kernels on the padded tensors (with the launcher's splits), the
    outputs sliced back."""
    d = q.shape[-1]
    pad = ca._layout(q)
    assert pad == -d % 4 and ca._route(q) == "wide_tf32"
    qp, kp, vp, dyp = ca._pad(pad, q, k, v, dy)
    y, lse, _ = emulate_f32_fwd(qp, kp, vp, tau, rate, seed, passes=passes)
    grads = emulate_f32_bwd(qp, kp, vp, y, dyp, lse, tau, rate, seed, passes=passes)
    for x in (y, *grads):
        assert not bool(x[..., d:].any())
    return y[..., :d], lse, tuple(x[..., :d] for x in grads)


def _f32_gate_shares(q, k, v, dy, tau, rate, seed, y, lse, grads):
    """Each error as a share of the card's f32 gates scaled to D
    (`chip_smoke.attention_gates`): y within ATTN_F32_FWD_RTOL |y| +
    ATTN_F32_FWD_ATOL, each gradient within ATTN_F32_BWD_TOL of its largest
    entry, both times sqrt(D / 64); lse within 1e-5.  The references are
    the plain versions, the backward's from the emulated y and lse."""
    scale = (q.shape[-1] / 64) ** 0.5
    want_y, want_lse = ca.attention_fwd_reference(q, k, v, tau, rate, seed, kernel_scale=True)
    want = ca.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed, kernel_scale=True)
    out = {"lse": ((lse - want_lse).abs() / (1e-5 + 1e-5 * want_lse.abs())).max().item(),
           "y": ((y - want_y).abs() / (scale * (F32_FWD_ATOL + F32_FWD_RTOL * want_y.abs())))
           .max().item()}
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        out[name] = ((a - w).abs().max() / (ATTN_F32_BWD_TOL * scale * w.abs().max())).item()
    return out


def test_f32_route_layout_and_plan():
    """Every f32 D > 64 takes the 3xTF32 route, an unaligned one after the
    zero pad to a multiple of 4 (65 to 68, 130 to 132), in ceil(D / 128)
    groups; D <= 64 the tuned kernels.  The forward's splits at a training
    step's two calls (N = 2048): 2 at B = 10 and 4 at B = 2; at B = 4, 4
    for D = 128 and 2 for D = 512 (four groups' blocks)."""
    for d in range(1, 1100):
        x = torch.zeros((1, 1, d))
        pad = ca._layout(x)
        assert pad == -d % 4
        assert ca._route(x) == ("tuned" if d <= 64 else "wide_tf32"), d
    assert [f32_plan(10, 2048, d)[0] for d in (68, 128, 132, 256, 260, 320, 512)] == \
        [1, 1, 2, 2, 3, 3, 4]
    assert [f32_plan(b, 2048, 128)[1] for b in (10, 2)] == [2, 4]
    assert [f32_plan(4, 2048, d)[1] for d in (128, 512)] == [4, 2]
    assert f32_plan(2, 100, 320)[1] == 4
    assert _groups(320, F32_GROUP) == [slice(0, 128), slice(128, 256), slice(256, 320)]


def test_f32_channel_order_is_a_permutation_within_16():
    """The k-steps' channel order permutes channels only within each 16
    (so a chunk of 32 holds whole k-steps), and S summed in that order
    differs from S summed in channel order only by rounding."""
    order = _channel_order(64)
    assert sorted(order.tolist()) == list(range(64))
    assert all(set(order[i:i + 16].tolist()) == set(range(i, i + 16)) for i in range(0, 64, 16))
    q, k, _, _ = _f32_inputs(1, 2, 40, 96)
    s = f32_scores(q, k, 0.125)
    torch.testing.assert_close(s, (q * 0.125) @ k.transpose(-1, -2), rtol=1e-5, atol=1e-5)


def test_f32_chunked_contraction_sums_as_one_pass():
    """Chunks change no bit of the scores: a chunk holds whole 16-channel
    blocks of the k-steps' order, zeros past D, and its k-steps run in
    channel order into the one accumulator, so S summed in chunks of 64
    (forward) or 32 (backward) channels, the last cut at D = 132, is S
    summed over all of D at once."""
    d = 132
    q, k, _, _ = _f32_inputs(4, 2, 40, d)
    want = f32_scores(q, k, 0.125)
    for chunk in F32_CHUNKS:
        acc = None
        for c0 in range(0, d, chunk):
            w = min(chunk, d - c0)
            pad = -w % 16
            a = torch.nn.functional.pad(q[..., c0:c0 + w] * 0.125, (0, pad))
            b = torch.nn.functional.pad(k[..., c0:c0 + w], (0, pad))
            order = _channel_order(w + pad)
            acc = tf32_ksteps(a[..., order], b[..., order].transpose(-1, -2), acc)
        assert torch.equal(acc, want), chunk


@pytest.mark.parametrize("d", [128, 100, 130, 192, 320])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_emulation_matches_plain_versions(d, rate):
    """D = 128, 100 (one group short of 128), 130 (through the zero pad to
    132: two groups, 128 + 4), 192 (128 + 64) and 320 (128 + 128 + 64), at
    B = 2 and a ragged N = 100 (two column tiles, the second cut; the
    forward's 4 splits, as the launcher picks there, and the backward's
    2): the emulated kernels' y and lse against
    `attention_fwd_reference`, their gradients against
    `attention_bwd_reference` from the emulated y and lse, within the
    card's f32 gates scaled to D (`_f32_gate_shares`)."""
    q, k, v, dy = _f32_inputs(d, 2, 100, d)
    tau = float(d) ** 0.5
    y, lse, grads = _emulate_f32_padded(q, k, v, dy, tau, rate, 7)
    shares = _f32_gate_shares(q, k, v, dy, tau, rate, 7, y, lse, grads)
    assert max(shares.values()) <= 1.0, shares


def test_f32_emulation_at_two_splits_matches_plain_versions():
    """The forward's splits at a training step's B = 10 (2), at D = 128
    with dropout, and the backward at 4: within the same gates."""
    q, k, v, dy = _f32_inputs(2, 2, 100, 128)
    tau = 128 ** 0.5
    y, lse, _ = emulate_f32_fwd(q, k, v, tau, 0.1, 5, splits=2)
    grads = emulate_f32_bwd(q, k, v, y, dy, lse, tau, 0.1, 5, splits=4)
    shares = _f32_gate_shares(q, k, v, dy, tau, 0.1, 5, y, lse, grads)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("d", [128, 100])
def test_f32_emulation_matches_pallas_kernels(monkeypatch, d):
    """The emulated kernels against `_attn_fwd_kernel` and `jax.grad`
    through `_attn_bwd_kernel` in interpret mode (f32 at Precision.HIGHEST),
    rate 0 (the Pallas mask does not run in interpret mode), B = 2, N = 64,
    as `tests/test_torch_f1.py` holds the plain versions: rtol 1e-5, atol
    1e-6 (3xTF32 keeps about 22 bits of each operand)."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    rng = np.random.default_rng(d + 1)
    xs = [rng.normal(size=(2, 64, d)).astype(np.float32) for _ in range(4)]
    tau = float(d) ** 0.5
    jq, jk, jv = (jnp.asarray(x) for x in xs[:3])
    want_y = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention(q, k, v, 0, tau, 0.0, True) * xs[3])

    want_g = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    y, _, grads = _emulate_f32_padded(*map(torch.from_numpy, xs), tau, 0.0, 0)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-6)
    for a, w in zip(grads, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [192, 320, 512])
def test_f32_groups_take_bit_identical_statistics(d):
    """Every group sums the scores over all of D in the same chunk order
    with the same code, so its m, l and P are every other group's bit for
    bit, and the groups' slices of y are what one group over all channels
    writes."""
    q, k, v, _ = _f32_inputs(d, 2, 100, d)
    tau = float(d) ** 0.5
    y, lse, per_group = emulate_f32_fwd(q, k, v, tau, 0.1, 3)
    assert len(per_group) == -(-d // F32_GROUP) >= 2
    for m, l, p in per_group[1:]:
        assert torch.equal(m, per_group[0][0]) and torch.equal(l, per_group[0][1])
        assert torch.equal(p, per_group[0][2])
    y1, lse1, _ = emulate_f32_fwd(q, k, v, tau, 0.1, 3, group=d)   # one group, every channel
    assert torch.equal(y, y1) and torch.equal(lse, lse1)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_1xtf32_products_miss_the_gates_at_d128(rate):
    """Why three passes at D = 128 too: the same kernels with one tf32 pass
    a product (q, k, v, P and dS rounded to 11 bits) miss the card's f32
    gates by far, where three passes meet them."""
    q, k, v, dy = _f32_inputs(11, 2, 100, 128)
    tau = 128 ** 0.5
    one = _f32_gate_shares(q, k, v, dy, tau, rate, 7,
                           *_emulate_f32_padded(q, k, v, dy, tau, rate, 7, passes=1))
    three = _f32_gate_shares(q, k, v, dy, tau, rate, 7,
                             *_emulate_f32_padded(q, k, v, dy, tau, rate, 7))
    assert max(three.values()) <= 1.0 < 2.0 < max(one.values()), (one, three)
