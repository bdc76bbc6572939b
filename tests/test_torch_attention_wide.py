"""The wide bf16 attention kernels (`csrc/attention_wide_bf16.cu`: bf16 q, k,
v at 64 < D <= 256 on bf16 tensor-core tiles) emulated on the CPU, and the
emulation held against the port's plain versions and the JAX package's
Pallas kernels in interpret mode.  Inputs are made from seeds with numpy.

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
  splits: its shared memory), dK from the unscaled q.

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

from chip_smoke import ATTN_BF16_BWD_TOL, ATTN_BF16_FWD_TOL
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


def emulate_fwd(q, k, v, tau, rate=0.0, seed=0, splits=2):
    """(y, lse) of the wide forward: bf16 (B, N, D) q, k, v, D a multiple of 8."""
    b, n, _ = q.shape
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    s = _ksteps(qs, k.float().transpose(-1, -2))
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
