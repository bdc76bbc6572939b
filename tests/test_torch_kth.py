"""Port per-row k-th distance (`ops/cuda_kth.py`) vs the JAX package's
`kth_smallest_per_row_pallas` in interpret mode: BIT-EQUAL, on f32 input
and on the bf16 compare copy of the bf16 episode graph (upcast to f32 in
both, sentinel rounded to bf16 in both); and the kernel's design
(`csrc/kth.cu`: order-preserving keys, radix select, the bisection replayed
on the k-th value) emulated on the bits with numpy, bit-equal to both on
rows that break naive selects."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from r3dfsseg_tpu.ops.lp import _BIG as JAX_BIG
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu_torch.ops import cuda_kth


def _distances(seed, n, m):
    d = np.random.default_rng(seed).uniform(0.1, 9.0, size=(n, m)).astype(np.float32)
    d[np.arange(min(n, m)), np.arange(min(n, m))] = JAX_BIG     # self
    d[:, -4:] = JAX_BIG                                          # invalid columns
    d[0] = JAX_BIG                                               # a row with no neighbour
    d[1, :9] = 2.5                                               # exact ties at the radius
    return d


def test_sentinel_matches_jax():
    assert cuda_kth.SENTINEL == JAX_BIG


@pytest.mark.parametrize("n,m,k,iters", [(96, 96, 7, 32), (40, 72, 9, 16), (64, 64, 3, 32)])
def test_kth_bit_equals_pallas_interpret(n, m, k, iters):
    d = _distances(n + k, n, m)
    want = np.asarray(kth_smallest_per_row_pallas(jnp.asarray(d), k, iters=iters, tile_n=8,
                                                  interpret=True))
    got = cuda_kth.kth_smallest_per_row(torch.from_numpy(d), k, iters).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))



@pytest.mark.parametrize("n,m,k", [(96, 96, 7), (40, 72, 9)])
def test_kth_bf16_bit_equals_pallas_interpret(n, m, k):
    """16 steps on a bf16 input, as the bf16 graph runs them."""
    d = jnp.asarray(_distances(2 * n + k, n, m)).astype(jnp.bfloat16)
    want = np.asarray(kth_smallest_per_row_pallas(d, k, iters=16, tile_n=8, interpret=True))
    td = torch.from_numpy(np.array(d.astype(jnp.float32))).to(torch.bfloat16)
    got = cuda_kth.kth_smallest_per_row(td, k, 16).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---- csrc/kth.cu's design emulated on the bits: keys, radix select, replay
BITS, CAP = 8, 128                  # kth.cu kBits, kCap
FINITE = np.float32(0.5) * np.float32(1e30)


def _keys(bits, bf16):
    """Order-preserving keys of f32 bits, or of bf16 bits (16-bit keys)."""
    sign, full = (np.uint32(0x8000), np.uint32(0xFFFF)) if bf16 else \
        (np.uint32(0x80000000), np.uint32(0xFFFFFFFF))
    return np.where(bits & sign, ~bits & full, bits | sign).astype(np.uint32)


def _unkey(key, bf16):
    sign, full = (0x8000, 0xFFFF) if bf16 else (0x80000000, 0xFFFFFFFF)
    bits = key & (sign - 1) if key & sign else ~key & full
    return np.array([bits << 16 if bf16 else bits], np.uint32).view(np.float32)[0]


def _select(bits, values, k, bf16):
    """(v_k, route, passes): the kernel's select on one row."""
    key = _keys(bits, bf16)[values < FINITE]
    if k <= 0:
        return np.float32(-np.inf), "none", 0
    if k > key.size:
        return np.float32(np.inf), "none", 0
    lo, span, rank, live, passes = int(key.min()), int(key.max() - key.min()), k, key.size, 0
    off = key.astype(np.int64)
    while span != 0 and live > CAP:
        shift = max(span.bit_length() - BITS, 0)
        inr = (off - lo >= 0) & (off - lo <= span)
        hist = np.bincount((off[inr] - lo) >> shift, minlength=1 << BITS)
        incl = np.cumsum(hist)
        b = int(np.argmax(incl >= rank))                # the bucket holding rank
        rank, live = rank - int(incl[b] - hist[b]), int(hist[b])
        lo += b << shift
        span = min(span - (b << shift), (1 << shift) - 1)
        passes += 1
    if span == 0:
        return _unkey(lo, bf16), "tie", passes
    cand = key[(off - lo >= 0) & (off - lo <= span)]
    assert cand.size == live <= CAP
    # each candidate's rank: entries below it, then equal ones before it
    j = np.arange(live)
    below = (cand[None, :] < cand[:, None]).sum(1) + \
        ((cand[None, :] == cand[:, None]) & (j[None, :] < j[:, None])).sum(1)
    assert sorted(below) == list(j)
    return _unkey(int(cand[below == rank - 1][0]), bf16), "direct", passes


def _replay(vk, values, k, iters):
    fin = values[values < FINITE]
    hi = max(np.float32(fin.max()) if fin.size else np.float32(0), np.float32(0))
    hi, lo, half = max(hi, np.float32(1e-6)), np.float32(0), np.float32(0.5)
    for _ in range(iters):
        mid = half * (lo + hi)
        lo, hi = (lo, mid) if vk <= mid else (mid, hi)
    return hi


def emulate_kth(d, k, iters, bf16):
    """csrc/kth.cu on the CPU: d (R, M) f32 values (bf16-exact when bf16)
    -> ((R, 1) f32, each row's (route, passes))."""
    bits = d.view(np.uint32) >> 16 if bf16 else d.view(np.uint32)
    out, routes = np.empty((len(d), 1), np.float32), []
    for r in range(len(d)):
        vk, route, passes = _select(bits[r], d[r], k, bf16)
        out[r, 0] = _replay(vk, d[r], k, iters)
        routes.append((route, passes))
    return out, routes


# the select's routes on each kind's rows at m = 1003, f32 then bf16: ranked
# directly among <= CAP entries after this many passes, a single key (ties),
# or no v_k
_D1, _NONE = {("direct", 1)}, {("none", 0)}
ROUTES = {"uniform": (_D1, _D1), "ties_at_radius": (_D1, _D1),
          "ties_over_cap": ({("tie", 4)}, {("tie", 2)}), "sentinels_only": (_NONE, _NONE),
          "few_finite": (_NONE, _NONE), "k_is_0": (_NONE, _NONE), "k_is_1": (_D1, _D1),
          "k_is_m": (_D1, _D1 | {("tie", 1)}), "special_values": (_D1, _D1),
          "midpoint": (_D1, _D1), "wide_cluster": ({("direct", 3)}, {("tie", 2)}),
          "all_equal": ({("tie", 0)}, {("tie", 0)})}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", chip_smoke.KTH_KINDS)
def test_select_and_replay_emulation_bit_equals_pallas(kind, dtype):
    """The kernel's design (order-preserving keys, radix passes over the
    live key range, the direct rank, the bisection replayed on v_k) bit for
    bit against the plain version and the Pallas kernel in interpret mode,
    on rows that break naive selects, at a ragged m; bf16 with 16 steps."""
    bf16, iters = dtype == "bfloat16", 32 if dtype == "float32" else 16
    d, k = chip_smoke.kth_rows(kind, 8, 1003, seed=len(kind))
    td = torch.from_numpy(d)
    if bf16:
        td = td.to(torch.bfloat16)
        d = td.float().numpy()
    got, routes = emulate_kth(d, k, iters, bf16)
    jd = jnp.asarray(d).astype(jnp.bfloat16) if bf16 else jnp.asarray(d)
    want = np.asarray(kth_smallest_per_row_pallas(jd, k, iters=iters, tile_n=8, interpret=True))
    plain = cuda_kth.kth_smallest_per_row_reference(td, k, iters).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert set(routes) <= ROUTES[kind][bf16], routes
