"""Kernel 6's plain pieces (`ops/cuda_scatter.py`): the inverse graph the
kernel builds (`inverse_graph_reference`), the kernel's order of sums
(`scatter_add_ordered_reference`), and CPU emulations of the kernels'
builds (the narrow one: per-warp histograms, a scan, the fill in batches
of 32 ranked by target; the general kernel's wide one: stable LSD radix
passes over the target's bits, the same fill on digits, records placed by
binary searches) and of the sum phase over their piece records, held
against `index_add_`, the JAX package's exact `_scatter_exact` (segment
sum) and its Pallas `_scatter_kernel` in interpret mode.

g is made bf16-representable, so the Pallas kernel's bf16 rounding of g is
exact and every version is the same f32 sum in some order: rtol 1e-6, atol
1e-6 of values of order 1.  Ids outside [0, N) are dropped by the kernel,
by the Pallas kernel (its one-hot tile has no column for them) and by
segment_sum where they fall outside every cloud's segment (B = 1)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops import fast_gather as jax_fg
from r3dfsseg_tpu_torch.ops import cuda_scatter
from test_torch_gather import _jax_scatter_kernel as jax_scatter_kernel


MAX_BITS = 11                # csrc/scatter_general.cu kMaxBits: a radix pass's digit bits
WIDE_ROWS = 16 * 512         # csrc/scatter_general.cu kWideRows: a wide unit's elements


def radix_plan(n: int, m: int, b: int, sms: int) -> tuple[int, int, int]:
    """The general kernel's wide build (`csrc/scatter_general.cu:wide_plan`)
    for n targets, M rows a cloud, B clouds on `sms` SMs: (passes, digit
    bits, units of a cloud).  The keys [0, n) take kb bits, cut into
    ceil(kb / MAX_BITS) passes of equal bits; the units are a multiple of
    SMs / B with at most WIDE_ROWS elements each."""
    kb = max(1, (n - 1).bit_length())
    passes = -(-kb // MAX_BITS)
    per = max(1, sms // b)
    return passes, -(-kb // passes), per * max(1, -(-m // (WIDE_ROWS * per)))


def _case(seed, b, nq, k, c, n, hub=3, bad=0):
    """g (B, NQ, K, C) bf16-representable, idx with a hub every row's first
    neighbour points at and `bad` ids per cloud outside [0, n)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, nq, k, c)).astype(np.float32)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, n, size=(b, nq, k)).astype(np.int32)
    idx[:, :, 0] = hub
    for cb in range(b):
        flat = idx[cb].reshape(-1)
        at = rng.choice(flat.size, size=bad, replace=False)
        flat[at] = rng.choice([-1, -7, n, n + 5], size=bad)
    return g, idx


def _emulate_build(idx, n, units, hw):
    """The kernel's build for one cloud, step by step in numpy: the rows cut
    into `units` contiguous units, each counted per target; per target, each
    unit's start and the offsets; then in each unit, warp w < hw owns rows
    [w r / hw, (w + 1) r / hw) of its r rows, counts them into its histogram
    row, and fills them 32 at a time, a lane ranked among the earlier lanes
    of its batch with the same target.  Returns perm (valid rows first)."""
    m = idx.size
    ok = (idx >= 0) & (idx < n)
    cuts = [u * m // units for u in range(units + 1)]
    cnt = np.zeros((units, n), np.int64)
    for u in range(units):
        lo, hi = cuts[u], cuts[u + 1]
        np.add.at(cnt[u], idx[lo:hi][ok[lo:hi]], 1)
    tot = cnt.sum(0)
    unit_start = np.cumsum(cnt, axis=0) - cnt + (np.cumsum(tot) - tot)[None, :]
    perm = np.full(m, -1, np.int64)
    for u in range(units):
        lo, hi = cuts[u], cuts[u + 1]
        ranges = [(lo + w * (hi - lo) // hw, lo + (w + 1) * (hi - lo) // hw) for w in range(hw)]
        hist = np.zeros((hw, n), np.int64)
        for w, (a, b) in enumerate(ranges):
            np.add.at(hist[w], idx[a:b][ok[a:b]], 1)
        pos = np.cumsum(hist, axis=0) - hist + unit_start[u][None, :]
        for w, (a, b) in enumerate(ranges):
            for r0 in range(a, b, 32):
                batch = [(r, int(idx[r])) for r in range(r0, min(r0 + 32, b)) if ok[r]]
                for lane, (r, j) in enumerate(batch):
                    rank = sum(1 for _, jj in batch[:lane] if jj == j)
                    perm[pos[w, j] + rank] = r
                for j in {j for _, j in batch}:
                    pos[w, j] += sum(1 for _, jj in batch if jj == j)
    return perm


def _narrow_warps(n):
    """csrc/scatter.cuh:narrow_warps: the (n,) histogram rows that fit in
    shared memory (232448 bytes) beside the scan's n + 96 ints, at most 16."""
    return max(0, min(16, (232448 - 4 * (n + 96)) // (4 * n)))


def _pieces(rows):
    return np.where(rows > cuda_scatter.PIECE, -(-rows // cuda_scatter.PIECE), 1)


def _place(keys, rows, digit, units):
    """One pass of the placing: the elements (keys, rows; key -1 dropped),
    in order, cut into `units` units; each unit's digit counts; per digit
    each unit's start, as `unit_starts` takes it (lane l sums a run of
    units, the runs scanned across 32 lanes); the digits' bases; then in
    each unit warp w < hw owns a run of its elements, counts them into its
    histogram row and places them 32 at a time, a lane ranked among the
    earlier lanes of its batch with the same digit."""
    size = len(keys)
    d_of = np.where(keys >= 0, digit(keys), -1)
    digits = int(d_of.max(initial=0)) + 1
    cuts = [u * size // units for u in range(units + 1)]
    cnt = np.zeros((units, digits), np.int64)
    for u in range(units):
        d = d_of[cuts[u]:cuts[u + 1]]
        np.add.at(cnt[u], d[d >= 0], 1)
    starts = np.zeros_like(cnt)
    runs = [(lane * units // 32, (lane + 1) * units // 32) for lane in range(32)]
    sums = np.array([cnt[g0:g1].sum(0) for g0, g1 in runs])
    lane_base = np.cumsum(sums, 0) - sums
    for (g0, g1), base in zip(runs, lane_base):
        starts[g0:g1] = base + np.cumsum(cnt[g0:g1], 0) - cnt[g0:g1]
    tot = cnt.sum(0)
    base = np.cumsum(tot) - tot
    out_k = np.full(int(tot.sum()), -1, np.int64)
    out_r = np.full(int(tot.sum()), -1, np.int64)
    for u in range(units):
        lo, hi = cuts[u], cuts[u + 1]
        hw = min(16, max(1, (hi - lo) // 128))
        ranges = [(lo + w * (hi - lo) // hw, lo + (w + 1) * (hi - lo) // hw) for w in range(hw)]
        hist = np.zeros((hw, digits), np.int64)
        for w, (a, b) in enumerate(ranges):
            d = d_of[a:b]
            np.add.at(hist[w], d[d >= 0], 1)
        pos = np.cumsum(hist, 0) - hist + base + starts[u]
        for w, (a, b) in enumerate(ranges):
            h = pos[w]
            for e0 in range(a, b, 32):
                d = d_of[e0:min(e0 + 32, b)]
                ok = d >= 0
                rank = ((d[:, None] == d[None, :]) & np.tri(len(d), k=-1, dtype=bool)).sum(1)
                at = h[d[ok]] + rank[ok]
                out_k[at] = keys[e0:e0 + len(d)][ok]
                out_r[at] = rows[e0:e0 + len(d)][ok]
                np.add.at(h, d[ok], 1)
    return out_k, out_r


def _emulate_wide(ids, n, units, bits, passes):
    """csrc/scatter_general.cu's wide build for one cloud, step by step:
    `passes` LSD passes of `bits` bits (`_place` each; pass 0 drops the ids
    outside [0, n)), then each target's offset and count by binary search
    over the sorted keys and its records at slots offset // PIECE + j + q,
    every other slot empty.  -> (keys, perm) of the kept rows and the
    records (cap, 4): (target, offset, rows, first slot), target -1 empty."""
    keys = np.where((ids >= 0) & (ids < n), ids, -1).astype(np.int64)
    rows = np.arange(ids.size)
    for p in range(passes):
        keys, rows = _place(keys, rows, lambda k, s=p * bits: (k >> s) & ((1 << bits) - 1),
                            units)
    targets = np.arange(n)
    lo = np.searchsorted(keys, targets, "left")
    cnt = np.searchsorted(keys, targets, "right") - lo
    first = lo // cuda_scatter.PIECE + targets
    return keys, rows, _records(ids.size, lo, cnt, first)


def _records(m, offs, cnt, first):
    """The record slots (n + ceil(m / PIECE), 4) with target j's pieces at
    first[j] + q, each (j, offs[j], cnt[j], first[j]), the rest (-1, 0, 0, 0)."""
    n = len(cnt)
    npc = _pieces(cnt)
    rec = np.tile(np.array([-1, 0, 0, 0], np.int64), (n + -(-m // cuda_scatter.PIECE), 1))
    j = np.repeat(np.arange(n), npc)
    q = np.arange(len(j)) - np.repeat(np.cumsum(npc) - npc, npc)
    rec[first[j] + q] = np.stack([j, offs[j], cnt[j], first[j]], 1)
    return rec


def _narrow_records(ids, n):
    """The narrow build's scan (`scan_cloud`): the offsets, and one record
    per piece, the pieces of the targets in order from slot 0; -> records
    (cap, 4) as `_emulate_wide`'s."""
    ok = (ids >= 0) & (ids < n)
    cnt = np.bincount(ids[ok], minlength=n)
    npc = _pieces(cnt)
    first = np.cumsum(npc) - npc
    offs = np.cumsum(cnt) - cnt
    return _records(ids.size, offs, cnt, first)


def _emulate_sum(g, perm, rec, n):
    """The sum phase (`sum_pieces`) over one cloud's records: each live
    slot's piece, rows perm[offset + PIECE q + r] for r < its length added
    in order from 0 in f32; a target of one piece takes its piece, a hub
    its partials added in piece order from 0.  g (M, C) -> dx (n, C)."""
    piece = cuda_scatter.PIECE
    t = np.nonzero(rec[:, 0] >= 0)[0]
    j, off, rows, first = rec[t].T
    q = t - first
    length = np.clip(rows - piece * q, 0, piece)
    part = np.zeros((len(t), g.shape[1]), np.float32)
    for r in range(piece):
        sel = length > r
        part[sel] = part[sel] + g[perm[off[sel] + piece * q[sel] + r]]
    dx = np.zeros((n, g.shape[1]), np.float32)
    hub = _pieces(rows) > 1
    dx[j[~hub]] = part[~hub]
    slot = {int(s): i for i, s in enumerate(t)}
    for i in np.nonzero(hub & (q == 0))[0]:
        total = np.zeros(g.shape[1], np.float32)
        for k in range(int(_pieces(rows[i]))):
            total = total + part[slot[int(first[i]) + k]]
        dx[j[i]] = total
    return dx


def general_build(ids, n, b, sms=132):
    """csrc/scatter_general.cu's build of one of B clouds of rows `ids` on
    `sms` SMs: the narrow build where a histogram row of n fits
    (`_emulate_build` with the kernel's units and warps, `_narrow_records`),
    else the wide one with `radix_plan`'s passes, bits and
    units.  -> (perm, records)."""
    if _narrow_warps(n) >= 1:
        perm = _emulate_build(ids, n, max(1, min(16, sms // b)), _narrow_warps(n))
        return perm, _narrow_records(ids, n)
    passes, bits, units = radix_plan(n, ids.size, b, sms)
    _, perm, rec = _emulate_wide(ids, n, units, bits, passes)
    return perm, rec


def emulate_general(g, idx, n):
    """csrc/scatter_general.cu on the CPU: each cloud's build
    (`general_build`), then the sum over its records.  g (B, NQ, K, C), idx
    (B, NQ, K) -> dx (B, n, C) f32."""
    b, nq, k, c = g.shape
    gf, ids = g.reshape(b, nq * k, c).astype(np.float32), idx.reshape(b, nq * k)
    return np.stack([_emulate_sum(gf[cb], *general_build(ids[cb], n, b), n) for cb in range(b)])


def _loop_sum(g, idx, n, piece):
    """The kernel's order of sums written as plain loops, one f32 add at a
    time: per target its rows in source order, pieces of `piece` rows each
    summed from 0, then the pieces summed from 0."""
    b, nq, k, c = g.shape
    gf, ids = g.reshape(b, -1, c), idx.reshape(b, -1)
    out = np.zeros((b, n, c), np.float32)
    for cb in range(b):
        for j in range(n):
            rows = np.nonzero(ids[cb] == j)[0]
            total = np.zeros(c, np.float32)
            for p0 in range(0, max(len(rows), 1), piece):
                part = np.zeros(c, np.float32)
                for r in rows[p0:p0 + piece]:
                    part = part + gf[cb, r]
                total = total + part
            out[cb, j] = total
    return out


@pytest.mark.parametrize("b,nq,k,n,bad", [(1, 40, 5, 40, 0), (2, 32, 4, 32, 0),
                                          (1, 60, 6, 50, 9), (2, 48, 5, 48, 7)])
def test_inverse_graph_lists_each_targets_rows_in_source_order(b, nq, k, n, bad):
    _, idx = _case(b * nq + bad, b, nq, k, 2, n, bad=bad)
    counts, offsets, perm = cuda_scatter.inverse_graph_reference(
        torch.from_numpy(idx.reshape(b, -1)), n)
    for cb in range(b):
        ids = idx[cb].reshape(-1)
        ok = (ids >= 0) & (ids < n)
        np.testing.assert_array_equal(counts[cb].numpy(), np.bincount(ids[ok], minlength=n))
        np.testing.assert_array_equal(offsets[cb].numpy(),
                                      np.concatenate([[0], np.cumsum(counts[cb].numpy())]))
        for j in range(n):
            got = perm[cb, offsets[cb, j]:offsets[cb, j + 1]].numpy()
            np.testing.assert_array_equal(got, np.nonzero(ids == j)[0])
        assert bool((perm[cb, int(ok.sum()):] == -1).all())
    assert int(counts[0, 3]) >= nq                       # the hub


@pytest.mark.parametrize("units,hw", [(1, 1), (1, 7), (3, 2), (5, 4), (66, 1), (13, 32)])
@pytest.mark.parametrize("bad", [0, 11])
def test_kernel_build_emulated_equals_the_inverse_graph(units, hw, bad):
    """The kernel's build (units of rows counted per block, per-warp
    histograms, ranked batches) gives the stable-sort CSR exactly, for any
    number of units and histogram warps, with a hub and with ids out of
    range."""
    _, idx = _case(units + hw + bad, 1, 70, 5, 2, 64, bad=bad)
    ids = idx.reshape(-1)
    _, _, perm = cuda_scatter.inverse_graph_reference(torch.from_numpy(ids[None]), 64)
    np.testing.assert_array_equal(_emulate_build(ids, 64, units, hw), perm[0].numpy())


def test_piece_matches_the_kernel():
    """The ordered emulation cuts each target's rows into pieces as the
    kernels do: PIECE is kPiece of their shared source (csrc/scatter.cuh)."""
    src = (Path(cuda_scatter.__file__).parents[1] / "csrc" / "scatter.cuh").read_text()
    assert re.search(r"constexpr int kPiece = (\d+);", src).group(1) == str(cuda_scatter.PIECE)


def test_radix_plan_matches_the_kernel():
    """`radix_plan` mirrors csrc/scatter_general.cu:wide_plan: its constants
    are the source's, the passes hold every key bit, each a digit of at
    most MAX_BITS bits, and the units a multiple of SMs / B with at most
    WIDE_ROWS elements."""
    src = (Path(cuda_scatter.__file__).parents[1] / "csrc" / "scatter_general.cu").read_text()
    assert re.search(r"constexpr int kMaxBits = (\d+);", src).group(1) == str(MAX_BITS)
    assert re.search(r"constexpr int kWideRows = kWarps \* (\d+);", src).group(1) == str(
        WIDE_ROWS // 16)
    for n, m, b, sms, want in [(32768, 655360, 1, 132, (2, 8, 132)), (32768, 2000000, 1, 132,
                                                                       (2, 8, 264)),
                               (40000, 10000, 2, 132, (2, 8, 66)),
                               (70000, 350000, 1, 132, (2, 9, 132)), (2 ** 22, 100, 3, 132,
                                                                      (2, 11, 44)),
                               (2 ** 22 + 1, 5, 200, 114, (3, 8, 1))]:
        passes, bits, units = radix_plan(n, m, b, sms)
        assert (passes, bits, units) == want
        assert passes * bits >= (n - 1).bit_length() and bits <= MAX_BITS
        assert units % max(1, sms // b) == 0 and -(-m // units) <= WIDE_ROWS


@pytest.mark.parametrize("b,nq,k,c,n", [(1, 40, 5, 8, 40), (2, 32, 4, 8, 32), (2, 64, 5, 16, 64),
                                        (1, 200, 4, 6, 50)])
def test_ordered_sum_matches_jax_exact_pallas_kernel_and_index_add(b, nq, k, c, n):
    """The hub (each row's first neighbour) has nq rows: several pieces of
    32, merged in piece order."""
    g, idx = _case(b * n + c, b, nq, k, c, n)
    got = cuda_scatter.scatter_add_ordered_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                                     n).numpy()
    exact = np.asarray(jax_fg._scatter_exact(jnp.asarray(g), jnp.asarray(idx), n))
    kernel = np.asarray(jax_scatter_kernel(jnp.asarray(g), jnp.asarray(idx), n, tm=nq * k))
    plain = cuda_scatter.scatter_add_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                               n).numpy()
    for want in (exact, kernel, plain):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b", [1, 2])
def test_ordered_sum_drops_ids_out_of_range(b):
    """Ids < 0 and >= N are dropped: against the Pallas kernel in interpret
    mode (any B), `index_add_` of the in-range rows, and segment_sum at B =
    1 (at B > 1 an id >= N would land in the next cloud's segment there)."""
    g, idx = _case(20 + b, b, 40, 5, 8, 40, bad=13)
    got = cuda_scatter.scatter_add_ordered_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                                     40).numpy()
    kernel = np.asarray(jax_scatter_kernel(jnp.asarray(g), jnp.asarray(idx), 40, tm=200))
    ok = (idx >= 0) & (idx < 40)
    plain = cuda_scatter.scatter_add_reference(torch.from_numpy(g * ok[..., None]),
                                               torch.from_numpy(np.where(ok, idx, 0)), 40).numpy()
    np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    if b == 1:
        exact = np.asarray(jax_fg._scatter_exact(jnp.asarray(g), jnp.asarray(idx), 40))
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_sum_is_the_kernels_order_bit_for_bit(seed):
    """The vectorised emulation equals the order written as loops, bit for
    bit, on values whose f32 sums depend on the order (spread over 2^-20 ..
    2^20), with a hub of about 100 rows (three or four pieces) and an empty
    target."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(2, 50, 4, 6)) * 2.0 ** rng.integers(-20, 20, size=(2, 50, 4, 6)))
    g = g.astype(np.float32)
    idx = rng.integers(1, 30, size=(2, 50, 4)).astype(np.int32)        # target 0 stays empty
    idx = np.where(rng.random(size=idx.shape) < 0.5, 7, idx).astype(np.int32)   # the hub
    got = cuda_scatter.scatter_add_ordered_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                                     30).numpy()
    want = _loop_sum(g, idx, 30, cuda_scatter.PIECE)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (idx == 7).sum(axis=(1, 2)).min() > 2 * cuda_scatter.PIECE
    assert not got[:, 0].any()


@pytest.mark.parametrize("n,units,bits,passes,bad", [(300, 1, 3, 3, 0), (300, 7, 5, 2, 17),
                                                     (2048, 3, 11, 1, 5), (2048, 66, 6, 2, 0),
                                                     (40000, 2, 8, 2, 9), (40000, 40, 11, 2, 3)])
def test_wide_build_emulated_is_the_inverse_graph(n, units, bits, passes, bad):
    """The general kernel's wide build (`_emulate_wide`: LSD passes placed
    as the fill places rows, records by binary search) gives the stable-sort
    CSR exactly for any count of units, digit bits and passes, with a hub of
    more than five pieces and ids out of range; each target's records cover
    its pieces at distinct slots within cap."""
    rng = np.random.default_rng(n + units + bits)
    ids = rng.integers(0, n, size=3000)
    ids[::13] = 5                                        # a hub of 231 rows: 8 pieces
    ids[rng.choice(3000, size=bad, replace=False)] = rng.choice([-1, -9, n, n + 3], size=bad)
    keys, perm, rec = _emulate_wide(ids, n, units, bits, passes)
    counts, offsets, want = cuda_scatter.inverse_graph_reference(torch.from_numpy(ids[None]), n)
    kept = int(counts.sum())
    np.testing.assert_array_equal(perm, want[0, :kept].numpy())
    np.testing.assert_array_equal(keys, ids[perm])
    live = rec[rec[:, 0] >= 0]                           # no slot taken twice:
    assert len(live) == _pieces(counts[0].numpy()).sum()  # every piece's record is there
    firsts = live[np.searchsorted(live[:, 0], np.arange(n))]
    np.testing.assert_array_equal(firsts[:, 1], offsets[0, :n].numpy())
    np.testing.assert_array_equal(firsts[:, 2], counts[0].numpy())
    assert int(counts[0, 5]) > 5 * cuda_scatter.PIECE


@pytest.mark.parametrize("n,c", [(300, 129), (2048, 63), (2048, 1), (40000, 3)])
def test_general_kernel_emulated_is_the_ordered_sum(n, c):
    """The general kernel emulated (`emulate_general`: the narrow build at n
    = 300 and 2048, two radix passes at 40000, then the sum over the
    records) equals `scatter_add_ordered_reference` bit for bit, on values
    whose f32 sums depend on the order, with a hub of six pieces and ids
    out of range; and the JAX package's `_scatter_kernel` (interpret mode)
    and `_scatter_exact` (on the kept rows) within rtol = atol = 1e-6 on a
    bf16-representable cotangent."""
    g, idx = _case(n + c, 2, 64, 20, c, n, hub=7, bad=5)
    idx[:, :, 1:3] = 7                                   # 192 rows: six pieces
    wide = g * 2.0 ** np.random.default_rng(c).integers(-20, 20, size=g.shape)
    tw, ti = torch.from_numpy(wide.astype(np.float32)), torch.from_numpy(idx)
    got = emulate_general(wide, idx, n)
    want = cuda_scatter.scatter_add_ordered_reference(tw, ti, n).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    got = emulate_general(g, idx, n)
    kernel = np.asarray(jax_scatter_kernel(jnp.asarray(g), jnp.asarray(idx), n, tm=256))
    ok = (idx >= 0) & (idx < n)
    exact = np.asarray(jax_fg._scatter_exact(jnp.asarray(g * ok[..., None]),
                                             jnp.asarray(np.where(ok, idx, 0)), n))
    for other in (kernel, exact):
        np.testing.assert_allclose(got, other, rtol=1e-6, atol=1e-6)
