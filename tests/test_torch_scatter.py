"""Kernel 6's plain pieces (`ops/cuda_scatter.py`): the inverse graph the
kernel builds (`inverse_graph_reference`), the kernel's order of sums
(`scatter_add_ordered_reference`), and a CPU emulation of the kernel's build
(per-warp histograms, a scan, the fill in batches of 32 ranked by target),
held against `index_add_`, the JAX package's exact `_scatter_exact`
(segment sum) and its Pallas `_scatter_kernel` in interpret mode.

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
    kernel does: PIECE is the kernel source's kPiece."""
    src = (Path(cuda_scatter.__file__).parents[1] / "csrc" / "scatter_add.cu").read_text()
    assert re.search(r"constexpr int kPiece = (\d+);", src).group(1) == str(cuda_scatter.PIECE)


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
