"""Port kNN (`ops/knn.py`, `ops/cuda_knn.py`) vs the JAX package's
`knn_indices` and its Pallas `_knn_kernel(exact=True)` in interpret mode.

Indices must be EQUAL, order included, with exact-duplicate points whose
distances tie bit for bit (lowest index first)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops.knn import gather_neighbors as jax_gather
from r3dfsseg_tpu.ops.knn import knn_indices as jax_knn
from r3dfsseg_tpu.ops.knn import pairwise_sqdist as jax_sqdist
from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn
from r3dfsseg_tpu_torch.ops.knn import gather_neighbors, knn_indices, pairwise_sqdist
from torch_port_helpers import jax_knn_kernel_exact


def _points(seed, b=2, n=64, c=8):
    x = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    x[0, 11] = x[0, 40]            # exact duplicate: a distance tie
    x[1, 3] = x[1, 5] = x[1, 57]   # a triple
    return x


@pytest.mark.parametrize("seed,c,k", [(0, 8, 5), (1, 9, 4), (2, 3, 20)])
def test_knn_equals_jax_and_pallas_exact(seed, c, k):
    x = _points(seed, c=c)
    want = np.asarray(jax_knn(jnp.asarray(x), k))
    kernel = np.asarray(jax_knn_kernel_exact(jnp.asarray(x), k, tile_n=32))
    np.testing.assert_array_equal(kernel, want)
    got = cuda_knn.knn(torch.from_numpy(x), k)          # CPU tensor: plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(knn_indices(torch.from_numpy(x), k).numpy(), want)


def test_knn_on_a_grid_of_exact_ties():
    """Points on an integer grid: every row has many exactly equal
    distances, which the lowest-index rule must order as JAX does."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2)), -1)
    x = g.reshape(1, -1, 3).astype(np.float32)
    want = np.asarray(jax_knn(jnp.asarray(x), 7))
    np.testing.assert_array_equal(knn_indices(torch.from_numpy(x), 7).numpy(), want)


def test_pairwise_sqdist_and_gather_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 30, 6)).astype(np.float32)
    d = pairwise_sqdist(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(d, np.asarray(jax_sqdist(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert (d == np.swapaxes(d, -1, -2)).all()          # exactly symmetric
    idx = rng.integers(0, 30, size=(2, 30, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_gather(jnp.asarray(x), jnp.asarray(idx))))



# ---- csrc/knn.cu's arithmetic and decomposition, emulated on the CPU ----
def _tf32_inner(x, passes=3):
    """x x^T as the kernel takes it: each operand split into tf32 hi and lo
    (`cuda_attention.split_tf32`), the products lo hi + hi lo + hi hi (each
    tf32 x tf32 product exact in f32) summed in f32; or one hi hi pass."""
    hi, lo = cuda_attention.split_tf32(x)
    t = lambda a: a.transpose(-1, -2)             # noqa: E731
    return lo @ t(hi) + hi @ t(lo) + hi @ t(hi) if passes == 3 else hi @ t(hi)


def _knn_emulated(x, k, splits=1, passes=3):
    """The kernel's distances d = max((qq + kk) - 2 inner, 0) with a 3xTF32
    inner product, the keys of each of `splits` ranges of 64-key tiles
    reduced to their k smallest by (d, index), and the partial lists
    merged by (d, index) in split order."""
    b, n, _ = x.shape
    xx = (x * x).sum(-1)
    d = ((xx[..., :, None] + xx[..., None, :]) - 2.0 * _tf32_inner(x, passes)).clamp_min(0.0)
    tiles = -(-n // cuda_knn.ROWS)
    span = -(-tiles // splits) * cuda_knn.ROWS
    parts = []
    for s in range(splits):
        lo, hi = min(n, s * span), min(n, (s + 1) * span)
        top = torch.sort(d[..., lo:hi], dim=-1, stable=True)
        parts.append((top.values[..., :k], top.indices[..., :k] + lo))
    vals = torch.cat([v for v, _ in parts], -1)
    idx = torch.cat([i for _, i in parts], -1)
    order = torch.sort(vals, dim=-1, stable=True).indices[..., :k]   # ties: split order
    return idx.gather(-1, order).to(torch.int32)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_knn_emulation_equals_plain_on_exact_ties(splits):
    """On the integer grid (every distance exact in f32 and in tf32 passes)
    and on duplicate and triple points, the emulated kernel equals the
    plain version, order included, whatever the number of key splits."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4)), -1)
    grid = torch.from_numpy(g.reshape(1, -1, 3).astype(np.float32))
    np.testing.assert_array_equal(_knn_emulated(grid, 20, splits).numpy(),
                                  knn_indices(grid, 20).numpy())
    x = torch.from_numpy(_points(3, n=256, c=9))
    np.testing.assert_array_equal(_knn_emulated(x, 20, splits).numpy(),
                                  knn_indices(x, 20).numpy())


@pytest.mark.parametrize("c", [9, 64])
def test_knn_emulation_meets_the_chip_gates(c):
    """At a flagship size (B = 2, N = 2048, k = 20, 4 key splits as the
    query batch takes them) the emulated 3xTF32 kernel keeps the plain
    version's sets on all but 1e-3 of the rows, each differing neighbour
    within NEAR_TIE of xx_i + xx_j of the k-th distance; one tf32 pass
    (11 bits) misses both gates."""
    import chip_smoke
    x = torch.from_numpy(np.random.default_rng(c).normal(size=(2, 2048, c)).astype(np.float32))
    want = knn_indices(x, 20).long()
    a = chip_smoke.knn_agreement(torch, x, _knn_emulated(x, 20, 4).long(), want)
    assert a["mismatch"] <= 1e-3 and a["gap"] <= chip_smoke.NEAR_TIE, a
    one = chip_smoke.knn_agreement(torch, x, _knn_emulated(x, 20, 4, passes=1).long(), want)
    assert one["mismatch"] > 1e-3 and one["gap"] > chip_smoke.NEAR_TIE, one


def test_knn_key_splits_by_batch():
    """One scan per row tile where the grid fills the card (B = 10, 320
    blocks on 132 SMs), four for the query batch (B = 2), and no more than
    half the key tiles."""
    assert cuda_knn.splits(10, 2048, 132) == 1
    assert cuda_knn.splits(2, 2048, 132) == 4
    assert cuda_knn.splits(2, 130, 132) == 2
    assert cuda_knn.splits(1, 64, 132) == 1


# ---- csrc/knn.cu's bf16 route: one tensor-core pass on bf16 values ----
def _bf16_points(seed, b, n, c):
    """bf16 points as f32 tensors (their exact upcast)."""
    x = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


def test_split_tf32_of_every_bf16_value_has_no_lo_part():
    """Every finite bf16 bit pattern (subnormals and both zeros included)
    widened to f32 is a tf32 value: the 3xTF32 split keeps it whole in hi
    and leaves lo = +0, so two of the f32 route's three products are zero
    on a bf16 input."""
    u = np.arange(1 << 16, dtype=np.uint32)
    u = u[(u >> 7 & 0xFF) != 0xFF]                         # finite: exponent below all ones
    x = torch.from_numpy((u << 16).view(np.int32)).view(torch.float32)
    hi, lo = cuda_attention.split_tf32(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    assert not bool(lo.view(torch.int32).any())


@pytest.mark.parametrize("splits", [1, 4])
def test_knn_emulation_one_pass_equals_three_on_bf16(splits):
    """At the query batch's flagship shape (B = 2, N = 2048, C = 64, k =
    20) on bf16 points, the emulated kernel with one tf32 pass (hi hi, the
    bf16 route) equals the three-pass one (the f32 route on the upcast) bit
    for bit, with and without key splits."""
    x = _bf16_points(splits, 2, 2048, 64)
    one = _knn_emulated(x, 20, splits, passes=1)
    np.testing.assert_array_equal(one.numpy(), _knn_emulated(x, 20, splits, passes=3).numpy())


def test_knn_emulation_one_pass_on_integer_bf16_points_equals_pallas_exact():
    """On integer points (exact in bf16, every distance exact, ties exact)
    at N = 256, the one-pass emulation at 1 and 4 key splits equals
    `_knn_kernel(exact=True)` in interpret mode on the bf16 input, which
    it upcasts on load."""
    xi = np.random.default_rng(9).integers(-6, 7, size=(2, 256, 9)).astype(np.float32)
    x = torch.from_numpy(xi).to(torch.bfloat16)
    want = np.asarray(jax_knn_kernel_exact(jnp.asarray(xi).astype(jnp.bfloat16), 20, tile_n=128))
    for splits in (1, 4):
        np.testing.assert_array_equal(_knn_emulated(x.float(), 20, splits, passes=1).numpy(), want)
