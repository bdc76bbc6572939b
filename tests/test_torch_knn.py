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
from r3dfsseg_tpu_torch.ops import cuda_knn
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

