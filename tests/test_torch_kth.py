"""Port per-row k-th distance (`ops/cuda_kth.py`) vs the JAX package's
`kth_smallest_per_row_pallas` in interpret mode: BIT-EQUAL in f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

