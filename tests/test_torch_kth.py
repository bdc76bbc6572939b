"""Port per-row k-th distance (`ops/cuda_kth.py`) vs the JAX package's
`kth_smallest_per_row_pallas` in interpret mode: BIT-EQUAL, on f32 input
and on the bf16 compare copy of the bf16 episode graph (upcast to f32 in
both, sentinel rounded to bf16 in both)."""
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



@pytest.mark.parametrize("n,m,k", [(96, 96, 7), (40, 72, 9)])
def test_kth_bf16_bit_equals_pallas_interpret(n, m, k):
    """16 steps on a bf16 input, as the bf16 graph runs them."""
    d = jnp.asarray(_distances(2 * n + k, n, m)).astype(jnp.bfloat16)
    want = np.asarray(kth_smallest_per_row_pallas(d, k, iters=16, tile_n=8, interpret=True))
    td = torch.from_numpy(np.array(d.astype(jnp.float32))).to(torch.bfloat16)
    got = cuda_kth.kth_smallest_per_row(td, k, 16).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
