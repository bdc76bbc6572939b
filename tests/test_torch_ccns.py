"""The port's cluster-level clean detection (`ops/ccns.py`) vs the JAX
package's `aggregate_class_clusters` and `detect_clean_clusters` on the
same inputs: means, sizes and masks within rtol 1e-5 (masks equal), with
empty cluster slots and padded rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops import ccns as jax_ccns
from r3dfsseg_tpu_torch.ops import ccns


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_class_clusters_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, n, d, c = 3, 80, 6, 10
    feat = rng.normal(size=(k, n, d)).astype(np.float32)
    cluster = rng.integers(0, c - 2, size=(k, n))          # the last two slots stay empty
    label = (rng.uniform(size=(k, n)) < (cluster % 3 == 0) * 0.9).astype(np.int32)
    got = ccns.aggregate_class_clusters(torch.from_numpy(feat), torch.from_numpy(label),
                                        torch.from_numpy(cluster), c)
    want = jax_ccns.aggregate_class_clusters(jnp.asarray(feat), jnp.asarray(label),
                                             jnp.asarray(cluster), c)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2][:, -2:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_clean_clusters_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, d = 12, 8
    base = rng.normal(size=d)
    feat = (base + 0.3 * rng.normal(size=(m, d))).astype(np.float32)
    feat[[2, 7]] = rng.normal(size=(2, d)) * 2.0          # two off-class clusters
    sizes = rng.integers(1, 50, size=m).astype(np.float32)
    valid = np.ones(m, bool)
    valid[-3:] = False                                     # padded rows
    got = ccns.detect_clean_clusters(torch.from_numpy(feat), torch.from_numpy(sizes),
                                     torch.from_numpy(valid))
    want = jax_ccns.detect_clean_clusters(jnp.asarray(feat), jnp.asarray(sizes),
                                          jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[-3:].any() and got.any()
