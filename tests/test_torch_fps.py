"""Port FPS (`ops/fps.py`, `ops/cuda_fps.py`) vs the JAX package's
`masked_fps(impl="xla")` and `multi_prototypes`.  Seeds must be EQUAL,
including masks with fewer valid points than k and invalid points
interleaved; prototypes agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops.fps import masked_fps as jax_fps
from r3dfsseg_tpu.ops.fps import multi_prototypes as jax_multi
from r3dfsseg_tpu_torch.ops.fps import masked_fps, multi_prototypes
from r3dfsseg_tpu_torch.ops.segment import segment_sum


def _instances(seed, p, n, c, keep):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(p, n, c)).astype(np.float32)
    valid = rng.uniform(size=(p, n)) < keep
    return feat, valid


@pytest.mark.parametrize("seed,n,c,keep,k", [
    (0, 64, 8, 0.5, 10),      # invalid points interleaved
    (1, 40, 5, 0.15, 12),     # fewer valid points than k
    (2, 50, 16, 1.0, 50),     # every point becomes a seed
    (3, 30, 4, 0.0, 6),       # no valid point at all
])
def test_masked_fps_equals_jax(seed, n, c, keep, k):
    feat, valid = _instances(seed, 3, n, c, keep)
    idx, ok = masked_fps(torch.from_numpy(feat), torch.from_numpy(valid), k)
    for p in range(3):
        want_idx, want_ok = jax_fps(jnp.asarray(feat[p]), jnp.asarray(valid[p]), k, impl="xla")
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(ok[p].numpy(), np.asarray(want_ok))
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("seed,keep,k", [(4, 0.6, 6), (5, 0.1, 8)])
def test_multi_prototypes_match_jax(seed, keep, k):
    feat, valid = _instances(seed, 2, 48, 6, keep)
    got = multi_prototypes(torch.from_numpy(feat), torch.from_numpy(valid), k)
    for p in range(2):
        want = jax_multi(jnp.asarray(feat[p]), jnp.asarray(valid[p]), k, impl="xla")
        np.testing.assert_allclose(got.prototypes[p].numpy(), np.asarray(want.prototypes),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.proto_valid[p].numpy(), np.asarray(want.proto_valid))
        np.testing.assert_array_equal(got.assignments[p].numpy(), np.asarray(want.assignments))


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    ids = rng.integers(0, 5, size=20).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=5))
    np.testing.assert_allclose(segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 5).numpy(),
                               want, rtol=1e-6, atol=1e-6)

