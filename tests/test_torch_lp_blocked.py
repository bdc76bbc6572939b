"""The port's scene-scale label propagation (`ops/lp_blocked.py`) vs the
JAX package's, on the same features, valid mask and labels: the graph of
`tests/test_lp_blocked.py` (M = 700, d = 24, k = 20, row tile 128).

float32 stored and rematerialising graphs: Z within rtol 2e-4, atol 2e-5
of the JAX package's (different orders of f32 sums, amplified by the
60-step solve).  bf16 stored and split store: argmax agreement above 0.995
on valid rows (a radius resolved on bf16 can flip a node at the k-th
distance).  The sparse variant at full width within 2e-4 / 2e-5, at the
default width agreeing above 0.99.  The global-bracket bisection is
bit-equal to the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops import lp as jax_lp
from r3dfsseg_tpu.ops import lp_blocked as jax_lpb
from r3dfsseg_tpu_torch.ops import cuda_kth, lp_blocked

K, ALPHA, ITERS = 20, 0.99, 60


def _graph(rng, m=700, d=24, c=3, n_invalid=37):
    """`tests/test_lp_blocked.py:_graph`."""
    feat = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.ones(m, bool)
    valid[rng.choice(m, n_invalid, replace=False)] = False
    y = np.zeros((m, c), np.float32)
    rows = rng.choice(m, 40, replace=False)
    y[rows, rng.integers(0, c, size=40)] = 1.0
    return feat, valid, y


@pytest.fixture(scope="module")
def graph():
    return _graph(np.random.default_rng(0))


def _jax(fn, graph, **kw):
    feat, valid, y = graph
    return np.asarray(fn(jnp.asarray(feat), jnp.asarray(y), k=K, alpha=ALPHA,
                         valid=jnp.asarray(valid), iters=ITERS, row_tile=128, **kw))


def _port(fn, graph, **kw):
    feat, valid, y = graph
    kw.setdefault("row_tile", 128)
    return fn(torch.from_numpy(feat), torch.from_numpy(y), k=K, alpha=ALPHA,
              valid=torch.from_numpy(valid), iters=ITERS, **kw).numpy()


_JAX_CACHE: dict = {}


def _jax_cached(graph, name, **kw):
    """The JAX package's Z for (variant, options), computed once a module."""
    key = (name, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _JAX_CACHE:
        fn = jax_lpb.sparse_label_propagate if name == "sparse" else \
            jax_lpb.blocked_label_propagate
        _JAX_CACHE[key] = _jax(fn, graph, **kw)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("store", [True, False], ids=["stored", "stream"])
@pytest.mark.parametrize("sigma", [1.0, 0.0])        # fixed and auto bandwidth
def test_blocked_f32_matches_jax(graph, sigma, store):
    want = _jax_cached(graph, "blocked", sigma=sigma, store_graph=store)
    got = _port(lp_blocked.blocked_label_propagate, graph, sigma=sigma, store_graph=store)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    valid = graph[1]
    np.testing.assert_array_equal(got[valid].argmax(-1), want[valid].argmax(-1))


@pytest.mark.parametrize("mode", ["bf16_stored", "split_store"])
@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_blocked_lowp_agrees_with_jax(graph, sigma, mode):
    kw = (dict(compute_dtype=jnp.bfloat16) if mode == "bf16_stored"
          else dict(split_store=True))
    want = _jax_cached(graph, "blocked", sigma=sigma, **kw)
    kw = (dict(compute_dtype=torch.bfloat16) if mode == "bf16_stored"
          else dict(split_store=True))
    got = _port(lp_blocked.blocked_label_propagate, graph, sigma=sigma, **kw)
    valid = graph[1]
    agree = (got[valid].argmax(-1) == want[valid].argmax(-1)).mean()
    assert agree > 0.995, agree
    # the bulk within bf16's storage rounding of the JAX package's
    close = np.isclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    assert close.mean() > 0.995, close.mean()


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_blocked_tiling_and_store_invariant(graph, sigma):
    """The row tiling and the storage are implementation details: row
    tiles of 64, 128 and 700 rows, stored or rebuilt, give one answer
    (`tests/test_lp_blocked.py:65-79`'s tolerances)."""
    out = [_port(lp_blocked.blocked_label_propagate, graph, sigma=sigma, row_tile=rt,
                 store_graph=store)
           for rt in (64, 128, 700) for store in (True, False)]
    for z in out[1:]:
        np.testing.assert_allclose(z, out[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_sparse_matches_jax(graph, sigma):
    m = graph[0].shape[0]
    want = _jax_cached(graph, "sparse", sigma=sigma, width=m)
    got = _port(lp_blocked.sparse_label_propagate, graph, sigma=sigma, width=m)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the default width (2k + 112): serving-grade agreement
    want = _jax_cached(graph, "sparse", sigma=sigma)
    got = _port(lp_blocked.sparse_label_propagate, graph, sigma=sigma)
    valid = graph[1]
    agree = (got[valid].argmax(-1) == want[valid].argmax(-1)).mean()
    assert agree > 0.99, agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_bracket_bisection_bit_equal(seed, dtype):
    """`kth_smallest_per_row_reference(..., hi=)` on a masked distance
    tile, its sentinels and ties included, equals the JAX package's
    `_kth_smallest_per_row(..., hi=)` bit for bit."""
    rng = np.random.default_rng(seed)
    r, m = 64, 300
    d = rng.uniform(0, 5, size=(r, m)).astype(np.float32)
    d[:, ::7] = d[:, :1]                                  # ties
    d[rng.uniform(size=(r, m)) < 0.2] = 1e30             # self/invalid/pad
    d[3] = 1e30                                            # a dead row
    hi = np.float32(4.0 * 6.25)
    iters = 32 if dtype == "float32" else 16
    jd = jnp.asarray(d).astype(getattr(jnp, dtype))
    want = np.asarray(jax_lp._kth_smallest_per_row(jd, K, iters=iters, hi=jnp.asarray(hi)))
    got = cuda_kth.kth_smallest_per_row_reference(
        torch.from_numpy(d).to(getattr(torch, dtype)), K, iters, hi=torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m,dtype,split,want", [
    (16684, None, None, "stored"),            # the dense path's scene, forced blocked
    (33068, None, None, "stored"),            # 32,768 points: 4.43 GB f32
    (65836, None, None, "split"),             # 65,536 points: 8.72 GB bf16
    (65836, torch.bfloat16, None, "stored"),  # a bf16 graph at 65,536 points
    (65836, None, False, "stream"),           # split refused: rebuilt per matvec
    (100000, None, None, "stream"),           # past the bf16 budget too
])
def test_scene_lp_mode(m, dtype, split, want):
    """The mode follows the JAX package's byte budget (9.2e9) and row tile
    (512)."""
    assert lp_blocked.scene_lp_mode(m, compute_dtype=dtype, split_store=split) == want
