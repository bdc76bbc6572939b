"""The reference-faithful modes of the port's episode graph vs the JAX
package: the exact top-k neighbour selection (`affinity_impl="topk"`), the
CG and dense label-propagation solves (`lp_solver="cg"` / `"solve"`), on
the float32 and the bf16 episode graph.

Operators: `exact_topk_select` bit for bit against `_exact_topk_select`;
the top-k affinity; `label_propagate` forward and its gradients in the
affinity and the labels against `jax.vjp`.  The slice: one served episode
at tiny_config in each of the ten modes that are new to the port
(affinity x solver x graph dtype, less threshold + Chebyshev), at the
tolerances of test_torch_mpti.py (one training step in each mode is in
test_torch_train.py).

As in those tests, the JAX side takes the threshold radius from the Pallas
kernel in interpret mode, and each episode first shows that both
frameworks keep the same graph neighbours on their own node features (the
seeds were picked so; a failure there means the inputs changed, not the
port): where a neighbour's distance ties the k-th within rounding, the two
may keep different ones while both are right."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r3dfsseg_tpu.ops.lp as jax_lp
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.ops import lp
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from torch_port_helpers import (PARITY_MODES, assert_same_neighbours, episode_arrays,
                                jax_mode_model, random_flax_weights)

BF16 = torch.bfloat16
JAX_DTYPES = {"float32": None, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": BF16}


def _pallas_kth(d, k, iters=32):
    return kth_smallest_per_row_pallas(d, k, iters=iters, tile_n=8, interpret=True)


@pytest.fixture(scope="module")
def jax_kth_kernel():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_lp, "_kth_smallest_per_row", _pallas_kth)
    yield
    mp.undo()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ operators --
def _rows(kind: str, rng: np.random.Generator, n: int = 48):
    """Non-negative f32 (n, n) distances: continuous values, small integers
    (exact ties at every rank, the k-th included), or continuous values
    with sentinel columns and two rows with fewer than k finite entries."""
    if kind == "ties":
        return rng.integers(0, 6, size=(n, n)).astype(np.float32)
    d = (rng.normal(size=(n, n)) ** 2).astype(np.float32)
    if kind == "sentinels":
        d[:, rng.choice(n, 9, replace=False)] = 1e30
        np.fill_diagonal(d, 1e30)
        d[3, 4:] = 1e30
        d[7, :] = 1e30
    return d


@pytest.mark.parametrize("k", [1, 8, 13])
@pytest.mark.parametrize("kind", ["random", "ties", "sentinels"])
def test_exact_topk_select_bit_equal_jax(kind, k):
    d = _rows(kind, np.random.default_rng(k))
    want_mask, want_kth = jax_lp._exact_topk_select(jnp.asarray(d), k)
    mask, kth = lp.exact_topk_select(torch.from_numpy(d), k)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert kth.dtype == torch.float32
    np.testing.assert_array_equal(kth.numpy().view(np.int32),
                                  np.asarray(want_kth).view(np.int32))
    assert (mask.sum(1) == k).all()
    if kind == "ties":   # ties at the k-th value go to the lowest indices
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        want = np.zeros_like(d, bool)
        np.put_along_axis(want, order, True, axis=1)
        np.testing.assert_array_equal(mask.numpy(), want)


@pytest.mark.parametrize("graph", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [1.0, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_topk_affinity_matches_jax(graph, sigma, masked):
    """f32 out on either graph; the same neighbours, values within f32
    rounding of the distances (rtol 1e-5), exactly symmetric."""
    rng = np.random.default_rng(30 + int(masked) + 2 * int(sigma))
    x = rng.normal(size=(48, 6)).astype(np.float32)
    valid = np.ones(48, bool)
    if masked:
        valid[[3, 10, 11, 30]] = False
    want = jax_lp.local_constrained_affinity(jnp.asarray(x), 8, sigma, valid=jnp.asarray(valid),
                                             impl="topk", compare_dtype=JAX_DTYPES[graph])
    got = lp.local_constrained_affinity(
        torch.from_numpy(x), 8, sigma, valid=torch.from_numpy(valid), impl="topk",
        compare_dtype=None if graph == "float32" else BF16)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.diag(got) == 0).all() and (got == got.T).all()


def test_topk_affinity_gradient_matches_jax():
    """The node-feature gradient through the top-k graph's distances and
    A + A^T, f32: rtol 1e-4 of the largest entry."""
    rng = np.random.default_rng(41)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[[5, 17]] = False
    w = rng.normal(size=(40, 40)).astype(np.float32)

    def loss(x_):
        return jnp.sum(jax_lp.local_constrained_affinity(
            x_, 8, 0.0, valid=jnp.asarray(valid), impl="topk") * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (lp.local_constrained_affinity(tx, 8, 0.0, valid=torch.from_numpy(valid), impl="topk")
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("matvec", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver", ["cg", "solve"])
def test_label_propagation_matches_jax(solver, a_dtype, matvec):
    """Forward and the gradients in the affinity and the labels against
    `jax.vjp` (the JAX package's matvec_dtype None is the port's
    torch.float32).  The solution and the labels' gradient: rtol 1e-4 of
    the largest entry.  The affinity's gradient: rtol 1e-4 where S and its
    cotangent stay f32; within one bf16 step of each entry and 2^-8 of the
    largest where either is bf16 (dS, or dA on a bf16 affinity, rounded
    to bf16 in both from f32 values that differ at f32 rounding)."""
    rng = np.random.default_rng(50)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    a = jax_lp.local_constrained_affinity(jnp.asarray(x), 8, 1.0,
                                          compare_dtype=JAX_DTYPES[a_dtype])
    y = np.zeros((50, 3), np.float32)
    y[:9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    w = rng.normal(size=(50, 3)).astype(np.float32)

    def solve(a_, y_):
        return jax_lp.label_propagate(a_, y_, 0.99, solver=solver, cg_iters=50,
                                      matvec_dtype=JAX_DTYPES[matvec])

    want_z, vjp = jax.vjp(solve, a, jnp.asarray(y))
    want_a, want_y = vjp(jnp.asarray(w))
    ta = torch.from_numpy(_f32(a)).to(TORCH_DTYPES[a_dtype]).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    z = lp.label_propagate(ta, ty, 0.99, solver=solver, cg_iters=50,
                           matvec_dtype=TORCH_DTYPES[matvec])
    (z * torch.from_numpy(w)).sum().backward()
    want_z = np.asarray(want_z)
    np.testing.assert_allclose(z.detach().numpy(), want_z, rtol=1e-4,
                               atol=1e-4 * np.abs(want_z).max())
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_y)).max())
    assert ta.grad.dtype == ta.dtype and want_a.dtype == a.dtype
    got_a, want_a = _f32(ta.grad), _f32(want_a)
    lowp = a_dtype == "bfloat16" or (matvec == "bfloat16" and solver == "cg")
    rtol, atol = (2 ** -7, 2 ** -8) if lowp else (1e-4, 1e-4)
    np.testing.assert_allclose(got_a, want_a, rtol=rtol, atol=atol * np.abs(want_a).max())


def test_adjoint_iters_truncate_cg_like_jax():
    """CG's adjoint with `adjoint_iters` steps: the labels' gradient
    against `jax.grad` through `custom_linear_solve`, rtol 1e-4."""
    rng = np.random.default_rng(51)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    a = np.array(jax_lp.local_constrained_affinity(jnp.asarray(x), 8, 1.0, impl="topk"))
    y = np.zeros((50, 3), np.float32)
    y[:9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    w = rng.normal(size=(50, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda y_: jnp.sum(jax_lp.label_propagate(
        jnp.asarray(a), y_, 0.99, solver="cg", cg_iters=50, adjoint_iters=3) * w))(
            jnp.asarray(y)))
    ty = torch.from_numpy(y).requires_grad_()
    (lp.label_propagate(torch.from_numpy(a), ty, 0.99, solver="cg", cg_iters=50,
                        adjoint_iters=3) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    full = torch.from_numpy(y).requires_grad_()
    (lp.label_propagate(torch.from_numpy(a), full, 0.99, solver="cg", cg_iters=50)
     * torch.from_numpy(w)).sum().backward()
    assert not torch.allclose(full.grad, ty.grad, rtol=1e-3)


# ---------------------------------------------------- the slice, tiny config --
@pytest.mark.parametrize("mode", PARITY_MODES, ids=["-".join(m) for m in PARITY_MODES])
def test_mode_serves_as_jax(jax_kth_kernel, mode):
    """One served episode (MDNS on) in ``mode`` against the JAX model with
    the same weights: logits atol = rtol = 1e-3, `FewShotPredictor` labels
    on >= 99% of points of the JAX argmax (the training step in each mode:
    test_torch_train.py)."""
    jcfg, cfg, model, shapes = jax_mode_model(mode)
    rng = np.random.default_rng(PARITY_MODES.index(mode))
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    arrays = episode_arrays(cfg, rng)
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    features = jax.jit(lambda x: model.apply(variables, x,
                                             method=lambda m, x: m.features(x, train=False)))
    assert_same_neighbours(lambda x: np.asarray(features(jnp.asarray(x))), jcfg, cfg,
                           learner.model, *arrays[:3], eval_mdns=True, train=False)
    logits = jax.jit(lambda ep: model.apply(variables, ep, train=False,
                                            eval_mdns=True).query_logits)
    want = np.asarray(logits(JaxEpisode(*map(jnp.asarray, arrays))))
    with torch.no_grad():
        got = learner.model(Episode(*map(torch.from_numpy, arrays)),
                            eval_mdns=True).query_logits.numpy()
    assert got.shape == want.shape == (1, cfg.n_way, cfg.pc_npts, cfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    pred = FewShotPredictor(cfg, learner, device="cpu").predict(*arrays[:3])
    assert (pred == want[0].argmax(-1)).mean() >= 0.99
