"""Port affinity graph and Chebyshev label propagation (`ops/lp.py`) vs the
JAX package's `local_constrained_affinity` and `label_propagate`, values
and gradients (the solve's implicit gradient against `jax.grad` through
`custom_linear_solve`).

On a TPU the JAX affinity takes its k-th radius from the Pallas kernel
(per-row bracket); on the CPU from an XLA loop with one global bracket.
The port follows the kernel, so the JAX side here runs that kernel in
interpret mode: the graphs then agree to f32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r3dfsseg_tpu.ops.lp as jax_lp
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu_torch.ops.lp import label_propagate, local_constrained_affinity


@pytest.fixture
def jax_kth_kernel(monkeypatch):
    monkeypatch.setattr(
        jax_lp, "_kth_smallest_per_row",
        lambda d, k, iters=32: kth_smallest_per_row_pallas(d, k, iters=iters, tile_n=8,
                                                           interpret=True))


@pytest.mark.parametrize("sigma", [1.0, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_affinity_matches_jax(jax_kth_kernel, sigma, masked):
    rng = np.random.default_rng(int(masked) + 2 * int(sigma))
    x = rng.normal(size=(48, 6)).astype(np.float32)
    valid = np.ones(48, bool)
    if masked:
        valid[[3, 10, 11, 30]] = False
    want = np.asarray(jax_lp.local_constrained_affinity(
        jnp.asarray(x), 8, sigma, valid=jnp.asarray(valid)))
    got = local_constrained_affinity(torch.from_numpy(x), 8, sigma,
                                     valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.diag(got) == 0).all() and (got == got.T).all()


@pytest.mark.parametrize("iters", [1, 30, 50])
def test_chebyshev_label_propagation_matches_jax(jax_kth_kernel, iters):
    rng = np.random.default_rng(iters)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    a = np.array(jax_lp.local_constrained_affinity(jnp.asarray(x), 8, 1.0))
    y = np.zeros((60, 3), np.float32)
    y[:9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    want = np.asarray(jax_lp.label_propagate(jnp.asarray(a), jnp.asarray(y), 0.99,
                                             solver="cheby", cg_iters=iters))
    got = label_propagate(torch.from_numpy(a), torch.from_numpy(y), 0.99, cg_iters=iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)



@pytest.mark.parametrize("adjoint_iters", [None, 5])
def test_label_propagation_gradient_matches_jax(jax_kth_kernel, adjoint_iters):
    """The implicit (`custom_linear_solve`) gradient: the affinity's and
    the labels' cotangents vs `jax.grad`, rtol 1e-4."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    a = np.array(jax_lp.local_constrained_affinity(jnp.asarray(x), 8, 1.0))
    y = np.zeros((50, 3), np.float32)
    y[:9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    w = rng.normal(size=(50, 3)).astype(np.float32)

    def loss(a_, y_):
        z = jax_lp.label_propagate(a_, y_, 0.99, solver="cheby", cg_iters=30,
                                   adjoint_iters=adjoint_iters)
        return jnp.sum(z * w)

    want_a, want_y = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(y))
    ta, ty = torch.from_numpy(a).requires_grad_(), torch.from_numpy(y).requires_grad_()
    (label_propagate(ta, ty, 0.99, cg_iters=30, adjoint_iters=adjoint_iters)
     * torch.from_numpy(w)).sum().backward()
    scale = np.abs(np.asarray(want_a)).max()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_a), rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_affinity_gradient_matches_jax(jax_kth_kernel, sigma):
    """Gradient of the node features through the affinity (distances ->
    gaussian weights; selection detached), rtol 1e-4."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[[5, 17]] = False
    w = rng.normal(size=(40, 40)).astype(np.float32)

    def loss(x_):
        return jnp.sum(jax_lp.local_constrained_affinity(
            x_, 8, sigma, valid=jnp.asarray(valid)) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (local_constrained_affinity(tx, 8, sigma, valid=torch.from_numpy(valid))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
