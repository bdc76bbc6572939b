"""Port neighbour gather and its scatter-add backward (`ops/fast_gather.py`,
`ops/cuda_scatter.py`) vs the JAX package: its exact `_scatter_exact`
(segment sum), its Pallas `_scatter_kernel` in interpret mode, and
`jax.grad` through `gather_neighbors_fast`; and the one-hot row gather
(`ops/cuda_gather.py`, kernel 8) vs `_gather_kernel` in interpret mode,
which is exact: every output element is one product 1 * x.

The Pallas kernel rounds g to bf16 for its one-hot matrix product; with g
bf16-representable that rounding is exact, and the kernel then equals the
f32 sum to rounding (rtol 1e-6, atol 1e-6)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from r3dfsseg_tpu.ops import fast_gather as jax_fg
from r3dfsseg_tpu_torch.ops import cuda_gather, cuda_scatter
from r3dfsseg_tpu_torch.ops.fast_gather import flat_take, gather_neighbors_fast


def _jax_scatter_kernel(g, idx, n, tm):
    """`_scatter_kernel` over (B, NQ, K, C), interpret mode."""
    b, nq, k, c = g.shape
    m = nq * k
    return pl.pallas_call(
        functools.partial(jax_fg._scatter_kernel, n_keys=n),
        out_shape=jax.ShapeDtypeStruct((b, n, c), jnp.float32),
        grid=(b, m // tm),
        in_specs=[pl.BlockSpec((1, tm, 1), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, tm, c), lambda i, j: (i, j, 0))],
        out_specs=pl.BlockSpec((1, n, c), lambda i, j: (i, 0, 0)),
        interpret=True,
    )(idx.reshape(b, m, 1), g.reshape(b, m, c))


def _case(seed, b, n, k, c):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, k, c)).astype(np.float32)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    idx[:, :, 0] = 3                                   # a hub
    return g, idx


@pytest.mark.parametrize("b,n,k,c", [(2, 32, 4, 8), (3, 64, 5, 16)])
def test_scatter_add_matches_jax_exact_and_pallas_kernel(b, n, k, c):
    g, idx = _case(b * n + k, b, n, k, c)
    exact = np.asarray(jax_fg._scatter_exact(jnp.asarray(g), jnp.asarray(idx), n))
    kernel = np.asarray(_jax_scatter_kernel(jnp.asarray(g), jnp.asarray(idx), n, tm=32))
    got = cuda_scatter.scatter_add(torch.from_numpy(g), torch.from_numpy(idx), n).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_gather_neighbors_grad_matches_jax(impl):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, size=(2, 40, 5)).astype(np.int32)
    w = rng.normal(size=(2, 40, 5, 6)).astype(np.float32)

    def loss(x_):
        return jnp.sum(jax_fg.gather_neighbors_fast(x_, jnp.asarray(idx), False) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    out = gather_neighbors_fast(tx, torch.from_numpy(idx), impl=impl)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax_fg._flat_take(jnp.asarray(x), jnp.asarray(idx))))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gather_without_autograd_is_the_plain_take():
    x = torch.randn(1, 9, 4)
    idx = torch.randint(0, 9, (1, 9, 3), dtype=torch.int32)
    before = cuda_scatter.launches
    with torch.no_grad():
        torch.testing.assert_close(gather_neighbors_fast(x.requires_grad_(), idx),
                                   flat_take(x, idx))
    assert cuda_scatter.launches == before
    with pytest.raises(NotImplementedError):
        gather_neighbors_fast(x, idx, impl="pallas")


def _jax_gather_kernel(x, idx, tm):
    """`_gather_kernel` over x (B, N, C) and idx (B, NQ, K), interpret mode."""
    b, n, c = x.shape
    m = idx.shape[1] * idx.shape[2]
    return pl.pallas_call(
        jax_fg._gather_kernel,
        out_shape=jax.ShapeDtypeStruct((b, m, c), x.dtype),
        grid=(b, m // tm),
        in_specs=[pl.BlockSpec((1, tm, 1), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, n, c), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, tm, c), lambda i, j: (i, j, 0)),
        interpret=True,
    )(idx.reshape(b, m, 1), x).reshape(*idx.shape, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_onehot_equals_pallas_kernel(dtype):
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.normal(size=(2, 32, 8)).astype(np.float32)).astype(dtype)
    idx = rng.integers(0, 32, size=(2, 16, 3)).astype(np.int32)
    idx[:, :, 0] = 5                                   # a hub
    want = np.asarray(_jax_gather_kernel(x, jnp.asarray(idx), tm=16).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    before = cuda_gather.launches
    got = cuda_gather.gather_onehot(tx, torch.from_numpy(idx))
    assert cuda_gather.launches == before and got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
