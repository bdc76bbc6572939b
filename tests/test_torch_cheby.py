"""Kernel 7's plain versions (`ops/cuda_cheby.py`) vs the JAX package's
Chebyshev solves: `cheby_solve_pallas` in interpret mode, and the XLA loop
`_chebyshev` that the JAX package runs off the TPU.

The TPU kernel feeds a bf16 S to the MXU with d split into a bf16 hi + lo
pair packed into one operand; the kernel (`r3d_cheby`) and its plain version
`cheby_solve_split_reference` do the same.  `cheby_solve_reference`, the
plain path (impl 'xla') and what a CPU tensor takes, multiplies the upcast S
by the f32 d, as the JAX package's XLA loop does: on an f32 S the two agree
to f32 rounding; on a bf16 S they differ by the split's error, which the JAX
package's own test bounds at 2e-3 of the largest entry
(tests/test_pallas_cheby.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops.lp import _chebyshev
from r3dfsseg_tpu.ops.pallas_cheby import cheby_solve_pallas
from r3dfsseg_tpu_torch.ops import cuda_cheby


def _lp_system(seed, m):
    """A normalised random S (M, M) and a 3-column right-hand side, f32."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m)).astype(np.float32)
    a = (a + a.T) * 0.5
    np.fill_diagonal(a, 0.0)
    deg = a.sum(1)
    s = (a / np.sqrt(np.outer(deg, deg))).astype(np.float32)
    b = np.zeros((m, 3), np.float32)
    b[rng.choice(m, size=m // 4, replace=False), 0] = 1.0
    b[rng.choice(m, size=m // 4, replace=False), 1] = 1.0
    b[:5, 2] = 0.5
    return s, b


def _bf16(s):
    """s rounded to bf16, as an f32 numpy array (exact)."""
    return np.array(jnp.asarray(s).astype(jnp.bfloat16).astype(jnp.float32))


def _port(s, b, alpha, iters, dtype=torch.float32):
    return cuda_cheby.cheby_solve_reference(torch.from_numpy(s).to(dtype),
                                            torch.from_numpy(b), alpha, iters).numpy()


def test_plain_matches_pallas_interpret_f32():
    """m = 96 (not a multiple of the TPU kernel's 128: its padding path);
    rtol 2e-5, the JAX kernel test's own f32 tolerance."""
    s, b = _lp_system(0, 96)
    want = np.asarray(cheby_solve_pallas(jnp.asarray(s), jnp.asarray(b), 0.99, 40,
                                         interpret=True))
    np.testing.assert_allclose(_port(s, b, 0.99, 40), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("iters", [1, 2, 60])
def test_plain_matches_pallas_interpret_bf16(iters):
    """bf16 S at m = 128: within 2e-3 of the largest entry, the TPU
    kernel's split-bf16 error."""
    s, b = _lp_system(1, 128)
    sb = _bf16(s)
    want = np.asarray(cheby_solve_pallas(jnp.asarray(sb, jnp.bfloat16), jnp.asarray(b), 0.99,
                                         iters, interpret=True))
    got = _port(sb, b, 0.99, iters, torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


@pytest.mark.parametrize("iters", [2, 50])
def test_plain_matches_jax_chebyshev_on_bf16_s(iters):
    """The same bf16 S through the JAX package's XLA loop (S upcast to f32,
    the off-TPU path of `label_propagate`): f32 rounding only, rtol 1e-5
    of the largest entry (JAX runs the scalar recurrence in f32, the port
    in double)."""
    s, b = _lp_system(2, 128)
    sb = _bf16(s)
    sj = jnp.asarray(sb, jnp.bfloat16)
    want = np.asarray(_chebyshev(lambda z: z - 0.99 * (sj @ z), jnp.asarray(b), 0.01, 1.99,
                                 iters=iters))
    got = _port(sb, b, 0.99, iters, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_plain_converges_to_direct_solve():
    """200 steps at alpha 0.9 reach np.linalg.solve, rtol 1e-3 / atol 1e-4
    (the JAX kernel test's bound)."""
    s, b = _lp_system(3, 64)
    want = np.linalg.solve(np.eye(64) - 0.9 * s.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(_port(s, b, 0.9, 200), want, rtol=1e-3, atol=1e-4)


def test_coefficients_follow_the_recurrence():
    """theta = 1 at any alpha, and the (c1, c2) schedule of Saad 12.1."""
    theta, steps = cuda_cheby.coefficients(0.99, 4)
    assert theta == pytest.approx(1.0) and len(steps) == 3
    rho, sigma1 = 0.99, 1.0 / 0.99
    for c1, c2 in steps:
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        assert (c1, c2) == pytest.approx((rho_new * rho, 2.0 * rho_new / 0.99), rel=1e-15)
        rho = rho_new
    assert cuda_cheby.coefficients(0.99, 1)[1] == []


def _split_system(seed, m, c):
    """`_lp_system`'s S rounded to bf16 and its 3 label columns, with c - 3
    dense normal columns after them (as an adjoint solve's right-hand side)."""
    s, b = _lp_system(seed, m)
    if c > 3:
        extra = np.random.default_rng(seed + 100).normal(size=(m, c - 3)).astype(np.float32)
        b = np.concatenate([b, extra], axis=1)
    return _bf16(s), b


@pytest.mark.parametrize("iters", [1, 2, 60])
@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("m", [96, 128])
def test_split_plain_matches_pallas_interpret(m, c, iters):
    """The kernel's plain version against the TPU kernel (its packed hi + lo
    operand, `body_packed`) at m = 96 (the TPU kernel's padding path) and
    128: the same arithmetic up to the order of the f32 sums and the step
    scalars (the TPU kernel carries them in f32, the port in double), within
    1e-5 of the largest entry (measured: 0 at 1 step, 2e-7 at 2, at most
    7.8e-6 at 60)."""
    sb, b = _split_system(1, m, c)
    want = np.asarray(cheby_solve_pallas(jnp.asarray(sb, jnp.bfloat16), jnp.asarray(b), 0.99,
                                         iters, interpret=True))
    got = cuda_cheby.cheby_solve_split_reference(torch.from_numpy(sb).to(torch.bfloat16),
                                                 torch.from_numpy(b), 0.99, iters).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("m", [96, 128])
def test_split_plain_within_cheby_tol_of_f32_plain(m, c):
    """On the same bf16 S, the split (the kernel's arithmetic) stays within
    1e-4 of the largest entry of the f32-product plain version at 60 steps:
    the card's gate between kernel 7 and `cheby_solve_reference`
    (chip_smoke.CHEBY_TOL)."""
    sb, b = _split_system(1, m, c)
    s16, tb = torch.from_numpy(sb).to(torch.bfloat16), torch.from_numpy(b)
    got = cuda_cheby.cheby_solve_split_reference(s16, tb, 0.99, 60)
    want = cuda_cheby.cheby_solve_reference(s16, tb, 0.99, 60)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_split_columns_pack_into_one_n8_operand(c):
    """C <= 4: hi and lo packed into one 8-column operand (hi in columns 0 ..
    C - 1, lo in C .. 2C - 1, the rest repeating column 2C - 1, as the
    kernel's B fragment loads clamp them) give, from one product, the same
    S hi and S lo as two separate products: exact, in float64, where every
    bf16 x bf16 product and these sums are exact.  hi + lo keeps d to 2^-16
    of its magnitude."""
    sb, _ = _split_system(4, 64, 3)
    s = torch.from_numpy(sb).double()
    d = torch.from_numpy(np.random.default_rng(c).normal(size=(64, c)).astype(np.float32))
    live = cuda_cheby.split_columns(d)
    assert live.shape == (64, 2 * c) and live.dtype == torch.bfloat16
    packed = torch.cat([live, live[:, -1:].expand(64, 8 - 2 * c)], dim=1).double()
    one = s @ packed
    hi, lo = d.to(torch.bfloat16), (d - d.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(one[:, :c], s @ hi.double())
    assert torch.equal(one[:, c:2 * c], s @ lo.double())
    err = (hi.double() + lo.double() - d.double()).abs()
    assert bool((err <= 2.0 ** -16 * d.double().abs()).all())
