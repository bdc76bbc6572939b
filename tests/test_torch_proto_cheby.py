"""Kernels 10 and 11's plain versions (`ops/cuda_proto_cheby.py`) against the
archived TPU probes `scripts/archive/proto_cheby_pallas.py:cheby_pallas` and
`scripts/archive/proto_cheby2.py:make_matmul_only` in interpret mode.

The archives call `pl.pallas_call` with no interpret switch, so each test
module's copy is loaded with importlib and its `pl` replaced by a namespace
whose `pallas_call` runs in interpret mode; the files are not touched.

Tolerances: both sides round the iterate to bf16 and take exact bf16 x bf16
products, so they differ only in the order of their f32 sums.  A d entry
near a bf16 rounding boundary may then round the other way, and the flip
carries through later steps: 1e-6 of max |x| at 1-3 steps, 5e-3 at 50."""
import functools
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_proto_cheby

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"archived_{name}", REPO / "scripts" / "archive" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    return mod


proto = _load("proto_cheby_pallas")
probe = _load("proto_cheby2")


@pytest.fixture
def probe_size():
    """Set the probe module's M and ITERS; restore them afterwards."""
    saved = probe.M, probe.ITERS

    def set_size(m, iters):
        probe.M, probe.ITERS = m, iters
    yield set_size
    probe.M, probe.ITERS = saved


def _lp_system(seed, m):
    """A normalised random S (M, M) and 3 label columns, as
    tests/test_torch_cheby.py builds them; S as an exact f32 copy of its
    bf16 rounding."""
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
    return np.array(jnp.asarray(s).astype(jnp.bfloat16).astype(jnp.float32)), b


def _both(s, b, alpha, iters):
    """(port plain version, archive kernel in interpret mode), numpy f32."""
    got = cuda_proto_cheby.proto_cheby_solve_reference(
        torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(b), alpha, iters).numpy()
    want = np.asarray(proto.cheby_pallas(jnp.asarray(s, jnp.bfloat16), jnp.asarray(b), alpha,
                                         iters))
    return got, want


@pytest.mark.parametrize("seed,m", [(0, 100), (1, 128)])
@pytest.mark.parametrize("iters", [1, 2, 50])
def test_plain_matches_cheby_pallas(seed, m, iters):
    """m = 100 and 128, neither a multiple of the archive's 256 rows (its
    padding path runs): 1e-6 of max |x| at 1 and 2 steps, 5e-3 at 50."""
    s, b = _lp_system(seed, m)
    got, want = _both(s, b, 0.99, iters)
    assert got.shape == want.shape == (m, 3)
    tol = 5e-3 if iters == 50 else 1e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_plain_rounds_d_to_bf16():
    """A dense b at 3 steps: the plain version sits within 1e-6 of max of
    `cheby_pallas`, and kernel 7's plain version (f32 d, no rounding) more
    than 1e-4 away, so a plain version that forgot to round d fails."""
    s, _ = _lp_system(2, 100)
    b = np.random.default_rng(3).normal(size=(100, 3)).astype(np.float32)
    got, want = _both(s, b, 0.99, 3)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    f32_d = cuda_cheby.cheby_solve_reference(torch.from_numpy(s).to(torch.bfloat16),
                                             torch.from_numpy(b), 0.99, 3).numpy()
    assert np.abs(f32_d - want).max() > 1e-4 * scale


@pytest.mark.parametrize("m", [64, 96])
@pytest.mark.parametrize("ncols", [8, 128])
@pytest.mark.parametrize("tile_rows", [None, 32])
def test_matmul_only_plain_matches_archive(probe_size, m, ncols, tile_rows):
    """The probe with its M at 64 and 96 and ITERS = 3, on S uniform in [0,
    1) as the archive draws it: within 1e-4 of max (one bf16 flip of an
    operand); tile_rows gives the same numbers."""
    probe_size(m, 3)
    rng = np.random.default_rng(m + ncols)
    s = jnp.asarray(rng.random((m, m), dtype=np.float32), jnp.bfloat16)
    b = rng.normal(size=(m, ncols)).astype(np.float32)
    want = np.asarray(probe.make_matmul_only(ncols, tile_rows)(s, jnp.asarray(b)))
    got = cuda_proto_cheby.matmul_only_reference(
        torch.from_numpy(np.array(s.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(b), 3).numpy()
    assert got.shape == want.shape == (m, ncols)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_one_step_is_b_over_theta():
    """The shared `coefficients`: a 1-step solve returns b / theta."""
    s, b = _lp_system(4, 40)
    theta, steps = cuda_cheby.coefficients(0.99, 1)
    got = cuda_proto_cheby.proto_cheby_solve_reference(torch.from_numpy(s).to(torch.bfloat16),
                                                       torch.from_numpy(b), 0.99, 1)
    assert steps == []
    torch.testing.assert_close(got, torch.from_numpy(b) / theta, rtol=0, atol=0)


def test_ldk_keeps_b_loads_off_bank_conflicts():
    """The bf16 buffers' leading dimension covers m in whole 16-row k-tiles
    and is 16 mod 64, as `csrc/proto_cheby.cu` checks."""
    for m in (1, 37, 100, 1001, 4396, 4480):
        k = cuda_proto_cheby.ldk(m)
        assert k >= -(-m // 16) * 16 and k % 64 == 16 and k - m < 80
    assert cuda_proto_cheby.smem_bytes(2, 4480) <= cuda_proto_cheby.SMEM_LIMIT
