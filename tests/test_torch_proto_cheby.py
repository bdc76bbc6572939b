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


# ---- kernel 11's design (csrc/matmul_probe.cu), emulated on the CPU --------
PLAN_M = [1, 15, 16, 17, 1000, 4396, 4480, cuda_proto_cheby.MAX_PROBE_M]


@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("sms", [114, 132])
def test_probe_split_covers_every_entry_of_s_once(m, sms):
    """Kernel 11's work split (`probe_plan`, `probe_segments`): the blocks'
    ranges are non-empty, within one unit of each other, and cover every
    (row group, chunk) unit exactly once, so every (row, k) of S is read
    once per step (a unit's rows and k tile [0, M) exactly); every segment
    has its own slot; each row group's partials are added in k order."""
    plan = cuda_proto_cheby.probe_plan(m, 128, sms)
    assert plan.grid == min(sms, plan.units) and plan.ldb % 8 == 0 and plan.ldb >= m
    sizes = [hi - lo for lo, hi in (cuda_proto_cheby.probe_range(plan, b)
                                    for b in range(plan.grid))]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1 and sum(sizes) == plan.units
    rows = [min(m, (r + 1) * 128) - r * 128 for r in range(plan.groups)]
    kc = cuda_proto_cheby.PROBE_CHUNK
    ks = [min(m, (c + 1) * kc) - c * kc for c in range(plan.chunks)]
    assert min(rows) > 0 and sum(rows) == m and min(ks) > 0 and sum(ks) == m
    count = np.zeros((plan.groups, plan.chunks), np.int64)
    segments = cuda_proto_cheby.probe_segments(plan)
    for blk, r, c0, c1, slot in segments:
        assert 0 <= c0 < c1 <= plan.chunks
        count[r, c0:c1] += 1
        for c in (c0, c1 - 1):
            assert cuda_proto_cheby.probe_owner(plan, r * plan.chunks + c) == blk
    assert (count == 1).all()
    slots = [seg[4] for seg in segments]
    assert len(set(slots)) == len(slots) and max(slots) < plan.slots
    for r in range(plan.groups):
        mine = sorted((c0, slot) for blk, rr, c0, c1, slot in segments if rr == r)
        assert cuda_proto_cheby.probe_reduce_order(plan, r) == [slot for _, slot in mine]


def test_probe_columns_and_quads_cover_every_output_once():
    """At every column count 1-128 a block computes probe_cols(ncols) >=
    ncols columns within the shared memory limit, and the reduction's quads
    of 4 rows (one column each) cover every (row, column) of acc once."""
    for ncols in range(1, 129):
        assert ncols <= cuda_proto_cheby.probe_cols(ncols) <= 128
        assert cuda_proto_cheby.probe_smem_bytes(ncols) <= cuda_proto_cheby.SMEM_LIMIT
        assert cuda_proto_cheby.matmul_only_fits(4480, ncols)
    for m in (1, 15, 17, 130):
        for ncols in (1, 7, 33, 128):
            quads = -(-m // 4)
            seen = np.zeros((m, ncols), np.int64)
            for q in range(ncols * quads):
                col, row = q // quads, 4 * (q % quads)
                seen[row:min(m, row + 4), col] += 1
            assert (seen == 1).all()
    assert not cuda_proto_cheby.matmul_only_fits(4480, 129)
    assert not cuda_proto_cheby.matmul_only_fits(cuda_proto_cheby.MAX_PROBE_M + 1, 8)


def test_probe_range_of_m_is_the_earlier_kernels():
    """The wrapper takes every M it took while kernel 11 staged an
    8-column block of bf16(acc): MAX_PROBE_M is the largest M whose block
    `smem_bytes(1, M)` fits."""
    top = cuda_proto_cheby.MAX_PROBE_M
    assert cuda_proto_cheby.smem_bytes(1, top) <= cuda_proto_cheby.SMEM_LIMIT
    assert cuda_proto_cheby.smem_bytes(1, top + 1) > cuda_proto_cheby.SMEM_LIMIT


def emulate_matmul_only(s: torch.Tensor, b: torch.Tensor, iters: int, sms: int) -> torch.Tensor:
    """Kernel 11's arithmetic in its order of sums: each unit's product of
    128 rows by 128 k summed from zero, a segment's units added in f32 in k
    order, the partials of a row group added in `probe_reduce_order`, times
    0.99, rounded to bf16 between steps."""
    m, ncols = b.shape
    plan = cuda_proto_cheby.probe_plan(m, ncols, sms)
    kc = cuda_proto_cheby.PROBE_CHUNK
    sf = s.float()
    acc = b
    for _ in range(iters):
        z = acc.to(torch.bfloat16).float()
        part = {}
        for _, r, c0, c1, slot in cuda_proto_cheby.probe_segments(plan):
            rows = sf[r * 128:(r + 1) * 128]
            tot = rows[:, c0 * kc:(c0 + 1) * kc] @ z[c0 * kc:(c0 + 1) * kc]
            for c in range(c0 + 1, c1):
                tot = tot + rows[:, c * kc:(c + 1) * kc] @ z[c * kc:(c + 1) * kc]
            part[slot] = tot
        sums = []
        for r in range(plan.groups):
            order = cuda_proto_cheby.probe_reduce_order(plan, r)
            tot = part[order[0]]
            for slot in order[1:]:
                tot = tot + part[slot]
            sums.append(tot)
        acc = torch.cat(sums) * cuda_proto_cheby.SCALE
    return acc


@pytest.mark.parametrize("m", [300, 1001])
@pytest.mark.parametrize("ncols", [24, 120])
@pytest.mark.parametrize("sms", [7, 132])
def test_emulated_order_of_sums_matches_plain(m, ncols, sms):
    """The emulation on S uniform in [0, 1) scaled by 1 / its row sums: 1
    step within 1e-6 of max of `matmul_only_reference` (the same products,
    f32 sums in another order), 3 steps within 1e-4 (the card's gate: a
    bf16 rounding of acc may flip).  sms = 7 puts several row groups in a
    block; 132 one unit in most blocks."""
    rng = np.random.default_rng(m + ncols + sms)
    a = rng.random((m, m), dtype=np.float32)
    s = torch.from_numpy(a / a.sum(1, keepdims=True)).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(m, ncols)).astype(np.float32))
    for iters, tol in ((1, 1e-6), (3, 1e-4)):
        got = emulate_matmul_only(s, b, iters, sms)
        want = cuda_proto_cheby.matmul_only_reference(s, b, iters)
        assert got.shape == want.shape == (m, ncols)
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("ncols", [24, 120])
def test_emulated_order_of_sums_matches_archive(probe_size, ncols):
    """The emulation against `make_matmul_only` in interpret mode at M =
    300 and ITERS = 3 on a grid of 4 blocks (three row groups of three
    chunks, the second block across two): within 1e-4 of max."""
    probe_size(300, 3)
    rng = np.random.default_rng(ncols)
    s = jnp.asarray(rng.random((300, 300), dtype=np.float32), jnp.bfloat16)
    b = rng.normal(size=(300, ncols)).astype(np.float32)
    want = np.asarray(probe.make_matmul_only(ncols, None)(s, jnp.asarray(b)))
    plan = cuda_proto_cheby.probe_plan(300, ncols, 4)
    assert (plan.groups, plan.chunks, plan.grid) == (3, 3, 4)
    assert [seg[:2] for seg in cuda_proto_cheby.probe_segments(plan)] == [(0, 0), (1, 0), (1, 1),
                                                                          (2, 1), (3, 2)]
    got = emulate_matmul_only(
        torch.from_numpy(np.array(s.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(b), 3, 4).numpy()
    assert got.shape == want.shape == (300, ncols)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
