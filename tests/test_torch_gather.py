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


# ---- csrc/gather.cu's narrow rows, the kernel emulated byte by byte ----
def _word(raw, a):
    """The aligned 4-byte word at a (a % 4 == 0) of the byte array, as an int."""
    assert a % 4 == 0
    return int.from_bytes(raw[a:a + 4].tobytes(), "little")


def _half(raw, a):
    return 0 if a is None else _word(raw, a & ~3) >> (8 * (a & 2)) & 0xFFFF


def _emulate_narrow(table: torch.Tensor, idx: np.ndarray, base: int = 0) -> torch.Tensor:
    """`r3d_gather_rows_narrow` on table (B, N, C) and idx (B, NQ, K), run as
    the kernel runs it, the table's bytes starting at address `base` (0 or
    2 mod 4): warps' runs of 32 x steps chunks, each run's rows staged as
    source rows (-1: a zero row), a cursor per lane moved 512 bytes a step
    without division, each chunk's words from `narrow_words`' loads (one
    aligned word, or two halves each from its aligned word), the tail's
    halfwords.  Checks on the way that each cursor stands at the
    chunk's (row, offset), that the cursor reads no row past its run's
    slots, and that every output byte is written once."""
    b, n, c = table.shape
    rb = c * table.element_size()
    plan = cuda_gather.narrow_plan(rb, base)
    assert plan["group_rows"] * rb == 16 * plan["group_chunks"]
    assert all((g * rb) % 16 for g in range(1, plan["group_rows"]))   # the least such G
    steps, dq, dr = plan["steps"], plan["dq"], plan["dr"]
    raw = np.zeros(base + table.numel() * table.element_size() + 8, np.uint8)
    raw[base:base + table.numel() * table.element_size()] = \
        table.contiguous().view(torch.uint8).reshape(-1).numpy()
    flat = idx.reshape(-1)
    rows, m = flat.size, flat.size // b
    total = rows * rb
    chunks = -(-total // 16)
    out = np.zeros(total, np.uint8)
    written = np.zeros(total, np.int32)
    for c0 in range(0, chunks, 32 * steps):
        r0, first = divmod(16 * c0, rb)
        nr = (first + 512 * steps - 1) // rb + 2
        assert nr <= 260                                  # the kernel's slots a warp
        slots = [(r0 + i) // m * n + int(flat[r0 + i])
                 if r0 + i < rows and 0 <= flat[r0 + i] < n else -1 for i in range(nr)]

        def src(slot):
            return None if slots[slot] < 0 else base + slots[slot] * rb

        for lane in range(32):
            slot, off = divmod(first + 16 * lane, rb)
            for s in range(steps):
                ch = c0 + lane + 32 * s
                if ch >= chunks:
                    break
                if s:
                    slot, off = slot + dq, off + dr
                    if off >= rb:
                        slot, off = slot + 1, off - rb
                assert (r0 + slot, off) == divmod(16 * ch, rb)
                words, _, _ = cuda_gather.narrow_words(rb, slot, off, src, plan["aligned"])
                val = 0
                for i, w in enumerate(words):
                    if w[0] == "word":
                        v = 0 if w[1] is None else _word(raw, w[1])
                    else:
                        v = _half(raw, w[1]) | _half(raw, w[2]) << 16
                    val |= v << (32 * i)
                got = np.frombuffer(val.to_bytes(16, "little"), np.uint8)
                end = min(16, total - 16 * ch)             # the tail: its halfwords
                out[16 * ch:16 * ch + end] = got[:end]
                written[16 * ch:16 * ch + end] += 1
    assert (written == 1).all()
    return torch.from_numpy(out).view(table.dtype).reshape(*idx.shape, c)


def _narrow_case(seed, b, n, nq, k, c, dtype):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, n, size=(b, nq, k)).astype(np.int32)
    idx[0, 0, 0], idx[-1, -1, -1], idx[1, 2, 1] = -1, n, 2**31 - 1    # outside [0, N)
    return table, idx


def _with_zero_rows(table, idx):
    """flat_take on the ids in [0, N), zero rows for the others."""
    ok = (idx >= 0) & (idx < table.shape[1])
    want = flat_take(table, torch.from_numpy(np.where(ok, idx, 0)))
    return torch.where(torch.from_numpy(ok)[..., None], want, torch.zeros((), dtype=table.dtype))


# (C, dtype) of rows that are not a multiple of 16 bytes (C = 60 f32, 240
# bytes, takes the 16-byte route)
NARROW_CASES = [(c, dt) for c in (1, 3, 7, 60, 63) for dt in (torch.float32, torch.bfloat16)
                if (c, dt) != (60, torch.float32)]


@pytest.mark.parametrize("c,dtype", NARROW_CASES)
def test_narrow_gather_plan_emulated_equals_flat_take(c, dtype):
    """The narrow kernel's groups, runs and cursor, emulated on the bytes at
    a 4-aligned and a 2-aligned table, on 333 rows (a ragged last group at
    every G) with ids outside [0, N): equal to `flat_take`, and zero rows
    for the outside ids."""
    table, idx = _narrow_case(c, 3, 50, 37, 3, c, dtype)
    want = _with_zero_rows(table, idx)
    for base in (0, 2):
        got = _emulate_narrow(table, idx, base)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), base


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_gather_emulated_equals_pallas_kernel(dtype):
    """At C = 7 (28 or 14 bytes a row) on 63 rows, ids outside [0, N) among
    them: the emulated narrow kernel equals `_gather_kernel` in interpret
    mode, whose one-hot rows of such ids are zero."""
    tdt = getattr(torch, dtype)
    table, idx = _narrow_case(5, 3, 20, 7, 3, 7, tdt)
    x = jnp.asarray(table.float().numpy()).astype(dtype)
    want = np.asarray(_jax_gather_kernel(x, jnp.asarray(idx), tm=7).astype(jnp.float32))
    got = _emulate_narrow(table, idx, 2)
    np.testing.assert_array_equal(got.float().numpy(), want)
