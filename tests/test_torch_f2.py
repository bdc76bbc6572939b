"""Fault F2 and kernel 9's bf16 form, on the CPU: the shapes and operand types
that the archived TPU kernels 8-11 take past the port's tuned kernels.

- The plain fused EdgeConv tail (`ops/fused_edge.py`, the plain versions of
  `ops/cuda_fused_edge.py`) on a bf16 e_raw, and at F2 shapes (C = 12 and
  7, K = 9, B = 1, N = 12) in f32 and bf16, against the archived tail
  `scripts/archive/fused_edge.py` in interpret mode (loaded as
  tests/test_torch_fused_edge.py loads it): after the upcast both compute
  in f32, so the archive's tolerances hold (forward 1e-5, statistics 1e-5
  and 1e-4, gradients 2e-4).  A bf16 d_e is the rounding of two f32 values
  whose sums ran in another order: an entry may sit one bf16 step apart
  where the two straddle a rounding edge, on at most D_E_FLIP_SHARE of the
  entries.
- An emulation of the general kernel's design (`csrc/fused_edge_general.cu`):
  its groups of points, its chunks of K rows, its chunks of W1's columns
  and input channels, its partial last group and tile, its per-block
  partial sums added in block order, at small chunk sizes that make every
  one of those cases occur, against the plain versions (stats1 and fwd
  within 1e-5 of the largest entry, the backward within 1e-4).
- The fused route's bf16 e_raw from a bf16 `EdgeConv` (`_EdgeFirstLayer.
  operands`, then the gather and the add, as `chip_smoke.fused_edgeconv`
  builds it) against the JAX bf16 `_EdgeFirstLayer`'s edge tensor, weights
  through `state_dict_from_jax`.
- The plain gather at odd C against `_gather_kernel`, and the plain
  versions of kernels 10 (16 columns) and 11 (12 columns) against the
  archived probes, in interpret mode.
"""
import importlib.util
import math
import pathlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.nn import dgcnn as jax_dgcnn
from r3dfsseg_tpu.ops.fast_gather import gather_neighbors_fast as jax_gather_neighbors
from r3dfsseg_tpu.ops.knn import knn_indices as jax_knn_indices
from r3dfsseg_tpu_torch.nn.dgcnn import EdgeConv
from r3dfsseg_tpu_torch.ops import cuda_fused_edge as cfe
from r3dfsseg_tpu_torch.ops import cuda_gather, cuda_proto_cheby, fused_edge
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_gather import _jax_gather_kernel
from test_torch_proto_cheby import _lp_system, probe, probe_size, proto  # noqa: F401
from torch_port_helpers import random_flax_weights

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "archived_fused_edge_f2", REPO / "scripts" / "archive" / "fused_edge.py")
jfe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jfe)

D_E_FLIP_SHARE = 1e-2   # bf16 d_e entries one bf16 step from the archive's


@pytest.fixture(autouse=True)
def _interpret():
    jfe._INTERPRET = True
    yield
    jfe._INTERPRET = False


def _inputs(seed, b, n, k, c, bf16):
    """e_raw (numpy f32, bf16-representable when ``bf16``), gamma0, beta0,
    w1, gamma1, beta1, and random running statistics, as the archive's
    test draws them; e_raw's channels sit off zero as raw edges do."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    e = (rng.normal(size=(b, n, k, c)) * 1.5 + 0.5).astype(f32)
    if bf16:
        e = np.array(jnp.asarray(e).astype(jnp.bfloat16).astype(jnp.float32))
    g0, g1 = (rng.uniform(0.5, 1.5, c).astype(f32) for _ in range(2))
    b0 = (rng.normal(size=c) * 0.1).astype(f32)
    w1 = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(f32)
    b1 = (rng.normal(size=c) * 0.1).astype(f32)
    running = [(rng.normal(size=c) * 0.1).astype(f32), rng.uniform(0.5, 2.0, c).astype(f32),
               (rng.normal(size=c) * 0.1).astype(f32), rng.uniform(0.5, 2.0, c).astype(f32)]
    return [e, g0, b0, w1, g1, b1], running


def _jax_e(e, bf16):
    return jnp.asarray(e).astype(jnp.bfloat16) if bf16 else jnp.asarray(e)


def _torch_e(e, bf16):
    return torch.from_numpy(e).to(torch.bfloat16 if bf16 else torch.float32)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (unit in the last place) at |x|."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_bf16_close(got: np.ndarray, want: np.ndarray, tol: float):
    """Within rtol = atol = tol, or one bf16 step apart on at most
    D_E_FLIP_SHARE of the entries (two f32 values straddling a rounding
    edge round apart)."""
    diff = np.abs(got - want)
    off = diff > tol + tol * np.abs(want)
    assert np.all(diff[off] <= _bf16_step(np.maximum(np.abs(got), np.abs(want)))[off])
    assert off.mean() <= D_E_FLIP_SHARE, off.mean()


CASES = [  # (b, n, k, c): the archive test's shape, then the F2 shapes
    (2, 32, 5, 16), (1, 12, 9, 12), (1, 12, 9, 7)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,n,k,c", CASES)
def test_eval_forward_and_batch_stats_match_archive(b, n, k, c, bf16):
    params, running = _inputs(b + n + k + c, b, n, k, c, bf16)
    jp = [_jax_e(params[0], bf16)] + [jnp.asarray(a) for a in params[1:]]
    tp = [_torch_e(params[0], bf16)] + [torch.from_numpy(a) for a in params[1:]]
    want = jfe.fused_edge_tail(*jp, *map(jnp.asarray, running), False)
    got = fused_edge.fused_edge_tail(*tp, *map(torch.from_numpy, running), False)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want_s = jfe.edge_batch_stats(*jp[:4])
    got_s = fused_edge.edge_batch_stats(*tp[:4])
    for name, x, y, tol in zip(["m0", "v0", "m1", "v1"], got_s, want_s,
                               [1e-5, 1e-5, 1e-4, 1e-4]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,n,k,c", CASES)
def test_value_and_grads_match_archive(b, n, k, c, bf16, train):
    """A weighted sum of the output and its gradients in e_raw (in e_raw's
    type on both sides), gamma0, beta0, W1, gamma1, beta1."""
    params, running = _inputs(2 * (b + n + k + c) + int(train), b, n, k, c, bf16)
    w = np.cos(np.arange(b * n * c, dtype=np.float32)).reshape(b, n, c)

    def jax_loss(*p):
        stats = (map(jax.lax.stop_gradient, jfe.edge_batch_stats(*p[:4])) if train
                 else map(jnp.asarray, running))
        return jnp.sum(jfe.fused_edge_tail(*p, *stats, train) * w)

    jp = [_jax_e(params[0], bf16)] + [jnp.asarray(a) for a in params[1:]]
    want_v, want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(6)))(*jp)
    leaves = [_torch_e(params[0], bf16).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in params[1:]]
    stats = (fused_edge.edge_batch_stats(*leaves[:4]) if train
             else [torch.from_numpy(a) for a in running])
    loss = (fused_edge.fused_edge_tail(*leaves, *stats, train) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    assert str(want_g[0].dtype) == ("bfloat16" if bf16 else "float32")
    assert leaves[0].grad.dtype == leaves[0].dtype
    for name, t, g in zip(["de", "dgamma0", "dbeta0", "dW1", "dgamma1", "dbeta1"], leaves,
                          want_g):
        got, want = t.grad.float().numpy(), np.asarray(g.astype(jnp.float32))
        if name == "de" and bf16:
            assert_bf16_close(got, want, 2e-4)
        else:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4, err_msg=name)


# ------------------------------------------- the general kernel's design --
# csrc/fused_edge_general.cu Vec rows
VEC = {name: i for i, name in enumerate(cfe.VECS)}


def _leaky(x):
    return torch.where(x > 0, x, cfe.NEG_SLOPE * x)


def _bn(x, aff, sh):
    return x * aff + sh          # two roundings, as __fmul_rn then __fadd_rn


def _l1_tile(ef, w1, vec, row0, nr, c0, nc, rows, cols):
    """`l1_tile`: a (rows x cols) tile of l1 for nr rows from row0 and nc
    columns from c0, summed over chunks of ``cols`` input channels; zero
    past nr and nc."""
    c = ef.shape[-1]
    acc = torch.zeros((rows, cols))
    for q0 in range(0, c, cols):
        nq = min(cols, c - q0)
        hs = torch.zeros((rows, cols))
        hs[:nr, :nq] = _leaky(_bn(ef[row0:row0 + nr, q0:q0 + nq],
                                  vec[VEC["aff0"], q0:q0 + nq], vec[VEC["sh0"], q0:q0 + nq]))
        ws = torch.zeros((cols, cols))
        ws[:nq, :nc] = w1[q0:q0 + nq, c0:c0 + nc]
        acc = acc + hs @ ws
    return acc


def emulate_route(e, dout, w1, vec, mode, rows, cols, grid):
    """`edge_route_kernel` block by block: items (group of points, chunk of
    columns), a group kRows / K whole points or one point in chunks of
    kRows rows; returns out (fwd), the block partials (bwd1) or the
    scratch (kstar, dzr)."""
    p, k, c = e.shape[0] * e.shape[1], e.shape[2], e.shape[3]
    ef = e.reshape(-1, c).float()
    pts = rows // k if k <= rows else 1
    groups, chunks = -(-p // pts), -(-c // cols)
    out = torch.full((p, c), float("nan"))
    kstar = torch.full((p, c), -1, dtype=torch.int32)
    dzr = torch.full((p, c), float("nan"))
    partial = torch.zeros((grid, 2 * c))
    for blk in range(grid):
        for item in range(blk, groups * chunks, grid):
            p0, c0 = (item // chunks) * pts, (item % chunks) * cols
            nc, npts = min(cols, c - c0), min(pts, p - p0)
            best = torch.zeros((rows, cols))
            bz, bl = torch.zeros((rows, cols)), torch.zeros((rows, cols))
            bk = torch.zeros((rows, cols), dtype=torch.int32)
            for k0 in range(0, npts * k, rows):
                nr = min(rows, npts * k - k0)
                lt = _l1_tile(ef, w1, vec, p0 * k + k0, nr, c0, nc, rows, cols)
                for s in range(npts):
                    for cc in range(nc):
                        aff1, sh1 = vec[VEC["aff1"], c0 + cc], vec[VEC["sh1"], c0 + cc]
                        for rr in range(max(s * k, k0), min(s * k + k, k0 + nr)):
                            kk, l1 = rr - s * k, lt[rr - k0, cc]
                            z1 = _bn(l1, aff1, sh1)
                            h1 = _leaky(z1)
                            if kk == 0 or h1 > best[s, cc]:
                                best[s, cc], bz[s, cc], bl[s, cc], bk[s, cc] = h1, z1, l1, kk
            for s in range(npts):
                at = slice(c0, c0 + nc)
                if mode == "fwd":
                    out[p0 + s, at] = best[s, :nc]
                    continue
                dz = dout.reshape(p, c)[p0 + s, at] * torch.where(bz[s, :nc] > 0, 1.0,
                                                                  cfe.NEG_SLOPE)
                if mode == "route":
                    kstar[p0 + s, at], dzr[p0 + s, at] = bk[s, :nc], dz
                else:
                    xhat1 = (bl[s, :nc] - vec[VEC["mu1"], at]) * vec[VEC["inv1"], at]
                    partial[blk, at] += dz
                    partial[blk, c + c0:c + c0 + nc] += dz * xhat1
    return out, partial, kstar, dzr


def emulate_rows(e, w1, vec, kstar, dzr, name, rows, cols, grid):
    """`edge_rows_kernel` block by block: tiles of kRows rows across points
    (the last one partial), l1 by chunks of columns, dl1 from the route's
    scratch, dW1 by chunks of input channels into the block's partial, dh0
    by chunks of input channels and of columns; returns the partials
    (stats1, bwd2) or d_e (bwd3)."""
    p, k, c = e.shape[0] * e.shape[1], e.shape[2], e.shape[3]
    ef = e.reshape(-1, c).float()
    n_rows = p * k
    n_sums = {"stats1": 2 * c, "bwd2": c * c + 2 * c, "bwd3": 0}[name]
    partial = torch.zeros((grid, n_sums))
    de = torch.full((n_rows, c), float("nan"))
    v = {key: vec[i] for key, i in VEC.items()}
    for blk in range(grid):
        for tile in range(blk, -(-n_rows // rows), grid):
            row0 = tile * rows
            nr = min(rows, n_rows - row0)
            dl = torch.zeros((rows, c))
            for c0 in range(0, c, cols):
                nc = min(cols, c - c0)
                acc = _l1_tile(ef, w1, vec, row0, nr, c0, nc, rows, cols)[:nr, :nc]
                at = slice(c0, c0 + nc)
                if name == "stats1":
                    partial[blk, at] += acc.sum(0)
                    partial[blk, c + c0:c + c0 + nc] += (acc * acc).sum(0)
                    continue
                row = torch.arange(row0, row0 + nr)
                pt, kk = row // k, (row % k).to(torch.int32)
                hit = kk[:, None] == kstar[pt, c0:c0 + nc]
                dz = torch.where(hit, dzr[pt, c0:c0 + nc], 0.0)
                xhat1 = (acc - v["mu1"][at]) * v["inv1"][at]
                dl[:nr, at] = v["g1inv"][at] * (dz - v["mr1"][at] - xhat1 * v["mr2"][at])
            if name == "stats1":
                continue
            h0 = _leaky(_bn(ef[row0:row0 + nr], v["aff0"], v["sh0"]))
            if name == "bwd2":
                for q0 in range(0, c, cols):
                    nq = min(cols, c - q0)
                    dw = h0[:, q0:q0 + nq].T @ dl[:nr]
                    partial[blk, q0 * c:(q0 + nq) * c] += dw.reshape(-1)
            for q0 in range(0, c, cols):
                nq = min(cols, c - q0)
                acc = torch.zeros((rows, cols))
                for c0 in range(0, c, cols):
                    nc = min(cols, c - c0)
                    ws = torch.zeros((cols, cols))            # [column][input channel]
                    ws[:nc, :nq] = w1[q0:q0 + nq, c0:c0 + nc].T
                    dlc = torch.zeros((rows, cols))
                    dlc[:, :nc] = dl[:, c0:c0 + nc]
                    acc = acc + dlc @ ws
                at = slice(q0, q0 + nq)
                ev = ef[row0:row0 + nr, at]
                dz0 = acc[:nr, :nq] * torch.where(h0[:, at] > 0, 1.0, cfe.NEG_SLOPE)
                xhat0 = (ev - v["mu0"][at]) * v["inv0"][at]
                if name == "bwd3":
                    de[row0:row0 + nr, at] = v["g0inv"][at] * (dz0 - v["mq1"][at]
                                                              - xhat0 * v["mq2"][at])
                else:
                    partial[blk, c * c + q0:c * c + q0 + nq] += dz0.sum(0)
                    partial[blk, c * c + c + q0:c * c + c + q0 + nq] += (dz0 * xhat0).sum(0)
    return partial, de.reshape(e.shape).to(e.dtype)


def _sum_blocks(partial):
    """`r3d::sum_partials_kernel`: the blocks' partials added in block order."""
    total = torch.zeros(partial.shape[1])
    for row in partial:
        total = total + row
    return total


def emulate_general(name, args, rows, cols, grid):
    """One pass of the general kernel as its launches run it."""
    e = args[0]
    c = e.shape[-1]
    dout = args[1] if name.startswith("bwd") else None
    names = {"stats1": ["aff0", "sh0"], "fwd": ["aff0", "sh0", "aff1", "sh1"],
             "bwd1": ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1"],
             "bwd2": ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1", "mr2",
                      "inv0", "mu0"],
             "bwd3": ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1", "mr2", "inv0",
                      "mu0", "g0inv", "mq1", "mq2"]}[name]
    vals = dict(zip(names, args[2 if dout is not None else 1:-1]))
    vec = torch.stack([vals.get(key, torch.zeros(c)) for key in cfe.VECS])
    w1 = args[-1]
    if name == "stats1":
        s = _sum_blocks(emulate_rows(e, w1, vec, None, None, name, rows, cols, grid)[0])
        return s[:c], s[c:]
    mode = {"fwd": "fwd", "bwd1": "bwd1"}.get(name, "route")
    out, partial, kstar, dzr = emulate_route(e, dout, w1, vec, mode, rows, cols, grid)
    if name == "fwd":
        return out.reshape(*e.shape[:2], c)
    if name == "bwd1":
        s = _sum_blocks(partial)
        return s[:c], s[c:]
    partial, de = emulate_rows(e, w1, vec, kstar, dzr, name, rows, cols, grid)
    if name == "bwd3":
        return de
    s = _sum_blocks(partial)
    return s[:c * c].view(c, c), s[c * c:c * c + c], s[c * c + c:]


def _pass_args(seed, b, n, k, c, dtype):
    """Each pass's arguments from random e, dout and vectors."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    e = t(rng.normal(size=(b, n, k, c)) * 1.5 + 0.5).to(dtype)
    dout = t(rng.normal(size=(b, n, c)))
    w1 = t(rng.normal(size=(c, c)) / np.sqrt(c))
    vec = {name: t(rng.uniform(0.5, 1.5, c) if name.startswith(("aff", "inv", "g")) else
                   rng.normal(size=c) * 0.1) for name in cfe.VECS}
    pick = lambda *names: [vec[x] for x in names]  # noqa: E731
    v1 = pick("aff0", "sh0", "aff1", "sh1", "inv1", "mu1")
    v2 = v1 + pick("g1inv", "mr1", "mr2", "inv0", "mu0")
    return {"stats1": (e, *pick("aff0", "sh0"), w1),
            "fwd": (e, *pick("aff0", "sh0", "aff1", "sh1"), w1),
            "bwd1": (e, dout, *v1, w1), "bwd2": (e, dout, *v2, w1),
            "bwd3": (e, dout, *v2, *pick("g0inv", "mq1", "mq2"), w1)}


# (b, n, k, c, rows, cols, grid): the chunk sizes small enough that C spans
# several chunks with a partial last one, K spans several row chunks (and,
# at K <= rows, a group holds several points), the last group and tile are
# partial, and blocks take several items; then the kernel's own constants
EMULATED = [(1, 12, 9, 12, 4, 8, 3), (1, 12, 9, 7, 4, 8, 2), (2, 5, 3, 10, 8, 4, 3),
            (1, 7, 2, 5, 16, 64, 1), (2, 12, 20, 64, 16, 64, 5), (1, 3, 40, 70, 16, 64, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k,c,rows,cols,grid", EMULATED)
def test_general_kernel_design_matches_the_plain_versions(b, n, k, c, rows, cols, grid, dtype):
    args = _pass_args(b + n + k + c + rows, b, n, k, c, dtype)
    for name, a in args.items():
        got = emulate_general(name, a, rows, cols, grid)
        want = getattr(cfe, f"{name}_reference")(*a)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert not torch.isnan(g).any(), name
            scale = float(w.float().abs().max())
            if name == "bwd3" and dtype == torch.bfloat16:
                assert_bf16_close(g.float().numpy(), w.float().numpy(), tol * scale)
            else:
                assert float((g.float() - w.float()).abs().max()) <= tol * scale, name


def test_general_kernel_routes_ties_to_the_lowest_k():
    """Duplicated rows give exact ties in the max: the emulated route keeps
    the lowest k, as the plain version and the archive do, across a chunk
    edge of K (rows 1 and 6 of a point with chunks of 4 rows)."""
    args = _pass_args(3, 1, 4, 8, 6, torch.float32)
    e = args["bwd3"][0]
    e[:, :, 6] = e[:, :, 1]
    got = emulate_general("bwd3", args["bwd3"], 4, 4, 2)
    want = cfe.bwd3_reference(*args["bwd3"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_wrapper_limits_and_bf16_plain_types():
    """The plain versions take a bf16 e on its upcast and give d_e in e's
    type; the wrapper's dispatch bound (GENERAL_MAX_C) is the kernel's."""
    args = _pass_args(5, 1, 6, 3, 5, torch.bfloat16)
    up = {name: (a[0].float(),) + tuple(a[1:]) for name, a in args.items()}
    for name in cfe.PASSES:
        got = getattr(cfe, name)(*args[name])
        want = getattr(cfe, name)(*up[name])
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert torch.equal(g, w.to(g.dtype)), name
    assert cfe.bwd3(*args["bwd3"]).dtype == torch.bfloat16
    src = (REPO / "r3dfsseg_tpu_torch" / "csrc" / "fused_edge_general.cu").read_text()
    assert f"constexpr int kMaxC = {cfe.GENERAL_MAX_C};" in src
    rows_bytes = 4 * (64 * 17 + 64 * 65 + 2 * 16 * 64 + 16 * cfe.GENERAL_MAX_C)
    assert rows_bytes <= 232448          # the rows kernel's shared memory at the largest C


# ----------------------------------------------------- the route's e_raw --
@pytest.mark.parametrize("c_in,width", [(9, 16), (16, 12)])
def test_route_bf16_e_raw_matches_jax_edge_first_layer(c_in, width):
    """e_raw = gather(a, idx) + b of a bf16 EdgeConv's first layer against
    the JAX bf16 `_EdgeFirstLayer`'s own a, b (captured from its conv) and
    its gather: bf16 on both sides, each entry equal or one bf16 step apart
    (the two bf16 products may round apart), on at most 2% of the
    entries."""
    rng = np.random.default_rng(c_in + width)
    x = rng.normal(size=(2, 40, c_in)).astype(np.float32)
    k = 6
    jm = jax_dgcnn.EdgeConv((width, width), k=k, knn_impl="xla", dtype=jnp.bfloat16,
                            bn_mode="fastvar")
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng)
    _, inter = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                        capture_intermediates=True, mutable=["intermediates"])
    a_j, b_j = flax.core.unfreeze(inter)["intermediates"]["layer0"]["conv"]["__call__"]
    idx = jax_knn_indices(jnp.asarray(x), k)
    want = jax_gather_neighbors(a_j, idx) + b_j[:, :, None, :]
    assert want.dtype == jnp.bfloat16

    tm = EdgeConv(c_in, (width, width), k=k, knn_impl="xla", dtype=torch.bfloat16,
                  bn_modes=("fastvar", "fastvar"), gather_impl="xla")
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        a, b = tm.layer0.operands(torch.from_numpy(x))
        got = fused_edge.edge_gather(a, torch.from_numpy(np.array(idx)), "xla") + \
            b[:, :, None, :]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    off = g != w
    assert np.all(np.abs(g - w)[off] <= 2 * _bf16_step(np.maximum(np.abs(g), np.abs(w)))[off])
    assert off.mean() <= 0.02, off.mean()


# ------------------------------------------------ kernels 8, 10 and 11 --
@pytest.mark.parametrize("c,dtype", [(63, "float32"), (7, "bfloat16"), (60, "bfloat16"),
                                     (1, "float32")])
def test_gather_plain_at_odd_c_equals_pallas_kernel(c, dtype):
    rng = np.random.default_rng(c)
    x = jnp.asarray(rng.normal(size=(2, 32, c)).astype(np.float32)).astype(dtype)
    idx = rng.integers(0, 32, size=(2, 16, 3)).astype(np.int32)
    want = np.asarray(_jax_gather_kernel(x, jnp.asarray(idx), tm=16).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = cuda_gather.gather_onehot(tx, torch.from_numpy(idx))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("iters", [2, 50])
def test_proto_cheby_plain_at_16_columns_matches_cheby_pallas(iters):
    """Kernel 10's plain version at 16 label columns (the wrapper's two
    groups of 8 on the card) against `cheby_pallas`, which pads to 128:
    1e-6 of max at 2 steps, 5e-3 at 50 (tests/test_torch_proto_cheby.py)."""
    s, _ = _lp_system(5, 100)
    rng = np.random.default_rng(6)
    b = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 100)] * (rng.random((100, 1)) < 0.5)
    got = cuda_proto_cheby.proto_cheby_solve_reference(
        torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(b), 0.99, iters).numpy()
    want = np.asarray(proto.cheby_pallas(jnp.asarray(s, jnp.bfloat16), jnp.asarray(b), 0.99,
                                         iters))
    assert got.shape == want.shape == (100, 16)
    tol = 5e-3 if iters == 50 else 1e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    halves = [cuda_proto_cheby.proto_cheby_solve_reference(
        torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(b[:, i:i + 8].copy()), 0.99,
        iters).numpy() for i in (0, 8)]
    assert np.abs(np.concatenate(halves, 1) - want).max() <= tol * np.abs(want).max()


def test_matmul_only_plain_at_12_columns_matches_archive(probe_size):
    """Kernel 11's plain version at 12 columns against `make_matmul_only(12)`
    (M = 64, 3 steps): within 1e-4 of max; and the zero pad to 16 columns
    the card takes changes the 12 columns by nothing but the sums' order."""
    probe_size(64, 3)
    rng = np.random.default_rng(12)
    s = jnp.asarray(rng.random((64, 64), dtype=np.float32), jnp.bfloat16)
    b = rng.normal(size=(64, 12)).astype(np.float32)
    want = np.asarray(probe.make_matmul_only(12, None)(s, jnp.asarray(b)))
    ts = torch.from_numpy(np.array(s.astype(jnp.float32))).to(torch.bfloat16)
    got = cuda_proto_cheby.matmul_only_reference(ts, torch.from_numpy(b), 3)
    assert got.shape == want.shape == (64, 12)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    padded = cuda_proto_cheby.matmul_only_reference(
        ts, torch.nn.functional.pad(torch.from_numpy(b), (0, 4)), 3)
    assert float(padded[:, 12:].abs().max()) == 0.0
    torch.testing.assert_close(padded[:, :12], got, rtol=1e-6, atol=1e-6 * math.sqrt(64))
