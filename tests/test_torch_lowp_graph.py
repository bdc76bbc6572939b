"""The port's bf16 episode graph (`ops/lp.py` with compare_dtype bf16, a
bf16 S solved by kernel 7's plain version) vs the JAX package's relaxed
graph (`compare_dtype` / `matvec_dtype` = bf16, solver='cheby').

As in test_torch_lp.py, the JAX side takes its k-th radius from the Pallas
kernel in interpret mode, which the port follows.

Both frameworks round the distances to a bf16 compare copy for neighbour
selection.  Where a distance lies within f32 rounding of a bf16 rounding
boundary, the two copies can differ by one bf16 step, and where that step
crosses a row's radius they select different neighbours while both are
right.  So each case first shows that the two compare copies are equal
(the operator tests) or, in the tiny-config slice, where a few of the
6400 entries do differ by a step, that both select the same neighbours
(the seeds were picked so; a failure of that check means the inputs
changed, not the port), then holds the graphs and their results to each
other."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r3dfsseg_tpu.ops.lp as jax_lp
from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.ops import cuda_kth, lp
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (episode_arrays, jax_graph_nodes, port_graph_nodes,
                                random_flax_weights, train_episode)

BF16 = torch.bfloat16


def _pallas_kth(d, k, iters=32):
    return kth_smallest_per_row_pallas(d, k, iters=iters, tile_n=8, interpret=True)


@pytest.fixture
def jax_kth_kernel(monkeypatch):
    monkeypatch.setattr(jax_lp, "_kth_smallest_per_row", _pallas_kth)


def _f32(x) -> np.ndarray:
    """A JAX or torch array (any float dtype) as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in units of the bf16 spacing at the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return np.abs(got - want) / ulp


def _compare_copies(x_jax: np.ndarray, x_port: np.ndarray):
    """Each framework's bf16 compare copy of its own node features (f32
    numpy), before the sentinels."""
    f = jnp.asarray(x_jax)
    xc = f - jnp.mean(f, axis=0, keepdims=True)
    want = jax_lp._centered_sqdist(xc.astype(jnp.bfloat16),
                                   jnp.sum(xc * xc, axis=-1, keepdims=True))
    t = torch.from_numpy(np.ascontiguousarray(x_port))
    tc = t - t.mean(0, keepdim=True)
    got = lp._CenteredSqdist.apply(tc.to(BF16), (tc * tc).sum(-1, keepdim=True))
    return _f32(want.astype(jnp.bfloat16)), _f32(got.to(BF16))


def _assert_copies_equal(x_jax, x_port, valid):
    want, got = _compare_copies(x_jax, x_port)
    off = ~np.eye(len(want), dtype=bool) & valid[None, :]
    assert (got[off] == want[off]).all(), \
        f"the bf16 compare copies differ on {(got[off] != want[off]).sum()} entries"


def _assert_same_selection(x_jax, x_port, valid, k):
    """Each framework's neighbour selection on its own compare copy (16
    bisection steps: the Pallas kernel in interpret mode and the port's
    plain version) keeps the same (i, j) pairs."""
    want, got = _compare_copies(x_jax, x_port)
    drop = np.eye(len(want), dtype=bool) | ~valid[None, :]
    sel_j = jnp.where(drop, jnp.asarray(1e30, jnp.bfloat16), jnp.asarray(want, jnp.bfloat16))
    sel_t = torch.from_numpy(got).to(BF16).masked_fill(torch.from_numpy(drop), 1e30)
    r_j = np.asarray(_pallas_kth(sel_j, k, iters=16))
    r_t = cuda_kth.kth_smallest_per_row_reference(sel_t, k, 16).numpy()
    mask_j, mask_t = _f32(sel_j) <= r_j, _f32(sel_t) <= r_t
    assert (mask_j == mask_t).all(), \
        f"the two bf16 selections differ on {(mask_j != mask_t).sum()} pairs"


@pytest.mark.parametrize("seed", [0, 1])
def test_centered_sqdist_matches_jax(seed):
    """Forward vs `_centered_sqdist` (rtol 1e-5: f32 sums in another
    order) and the custom backward vs `_cs_bwd` on the same cotangent:
    d_xb bf16 within one bf16 step, d_xx rtol 1e-5."""
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(40, 12)).astype(np.float32)
    xb = _f32(jnp.asarray(xc).astype(jnp.bfloat16))
    xx = (xc * xc).sum(-1, keepdims=True)
    g = rng.normal(size=(40, 40)).astype(np.float32)
    want, res = jax_lp._cs_fwd(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(xx))
    want_dxb, want_dxx = jax_lp._cs_bwd(res, jnp.asarray(g))

    txb = torch.from_numpy(xb).to(BF16).requires_grad_()
    txx = torch.from_numpy(xx).requires_grad_()
    out = lp._CenteredSqdist.apply(txb, txx)
    out.backward(torch.from_numpy(g))
    want = np.asarray(want)
    np.testing.assert_array_equal(out.detach().numpy() > 0, want > 0)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert txb.grad.dtype == BF16 and want_dxb.dtype == jnp.bfloat16
    assert _bf16_ulps(_f32(txb.grad), _f32(want_dxb)).max() <= 1.0
    np.testing.assert_allclose(txx.grad.numpy(), np.asarray(want_dxx), rtol=1e-5,
                               atol=1e-5 * np.abs(want_dxx).max())


@pytest.mark.parametrize("sigma", [1.0, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_affinity_matches_jax(jax_kth_kernel, sigma, masked):
    """bf16 out; with equal compare copies, the same neighbours, and every
    value within one bf16 step (the f32 exp before the rounding differs
    at f32 rounding)."""
    rng = np.random.default_rng(10 + int(masked) + 2 * int(sigma))
    x = rng.normal(size=(48, 6)).astype(np.float32)
    valid = np.ones(48, bool)
    if masked:
        valid[[3, 10, 11, 30]] = False
    _assert_copies_equal(x, x, valid)
    want = jax_lp.local_constrained_affinity(jnp.asarray(x), 8, sigma, valid=jnp.asarray(valid),
                                             compare_dtype=jnp.bfloat16)
    got = lp.local_constrained_affinity(torch.from_numpy(x), 8, sigma,
                                        valid=torch.from_numpy(valid), compare_dtype=BF16)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    got, want = _f32(got), _f32(want)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert _bf16_ulps(got, want).max() <= 1.0
    assert (np.diag(got) == 0).all() and (got == got.T).all()


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_bf16_affinity_gradient_matches_jax(jax_kth_kernel, sigma):
    """The node-feature gradient through the bf16 Gram's custom backward:
    cosine > 0.999 and relative L2 <= 1e-2 (bf16 cotangents rounded at the
    same points, whose roundings differ where the f32 values do)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[[5, 17]] = False
    w = rng.normal(size=(40, 40)).astype(np.float32)
    _assert_copies_equal(x, x, valid)

    def loss(x_):
        a = jax_lp.local_constrained_affinity(x_, 8, sigma, valid=jnp.asarray(valid),
                                              compare_dtype=jnp.bfloat16)
        return jnp.sum(a.astype(jnp.float32) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (lp.local_constrained_affinity(tx, 8, sigma, valid=torch.from_numpy(valid),
                                   compare_dtype=BF16).float() * torch.from_numpy(w)).sum().backward()
    got = tx.grad.numpy()
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.999, cos
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("adjoint_iters", [None, 5])
def test_bf16_label_propagation_matches_jax(jax_kth_kernel, adjoint_iters):
    """The bf16 S (self-normalised, rounded once) and the solve, values
    rtol 1e-4; the implicit gradient vs `jax.grad` through
    `custom_linear_solve`: the bf16 affinity's within a bf16 step of its
    largest entry (dS is rounded to bf16 in both), the labels' rtol 1e-4."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    a = jax_lp.local_constrained_affinity(jnp.asarray(x), 8, 1.0, compare_dtype=jnp.bfloat16)
    y = np.zeros((50, 3), np.float32)
    y[:9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    w = rng.normal(size=(50, 3)).astype(np.float32)

    def solve(a_, y_):
        return jax_lp.label_propagate(a_, y_, 0.99, solver="cheby", cg_iters=30,
                                      matvec_dtype=jnp.bfloat16, adjoint_iters=adjoint_iters)

    want_z = np.asarray(solve(a, jnp.asarray(y)))
    want_a, want_y = jax.grad(lambda a_, y_: jnp.sum(solve(a_, y_) * w), argnums=(0, 1))(
        a, jnp.asarray(y))
    ta = torch.from_numpy(_f32(a)).to(BF16).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    z = lp.label_propagate(ta, ty, 0.99, cg_iters=30, adjoint_iters=adjoint_iters)
    (z * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), want_z, rtol=1e-4,
                               atol=1e-4 * np.abs(want_z).max())
    assert ta.grad.dtype == BF16 and want_a.dtype == jnp.bfloat16
    got_a, want_a = _f32(ta.grad), _f32(want_a)
    np.testing.assert_allclose(got_a, want_a, rtol=2 ** -7, atol=2 ** -8 * np.abs(want_a).max())
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-6)


def test_bf16_s_is_rounded_once():
    """S of a bf16 affinity: f32 degrees and scales, one rounding to bf16."""
    a = torch.rand(30, 30, generator=torch.Generator().manual_seed(0))
    a = ((a + a.t()) * (torch.rand(30, 30) < 0.3)).fill_diagonal_(0.0).to(BF16)
    s = lp.propagation_matrix(a)
    assert s.dtype == BF16
    r = (1.0 / (a.double().sum(1) + 2.220446049250313e-16)).sqrt()
    want = (a.double() * r[:, None] * r[None, :]).to(BF16)
    assert _bf16_ulps(_f32(s), _f32(want)).max() <= 1.0


# ------------------------------------------------- the slice, tiny config --
@pytest.fixture(scope="module")
def jax_bf16_side():
    """The JAX model at tiny_config(graph_dtype='bfloat16', attn_dropout=0)
    with the k-th radius of the Pallas kernel in interpret mode: variable
    shapes, eval logits, train loss and gradients, embeddings."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_lp, "_kth_smallest_per_row", _pallas_kth)
    cfg = jax_tiny_config(graph_dtype="bfloat16", attn_dropout=0.0)
    model = jax_mpti.MPTINet(cfg)
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    logits = jax.jit(functools.partial(model.apply, train=False), static_argnames="eval_mdns")

    @jax.jit
    def loss_and_grads(params, stats, ep):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, ep, train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(2)})
            return out.lp_loss + cfg.contrast_weight * out.contrast_loss, out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def features(train):
        return jax.jit(lambda v, x: model.apply(
            v, x, method=lambda m, x: m.features(x, train=train), mutable=["batch_stats"])[0])

    yield cfg, shapes, logits, loss_and_grads, {False: features(False), True: features(True)}
    mp.undo()


def _check_graph_precondition(jax_side, variables, model, cfg, arrays, eval_mdns, train):
    jcfg, *_, features = jax_side
    sx, sy, qx = arrays[:3]
    enc = lambda x: np.asarray(features[train](variables, jnp.asarray(x)))  # noqa: E731
    node_j, valid = jax_graph_nodes(enc, jcfg, sx, sy, qx, eval_mdns)
    node_t = port_graph_nodes(copy.deepcopy(model), cfg, sx, sy, qx, eval_mdns, train)
    _assert_same_selection(node_j, node_t, valid, cfg.k_connect)


@pytest.mark.parametrize("seed,eval_mdns", [(12, True), (27, False)])
def test_bf16_graph_slice_matches_jax(jax_bf16_side, seed, eval_mdns):
    """`MPTINet` eval logits at tiny_config(graph_dtype='bfloat16') vs the
    JAX model with the same weights: atol = rtol = 1e-3, as the float32
    slice (a few entries of the bf16 S may differ by one bf16 step where
    the f32 values before the rounding differ), and the predictions agree
    on >= 99% of points."""
    jcfg, shapes, jax_logits, _, _ = jax_bf16_side
    cfg = tiny_config(graph_dtype="bfloat16", attn_dropout=0.0)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    arrays = episode_arrays(cfg, rng)
    _check_graph_precondition(jax_bf16_side, variables, learner.model, cfg, arrays, eval_mdns,
                              train=False)

    want = np.asarray(jax_logits(variables, JaxEpisode(*map(jnp.asarray, arrays)),
                                 eval_mdns=eval_mdns).query_logits)
    with torch.no_grad():
        got = learner.model(Episode(*map(torch.from_numpy, arrays)),
                            eval_mdns=eval_mdns).query_logits.numpy()
    assert got.shape == want.shape == (1, cfg.n_way, cfg.pc_npts, cfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("seed", [3, 8])
def test_bf16_graph_train_step_matches_jax(jax_bf16_side, seed):
    """One `MPTILearner.train` step at tiny_config(graph_dtype='bfloat16')
    vs the JAX loss_fn with the same weights: losses rtol 1e-4, each
    parameter's gradient within a relative L2 distance of 1e-3 (the bf16
    cotangents of S, A and the Gram round at the same points in both, and
    differ only where the f32 values before them do)."""
    jcfg, shapes, _, loss_and_grads, _ = jax_bf16_side
    cfg = tiny_config(graph_dtype="bfloat16", attn_dropout=0.0)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    arrays = train_episode(cfg, rng)
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    _check_graph_precondition(jax_bf16_side, variables, learner.model, cfg, arrays,
                              eval_mdns=False, train=True)

    (loss, out), grads = loss_and_grads(params, stats, JaxEpisode(*map(jnp.asarray, arrays)))
    metrics = learner.train(arrays)
    for key, want in (("loss", loss), ("lp_loss", out.lp_loss),
                      ("contrast_loss", out.contrast_loss)):
        np.testing.assert_allclose(metrics[key].item(), float(want), rtol=1e-4, err_msg=key)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    top = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in learner.model.named_parameters():
        want = want_g[name].numpy()
        if name.startswith("features.base_learner.") and name.endswith(".conv.bias"):
            # feeds a train-mode BatchNorm: an exact gradient of 0, noise on both sides
            assert max(np.abs(want).max(), p.grad.abs().max().item()) < 1e-5 * top, name
            continue
        rel = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-3, (name, rel)
