"""Port fused EdgeConv tail (`ops/fused_edge.py`, the passes of
`ops/cuda_fused_edge.py`) against the archived JAX kernels
`scripts/archive/fused_edge.py` in interpret mode, loaded as their own test
loads them; then the port's fused EdgeConv route (`chip_smoke.fused_edgeconv`,
what the card runs) against the port's unfused `EdgeConv`.

Tolerances: the archive's own (`scripts/archive/test_fused_edge.py`): eval
forward 1e-5; batch statistics 1e-5, m1 and v1 1e-4; the train value rtol
1e-5; every gradient atol and rtol 2e-4.  Each pass's plain version against
the matching Pallas kernel body: rtol 1e-5 with an atol of 1e-5 of the
output's largest entry (f32 sums of 320 rows in another order)."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from r3dfsseg_tpu_torch.nn.dgcnn import EdgeConv
from r3dfsseg_tpu_torch.ops import cuda_fused_edge as cfe
from r3dfsseg_tpu_torch.ops import fused_edge

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "archived_fused_edge", REPO / "scripts" / "archive" / "fused_edge.py")
jfe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jfe)


@pytest.fixture(autouse=True)
def _interpret():
    jfe._INTERPRET = True
    yield
    jfe._INTERPRET = False


def _inputs(seed, b=2, n=32, k=5, c=16):
    """e_raw, gamma0, beta0, w1, gamma1, beta1 as numpy f32, as the
    archive's test draws them, and random running statistics."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    e = rng.normal(size=(b, n, k, c)).astype(f32)
    g0, g1 = (rng.uniform(0.5, 1.5, c).astype(f32) for _ in range(2))
    b0 = (rng.normal(size=c) * 0.1).astype(f32)
    w1 = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(f32)
    b1 = (rng.normal(size=c) * 0.1).astype(f32)
    running = [(rng.normal(size=c) * 0.1).astype(f32), rng.uniform(0.5, 2.0, c).astype(f32),
               (rng.normal(size=c) * 0.1).astype(f32), rng.uniform(0.5, 2.0, c).astype(f32)]
    return [e, g0, b0, w1, g1, b1], running


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def test_eval_forward_matches_archive():
    params, running = _inputs(0)
    want = jfe.fused_edge_tail(*_j(params), *_j(running), False)
    got = fused_edge.fused_edge_tail(*_t(params), *_t(running), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_batch_stats_match_archive():
    params, _ = _inputs(1)
    want = jfe.edge_batch_stats(*_j(params[:4]))
    got = fused_edge.edge_batch_stats(*_t(params[:4]))
    for name, a, b, tol in zip(["m0", "v0", "m1", "v1"], got, want, [1e-5, 1e-5, 1e-4, 1e-4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_value_and_grads_match_archive(train):
    """A weighted sum of the output (a nontrivial cotangent) and its
    gradients in e_raw, gamma0, beta0, W1, gamma1, beta1."""
    params, running = _inputs(2)
    w = _weights(params[0].shape[:2] + params[0].shape[3:])

    def jax_loss(*p):
        stats = (map(jax.lax.stop_gradient, jfe.edge_batch_stats(*p[:4])) if train
                 else _j(running))
        return jnp.sum(jfe.fused_edge_tail(*p, *stats, train) * w)

    want_v, want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(6)))(*_j(params))
    leaves = [t.requires_grad_() for t in _t(params)]
    stats = fused_edge.edge_batch_stats(*leaves[:4]) if train else _t(running)
    loss = (fused_edge.fused_edge_tail(*leaves, *stats, train) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name, t, g in zip(["de", "dgamma0", "dbeta0", "dW1", "dgamma1", "dbeta1"], leaves,
                          want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def _pass_vectors(seed, c):
    """Random (C,) vectors in the roles of the archive's pass arguments."""
    rng = np.random.default_rng(seed)
    names = ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1", "mr2", "inv0", "mu0",
             "g0inv", "mq1", "mq2"]
    return {n: (rng.uniform(0.5, 1.5, c) if n.startswith(("aff", "inv", "g")) else
                rng.normal(size=c) * 0.1).astype(np.float32) for n in names}


PASS_ARGS = {   # pass -> (archive kernel, uses dout, its vectors, its output shapes)
    "stats1": ("_stats1_kernel", False, ["aff0", "sh0"], ["1c", "1c"]),
    "fwd": ("_fwd_kernel", False, ["aff0", "sh0", "aff1", "sh1"], ["bnc"]),
    "bwd1": ("_bwd1_kernel", True, ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1"], ["1c", "1c"]),
    "bwd2": ("_bwd2_kernel", True, ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1",
                                    "mr2", "inv0", "mu0"], ["cc", "1c", "1c"]),
    "bwd3": ("_bwd3_kernel", True, ["aff0", "sh0", "aff1", "sh1", "inv1", "mu1", "g1inv", "mr1",
                                    "mr2", "inv0", "mu0", "g0inv", "mq1", "mq2"], ["bnkc"]),
}


@pytest.mark.parametrize("name", cfe.PASSES)
def test_each_pass_matches_archive_kernel(name):
    """Each pass of the port (the plain version, on CPU tensors) against
    the archive's Pallas body for it, through the archive's `_call`."""
    kernel, uses_dout, vec_names, outs = PASS_ARGS[name]
    params, _ = _inputs(3, n=16, k=4)
    e, w1 = params[0], params[3]
    b, n, k, c = e.shape
    dout = np.random.default_rng(4).normal(size=(b, n, c)).astype(np.float32)
    vecs = _pass_vectors(5, c)
    shapes = {"1c": (1, c), "cc": (c, c), "bnc": (b, n, c), "bnkc": (b, n, k, c)}
    jdout = jnp.asarray(dout) if uses_dout else None
    want = jfe._call(getattr(jfe, kernel), jnp.asarray(e), jdout,
                     [jnp.asarray(vecs[v]) for v in vec_names], [jnp.asarray(w1)],
                     [jax.ShapeDtypeStruct(shapes[s], jnp.float32) for s in outs], tile=8)
    want = want if isinstance(want, tuple) else (want,)
    t = torch.from_numpy
    args = [t(e)] + ([t(dout)] if uses_dout else []) + [t(vecs[v]) for v in vec_names] + [t(w1)]
    got = getattr(cfe, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def _edgeconv(seed, c_in=6, width=16, k=4, knn_impl="auto"):
    """A port EdgeConv with random weights, BatchNorm affines and running
    statistics."""
    torch.manual_seed(seed)
    block = EdgeConv(c_in, (width, width), k=k, knn_impl=knn_impl)
    with torch.no_grad():
        for layer in (block.layer0, block.layer1):
            layer.bn.weight.uniform_(0.5, 1.5)
            layer.bn.bias.normal_(0.0, 0.1)
            layer.bn.running_mean.normal_(0.0, 0.5)
            layer.bn.running_var.uniform_(0.5, 1.5)
    return block


@pytest.mark.parametrize("knn_impl", ["auto", "xla"])
def test_fused_route_matches_unfused_edgeconv_train(knn_impl):
    """Outputs, the BatchNorms' batch statistics and the gradients of x and
    of the block's six parameters, under a random cotangent that is zero
    where the max over k has a near-tie."""
    block = _edgeconv(6, knn_impl=knn_impl)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(3, 32, 6)).astype(np.float32))
    xu = x.clone().requires_grad_()
    out_u, stats_u, edges = chip_smoke.unfused_edgeconv(block, xu, True)
    _, near = chip_smoke.near_ties(torch, edges)
    w = torch.from_numpy(np.random.default_rng(8).normal(size=out_u.shape).astype(np.float32))
    w = w * ~near
    (out_u * w).sum().backward()
    want = {"x": xu.grad.clone(), **{n: p.grad.clone() for n, p in block.named_parameters()}}
    block.zero_grad(set_to_none=True)
    xf = x.clone().requires_grad_()
    out_f, stats_f = chip_smoke.fused_edgeconv(block, xf, True)
    (out_f * w).sum().backward()
    got = {"x": xf.grad, **{n: p.grad for n, p in block.named_parameters()}}
    torch.testing.assert_close(out_f, out_u, rtol=1e-5, atol=1e-5 * out_u.abs().max().item())
    for a, b, tol in zip(stats_f, stats_u, [1e-5, 1e-5, 1e-4, 1e-4]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * b.abs().max().item())
    assert set(got) == set(want) and len(want) == 7
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, rtol=1e-4, atol=1e-4 * g.abs().max().item(),
                                   msg=n)


def test_fused_route_matches_unfused_edgeconv_eval():
    block = _edgeconv(9)
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 24, 6)).astype(np.float32))
    with torch.no_grad():
        out_f, stats = chip_smoke.fused_edgeconv(block, x, False)
        out_u = block(x, False)
    torch.testing.assert_close(out_f, out_u, rtol=1e-5, atol=1e-5 * out_u.abs().max().item())
    assert stats[0] is block.layer0.bn.running_mean


def test_fused_edge_impl_guard():
    params, running = _inputs(11, n=8, k=2, c=4)
    with pytest.raises(NotImplementedError):
        fused_edge.fused_edge_tail(*_t(params), *_t(running), False, impl="pallas")
    with pytest.raises(NotImplementedError):
        fused_edge.edge_gather(torch.zeros(1, 8, 4), torch.zeros(1, 8, 2, dtype=torch.int32),
                               impl="pallas")
    before = [getattr(cfe, f"{p}_launches") for p in cfe.PASSES]
    out = fused_edge.fused_edge_tail(*_t(params), *_t(running), False, impl="xla")
    torch.testing.assert_close(out, fused_edge.fused_edge_tail(*_t(params), *_t(running), False))
    assert [getattr(cfe, f"{p}_launches") for p in cfe.PASSES] == before


def test_tied_max_routes_to_the_lowest_k():
    """Edge rows duplicated within a point give exact ties in the max over
    k: the gradient goes to the lowest k, as in the archive's kernels."""
    params, running = _inputs(12, n=16, k=4)
    params[0][:, :, 3] = params[0][:, :, 1]
    w = _weights(params[0].shape[:2] + params[0].shape[3:])

    def jax_loss(e):
        return jnp.sum(jfe.fused_edge_tail(e, *_j(params[1:]), *_j(running), False) * w)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(params[0])))
    e = torch.from_numpy(params[0]).requires_grad_()
    (fused_edge.fused_edge_tail(e, *_t(params[1:]), *_t(running), False)
     * torch.from_numpy(w)).sum().backward()
    assert np.abs(want[:, :, 3]).max() == 0 and np.abs(want[:, :, 1]).max() > 0
    np.testing.assert_allclose(e.grad.numpy(), want, atol=2e-5, rtol=2e-5)
