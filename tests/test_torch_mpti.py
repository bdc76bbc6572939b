"""Port MPTI model (`models/mpti.py`, `serve.py`) vs the JAX package.

MDNS flags, graph nodes and WayContrast (prototypes, loss and its
gradient) are compared on the same inputs; the whole
slice on the same episode and the same weights (the JAX model's Flax trees,
carried by `state_dict_from_jax`): query logits within atol = rtol = 1e-3
and predictions agreeing on >= 99% of points.

The affinity keeps each node's k nearest neighbours by a Gram-form
distance that rounds at the scale of the squared norms.  Where a node's
k-th and (k+1)-th distances lie within that rounding (a relative margin
near 1e-7), the two frameworks, whose sums round differently, keep
different neighbours and the logits differ by O(0.1) while both are right.
So each episode here first shows a margin above 1e-6 (`jax_graph_margin`);
the seeds were picked so, and a failure of that check means the episode
changed, not the port."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners import MPTILearner as JaxLearner
from r3dfsseg_tpu.learners.base import TrainState
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.serve import FewShotPredictor as JaxPredictor
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.models import mpti
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from torch_port_helpers import episode_arrays, jax_graph_margin, random_flax_weights


def _support(seed, w=2, k=3, n=40, d=6):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(w, k, n, d)).astype(np.float32)
    fg = rng.uniform(size=(w, k, n)) < 0.4
    xyz = rng.uniform(0, 2, size=(w, k, n, 3)).astype(np.float32)
    feat[0, 1] += 3.0                       # an outlier shot for MDNS to drop
    return feat, fg, xyz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdns_flags_equal_jax(seed):
    feat, fg, xyz = _support(seed)
    if seed == 2:
        fg[1, 1:] = False                   # way 1 keeps one fg shot only
    scales = ((1, 1, 1), (2, 2, 1))
    want_keep, _ = jax_mpti.mdns_keep_mask(jnp.asarray(feat), jnp.asarray(fg),
                                           jnp.asarray(xyz), scales)
    got_keep, _ = mpti.mdns_keep_mask(torch.from_numpy(feat), torch.from_numpy(fg),
                                      torch.from_numpy(xyz), scales)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    for sc in scales:
        np.testing.assert_array_equal(
            mpti._mdns_flags_one_scale(torch.from_numpy(feat), torch.from_numpy(fg),
                                       torch.from_numpy(xyz), sc).numpy(),
            np.asarray(jax_mpti._mdns_flags_one_scale(jnp.asarray(feat), jnp.asarray(fg),
                                                      jnp.asarray(xyz), sc)))


def test_episode_graph_nodes_match_jax():
    feat, fg, _ = _support(3, n=64, d=12)
    used = fg.copy()
    used[1, 0] = False
    cfg, jcfg = tiny_config(), jax_tiny_config()
    want = jax_mpti.episode_graph_nodes(jnp.asarray(feat), jnp.asarray(used), jnp.asarray(fg),
                                        jcfg)
    got = mpti.episode_graph_nodes(torch.from_numpy(feat), torch.from_numpy(used),
                                   torch.from_numpy(fg), cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("flags", [[[3, 3, 3], [5, 5, 5]], [[3, 5, 3], [5, 5, 3]]])
def test_way_contrast_matches_jax(flags):
    """`_contrast_prototypes` (a clean and a noisy episode: the borrowed
    negatives count only when way 0's flags agree), `way_contrast_loss` and
    its gradient vs the JAX package, rtol 1e-5."""
    rng = np.random.default_rng(len(str(flags)))
    w, k, n, d, fps_k = 2, 3, 40, 12, 2
    feat = rng.normal(size=(w, k, n, d)).astype(np.float32)
    sy = (rng.uniform(size=(w, k, n)) < 0.4).astype(np.int32)
    sy[..., 0] = 1
    flag = np.asarray(flags, np.int32)
    want = jax_mpti._contrast_prototypes(jnp.asarray(feat), jnp.asarray(sy),
                                         jnp.asarray(flag, jnp.float32), fps_k)
    got = mpti._contrast_prototypes(torch.from_numpy(feat), torch.from_numpy(sy),
                                    torch.from_numpy(flag), fps_k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))

    z = rng.normal(size=(w, k + 2, fps_k, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    jloss = lambda zz: jax_mpti.way_contrast_loss(zz, *want[1:], 0.1)  # noqa: E731
    want_loss, want_grad = jax.value_and_grad(jloss)(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    loss = mpti.way_contrast_loss(tz, *got[1:], 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's variable shapes and jitted logits/embedding functions."""
    cfg = jax_tiny_config()
    model = jax_mpti.MPTINet(cfg)
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    logits = jax.jit(functools.partial(model.apply, train=False), static_argnames="eval_mdns")
    features = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.features(x, train=False)))
    return cfg, model, shapes, logits, features


@pytest.mark.parametrize("seed,eval_mdns", [(12, True), (21, True), (27, False)])
def test_slice_matches_jax(jax_side, seed, eval_mdns):
    jcfg, model, shapes, jax_logits, jax_features = jax_side
    cfg = tiny_config()
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    port = FewShotPredictor(cfg, device="cpu", eval_mdns=eval_mdns)
    port._learner.load_params(params, stats)
    sx, sy, qx, qy = episode_arrays(cfg, rng)
    margin = jax_graph_margin(lambda x: np.asarray(jax_features(variables, jnp.asarray(x))),
                              jcfg, sx, sy, qx, eval_mdns)
    assert margin > 1e-6, f"episode has a k-th-neighbour tie at f32 rounding ({margin:.1e})"

    want = np.asarray(jax_logits(variables, JaxEpisode(*map(jnp.asarray, (sx, sy, qx, qy))),
                                 eval_mdns=eval_mdns).query_logits)
    got = port._learner.model(Episode(*map(torch.from_numpy, (sx, sy, qx, qy))),
                              eval_mdns=eval_mdns).query_logits.detach().numpy()
    assert got.shape == want.shape == (1, cfg.n_way, cfg.pc_npts, cfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)

    pred = port.predict(sx, sy, qx)
    assert pred.dtype == np.int32 and pred.shape == (cfg.n_way, cfg.pc_npts)
    assert 0 <= pred.min() and pred.max() <= cfg.n_way
    learner = JaxLearner(jcfg)
    learner.state = TrainState(jnp.zeros((), jnp.int32), params, stats, learner.tx.init(params))
    jax_pred = np.asarray(JaxPredictor(jcfg, learner, eval_mdns=eval_mdns).predict(sx, sy, qx))
    assert (pred == jax_pred).mean() >= 0.99


def test_predictor_shape_guard_and_unported_modes():
    cfg = tiny_config()
    p = FewShotPredictor(cfg, device="cpu")
    with pytest.raises(ValueError, match="episode shape mismatch"):
        p.predict(np.zeros((3, 5, cfg.pc_npts, 9)), np.zeros((3, 5, cfg.pc_npts)),
                  np.zeros((2, cfg.pc_npts, 9)))
    for bad in ({"lp_solver": "bogus"}, {"affinity_impl": "bogus"},
                {"bn_mode": "bogus"}, {"compute_dtype": "float16"}):
        with pytest.raises(NotImplementedError):
            mpti.MPTINet(cfg.replace(**bad))
    # every affinity, solver and graph dtype is served, on either encoder
    for enc in ("float32", "bfloat16"):
        for aff in ("threshold", "topk"):
            for solver in ("cheby", "cg", "solve"):
                for graph in ("float32", "bfloat16"):
                    mpti.MPTINet(cfg.replace(compute_dtype=enc, affinity_impl=aff,
                                             lp_solver=solver, graph_dtype=graph))
    with pytest.raises(NotImplementedError):
        mpti.MPTINet(cfg.replace(compute_dtype="bfloat16", lp_solver="dense"))
    with pytest.raises(NotImplementedError):
        FewShotPredictor(cfg.replace(phase="protoeval"))


@pytest.mark.parametrize("graph_dtype", ["bfloat16", "float32", "auto"])
def test_graph_dtypes_are_served(graph_dtype):
    """Both encoders, float32 and bf16 (compute_dtype), serve both episode
    graphs; 'auto' follows the encoder."""
    cfg = tiny_config(graph_dtype=graph_dtype)
    arrays = episode_arrays(cfg, np.random.default_rng(4))[:3]
    for c in (cfg, cfg.replace(compute_dtype="bfloat16")):
        pred = FewShotPredictor(c, device="cpu").predict(*arrays)
        assert pred.dtype == np.int32 and pred.shape == (c.n_way, c.pc_npts)
        assert 0 <= pred.min() and pred.max() <= c.n_way


def test_batched_episodes_match_one_by_one():
    cfg = tiny_config()
    rng = np.random.default_rng(5)
    eps = [episode_arrays(cfg, rng) for _ in range(2)]
    net = FewShotPredictor(cfg, device="cpu")._learner.model
    with torch.no_grad():
        both = net(Episode(*(torch.from_numpy(np.stack(a)) for a in zip(*eps))),
                   eval_mdns=True).query_logits
        one = [net(Episode(*map(torch.from_numpy, e)), eval_mdns=True).query_logits[0]
               for e in eps]
    torch.testing.assert_close(both, torch.stack(one), rtol=1e-5, atol=1e-5)
