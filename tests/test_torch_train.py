"""One meta-training step of the port (`MPTILearner.train`: MPTI +
attention + WayContrast, Adam + StepLR) vs the JAX learner's loss_fn
(`r3dfsseg_tpu/learners/mpti_learner.py:587`) on the same episode and
weights: loss, lp_loss and contrast_loss within rtol 1e-4, every
parameter's gradient within rtol 1e-3, and the running BatchNorm
statistics after the step's two updates.

Attention dropout is 0 here: the port's Philox bits are not the TPU
generator's.  As in test_torch_mpti.py, each episode first shows a
k-th-neighbour margin above 1e-6 in the JAX model's graph, now on its
train-mode embeddings (batch-statistics BatchNorm), because rounding-level
ties would let the two frameworks keep different graph neighbours."""
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
from r3dfsseg_tpu_torch.learners import mpti_learner
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (PARITY_MODES, assert_same_neighbours, jax_graph_margin,
                                jax_mode_model, random_flax_weights, train_episode)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_tiny_config(attn_dropout=0.0)
    model = jax_mpti.MPTINet(cfg)
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))

    @jax.jit
    def loss_and_grads(params, stats, ep):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, ep, train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(2)})
            return out.lp_loss + cfg.contrast_weight * out.contrast_loss, (out, mut)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    features = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.features(x, train=True), mutable=["batch_stats"])[0])
    return cfg, shapes, loss_and_grads, features


@pytest.mark.parametrize("seed", [3, 8])
def test_train_step_matches_jax(jax_side, seed):
    jcfg, shapes, loss_and_grads, jax_features = jax_side
    cfg = tiny_config(attn_dropout=0.0)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    arrays = train_episode(cfg, rng)
    sx, sy, qx = arrays[:3]
    variables = {"params": params, "batch_stats": stats}
    margin = jax_graph_margin(lambda x: np.asarray(jax_features(variables, jnp.asarray(x))),
                              jcfg, sx, sy, qx, eval_mdns=False)
    assert margin > 1e-6, f"episode has a k-th-neighbour tie at f32 rounding ({margin:.1e})"

    (loss, (out, mut)), grads = loss_and_grads(params, stats,
                                               JaxEpisode(*map(jnp.asarray, arrays)))
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    metrics = learner.train(arrays)

    for key, want in (("loss", loss), ("lp_loss", out.lp_loss),
                      ("contrast_loss", out.contrast_loss)):
        np.testing.assert_allclose(metrics[key].item(), float(want), rtol=1e-4, err_msg=key)
    for key in ("accuracy", "query_acc_LP", "query_acc_original", "clean_ratio_LP",
                "clean_ratio_original"):
        np.testing.assert_allclose(metrics[key].item(), float(out.aux[key]), atol=1e-6,
                                   err_msg=key)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    assert min(float(np.abs(want_g[n].numpy()).max())
               for n in ("proj.weight", "features.encoder.edgeconv0.layer0.conv.weight",
                         "features.att_learner.q_map.weight")) > 1e-6
    top = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in learner.model.named_parameters():
        want = want_g[name].numpy()
        if name.startswith("features.base_learner.") and name.endswith(".conv.bias"):
            # feeds a train-mode BatchNorm: the exact gradient is 0 and both
            # sides hold rounding noise, far below the largest gradient
            assert max(np.abs(want).max(), p.grad.abs().max().item()) < 1e-5 * top, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    want_s = state_dict_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
    got_s = learner.model.state_dict()
    for name, w in want_s.items():
        np.testing.assert_allclose(got_s[name].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("mode", PARITY_MODES, ids=["-".join(m) for m in PARITY_MODES])
def test_mode_train_step_matches_jax(monkeypatch, mode):
    """One training step in each reference-faithful mode new to the port
    (affinity_impl x lp_solver x graph_dtype, test_torch_lp_modes.py) vs
    the JAX loss_fn with the same weights: losses rtol 1e-4; every
    gradient rtol 1e-3 (atol 1e-4 of its largest entry) on the float32
    graph and within a relative L2 distance of 1e-3 on the bf16 graph, as
    test_torch_lowp_graph.py holds it.  The JAX side takes the threshold
    radius from the Pallas kernel in interpret mode, and the episode first
    shows that both frameworks keep the same graph neighbours."""
    monkeypatch.setattr(jax_lp, "_kth_smallest_per_row", lambda d, k, iters=32:
                        kth_smallest_per_row_pallas(d, k, iters=iters, tile_n=8,
                                                    interpret=True))
    jcfg, cfg, model, shapes = jax_mode_model(mode)
    rng = np.random.default_rng(40 + PARITY_MODES.index(mode))
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    arrays = train_episode(cfg, rng)
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    features = jax.jit(lambda x: model.apply(
        variables, x, method=lambda m, x: m.features(x, train=True), mutable=["batch_stats"])[0])
    assert_same_neighbours(lambda x: np.asarray(features(jnp.asarray(x))), jcfg, cfg,
                           learner.model, *arrays[:3], eval_mdns=False, train=True)

    @jax.jit
    def loss_and_grads(ep):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, ep, train=True,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
            return out.lp_loss + jcfg.contrast_weight * out.contrast_loss, out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, out), grads = loss_and_grads(JaxEpisode(*map(jnp.asarray, arrays)))
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
        elif cfg.graph_bf16:
            rel = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= 1e-3, (name, rel)
        else:
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=name)


def test_episode_batch_of_two_matches_one_by_one():
    """E = 2 in one call gives each episode the result it gets alone:
    BatchNorm statistics per episode group, losses averaged."""
    cfg = tiny_config(attn_dropout=0.0)
    rng = np.random.default_rng(5)
    eps = [train_episode(cfg, rng) for _ in range(2)]
    net = MPTILearner(cfg, "cpu").model
    both = net(Episode(*(torch.from_numpy(np.stack(a)) for a in zip(*eps))), train=True)
    one = [net(Episode(*map(torch.from_numpy, e)), train=True) for e in eps]
    torch.testing.assert_close(both.query_logits, torch.cat([o.query_logits for o in one]),
                               rtol=1e-5, atol=1e-5)
    for field in ("lp_loss", "contrast_loss"):
        torch.testing.assert_close(getattr(both, field),
                                   torch.stack([getattr(o, field) for o in one]).mean(),
                                   rtol=1e-5, atol=1e-6)
    for key in both.aux:
        torch.testing.assert_close(both.aux[key], torch.stack([o.aux[key] for o in one]).mean(),
                                   rtol=1e-5, atol=1e-6)


def test_train_metrics_dropout_and_schedule():
    """train() returns 0-d tensors (no host sync), draws the dropout seeds
    from the learner's generator (same seed, same step) and steps StepLR
    once per optimizer step."""
    cfg = tiny_config(step_size=2, gamma=0.5)
    ep = train_episode(cfg, np.random.default_rng(9))
    a, b = (MPTILearner(cfg, "cpu", torch.Generator().manual_seed(4)) for _ in range(2))
    ma = a.train(ep)
    mb = b.train(ep)
    assert set(ma) == {"loss", "lp_loss", "contrast_loss", "accuracy", "query_acc_LP",
                       "query_acc_original", "clean_ratio_LP", "clean_ratio_original"}
    assert all(v.dim() == 0 and not v.requires_grad for v in ma.values())
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    a.train(ep)
    assert [g["lr"] for g in a.optimizer.param_groups] == [cfg.encoder_lr * 0.5, cfg.lr * 0.5]
    c = MPTILearner(cfg, "cpu", torch.Generator().manual_seed(5))
    assert not torch.equal(c.train(ep)["loss"], ma["loss"])


def test_load_params_encoder_only_resets_the_optimizer(jax_side):
    _, shapes, _, _ = jax_side
    cfg = tiny_config()
    params, stats = random_flax_weights(shapes, np.random.default_rng(1))
    learner = MPTILearner(cfg, "cpu")
    learner.train(train_episode(cfg, np.random.default_rng(2)))
    proj = learner.model.proj.weight.detach().clone()
    assert learner.optimizer.state
    learner.load_params(params["features"], stats["features"], encoder_only=True)
    want = state_dict_from_jax(params["features"], stats["features"])
    got = learner.model.features.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert torch.equal(learner.model.proj.weight, proj)
    assert not learner.optimizer.state and learner.scheduler.last_epoch == 0
    learner.load_params(params, stats, encoder_only=True)     # the whole tree: its subtree
    with pytest.raises(KeyError, match="no feature-extractor counterpart"):
        learner.load_params({"proj": params["proj"]}, encoder_only=True)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU; there is no quiet fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPTILearner(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FewShotPredictor(cfg)
    assert mpti_learner.resolve_device("cpu") == torch.device("cpu")
    assert MPTILearner(cfg, "cpu").device == torch.device("cpu")
