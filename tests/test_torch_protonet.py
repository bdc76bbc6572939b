"""The port's ProtoNet baselines (`models/protonet.py`, `ops/segment.py:
masked_mean`) vs the JAX package's on the same inputs and weights (the JAX
model's Flax trees, carried by `state_dict_from_jax`).

ProtoNet and ProtoNet_Contrast, cosine and euclidean similarity, in
training (batch-statistics BatchNorm, the WayContrast loss on the
contrast variant) and in eval with MDNS on (the contrast variant weights
its shots by MDNS's clean flags): logits and losses within rtol 1e-4
(atol 1e-4 of the logits' scale), the accuracy equal, and the MDNS shot
weights equal.  Attention dropout is 0: the port's dropout bits are not
the TPU generator's.  Episode batches (E = 2) keep BatchNorm's statistics
per episode in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.models import protonet as jax_protonet
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.ops.segment import masked_mean as jax_masked_mean
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.models.protonet import ProtoNet
from r3dfsseg_tpu_torch.ops.segment import masked_mean
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import random_flax_weights, train_episode


def jax_variables(model, cfg, rng, e: int = 1):
    """Random Flax trees for the JAX ``model`` (`random_flax_weights`)."""
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    lead = (e,) if e > 1 else ()
    ep = JaxEpisode(jnp.zeros(lead + (w, k, n, c)), jnp.zeros(lead + (w, k, n), jnp.int32),
                    jnp.zeros(lead + (w, n, c)), jnp.zeros(lead + (w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    return random_flax_weights(shapes, rng)


def episode_batch(cfg, rng, e: int):
    """``e`` training episodes' arrays, stacked when e > 1."""
    eps = [train_episode(cfg, rng) for _ in range(e)]
    return eps[0] if e == 1 else tuple(np.stack(a) for a in zip(*eps))


def jax_apply(model, params, stats, arrays, train: bool, eval_mdns: bool = False):
    """The JAX model on ``arrays``, jitted (one XLA program compiles far
    faster than the op-by-op run): its output, and in training the new
    batch statistics."""
    def apply(variables, ep):
        if train:
            return model.apply(variables, ep, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(2)})
        return model.apply(variables, ep, train=False, eval_mdns=eval_mdns), None
    return jax.jit(apply)({"params": params, "batch_stats": stats},
                          JaxEpisode(*map(jnp.asarray, arrays)))


def run_jax(model, params, stats, arrays, train: bool, eval_mdns: bool = False):
    return jax_apply(model, params, stats, arrays, train, eval_mdns)[0]


def run_port(model, arrays, train: bool, eval_mdns: bool = False):
    ep = Episode(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    with torch.no_grad():
        return model(ep, train=train, eval_mdns=eval_mdns)


def assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_mean_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 4, 50, 6)).astype(np.float32)
    mask = rng.uniform(size=(3, 4, 50, 1)) < 0.3
    mask[0, 0] = False                                  # an empty mask: 0 / 1e-5
    for axis in (2, 1):
        got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask), dim=axis)
        want = jax_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


CASES = [(contrast, dist, mode) for contrast in (False, True)
         for dist in ("cosine", "euclidean") for mode in ("train", "eval")]


@pytest.mark.parametrize("contrast,dist,mode", CASES,
                         ids=[f"{'contrast' if c else 'plain'}-{d}-{m}" for c, d, m in CASES])
def test_protonet_matches_jax(contrast, dist, mode):
    """Logits, the CE loss, the contrast loss (training) and the accuracy;
    eval runs with eval_mdns=True, which only the contrast variant uses."""
    kw = dict(attn_dropout=0.0, dist_method=dist, k_shot=3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(10 + CASES.index((contrast, dist, mode)))
    jmodel = jax_protonet.ProtoNet(jcfg, with_contrast=contrast)
    params, stats = jax_variables(jmodel, jcfg, rng)
    arrays = train_episode(cfg, rng)
    model = ProtoNet(cfg, with_contrast=contrast)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)

    train = mode == "train"
    want = run_jax(jmodel, params, stats, arrays, train, eval_mdns=True)
    got = run_port(model, arrays, train, eval_mdns=True)
    assert_logits_close(got.query_logits, want.query_logits)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-4)
    np.testing.assert_allclose(got.contrast_loss.item(), float(want.contrast_loss), rtol=1e-4,
                               atol=1e-6)
    assert (got.contrast_loss.item() > 0) == (train and contrast)
    assert got.aux["accuracy"].item() == pytest.approx(float(want.aux["accuracy"]), abs=1e-6)


def test_mdns_weights_the_shots_as_jax():
    """The contrast variant's eval with an outlier shot: MDNS drops it in
    both packages, and the prototypes (so the logits) follow; without
    eval_mdns the shot counts."""
    kw = dict(attn_dropout=0.0, k_shot=3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(21)
    jmodel = jax_protonet.ProtoNet(jcfg, with_contrast=True)
    params, stats = jax_variables(jmodel, jcfg, rng)
    arrays = list(train_episode(cfg, rng))
    arrays[0][0, 1] = arrays[0][0, 1] * 4.0 + 3.0       # way 0's shot 1 far from the rest
    model = ProtoNet(cfg, with_contrast=True)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    outs = {}
    for mdns in (True, False):
        want = run_jax(jmodel, params, stats, arrays, False, eval_mdns=mdns)
        got = run_port(model, arrays, False, eval_mdns=mdns)
        assert_logits_close(got.query_logits, want.query_logits)
        outs[mdns] = got.query_logits
    assert not torch.allclose(outs[True], outs[False])


def test_episode_batch_matches_jax():
    """E = 2 episodes in one call (the contrast variant), in training
    (per-episode BatchNorm statistics, and the running statistics' update)
    and then in eval with MDNS."""
    kw = dict(attn_dropout=0.0, k_shot=3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(30)
    jmodel = jax_protonet.ProtoNet(jcfg, with_contrast=True)
    params, stats = jax_variables(jmodel, jcfg, rng, e=2)
    arrays = episode_batch(cfg, rng, 2)
    model = ProtoNet(cfg, with_contrast=True)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    want, mut = jax_apply(jmodel, params, stats, arrays, True)
    want_eval = run_jax(jmodel, params, stats, arrays, False, eval_mdns=True)
    for train, w in ((True, want), (False, want_eval)):
        got = run_port(model, arrays, train, eval_mdns=True)
        assert got.query_logits.shape[0] == 2
        assert_logits_close(got.query_logits, w.query_logits)
        np.testing.assert_allclose(got.loss.item(), float(w.loss), rtol=1e-4)
        np.testing.assert_allclose(got.contrast_loss.item(), float(w.contrast_loss), rtol=1e-4,
                                   atol=1e-6)
        if train:
            sd = model.state_dict()
            for k, v in state_dict_from_jax({}, jax.tree.map(np.asarray,
                                                             mut["batch_stats"])).items():
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            model.load_state_dict(state_dict_from_jax(params, stats), strict=True)


def test_unknown_dist_method_raises():
    with pytest.raises(NotImplementedError, match="unknown"):
        ProtoNet(tiny_config(dist_method="manhattan"))


def jax_loss_and_grads(model, params, stats, arrays, loss_of):
    """The JAX learner's loss_fn on ``arrays`` (jitted): (loss, out,
    gradients) of ``loss_of(out)``."""
    @jax.jit
    def run(params, stats, ep):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, ep, train=True,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
            return loss_of(out), out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    (loss, out), grads = run(params, stats, JaxEpisode(*map(jnp.asarray, arrays)))
    return float(loss), out, grads


def assert_grads_close(model, grads, tol: float = 1e-3, floor: float = 1e-5):
    """Every parameter's gradient within a relative L2 distance of ``tol``
    of the JAX gradient (`state_dict_from_jax` of the gradient tree), the
    JAX gradient's norm floored at ``floor`` times the largest gradient
    entry: a leaf's gradient that far below the largest (the transformer's
    second-layer query projection at these widths, a difference of
    softmax terms that nearly cancel) carries f32 rounding noise of more
    than ``tol`` of its own norm in either framework.  A conv bias feeding a train-mode BatchNorm
    and the attention's key bias (it adds q . b to every score of a query
    row, which the softmax cancels) have an exact gradient of 0: both
    sides hold rounding noise there, below ``floor`` of the largest entry.
    A parameter whose gradient is stopped (the transformer's class tokens)
    has none in the port and zeros in JAX."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        w = want[name]
        if p.grad is None:
            assert float(w.abs().max()) == 0.0, name
            continue
        if (name.startswith("features.base_learner.") and name.endswith(".conv.bias")
                or name.endswith("self_attn.key.bias")):
            assert max(float(w.abs().max()), float(p.grad.abs().max())) < floor * top, name
            continue
        rel = float((p.grad - w).norm()) / max(float(w.norm()), floor * top)
        assert rel <= tol, (name, rel)


def test_learner_train_step_matches_jax():
    """One `ProtoLearner.train` step (ProtoNet_Contrast) against the JAX
    learner's loss_fn on the same weights: loss and contrast_loss rtol
    1e-4, every gradient within a relative L2 of 1e-3."""
    from r3dfsseg_tpu_torch.learners import ProtoLearner
    kw = dict(attn_dropout=0.0, k_shot=3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(50)
    jmodel = jax_protonet.ProtoNet(jcfg, with_contrast=True)
    params, stats = jax_variables(jmodel, jcfg, rng)
    arrays = train_episode(cfg, rng)
    loss, out, grads = jax_loss_and_grads(
        jmodel, params, stats, arrays, lambda o: o.loss + jcfg.contrast_weight * o.contrast_loss)
    learner = ProtoLearner(cfg, "cpu", with_contrast=True)
    learner.load_params(params, stats)
    metrics = learner.train(arrays)
    assert sorted(metrics) == ["accuracy", "contrast_loss", "loss"]
    np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-4)
    np.testing.assert_allclose(metrics["contrast_loss"].item(), float(out.contrast_loss),
                               rtol=1e-4)
    assert_grads_close(learner.model, grads)
    pred, test_loss, acc = learner.test(arrays, eval_mdns=True)
    assert pred.shape == (1, cfg.n_way, cfg.pc_npts) and pred.dtype == torch.int32


def test_learners_need_a_gpu_by_default():
    from r3dfsseg_tpu_torch.learners import ProtoLearner, TransformerLearner
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: ProtoLearner(tiny_config(), with_contrast=True),
                 lambda: TransformerLearner(tiny_config())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
