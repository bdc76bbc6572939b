"""The port's transformer baseline (`models/transformer.py`) vs the JAX
package's on the same inputs and weights (the JAX model's Flax trees,
carried by `state_dict_from_jax`, which folds the attention's head axes).

`gen_prototypes` in every aggregation (rtol 1e-5); `ShotTransformer` in
each class-token and position type; `ProtoNetTransformer` in training
and in eval at dropout 0 (the JAX model built with dropout=0.0, as
tests/test_reference_parity_extra.py builds it; the port's dropout bits
are not the TPU generator's): logits and the CE, binary and
clean-prototype losses within rtol 1e-4 (the logits with atol 1e-4 of
their scale), on one episode and on an episode batch (E = 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.models import transformer as jax_transformer
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.models import transformer
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_protonet import (assert_logits_close, episode_batch, jax_apply, jax_variables,
                                 run_port)

ARCH = dict(d_model=16, n_layers=2, n_head=4, d_feed=12)
AGG_METHODS = ["mean", "median", "cosine", "euclidean", "abs", "cosine_2", "euclidean_0.5"]


@pytest.mark.parametrize("agg", AGG_METHODS)
def test_gen_prototypes_matches_jax(agg):
    rng = np.random.default_rng(AGG_METHODS.index(agg))
    emb = rng.normal(size=(3 * 4, 10)).astype(np.float32)
    emb[5] += 4.0                                          # an outlier shot
    got = transformer.gen_prototypes(torch.from_numpy(emb), 3, 4, agg)
    want = jax_transformer.gen_prototypes(jnp.asarray(emb), 3, 4, agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gen_prototypes_unknown_raises():
    with pytest.raises(NotImplementedError):
        transformer.gen_prototypes(torch.zeros(4, 3), 2, 2, "mode")


SHOT_TYPES = [("rand_const", "pos_learn"), ("cls_learn", "rand_const"), ("proto", "pos_learn")]


@pytest.mark.parametrize("cls_type,pos_type", SHOT_TYPES)
def test_shot_transformer_matches_jax(cls_type, pos_type):
    """Each class-token and position type, eval mode, E = 2 episodes
    against the JAX module vmapped over them; the stopped gradients give
    no gradient to the stopped table."""
    ways, shots = 2, 3
    kw = dict(num_layers=2, n_head=4, d_model=16, d_feed=12, cls_type=cls_type,
              pos_type=pos_type, agg_method="median")
    jm = jax_transformer.ShotTransformer(ways, shots, **kw)
    rng = np.random.default_rng(SHOT_TYPES.index((cls_type, pos_type)))
    x = rng.normal(size=(2, ways * shots, 16)).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[0]))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
                          * 0.1, variables["params"])
    want = jax.vmap(lambda xe: jm.apply({"params": params}, xe))(jnp.asarray(x))
    port = transformer.ShotTransformer(ways, shots, **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    got.square().sum().backward()
    if cls_type != "proto":
        assert (port.cls_embeddings.weight.grad is None) == (cls_type == "rand_const")
    assert (port.pos_embeddings.weight.grad is None) == (pos_type == "rand_const")


def _models(e: int, seed: int):
    kw = dict(attn_dropout=0.0, k_shot=3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(seed)
    jmodel = jax_transformer.ProtoNetTransformer(jcfg, dropout=0.0, **ARCH)
    params, stats = jax_variables(jmodel, jcfg, rng, e=e)
    model = transformer.ProtoNetTransformer(cfg, dropout=0.0, **ARCH)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jmodel, params, stats, model, episode_batch(cfg, rng, e)


@pytest.mark.parametrize("e", [1, 2])
def test_transformer_matches_jax(e):
    """Training (the three losses, the running statistics), then eval."""
    jmodel, params, stats, model, arrays = _models(e, 40 + e)
    want, mut = jax_apply(jmodel, params, stats, arrays, True)
    got = run_port(model, arrays, True)
    assert_logits_close(got.query_logits, want.query_logits)
    for key in ("loss", "binary_loss", "clean_proto_loss"):
        np.testing.assert_allclose(getattr(got, key).item(), float(getattr(want, key)),
                                   rtol=1e-4, err_msg=key)
        assert getattr(got, key).item() > 0, key
    sd = model.state_dict()
    for k, v in state_dict_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"])).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)

    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    want = jax_apply(jmodel, params, stats, arrays, False)[0]
    got = run_port(model, arrays, False, eval_mdns=True)      # eval_mdns is ignored
    assert_logits_close(got.query_logits, want.query_logits)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-4)
    assert got.binary_loss.item() == got.clean_proto_loss.item() == 0.0


def test_projections_start_equal():
    """proj_trans_out starts as a copy of proj_trans_in, an orthogonal
    (feat_dim, d_model) matrix drawn from the generator; the two train
    apart."""
    cfg = tiny_config()
    model = transformer.ProtoNetTransformer(cfg, **ARCH)
    model.init_weights(torch.Generator().manual_seed(3))
    a, b = model.proj_trans_in.detach(), model.proj_trans_out.detach()
    assert torch.equal(a, b) and a.shape == (cfg.feat_dim, ARCH["d_model"])
    torch.testing.assert_close(a.T @ a, torch.eye(ARCH["d_model"]), rtol=0, atol=1e-5)
    assert model.proj_trans_in is not model.proj_trans_out
    again = transformer.ProtoNetTransformer(cfg, **ARCH)
    again.init_weights(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(model.state_dict().values(),
                                                  again.state_dict().values()))


def test_dropout_draws_from_the_generator():
    """In training every dropout of the transformer draws from the caller's
    generator: the same seed gives the same loss, another seed another."""
    cfg = tiny_config(attn_dropout=0.0, k_shot=3)
    model = transformer.ProtoNetTransformer(cfg, **ARCH)
    model.init_weights(torch.Generator().manual_seed(0))
    from r3dfsseg_tpu_torch.models.episode import Episode
    arrays = episode_batch(cfg, np.random.default_rng(5), 1)
    ep = Episode(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    losses = []
    for seed in (1, 1, 2):
        m = transformer.ProtoNetTransformer(cfg, **ARCH)
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            losses.append(m(ep, train=True, generator=torch.Generator().manual_seed(seed)).loss)
    assert losses[0].item() == losses[1].item() != losses[2].item()


def test_learner_train_step_matches_jax():
    """One `TransformerLearner.train` step at dropout 0 against the JAX
    learner's loss_fn (CE + binary + clean-prototype losses) on the same
    weights: the losses rtol 1e-4, every gradient within a relative L2 of
    1e-3; the stopped class tokens keep their values after the step in
    both packages (torch's Adam skips a parameter without a gradient; the
    JAX optimizer's update of a zero gradient is 0)."""
    import optax

    from r3dfsseg_tpu.learners.base import make_optimizer as jax_make_optimizer
    from r3dfsseg_tpu_torch.learners import TransformerLearner
    from test_torch_protonet import assert_grads_close, jax_loss_and_grads
    from torch_port_helpers import train_episode

    jmodel, params, stats, model, arrays = _models(1, 60)
    jcfg = jmodel.cfg
    loss, out, grads = jax_loss_and_grads(
        jmodel, params, stats, arrays, lambda o: o.loss + o.binary_loss + o.clean_proto_loss)
    learner = TransformerLearner(model.cfg, "cpu", dropout=0.0, **ARCH)
    learner.load_params(params, stats)
    cls_before = learner.model.transformer.cls_embeddings.weight.detach().clone()
    metrics = learner.train(arrays)
    assert sorted(metrics) == ["accuracy", "clean_proto_loss", "contrast_loss", "loss",
                               "lp_loss"]
    for key, want in (("loss", loss), ("lp_loss", out.loss), ("contrast_loss", out.binary_loss),
                      ("clean_proto_loss", out.clean_proto_loss)):
        np.testing.assert_allclose(metrics[key].item(), float(want), rtol=1e-4, err_msg=key)
    assert_grads_close(learner.model, grads)
    assert learner.model.transformer.cls_embeddings.weight.grad is None
    assert torch.equal(learner.model.transformer.cls_embeddings.weight, cls_before)
    assert learner.model.transformer.pos_embeddings.weight.grad is not None

    tx = jax_make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    cls = ("transformer", "cls_embeddings", "embedding")
    get = lambda t: t[cls[0]][cls[1]][cls[2]]  # noqa: E731
    np.testing.assert_array_equal(np.asarray(get(new)), np.asarray(get(params)))

    # test() takes eval_mdns and ignores it
    a, b = (learner.test(train_episode(model.cfg, np.random.default_rng(61)), eval_mdns=m)[0]
            for m in (True, False))
    assert torch.equal(a, b)


def test_learner_architecture_from_the_config():
    from r3dfsseg_tpu_torch.learners import TransformerLearner
    cfg = tiny_config(d_model=16, n_head=2, n_layers=1, d_feed=8)
    t = TransformerLearner(cfg, "cpu").model.transformer
    assert (t.n_layers, t.layer0.self_attn.n_head, t.layer0.linear1.out_features,
            t.pos_embeddings.weight.shape[1]) == (1, 2, 8, 16)
    t = TransformerLearner(cfg, "cpu", n_layers=2, d_model=8).model.transformer
    assert t.n_layers == 2 and t.pos_embeddings.weight.shape[1] == 8
