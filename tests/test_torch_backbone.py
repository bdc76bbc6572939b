"""Port FeatureExtractor vs the JAX module with the same weights, carried
by `utils/convert.py:state_dict_from_jax`: eval mode, and train mode with
batch-statistics BatchNorm (features, gradients and the updated running
statistics, two sequential updates, per-episode groups).  Tolerance
rtol = atol = 1e-4: the BatchNorm and matmul formulas round in another
order, and three dynamic kNN graphs follow the features."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config
from r3dfsseg_tpu.nn import FeatureExtractor as JaxFeatureExtractor
from r3dfsseg_tpu_torch.nn.dgcnn import FeatureExtractor
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import random_flax_weights


def _pair(cfg, use_attention=True, knn_impl="auto", attn_impl="auto", attn_dropout=0.1):
    widths = tuple(tuple(w) for w in cfg.edgeconv_widths)
    jm = JaxFeatureExtractor(widths, tuple(cfg.dgcnn_mlp_widths), tuple(cfg.base_widths),
                             cfg.output_dim, dgcnn_k=cfg.dgcnn_k, use_attention=use_attention,
                             attn_dropout=attn_dropout)
    tm = FeatureExtractor(cfg.pc_in_dim, widths, cfg.dgcnn_mlp_widths, cfg.base_widths,
                          cfg.output_dim, dgcnn_k=cfg.dgcnn_k, use_attention=use_attention,
                          knn_impl=knn_impl, attn_impl=attn_impl, attn_dropout=attn_dropout,
                          gather_impl=knn_impl)
    return jm, tm


@pytest.mark.parametrize("use_attention,impl", [(True, "auto"), (True, "xla"), (False, "auto")])
def test_feature_extractor_matches_jax(use_attention, impl):
    cfg = tiny_config()
    rng = np.random.default_rng(int(use_attention) + 7 * len(impl))
    x = rng.normal(size=(3, cfg.pc_npts, cfg.pc_in_dim)).astype(np.float32)
    jm, tm = _pair(cfg, use_attention, impl, impl)
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.pc_npts, cfg.feat_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_state_dict_names_follow_the_flax_tree():
    cfg = tiny_config()
    jm, tm = _pair(cfg)
    x = jnp.zeros((1, cfg.pc_npts, cfg.pc_in_dim))
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]),
                             jax.tree.map(np.asarray, variables["batch_stats"]))
    assert set(sd) == set(tm.state_dict())
    k = variables["params"]["encoder"]["edgeconv0"]["layer0"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.edgeconv0.layer0.conv.weight"].numpy(),
                                  np.asarray(k).T)
    np.testing.assert_array_equal(
        sd["encoder.mlp1.bn.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["encoder"]["mlp1"]["bn"]["var"]))
    with pytest.raises(KeyError, match="no port counterpart"):
        state_dict_from_jax({"m": {"gamma": np.zeros(3)}})


def test_training_mode_raises():
    """Training with attention dropout needs a generator for the mask
    seeds, as Flax needs a 'dropout' rng."""
    cfg = tiny_config()
    _, tm = _pair(cfg)
    with pytest.raises(ValueError, match="generator"):
        tm(torch.zeros((1, cfg.pc_npts, cfg.pc_in_dim)), train=True)


def _stats_close(tm, jax_stats):
    want = state_dict_from_jax({}, jax.tree.map(np.asarray, jax_stats))
    got = tm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("groups", [1, 2])
def test_train_mode_matches_flax(groups):
    """Features and parameter gradients with batch statistics, and the
    running statistics after two sequential updates (support then query
    batch, as one training step makes them), vs Flax's
    apply(train=True, mutable=["batch_stats"]).  groups=2: per-episode
    statistics (`GroupedBatchNorm`)."""
    cfg = tiny_config()
    rng = np.random.default_rng(40 + groups)
    xs = [rng.normal(size=(2 * groups, cfg.pc_npts, cfg.pc_in_dim)).astype(np.float32)
          for _ in range(2)]
    w = rng.normal(size=(2 * groups, cfg.pc_npts, cfg.feat_dim)).astype(np.float32)
    jm, tm = _pair(cfg, attn_dropout=0.0)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(xs[0]))
    params, stats = random_flax_weights(variables, rng)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)

    def apply(p, st, x):
        return jm.apply({"params": p, "batch_stats": st}, jnp.asarray(x), train=True,
                        groups=groups, mutable=["batch_stats"])

    want, mut = apply(params, stats, xs[0])
    want_grads = jax.grad(lambda p: jnp.sum(apply(p, stats, xs[0])[0] * w))(params)
    got = tm(torch.from_numpy(xs[0]), train=True, groups=groups)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _stats_close(tm, mut["batch_stats"])
    (got * torch.from_numpy(w)).sum().backward()
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, want_grads))
    top = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        want = want_g[name].numpy()
        if name.startswith("base_learner.") and name.endswith(".conv.bias"):
            # feeds a train-mode BatchNorm: the exact gradient is 0 and both
            # sides hold rounding noise, far below the largest gradient
            assert max(np.abs(want).max(), p.grad.abs().max().item()) < 1e-5 * top, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)

    _, mut2 = apply(params, mut["batch_stats"], xs[1])
    with torch.no_grad():
        tm(torch.from_numpy(xs[1]), train=True, groups=groups)
    _stats_close(tm, mut2["batch_stats"])
