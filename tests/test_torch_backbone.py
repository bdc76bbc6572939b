"""Port FeatureExtractor, eval mode, vs the JAX module with the same
weights, carried by `utils/convert.py:state_dict_from_jax`.  Tolerance
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


def _pair(cfg, use_attention=True, knn_impl="auto", attn_impl="auto"):
    widths = tuple(tuple(w) for w in cfg.edgeconv_widths)
    jm = JaxFeatureExtractor(widths, tuple(cfg.dgcnn_mlp_widths), tuple(cfg.base_widths),
                             cfg.output_dim, dgcnn_k=cfg.dgcnn_k, use_attention=use_attention)
    tm = FeatureExtractor(cfg.pc_in_dim, widths, cfg.dgcnn_mlp_widths, cfg.base_widths,
                          cfg.output_dim, dgcnn_k=cfg.dgcnn_k, use_attention=use_attention,
                          knn_impl=knn_impl, attn_impl=attn_impl)
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
        state_dict_from_jax({"m": {"embedding": np.zeros(3)}})


def test_training_mode_raises():
    cfg = tiny_config()
    _, tm = _pair(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm(torch.zeros((1, cfg.pc_npts, cfg.pc_in_dim)), train=True)
