"""The port's checkpoint interop with the original PyTorch model
(`utils/torch_convert.py`, `MPTILearner.load_torch_state`,
`FewShotPredictor.from_checkpoint`) vs the JAX package's
(`r3dfsseg_tpu/utils/torch_convert.py`, `serve.py`).

Weights are the JAX model's random Flax trees at tiny_config, carried into
the port by `state_dict_from_jax`; every `.tar` is written in the test with
`torch.save` under tmp_path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.serve import FewShotPredictor as JaxPredictor
from r3dfsseg_tpu.utils import torch_convert as jax_convert
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from r3dfsseg_tpu_torch.utils import torch_convert
from torch_port_helpers import episode_arrays, jax_graph_margin, random_flax_weights

# the reference-faithful modes: no k-th-radius bracket to differ between
# the JAX package's CPU loop and the port
MODES = dict(affinity_impl="topk", lp_solver="solve")


@pytest.fixture(scope="module")
def jax_shapes():
    """use_attention -> the JAX model's variable shapes at tiny_config."""
    out = {}
    for att in (True, False):
        cfg = jax_tiny_config(use_attention=att, **MODES)
        model = jax_mpti.MPTINet(cfg)
        w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
        ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                        jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
        out[att] = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    return out


def _learner(jax_shapes, att: bool, seed: int):
    """(Flax params, batch_stats, a port learner holding them)."""
    params, stats = random_flax_weights(jax_shapes[att], np.random.default_rng(seed))
    learner = MPTILearner(tiny_config(use_attention=att, **MODES), "cpu")
    learner.load_params(params, stats)
    return params, stats, learner


def _state(learner):
    return {k: v.clone() for k, v in learner.model.state_dict().items()}


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("att", [True, False])
def test_export_matches_jax(jax_shapes, att):
    """The same keys, shapes, dtypes and values as JAX `export_mpti_state`,
    `num_batches_tracked` = 0 as int64 included, and as JAX
    `export_feature_extractor` under a prefix."""
    params, stats, learner = _learner(jax_shapes, att, 0)
    want = jax_convert.export_mpti_state(params, stats)
    got = torch_convert.export_mpti_state(learner.model)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert ("att_learner.q_map.weight" in got) == att
    assert ("linear_mapper.weight" in got) == (not att)
    want = jax_convert.export_feature_extractor(params["features"], stats["features"],
                                                prefix="x.")
    got = torch_convert.export_feature_extractor(learner.model.features, prefix="x.")
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("att", [True, False])
def test_key_map_round_trips(jax_shapes, att):
    """export -> load gives back every tensor of the model bit for bit, into
    a learner with other weights; the map is one to one."""
    _, _, learner = _learner(jax_shapes, att, 1)
    kmap = torch_convert.key_map(learner.model)
    ports = [p for p, _ in kmap.values()]
    assert len(set(ports)) == len(ports) == len(learner.model.state_dict())
    other = MPTILearner(tiny_config(use_attention=att, **MODES), "cpu",
                        torch.Generator().manual_seed(9))
    other.load_torch_state(torch_convert.export_mpti_state(learner.model))
    _assert_state_equal(_state(other), _state(learner))


@pytest.mark.parametrize("schema", ["model_state_dict", "params", "bare"])
def test_checkpoint_schemas_load(jax_shapes, tmp_path, schema):
    """The full model's schema and a bare state dict fill the whole model;
    the pretraining schema ('params', the encoder without its prefix)
    fills the encoder only."""
    _, _, learner = _learner(jax_shapes, True, 2)
    sd = torch_convert.export_mpti_state(learner.model)
    if schema == "model_state_dict":
        blob = {"iteration": 7, "model_state_dict": sd, "optimizer_state_dict": None,
                "loss": np.float32(0.5), "IoU": np.float64(0.25)}
    elif schema == "params":
        blob = {"params": {k[len("encoder."):]: v for k, v in sd.items()
                           if k.startswith("encoder.")}}
    else:
        blob = sd
    path = str(tmp_path / "checkpoint.tar")
    torch.save(blob, path)
    got, encoder_only = torch_convert.load_torch_checkpoint(path)
    assert encoder_only == (schema == "params")
    assert set(got) == ({k for k in sd if k.startswith("encoder.")} if encoder_only else set(sd))
    assert all(torch.equal(got[k], sd[k]) for k in got)

    fresh = MPTILearner(tiny_config(**MODES), "cpu", torch.Generator().manual_seed(9))
    before = _state(fresh)
    fresh.load_torch_state(got, encoder_only=encoder_only)
    after, want = _state(fresh), _state(learner)
    for k in want:
        assert torch.equal(after[k], want[k] if not encoder_only
                           or k.startswith("features.encoder.") else before[k]), k


def test_encoder_only_leaves_base_learner_and_proj(jax_shapes):
    _, _, learner = _learner(jax_shapes, True, 3)
    sd = torch_convert.export_mpti_state(learner.model)
    target = MPTILearner(tiny_config(**MODES), "cpu", torch.Generator().manual_seed(9))
    target.train(episode_arrays(target.cfg, np.random.default_rng(0))
                 + (None, None, np.ones((2, target.cfg.k_shot), np.int32)))
    assert target.optimizer.state
    before = _state(target)
    target.load_torch_state({k: v for k, v in sd.items() if k.startswith("encoder.")},
                            encoder_only=True)
    after, source = _state(target), _state(learner)
    assert not target.optimizer.state and target.scheduler.last_epoch == 0
    for k, v in after.items():
        if k.startswith("features.encoder."):
            assert torch.equal(v, source[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert any(k.startswith("features.base_learner.") for k in after)
    with pytest.raises(KeyError, match="no feature-extractor counterpart"):
        target.load_torch_state({"proj.weight": sd["proj.weight"]}, encoder_only=True)


def test_bad_checkpoints_raise(jax_shapes):
    """An unknown torch key, a port tensor left unfilled and a conv weight
    that is not 1x1 raise; `num_batches_tracked` alone is dropped."""
    _, _, learner = _learner(jax_shapes, True, 4)
    sd = torch_convert.export_mpti_state(learner.model)
    target = MPTILearner(tiny_config(**MODES), "cpu")
    with pytest.raises(KeyError, match="no port counterpart"):
        target.load_torch_state({**sd, "encoder.att_learner.q_map.weight": sd["proj.weight"]})
    with pytest.raises(KeyError, match="unfilled"):
        target.load_torch_state({k: v for k, v in sd.items() if k != "proj.bias"})
    key = "encoder.edge_convs.0.layer.0.weight"
    with pytest.raises(ValueError, match="1x1 conv"):
        target.load_torch_state({**sd, key: sd[key].expand(-1, -1, 1, 2)})
    target.load_torch_state({k: v for k, v in sd.items()
                             if not k.endswith("num_batches_tracked")})
    _assert_state_equal(_state(target), _state(learner))


def test_msgpack_checkpoint_raises(tmp_path):
    """A directory is searched for checkpoint.msgpack first: one that holds
    it raises, even beside a checkpoint.tar; an empty one is no checkpoint."""
    with pytest.raises(ValueError, match="no checkpoint"):
        FewShotPredictor.from_checkpoint(str(tmp_path), tiny_config(), device="cpu")
    (tmp_path / "checkpoint.msgpack").write_bytes(b"\x80")
    torch.save({"model_state_dict": {}}, str(tmp_path / "checkpoint.tar"))
    for path in (tmp_path, tmp_path / "checkpoint.msgpack"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            FewShotPredictor.from_checkpoint(str(path), tiny_config(), device="cpu")


def test_from_checkpoint_predicts_as_jax(jax_shapes, tmp_path):
    """A `.tar` written by the JAX package's `save_reference_checkpoint`
    serves the same labels through the port's `from_checkpoint` as through
    the JAX package's; the port's own `save_reference_checkpoint` of the
    loaded model writes the same tensors.  The episode first shows a
    k-th-neighbour margin above 1e-6 in the JAX model's graph (see
    test_torch_mpti.py)."""
    params, stats = random_flax_weights(jax_shapes[True], np.random.default_rng(5))
    jcfg, cfg = jax_tiny_config(**MODES), tiny_config(**MODES)
    jax_convert.save_reference_checkpoint(str(tmp_path / "checkpoint.tar"), params, stats)
    port = FewShotPredictor.from_checkpoint(str(tmp_path), cfg, device="cpu")
    jax_pred = JaxPredictor.from_checkpoint(str(tmp_path), jcfg)

    sx, sy, qx, _ = episode_arrays(cfg, np.random.default_rng(6))
    model = jax_mpti.MPTINet(jcfg)
    variables = {"params": params, "batch_stats": stats}
    features = jax.jit(lambda x: model.apply(
        variables, x, method=lambda m, x: m.features(x, train=False)))
    margin = jax_graph_margin(lambda x: np.asarray(features(jnp.asarray(x))), jcfg,
                              sx, sy, qx, eval_mdns=True)
    assert margin > 1e-6, f"episode has a k-th-neighbour tie at f32 rounding ({margin:.1e})"
    got = port(sx, sy, qx)
    assert got.dtype == np.int32 and got.shape == (cfg.n_way, cfg.pc_npts)
    np.testing.assert_array_equal(got, port.predict(sx, sy, qx))
    np.testing.assert_array_equal(got, jax_pred(sx, sy, qx))

    torch_convert.save_reference_checkpoint(str(tmp_path / "again.tar"), port._learner.model)
    again, _ = torch_convert.load_torch_checkpoint(str(tmp_path / "again.tar"))
    want = jax_convert.load_torch_checkpoint(str(tmp_path / "checkpoint.tar"))
    assert set(again) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)
