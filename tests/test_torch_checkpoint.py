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
from r3dfsseg_tpu_torch.utils import checkpoint, torch_convert
from torch_port_helpers import episode_arrays, jax_graph_margin, random_flax_weights, train_episode

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
    got = torch_convert.export_model_state(learner.model)
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
    other.load_torch_state(torch_convert.export_model_state(learner.model))
    _assert_state_equal(_state(other), _state(learner))


@pytest.mark.parametrize("schema", ["model_state_dict", "params", "bare"])
def test_checkpoint_schemas_load(jax_shapes, tmp_path, schema):
    """The full model's schema and a bare state dict fill the whole model;
    the pretraining schema ('params', the encoder without its prefix)
    fills the encoder only."""
    _, _, learner = _learner(jax_shapes, True, 2)
    sd = torch_convert.export_model_state(learner.model)
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
    checkpoint.restore(path, fresh)
    after, want = _state(fresh), _state(learner)
    for k in want:
        assert torch.equal(after[k], want[k] if not encoder_only
                           or k.startswith("features.encoder.") else before[k]), k


def test_encoder_only_leaves_base_learner_and_proj(jax_shapes, tmp_path):
    _, _, learner = _learner(jax_shapes, True, 3)
    sd = torch_convert.export_model_state(learner.model)
    target = MPTILearner(tiny_config(**MODES), "cpu", torch.Generator().manual_seed(9))
    target.train(episode_arrays(target.cfg, np.random.default_rng(0))
                 + (None, None, np.ones((2, target.cfg.k_shot), np.int32)))
    assert target.optimizer.state
    before = _state(target)
    path = str(tmp_path / "pretrain_checkpoint.tar")
    torch.save({"params": {k[len("encoder."):]: v for k, v in sd.items()
                           if k.startswith("encoder.")}}, path)
    checkpoint.restore(path, target)
    after, source = _state(target), _state(learner)
    assert not target.optimizer.state and target.scheduler.last_epoch == 0
    for k, v in after.items():
        if k.startswith("features.encoder."):
            assert torch.equal(v, source[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert any(k.startswith("features.base_learner.") for k in after)
    torch.save({"params": {"proj.weight": sd["proj.weight"]}}, path)
    with pytest.raises(KeyError, match="no port counterpart"):
        checkpoint.restore(path, target)


def test_bad_checkpoints_raise(jax_shapes):
    """An unknown torch key, a port tensor left unfilled and a conv weight
    that is not 1x1 raise; `num_batches_tracked` alone is dropped."""
    _, _, learner = _learner(jax_shapes, True, 4)
    sd = torch_convert.export_model_state(learner.model)
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
    it takes the `.msgpack`, even beside a checkpoint.tar, so a `.msgpack`
    that is no model checkpoint raises there as it does alone; an empty
    directory is no checkpoint."""
    with pytest.raises(ValueError, match="no checkpoint"):
        FewShotPredictor.from_checkpoint(str(tmp_path), tiny_config(), device="cpu")
    (tmp_path / "checkpoint.msgpack").write_bytes(b"\x80")
    torch.save({"model_state_dict": {}}, str(tmp_path / "checkpoint.tar"))
    for path in (tmp_path, tmp_path / "checkpoint.msgpack"):
        with pytest.raises(ValueError, match="not a model checkpoint"):
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


# ------------------------------------------------------------- baselines --
# the baselines' `.tar` schemas: ProtoNet_Contrast's keys are the MPTI
# model's; ProtoNet_transformer's hold the packed `in_proj` tensors
GOLDEN = {"protoeval": "pc_sd/", "transformereval": "pt_sd/"}
TRANSFORMER = dict(d_model=128, n_head=8, n_layers=3, d_feed=128)


def _golden_learner(phase):
    """(the golden fixture's original state dict, a port learner of
    ``phase`` at the fixture's widths holding it)."""
    import json
    import os

    from r3dfsseg_tpu_torch.learners import make_learner
    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "reference_parity_extra.npz"))
    meta = json.loads(bytes(data["meta"]).decode())
    cfg = tiny_config(phase=phase, k_shot=meta["k_shot"], dgcnn_k=meta["dgcnn_k"],
                      edgeconv_widths=tuple(tuple(w) for w in meta["edgeconv_widths"]),
                      dgcnn_mlp_widths=tuple(meta["dgcnn_mlp_widths"]),
                      base_widths=tuple(meta["base_widths"]), output_dim=meta["output_dim"],
                      dg_atten_dim=meta["dg_atten_dim"], proj_dim=128, **TRANSFORMER)
    prefix = GOLDEN[phase]
    sd = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
    learner = make_learner(cfg, "cpu")
    learner.load_torch_state(sd)
    return sd, learner


@pytest.mark.parametrize("phase", list(GOLDEN))
def test_baseline_tar_round_trips(phase):
    """The original state dict loads strictly, exports back to the same
    keys and values (the transformer's in_proj split and joined again;
    num_batches_tracked written as 0), and the JAX package's converter
    reads the port's export into the port's own Flax tree."""
    from r3dfsseg_tpu_torch.utils.convert import jax_tree_from_state_dict
    sd, learner = _golden_learner(phase)
    out = torch_convert.export_model_state(learner.model)
    assert set(out) == set(sd)
    for k, v in sd.items():
        want = np.zeros_like(v) if k.endswith("num_batches_tracked") else v
        np.testing.assert_array_equal(out[k].numpy(), want, err_msg=k)
    if phase == "transformereval":
        w = learner.model.transformer.layer1.self_attn
        packed = sd["transformer.encoder.layers.1.self_attn.in_proj_weight"]
        for i, m in enumerate((w.query, w.key, w.value)):
            np.testing.assert_array_equal(m.weight.detach().numpy(), packed[i * 128:(i + 1) * 128])
    c = learner.cfg
    fe = dict(edgeconv_widths=c.edgeconv_widths, dgcnn_mlp_widths=c.dgcnn_mlp_widths,
              base_widths=c.base_widths, use_attention=True)
    numpy_sd = {k: v.numpy() for k, v in out.items()}
    jp, js = (jax_convert.convert_transformer_model(numpy_sd, d_model=128, n_head=8, n_layers=3,
                                                    **fe)
              if phase == "transformereval" else jax_convert.convert_mpti_model(numpy_sd, **fe))
    got_p, got_s = jax_tree_from_state_dict(learner.model)
    for got, want in ((got_p, jp), (got_s, js)):
        assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("phase", list(GOLDEN))
def test_baseline_bad_keys_raise(phase):
    sd, learner = _golden_learner(phase)
    with pytest.raises(KeyError, match="no port counterpart"):
        learner.load_torch_state({**sd, "transformer.encoder.layers.9.linear1.weight":
                                  np.zeros((128, 128), np.float32)})
    with pytest.raises(KeyError, match="unfilled"):
        learner.load_torch_state({k: v for k, v in sd.items() if "norm" not in k
                                  and not k.startswith("proj.")})


def test_baseline_tar_resume_leaves_adam_fresh(tmp_path):
    """A ProtoNet_Contrast `.tar` that carries an optimizer state: the
    weights resume, the Adam state does not, in the port as in the JAX
    package (its `resume_from_reference_checkpoint` restores Adam for the
    MPTI phases only).  The transformer has no such layout in the
    original MPTI model's Adam order: exporting one raises."""
    from r3dfsseg_tpu.learners import ProtoLearner as JaxProto
    from r3dfsseg_tpu.learners.base import TrainState
    sd, learner = _golden_learner("protoeval")
    learner.train(train_episode(learner.cfg, np.random.default_rng(3)))
    path = str(tmp_path / "checkpoint.tar")
    torch.save({"iteration": 6, "model_state_dict": torch_convert.export_model_state(
                    learner.model),
                "optimizer_state_dict": torch_convert.export_adam_state(
                    learner.model, learner.optimizer, 6),
                "loss": 0.5, "IoU": 0.25}, path)
    assert learner.optimizer.state
    fresh = type(learner)(learner.cfg, "cpu", with_contrast=True)
    said = []
    info = checkpoint.restore(path, fresh, log=said.append)
    assert info["iteration"] == 6 and not fresh.optimizer.state
    assert fresh.scheduler.last_epoch == 0 and "not restored" in said[0]
    _assert_state_equal(_state(fresh), _state(learner))

    jcfg = jax_tiny_config(**{k: getattr(learner.cfg, k) for k in (
        "phase", "k_shot", "dgcnn_k", "edgeconv_widths", "dgcnn_mlp_widths", "base_widths",
        "output_dim", "dg_atten_dim", "proj_dim")})
    jl = JaxProto(jcfg, with_contrast=True)
    p, s = (jax.tree.map(np.zeros_like, t) for t in jax_convert.convert_mpti_model(
        {k: np.asarray(v) for k, v in sd.items()}, edgeconv_widths=jcfg.edgeconv_widths,
        dgcnn_mlp_widths=jcfg.dgcnn_mlp_widths, base_widths=jcfg.base_widths))
    jl.state = TrainState(jnp.zeros((), jnp.int32), p, s, jl.tx.init(p))
    jax_convert.resume_from_reference_checkpoint(path, jl)
    inner = jl.state.opt_state.inner_states
    assert all(not np.asarray(x).any() for g in ("encoder", "rest")
               for x in jax.tree.leaves(inner[g].inner_state[0]))

    _, tl = _golden_learner("transformereval")
    with pytest.raises(KeyError, match="Adam groups"):
        torch_convert.export_adam_state(tl.model, tl.optimizer, 1)


@pytest.mark.parametrize("phase", list(GOLDEN))
def test_baseline_served_from_msgpack_and_tar(phase, tmp_path):
    """`FewShotPredictor.from_checkpoint` of a baseline phase on the port's
    `.msgpack` and on its `.tar` serves bit-equal logits and equal labels;
    a phase without a learner raises."""
    _, learner = _golden_learner(phase)
    learner.train(train_episode(learner.cfg, np.random.default_rng(1)))  # moments to carry
    checkpoint.save_checkpoint(str(tmp_path / "checkpoint.msgpack"), learner, iteration=1)
    torch_convert.save_reference_checkpoint(str(tmp_path / "checkpoint.tar"), learner.model,
                                            iteration=1)
    preds = [FewShotPredictor.from_checkpoint(str(tmp_path / f), learner.cfg, device="cpu")
             for f in ("checkpoint.msgpack", "checkpoint.tar")]
    assert type(preds[0]._learner) is type(learner)
    ep = train_episode(learner.cfg, np.random.default_rng(2))
    a, b = (p.predict(*ep[:3]) for p in preds)
    assert a.shape == (learner.cfg.n_way, learner.cfg.pc_npts) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    _assert_state_equal(_state(preds[0]._learner), _state(preds[1]._learner))
    with pytest.raises(NotImplementedError, match="no learner"):
        FewShotPredictor(learner.cfg.replace(phase="pretrain"), device="cpu")
