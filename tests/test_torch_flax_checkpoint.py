"""The JAX package's Flax `.msgpack` checkpoints in the port
(`utils/checkpoint.py`, `utils/convert.py:jax_tree_from_state_dict`), both
ways, against the JAX package's own `save_checkpoint` / `load_checkpoint`
/ `save_pretrain_checkpoint` and its `.tar` export:

  * a JAX learner at tiny_config (random Flax weights, two JAX training
    steps) writes `checkpoint.msgpack` and, from the same TrainState,
    `checkpoint.tar` (`save_reference_checkpoint` with the Adam state):
    `FewShotPredictor.from_checkpoint` on each serves bit-equal logits and
    equal labels; the port's learner resumed from each holds bit-equal
    Adam moments (equal to the JAX mu and nu), equal steps and StepLR
    rates, and takes its next step to losses within 1e-6;
  * the port's `save_checkpoint` is restored by the JAX `load_checkpoint`
    into a TrainState whose params, stats, mu and nu are bit-equal to the
    port's, and the JAX learner trains from it;
  * a JAX pretraining `.msgpack` (`save_pretrain_checkpoint` of a JAX
    `DGCNNSegAttention`'s encoder, no training) starts the port's
    meta-training CLI and its finetune with a bit-equal trunk;
  * a log directory holding both files gives the `.msgpack`;
  * `jax_tree_from_state_dict(state_dict_from_jax(t)) == t` for the MPTI,
    the segmentation and the two baselines' trees (the transformer's
    `DenseGeneral` kernels, embeddings, LayerNorms and bare projections);
  * the baselines (ProtoNet_Contrast, the transformer): a JAX TrainState
    with random weights and Adam moments written by the JAX
    `save_checkpoint`, loaded by the port, written again by the port and
    read by the JAX `load_checkpoint` comes back bit-equal; the port's
    transformer trains a step from it with its stopped class tokens and
    their moments bit-equal, and the JAX learner resumes from the port's
    file at the same Adam count and keeps its class tokens too."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners.mpti_learner import MPTILearner as JaxLearner
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.nn import DGCNNSegAttention as JaxSeg
from r3dfsseg_tpu.utils import checkpoint as jax_checkpoint
from r3dfsseg_tpu.utils import torch_convert as jax_convert
from r3dfsseg_tpu_torch import mpti_train_noise, pretrain as port_pretrain
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
from r3dfsseg_tpu_torch.learners import make_learner
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import DGCNNSegAttention
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from r3dfsseg_tpu_torch.utils import checkpoint, torch_convert
from r3dfsseg_tpu_torch.utils.convert import (flax_paths, jax_tree_from_state_dict,
                                                state_dict_from_jax)
from torch_port_helpers import random_flax_weights, train_episode

KW = dict(step_size=2, gamma=0.5)      # the StepLR halves the rates at step 2
ITERATION = 2


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX learner after two steps from random Flax weights, its
    `checkpoint.msgpack` and `checkpoint.tar` in one directory, the
    episodes, and the Flax trees at the save."""
    tmp = tmp_path_factory.mktemp("flax_ckpt")
    jcfg = jax_tiny_config(**KW)
    rng = np.random.default_rng(3)
    episodes = [train_episode(tiny_config(**KW), rng) for _ in range(3)]
    learner = JaxLearner(jcfg)
    learner.init(JaxEpisode(*map(jnp.asarray, episodes[0])))
    params, stats = random_flax_weights(
        {"params": learner.state.params, "batch_stats": learner.state.batch_stats}, rng)
    learner.load_params(params, stats)
    for ep in episodes[:ITERATION]:
        learner.train(JaxEpisode(*map(jnp.asarray, ep)))
    state = jax.tree.map(np.asarray, learner.state)
    jax_checkpoint.save_checkpoint(str(tmp / "checkpoint.msgpack"), learner.state, loss=0.5,
                                   iou=0.25, iteration=ITERATION)
    jax_convert.save_reference_checkpoint(
        str(tmp / "checkpoint.tar"), state.params, state.batch_stats, iteration=ITERATION,
        loss=0.5, iou=0.25, opt_state=state.opt_state, cfg=jcfg)
    return dict(dir=tmp, learner=learner, state=state, episodes=episodes, jcfg=jcfg)


def _logits(predictor, ep):
    sx, sy, qx = (torch.from_numpy(a)[None] for a in ep[:3])
    e = Episode(sx, sy, qx, torch.zeros(qx.shape[:3], dtype=torch.int64))
    with torch.no_grad():
        return predictor._learner.model(e, eval_mdns=True).query_logits


def _moments(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def test_msgpack_serves_as_its_tar(jax_run):
    d = jax_run["dir"]
    cfg = tiny_config(**KW)
    from_msgpack = FewShotPredictor.from_checkpoint(str(d / "checkpoint.msgpack"), cfg,
                                                    device="cpu")
    from_tar = FewShotPredictor.from_checkpoint(str(d / "checkpoint.tar"), cfg, device="cpu")
    sd_m, sd_t = (p._learner.model.state_dict() for p in (from_msgpack, from_tar))
    assert all(torch.equal(sd_m[k], sd_t[k]) for k in sd_t)
    for ep in jax_run["episodes"]:
        assert torch.equal(_logits(from_msgpack, ep), _logits(from_tar, ep))
        np.testing.assert_array_equal(from_msgpack(*ep[:3]), from_tar(*ep[:3]))


def test_resume_from_msgpack_equals_tar(jax_run):
    d, state = jax_run["dir"], jax_run["state"]
    cfg = tiny_config(**KW)
    learners = {}
    for name in ("checkpoint.msgpack", "checkpoint.tar"):
        learner = MPTILearner(cfg, "cpu")
        info = checkpoint.restore(str(d / name), learner)
        assert info["iteration"] == ITERATION and info["IoU"] == 0.25
        learners[name] = learner
    a, b = learners.values()
    params_a, params_b = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    inner = state.opt_state.inner_states
    for name, p in params_a.items():
        sa, sb = a.optimizer.state[p], b.optimizer.state[params_b[name]]
        group = "encoder" if name.startswith("features.encoder.") else "rest"
        adam = inner[group].inner_state[0]
        coll, path, transposed, _ = flax_paths(a.model)[name]
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            assert torch.equal(sa[key], sb[key]), (name, key)
            want = np.asarray(_moments(getattr(adam, jkey), path))
            np.testing.assert_array_equal(sa[key].numpy(), want.T if transposed else want)
        assert float(sa["step"]) == float(sb["step"]) == ITERATION
    for learner in (a, b):
        assert learner.scheduler.last_epoch == ITERATION
        assert [g["lr"] for g in learner.optimizer.param_groups] == \
            [cfg.encoder_lr * 0.5, cfg.lr * 0.5]
    ma, mb = (learner.train(jax_run["episodes"][2]) for learner in (a, b))
    for key in ("loss", "lp_loss", "contrast_loss"):
        np.testing.assert_allclose(ma[key].item(), mb[key].item(), rtol=0, atol=1e-6)


def test_jax_restores_the_port_checkpoint(jax_run, tmp_path):
    cfg = tiny_config(**KW)
    learner = MPTILearner(cfg, "cpu")
    checkpoint.restore(str(jax_run["dir"] / "checkpoint.msgpack"), learner)
    learner.train(jax_run["episodes"][2])                # the port's own third step
    path = str(tmp_path / "checkpoint.msgpack")
    checkpoint.save_checkpoint(path, learner, loss=0.1, iou=0.3, iteration=ITERATION + 1)

    jl = jax_run["learner"]
    blob, restored = jax_checkpoint.load_checkpoint(path, jl.state)
    assert blob["iteration"] == ITERATION + 1 and int(restored.step) == ITERATION + 1
    want_p, want_s = jax_tree_from_state_dict(learner.model)
    for got, want in ((restored.params, want_p), (restored.batch_stats, want_s)):
        flat = jax.tree_util.tree_flatten_with_path(got)[0]
        assert len(flat) == len(jax.tree.leaves(want))
        for kp, leaf in flat:
            np.testing.assert_array_equal(np.asarray(leaf), _moments(want, [e.key for e in kp]))
    params = dict(learner.model.named_parameters())
    for name, (coll, path_, transposed, _) in flax_paths(learner.model).items():
        if coll != "params":
            continue
        group = "encoder" if name.startswith("features.encoder.") else "rest"
        adam = restored.opt_state.inner_states[group].inner_state[0]
        assert int(adam.count) == ITERATION + 1
        st = learner.optimizer.state[params[name]]
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            got = np.asarray(_moments(getattr(adam, jkey), path_))
            want = st[key].numpy()
            np.testing.assert_array_equal(got, want.T if transposed else want)
    jl.state = restored
    metrics = jl.train(JaxEpisode(*map(jnp.asarray, jax_run["episodes"][0])))
    assert np.isfinite(float(metrics["loss"]))


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("flax_ds") / "blocks"),
                                  n_scans=40, pts_per_scan=512, seed=9)


def test_jax_pretraining_msgpack_starts_the_port(ds, tmp_path):
    """The JAX pretraining artifact (its `pretrain.py` saves the trunk of a
    `DGCNNSegAttention` under features/encoder), written from random
    weights, starts the port's meta-training CLI and its finetune: at zero
    learning rates the trunk's parameters stay the artifact's."""
    jcfg = jax_tiny_config()
    jm = JaxSeg(num_classes=7, edgeconv_widths=jcfg.edgeconv_widths,
                dgcnn_mlp_widths=jcfg.dgcnn_mlp_widths, dgcnn_k=jcfg.dgcnn_k,
                atten_dim=jcfg.dg_atten_dim)
    variables = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 64, 9)), train=False))
    params, stats = random_flax_weights(variables, np.random.default_rng(5))
    path = str(tmp_path / "pretrain_checkpoint.msgpack")
    jax_checkpoint.save_pretrain_checkpoint(path, {"features": {"encoder": params["encoder"]}},
                                            {"features": {"encoder": stats["encoder"]}})
    trunk = state_dict_from_jax(params["encoder"], stats["encoder"])
    weights = [k for k in trunk if not k.endswith(("running_mean", "running_var"))]

    cfg = tiny_config(clean_data_path=ds, n_iters=1, eval_interval=1, n_episode_test=1,
                      n_workers=1, lr=0.0, encoder_lr=0.0, pretrain_checkpoint_path=path,
                      save_path=str(tmp_path), log_dir=str(tmp_path / "mt"))
    mpti_train_noise.train(cfg, device="cpu")
    assert "Load encoder module" in open(tmp_path / "mt" / "log_mptitrain.txt").read()
    learner = MPTILearner(cfg, "cpu")
    checkpoint.restore(str(tmp_path / "mt" / "checkpoint_1.tar"), learner)
    got = learner.model.features.encoder.state_dict()
    for k in weights:
        assert torch.equal(got[k], trunk[k]), k

    ft = cfg.replace(phase="finetune", log_dir=str(tmp_path / "ft"))
    out = port_pretrain.pretrain(ft, batch_size=2, lr=0.0, device="cpu")
    assert "finetune: loaded encoder" in open(tmp_path / "ft" / "log_finetune.txt").read()
    model = DGCNNSegAttention(9, 7, cfg.edgeconv_widths, cfg.dgcnn_mlp_widths, cfg.dgcnn_k,
                              atten_dim=cfg.dg_atten_dim)
    model.encoder.load_state_dict(checkpoint.load_pretrain_checkpoint(out, model.encoder))
    got = model.encoder.state_dict()
    for k in weights:
        assert torch.equal(got[k], trunk[k]), k


def test_log_dir_gives_the_msgpack_first(jax_run, tmp_path):
    """A directory holding both files serves the `.msgpack`'s weights, as
    the JAX package's `FewShotPredictor` does, even beside a `.tar` of
    other weights."""
    cfg = tiny_config(**KW)
    src = jax_run["dir"] / "checkpoint.msgpack"
    (tmp_path / "checkpoint.msgpack").write_bytes(src.read_bytes())
    other = MPTILearner(cfg, "cpu", torch.Generator().manual_seed(77))
    torch_convert.save_reference_checkpoint(str(tmp_path / "checkpoint.tar"), other.model)
    assert torch_convert.checkpoint_file(str(tmp_path)) == str(tmp_path / "checkpoint.msgpack")
    from_dir = FewShotPredictor.from_checkpoint(str(tmp_path), cfg, device="cpu")
    from_file = FewShotPredictor.from_checkpoint(str(src), cfg, device="cpu")
    ep = jax_run["episodes"][0]
    assert torch.equal(_logits(from_dir, ep), _logits(from_file, ep))


@pytest.mark.parametrize("which", ["mpti", "seg", "protoeval", "transformereval"])
def test_tree_round_trip_is_the_identity(jax_run, which):
    if which == "mpti":
        params, stats = jax_run["state"].params, jax_run["state"].batch_stats
        model = MPTILearner(tiny_config(**KW), "cpu").model
    elif which in BASELINES:
        state, _, cfg = _jax_baseline(which, 8)
        params, stats = state.params, state.batch_stats
        model = make_learner(cfg, "cpu").model
    else:
        jm = JaxSeg(num_classes=6, edgeconv_widths=((8, 8), (8, 8)), dgcnn_mlp_widths=(16, 12),
                    dgcnn_k=4, atten_dim=8, v2=True)
        variables = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
            jnp.zeros((2, 32, 9)), train=False))
        params, stats = random_flax_weights(variables, np.random.default_rng(6))
        model = DGCNNSegAttention(9, 6, ((8, 8), (8, 8)), (16, 12), 4, atten_dim=8, v2=True)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    got_p, got_s = jax_tree_from_state_dict(model)
    for got, want in ((got_p, params), (got_s, stats)):
        assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------- baselines --
BASELINES = {"protoeval": {}, "transformereval": dict(d_model=16, n_head=4, n_layers=2,
                                                      d_feed=12)}
CLS = ("transformer", "cls_embeddings", "embedding")


def _jax_baseline(phase, seed):
    """(a JAX TrainState of the ``phase``'s learner at tiny_config: random
    Flax weights, random Adam moments and counts 3; the JAX learner; the
    port's config)."""
    from r3dfsseg_tpu.learners import ProtoLearner as JaxProto
    from r3dfsseg_tpu.learners import TransformerLearner as JaxTransformer
    from r3dfsseg_tpu.learners.base import TrainState

    kw = dict(phase=phase, **KW, **BASELINES[phase])
    jcfg = jax_tiny_config(**kw)
    jl = JaxProto(jcfg, with_contrast=True) if phase == "protoeval" else JaxTransformer(jcfg)
    w, k, n, c = jcfg.n_way, jcfg.k_shot, jcfg.pc_npts, jcfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: jl.model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)

    def moment(path, leaf):
        names = [getattr(e, "name", getattr(e, "key", None)) for e in path]
        if names[-1] == "count":
            return np.asarray(3, np.int32)
        return (rng.uniform(0.0, 1e-3, size=np.shape(leaf))
                * (0.0 if tuple(names[-3:]) == CLS else 1.0)).astype(np.float32)
    opt = jax.tree_util.tree_map_with_path(moment, jl.tx.init(params))
    return TrainState(np.asarray(3, np.int32), params, stats, opt), jl, tiny_config(**kw)


def _assert_trees_equal(got, want):
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w and len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("phase", list(BASELINES))
def test_baseline_msgpack_round_trip(phase, tmp_path):
    state, jl, cfg = _jax_baseline(phase, 5)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax.msgpack"), state, loss=0.5, iou=0.25,
                                   iteration=3)
    learner = make_learner(cfg, "cpu")
    checkpoint.load_checkpoint(str(tmp_path / "jax.msgpack"), learner)
    assert learner.scheduler.last_epoch == 3
    checkpoint.save_checkpoint(str(tmp_path / "port.msgpack"), learner, loss=0.5, iou=0.25,
                               iteration=3)
    blob, restored = jax_checkpoint.load_checkpoint(str(tmp_path / "port.msgpack"), state)
    assert blob["iteration"] == 3 and int(restored.step) == 3
    _assert_trees_equal(restored, state)
    if phase != "transformereval":
        return

    # a step in the port: the stopped class tokens and their moments stay
    ep = train_episode(cfg, np.random.default_rng(6))
    before = learner.model.transformer.cls_embeddings.weight.detach().clone()
    learner.train(ep)
    assert torch.equal(learner.model.transformer.cls_embeddings.weight, before)
    checkpoint.save_checkpoint(str(tmp_path / "step.msgpack"), learner, iteration=4)
    _, restored = jax_checkpoint.load_checkpoint(str(tmp_path / "step.msgpack"), state)
    adam = restored.opt_state.inner_states["rest"].inner_state[0]
    assert int(adam.count) == 4 and int(restored.step) == 4
    np.testing.assert_array_equal(np.asarray(_moments(restored.params, CLS)), before.numpy())
    for m in (adam.mu, adam.nu):
        assert not np.asarray(_moments(m, CLS)).any()
    # ... and a JAX step from the port's file: its count moves on, its class
    # tokens stay
    jl.state = restored
    jl.train(JaxEpisode(*map(jnp.asarray, ep)))
    adam = jl.state.opt_state.inner_states["rest"].inner_state[0]
    assert int(adam.count) == 5
    np.testing.assert_array_equal(np.asarray(_moments(jl.state.params, CLS)), before.numpy())
