"""The port's meta-training and meta-test CLIs (`r3dfsseg_tpu_torch/cli.py`,
`mpti_train_noise.py`, `eval_noise.py`) against the JAX package's, on the
CPU at tiny sizes: the flag surface and its config, the flags the port
refuses, the MDNS diagnostics, train then evaluate end to end with the JAX
package's `eval_noise.evaluate` reading the port's `checkpoint.tar`, resume,
the Adam state in the original layout, and a run without h5py or msgpack.

TensorBoard is blocked in this module (`torch.utils.tensorboard` imports
TensorFlow here, which takes many seconds); the scalars go to
`scalars.jsonl`, as on a machine without the tensorboard package."""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
sys.path.insert(0, REPO)

import eval_noise as jax_eval  # noqa: E402
from r3dfsseg_tpu import cli as jax_cli  # noqa: E402
from r3dfsseg_tpu.config import R3DConfig as JaxConfig  # noqa: E402
from r3dfsseg_tpu.data import synthetic as jax_synthetic  # noqa: E402
from r3dfsseg_tpu.learners.base import TrainState  # noqa: E402
from r3dfsseg_tpu.learners.mpti_learner import MPTILearner as JaxLearner  # noqa: E402
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode  # noqa: E402
from r3dfsseg_tpu.utils import diagnostics as jax_diag  # noqa: E402
from r3dfsseg_tpu.utils import torch_convert as jax_convert  # noqa: E402
from r3dfsseg_tpu_torch import cli, eval_noise, mpti_train_noise  # noqa: E402
from r3dfsseg_tpu_torch.config import R3DConfig  # noqa: E402
from r3dfsseg_tpu_torch.data.episodes import NoisyEpisodeSampler  # noqa: E402
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner  # noqa: E402
from r3dfsseg_tpu_torch.utils import diagnostics, torch_convert  # noqa: E402
from r3dfsseg_tpu_torch.utils.convert import jax_tree_from_state_dict  # noqa: E402
from r3dfsseg_tpu_torch.utils.flax_msgpack import msgpack_serialize  # noqa: E402
from torch_port_helpers import random_flax_weights  # noqa: E402

TINY = dict(dataset="s3dis", cvfold=0, pc_npts=64, dgcnn_k=4,
            edgeconv_widths=((8, 8), (8, 8), (8, 8)), dgcnn_mlp_widths=(16, 16),
            base_widths=(8, 8), output_dim=8, use_attention=True, n_subprototypes=8,
            k_connect=8, lp_cg_iters=20, n_way=2, k_shot=2, n_queries=1, n_episode_test=1,
            n_workers=2)
TINY_FLAGS = ["--pc_npts", "64", "--dgcnn_k", "4", "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
              "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]", "--output_dim", "8",
              "--use_attention", "--n_subprototypes", "8", "--k_connect", "8",
              "--lp_cg_iters", "20", "--k_shot", "2", "--n_episode_test", "1",
              "--n_workers", "2"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return jax_synthetic.make_synthetic_dataset(
        str(tmp_path_factory.mktemp("torch_cli") / "blocks"), n_scans=40, pts_per_scan=512,
        seed=7)


def _tiny(ds, tmp, **kw):
    return R3DConfig(clean_data_path=ds, log_dir=str(tmp / "run"), save_path=str(tmp),
                     **{**TINY, **kw})


def _jax_config(cfg: R3DConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------- parser --
def _actions(parser):
    return {a.dest: (a.default, a.choices, a.type, a.nargs, a.const, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("eval_mode", [False, True])
def test_parser_is_the_jax_parser_plus_device(eval_mode):
    got = _actions(cli.build_parser(eval_mode))
    want = _actions(jax_cli.build_parser(eval_mode))
    assert got.pop("device")[0] == "cuda"
    assert got == want


ARGVS = [[], TINY_FLAGS,
         TINY_FLAGS + ["--pc_augm", "--pc_augm_scale", "1.25", "--train_noise_ratio", "[0.1,0.3]",
                       "--episode_batch", "2", "--lp_solver", "solve", "--knn_impl", "xla",
                       "--affinity_impl", "topk", "--compute_dtype", "bfloat16", "--seed", "9",
                       "--wire_format", "none", "--transfer_batch", "1", "--mesh", "1"]]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "tiny", "knobs"])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_args_to_config_equals_jax(argv, eval_mode):
    extra = ["--noise_ratio", "0.2", "--noise_type", "pair", "--noise_pair_dict", "{0: 3, 3: 0}",
             "--save_test_record", "--model_checkpoint_path", "/ckpt"] if eval_mode else []
    got = cli.args_to_config(cli.build_parser(eval_mode).parse_args(argv + extra), eval_mode)
    want = jax_cli.args_to_config(jax_cli.build_parser(eval_mode).parse_args(argv + extra),
                                  eval_mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


REFUSED = [(["--knn_impl", "approx"], "Not queued"),
           (["--wire_format", "f16"], "Not queued")]


@pytest.mark.parametrize("argv,item", REFUSED, ids=[" ".join(a) for a, _ in REFUSED])
def test_flags_the_port_does_not_run_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        cli.args_to_config(cli.build_parser(False).parse_args(argv), False)


MESHES = [["--mesh", "2"], ["--phase", "pretrain", "--mesh", "2"],
          ["--phase", "finetune", "--mesh", "4"]]


@pytest.mark.parametrize("argv", MESHES, ids=[" ".join(a) for a in MESHES])
def test_mesh_flags_are_taken(argv):
    """`--mesh N` runs data-parallel ranks (tests/test_torch_parallel.py):
    the config carries the mesh as the JAX CLI's does."""
    cfg = cli.args_to_config(cli.build_parser(False).parse_args(argv), False)
    assert cfg.mesh_shape == (int(argv[-1]),)


def test_episode_batch_auto_is_one():
    cfg = cli.args_to_config(cli.build_parser(False).parse_args([]), False)
    assert cfg.episode_batch == 0
    assert cli.resolve_episode_batch(cfg).episode_batch == 1
    assert cli.resolve_episode_batch(cfg.replace(episode_batch=3)).episode_batch == 3


def test_default_device_needs_a_gpu(ds, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpti_train_noise.main(["--clean_data_path", ds, "--save_path", str(tmp_path)]
                              + TINY_FLAGS)


# ----------------------------------------------------------- diagnostics --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diagnostics_equal_jax(seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    gt, pr = rng.integers(0, 2, size=(2, 5)), rng.integers(0, 2, size=(2, 5))
    for g, w in zip(diagnostics.clean_detection_precision_recall(torch.tensor(gt), torch.tensor(pr)),
                    jax_diag.clean_detection_precision_recall(jnp.asarray(gt), jnp.asarray(pr))):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    gl, pl = rng.integers(0, 3, size=(2, 40)), rng.integers(0, 3, size=(2, 40))
    got = diagnostics.query_label_precision_recall(torch.tensor(gl), torch.tensor(pl), 3)
    want = jax_diag.query_label_precision_recall(jnp.asarray(gl), jnp.asarray(pl), 3)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    est, orig, gtm = (rng.integers(0, 2, size=(2, 3, 16)) for _ in range(3))
    got = diagnostics.support_mask_accuracy(*map(torch.tensor, (est, orig, gtm)))
    want = jax_diag.support_mask_accuracy(*map(jnp.asarray, (est, orig, gtm)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assign = rng.integers(0, 4, size=(2, 48))
    valid = rng.uniform(size=(2, 48)) < 0.5
    got = diagnostics.prototype_cleanness(torch.tensor(gtm), torch.tensor(orig),
                                          torch.tensor(assign), torch.tensor(valid), 4)
    want = jax_diag.prototype_cleanness(jnp.asarray(gtm), jnp.asarray(orig),
                                        jnp.asarray(assign), jnp.asarray(valid), 4)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6)


@pytest.mark.parametrize("seed,noise_type", [(3, "ood"), (4, "sym")])
def test_mdns_aux_equals_jax(ds, seed, noise_type):
    """`test(..., return_aux=True)`'s MDNS diagnostics, on the same random
    Flax weights (`load_params`, through `state_dict_from_jax`) and a noisy
    episode of the synthetic set with its clean masks."""
    import jax.numpy as jnp
    cfg = R3DConfig(**{**TINY, "k_shot": 3}, attn_dropout=0.0)
    ep = NoisyEpisodeSampler(ds, "s3dis", mode="test", noise_ratio=0.4, noise_type=noise_type,
                             k_shot=3, num_point=64, seed=seed).sample()
    jax_learner = JaxLearner(_jax_config(cfg))
    shapes = jax.eval_shape(lambda: jax_learner.model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, JaxEpisode(*ep)))
    params, stats = random_flax_weights(shapes, np.random.default_rng(seed))
    jax_learner.state = TrainState(jnp.zeros((), jnp.int32), params, stats, None)
    _, _, jax_acc, jax_aux = jax_learner.test(JaxEpisode(*ep), eval_mdns=True, return_aux=True)
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    _, _, acc, aux = learner.test(ep, eval_mdns=True, return_aux=True)
    keys = ["mdns_point_clean_ratio", "mdns_precision", "mdns_recall",
            "mdns_shot_clean_ratio", "mdns_size_ratio"]
    assert sorted(k for k in aux if k.startswith("mdns")) == keys
    for k in keys:
        assert abs(float(aux[k]) - float(jax_aux[k])) <= 1e-6, k
    assert "mdns_precision" not in learner.test(ep, eval_mdns=False, return_aux=True)[3]
    assert len(learner.test(ep, eval_mdns=True)) == 3


# ------------------------------------------------------------ end to end --
def test_train_then_evaluate_and_jax_reads_the_checkpoint(ds, tmp_path):
    cfg = _tiny(ds, tmp_path, n_iters=4, eval_interval=2, train_noise_ratio=(0.0, 0.5),
                profile_dir=str(tmp_path / "profile"))
    stats = mpti_train_noise.train(cfg, device="cpu")
    assert (tmp_path / "profile" / "trace.json").exists()
    ckpt = os.path.join(cfg.log_dir, "checkpoint.tar")
    assert os.path.exists(ckpt)
    assert all(os.path.exists(os.path.join(cfg.log_dir, f"checkpoint_{i}.tar")) for i in (2, 4))
    log = open(os.path.join(cfg.log_dir, "log_mptitrain.txt")).read()
    assert "[VALID]" in log and "Mean IoU" in log and log.count("==[Train] Iter") == 4
    assert len(stats["losses"]) == 4 and np.isfinite(stats["losses"]).all()
    assert stats["episodes_per_s"] > 0 and 0.0 < stats["best_iou"] <= 1.0
    tags = {json.loads(line)["tag"] for line in open(os.path.join(cfg.log_dir, "scalars.jsonl"))}
    assert {"Train/loss", "Valid/meanIoU", "Train/clean_ratio_LP"} <= tags
    blob = torch.load(ckpt, weights_only=False)
    assert set(blob) == {"iteration", "model_state_dict", "optimizer_state_dict", "loss", "IoU"}
    assert blob["iteration"] in (2, 4) and blob["IoU"] == stats["best_iou"]

    # the digest of the first episodes: the samplers' stream for the seed
    samplers = mpti_train_noise.train_samplers(cfg)
    first = [samplers[i % len(samplers)].sample() for i in range(4)]
    assert stats["episodes_sha256"] == mpti_train_noise.episodes_sha256(first)

    ecfg = cfg.replace(phase="mptinoise_eval", noise_ratio=0.5, noise_type="ood",
                       model_checkpoint_path=cfg.log_dir, save_test_record=True,
                       log_dir=cfg.log_dir)
    miou = eval_noise.evaluate(ecfg, device="cpu")
    assert 0.0 <= miou <= 1.0
    elog = open(os.path.join(cfg.log_dir, "log_mptinoise_eval.txt")).read()
    assert "mdns_precision" in elog and "[TEST]" in elog and "eval throughput" in elog
    record = os.path.join(cfg.log_dir, "ood_0.500_test_record.npz")
    with np.load(record) as f:
        port = {k: f[k] for k in f.files}

    jax_miou = jax_eval.evaluate(_jax_config(ecfg))
    with np.load(record) as f:
        jax = {k: f[k] for k in f.files}
    np.testing.assert_array_equal(port["label"], jax["label"])
    np.testing.assert_array_equal(port["classes"], jax["classes"])
    agree = float((port["pred"] == jax["pred"]).mean())
    assert agree >= 0.99, agree
    assert abs(miou - jax_miou) <= 1e-2, (miou, jax_miou)


BASELINE_RUNS = [("prototrain", "protoeval", {}),
                 ("transformertrain", "transformereval",
                  dict(d_model=16, n_head=4, n_layers=2, d_feed=12))]


@pytest.mark.parametrize("train_phase,eval_phase,arch", BASELINE_RUNS,
                         ids=[r[0] for r in BASELINE_RUNS])
def test_baseline_phases_train_then_evaluate(ds, tmp_path, train_phase, eval_phase, arch):
    """A baseline's training phase runs 2 episodes, logs each learner's
    keys (lp_loss defaults to the loss, contrast_loss to 0; the
    transformer's contrast_loss is its BCE), validates and writes its
    `.tar` checkpoints without an Adam state (the original MPTI model's
    layout is the only one known); its eval phase reads it, and so does
    the JAX package's `eval_noise.evaluate`, which keeps >= 99% of the
    port's labels."""
    cfg = _tiny(ds, tmp_path, phase=train_phase, n_iters=2, eval_interval=2, **arch)
    stats = mpti_train_noise.train(cfg, device="cpu")
    assert len(stats["losses"]) == 2 and np.isfinite(stats["losses"]).all()
    log = open(os.path.join(cfg.log_dir, f"log_{train_phase}.txt")).read()
    assert log.count("==[Train] Iter") == 2 and "[VALID]" in log
    # the periodic file (the best one is written only past a validation
    # IoU of 0), evaluated from a directory of its own as checkpoint.tar
    tar = os.path.join(cfg.log_dir, "checkpoint_2.tar")
    blob = torch.load(tar, weights_only=False)
    assert blob["optimizer_state_dict"] is None and blob["iteration"] == 2
    assert any(k.startswith("transformer.") for k in blob["model_state_dict"]) == (
        train_phase == "transformertrain")
    ev = tmp_path / "eval"
    ev.mkdir()
    shutil.copy(tar, ev / "checkpoint.tar")

    ecfg = cfg.replace(phase=eval_phase, noise_ratio=0.5, noise_type="ood",
                       model_checkpoint_path=str(ev), save_test_record=True)
    miou = eval_noise.evaluate(ecfg, device="cpu")
    assert 0.0 <= miou <= 1.0
    elog = open(ev / f"log_{eval_phase}.txt").read()
    assert "[TEST]" in elog and "eval throughput" in elog
    record = str(ev / "ood_0.500_test_record.npz")
    with np.load(record) as f:
        port = f["pred"]
    jax_miou = jax_eval.evaluate(_jax_config(ecfg))
    with np.load(record) as f:
        agree = float((port == f["pred"]).mean())
    assert agree >= 0.99, agree
    assert abs(miou - jax_miou) <= 1e-2, (miou, jax_miou)


def test_episode_batches(ds, tmp_path):
    """Two episodes a step: iterations and checkpoints count episodes, and
    evaluation stacks two cached episodes a step."""
    cfg = _tiny(ds, tmp_path, n_iters=4, eval_interval=2, episode_batch=2)
    stats = mpti_train_noise.train(cfg, device="cpu")
    assert len(stats["losses"]) == 2
    log = open(os.path.join(cfg.log_dir, "log_mptitrain.txt")).read()
    assert "Iter: 2 |" in log and "Iter: 4 |" in log and log.count("[VALID]") == 2
    assert torch.load(os.path.join(cfg.log_dir, "checkpoint_4.tar"),
                      weights_only=False)["iteration"] == 4
    ecfg = cfg.replace(phase="mptinoise_eval", noise_ratio=0.4, noise_type="sym",
                       model_checkpoint_path=cfg.log_dir)
    assert 0.0 <= eval_noise.evaluate(ecfg, device="cpu") <= 1.0


def _flax_path_key(names):
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[names[-1]]
    return ".".join([*names[:-1], leaf]), names[-1] == "kernel"


def test_resume_continues_the_run(ds, tmp_path):
    """Three steps in one run, and two steps then a resume from
    checkpoint_2.tar for the third, end on the same weights and Adam state;
    the JAX package's `convert_adam_state` reads the port's moments."""
    base = _tiny(ds, tmp_path, n_iters=3, eval_interval=1, train_noise_ratio=(0.0, 0.5),
                 attn_dropout=0.0)
    whole = base.replace(log_dir=str(tmp_path / "whole"))
    mpti_train_noise.train(whole, device="cpu")
    resumed = base.replace(log_dir=str(tmp_path / "resumed"),
                           model_checkpoint_path=str(tmp_path / "whole" / "checkpoint_2.tar"))
    stats = mpti_train_noise.train(resumed, device="cpu")
    assert len(stats["losses"]) == 1
    assert "Resume from checkpoint" in open(tmp_path / "resumed" / "log_mptitrain.txt").read()

    a = torch.load(tmp_path / "whole" / "checkpoint_3.tar", weights_only=False)
    b = torch.load(tmp_path / "resumed" / "checkpoint_3.tar", weights_only=False)
    assert a["iteration"] == b["iteration"] == 3
    for k, v in a["model_state_dict"].items():
        assert float((v.double() - b["model_state_dict"][k].double()).abs().max()) <= 1e-6, k
    for i, st in a["optimizer_state_dict"]["state"].items():
        other = b["optimizer_state_dict"]["state"][i]
        assert float(st["step"]) == float(other["step"]) == 3
        for m in ("exp_avg", "exp_avg_sq"):
            assert float((st[m] - other[m]).abs().max()) <= 1e-6, (i, m)

    # the JAX package reads the moments of checkpoint_2.tar into optax's
    # mu / nu where the port's resume puts them
    tar = str(tmp_path / "whole" / "checkpoint_2.tar")
    learner = MPTILearner(base, "cpu")
    info = torch_convert.resume_from_reference_checkpoint(tar, learner)
    assert info["iteration"] == 2
    assert learner.scheduler.last_epoch == 2
    jcfg = _jax_config(base)
    params, _ = jax_convert.convert_for_phase(jax_convert.load_torch_checkpoint(tar), jcfg)
    blob = torch.load(tar, weights_only=False)
    opt_state, step = jax_convert.convert_adam_state(blob["optimizer_state_dict"], params, jcfg)
    assert step == 2
    port_params = dict(learner.model.named_parameters())
    seen = set()
    for tpath, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [jax_convert._leafname(e) for e in tpath]
        for which, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            if which in names:
                key, transpose = _flax_path_key(
                    [n for n in names[names.index(which) + 1:] if n is not None])
                want = np.asarray(leaf).T if transpose else np.asarray(leaf)
                got = learner.optimizer.state[port_params[key]][moment].numpy()
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=key)
                seen.add(key)
    assert seen == set(port_params)


def test_pretrain_checkpoint_replaces_the_encoder(ds, tmp_path):
    """`--pretrain_checkpoint_path` takes an encoder-only `.tar` of the
    original pretraining schema ({'params': the DGCNN's tensors without
    their 'encoder.' prefix}) and starts from its encoder; so does a
    `.msgpack` in the JAX pretraining artifact's layout (the trunk under
    features/encoder), and a `.msgpack` that is not one raises."""
    donor = MPTILearner(R3DConfig(**TINY, seed=5), "cpu")
    enc = {k[len("encoder."):]: v for k, v in
           torch_convert.export_feature_extractor(donor.model.features).items()
           if k.startswith("encoder.")}
    torch.save({"params": enc}, tmp_path / "pretrain.tar")
    cfg = _tiny(ds, tmp_path, n_iters=1, eval_interval=1, lr=0.0, encoder_lr=0.0,
                pretrain_checkpoint_path=str(tmp_path / "pretrain.tar"))
    mpti_train_noise.train(cfg, device="cpu")
    assert "Load encoder module from pretrained checkpoint" in \
        open(os.path.join(cfg.log_dir, "log_mptitrain.txt")).read()
    # at zero learning rates the encoder's parameters stay the donor's (its
    # BatchNorm running statistics move with the step)
    saved = torch.load(os.path.join(cfg.log_dir, "checkpoint_1.tar"),
                       weights_only=False)["model_state_dict"]
    params = [k for k in enc if k.endswith((".weight", ".bias"))]
    assert params
    for k in params:
        torch.testing.assert_close(saved["encoder." + k], enc[k], rtol=0, atol=0)
    tree_p, tree_s = jax_tree_from_state_dict(donor.model.features.encoder)
    (tmp_path / "pretrain.msgpack").write_bytes(msgpack_serialize(
        {"params": {"features": {"encoder": tree_p}},
         "batch_stats": {"features": {"encoder": tree_s}}}))
    mcfg = cfg.replace(pretrain_checkpoint_path=str(tmp_path / "pretrain.msgpack"),
                       log_dir=str(tmp_path / "from_msgpack"))
    mpti_train_noise.train(mcfg, device="cpu")
    saved = torch.load(os.path.join(mcfg.log_dir, "checkpoint_1.tar"),
                       weights_only=False)["model_state_dict"]
    for k in params:
        torch.testing.assert_close(saved["encoder." + k], enc[k], rtol=0, atol=0)
    (tmp_path / "bad.msgpack").write_bytes(b"\x80")
    with pytest.raises(KeyError):
        mpti_train_noise.train(cfg.replace(pretrain_checkpoint_path=str(
            tmp_path / "bad.msgpack")), device="cpu")


def test_cli_runs_without_h5py_or_msgpack(tmp_path):
    """Both CLIs through `python -m`'s entry, in a fresh interpreter where
    h5py, msgpack and tensorboard cannot be imported (as on the card's
    machine), with jax, flax and the JAX package absent at the end."""
    code = f"""
import runpy, sys
for m in ("h5py", "msgpack", "torch.utils.tensorboard"):
    sys.modules[m] = None
from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
ds = make_synthetic_dataset({str(tmp_path / 'blocks')!r}, n_scans=40, pts_per_scan=512, seed=7)
flags = {TINY_FLAGS!r} + ["--clean_data_path", ds, "--device", "cpu"]
sys.argv = ["mpti_train_noise", "--n_iters", "2", "--eval_interval", "2",
            "--save_path", {str(tmp_path)!r}, "--log_dir", "run"] + flags
runpy.run_module("r3dfsseg_tpu_torch.mpti_train_noise", run_name="__main__")
log_dir = {str(tmp_path / 'Cleantrain' / 'S0_N2_K2_Att1' / 'run')!r}
sys.argv = ["eval_noise", "--model_checkpoint_path", log_dir, "--noise_ratio", "0.4",
            "--noise_type", "ood"] + flags
runpy.run_module("r3dfsseg_tpu_torch.eval_noise", run_name="__main__")
bad = sorted(m for m in sys.modules if m in ("jax", "flax", "r3dfsseg_tpu")
             or m.startswith(("jax.", "flax.", "r3dfsseg_tpu.")))
assert not bad, bad
assert sys.modules["h5py"] is None and sys.modules["msgpack"] is None
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log_dir = tmp_path / "Cleantrain" / "S0_N2_K2_Att1" / "run"
    assert (log_dir / "checkpoint.tar").exists() or (log_dir / "checkpoint_2.tar").exists()
    assert "=====[TEST]" in (log_dir / "log_mptinoise_eval.txt").read_text()
    cache_dirs = [d for d in os.listdir(tmp_path / "blocks") if "episodes" in d]
    assert cache_dirs and all(f.endswith(".npz") for d in cache_dirs
                              for f in os.listdir(tmp_path / "blocks" / d))
