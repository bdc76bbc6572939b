"""Episode and scene-batch data parallelism of the port
(`r3dfsseg_tpu_torch/parallel/`), on the CPU with gloo ranks that
`parallel.launch` spawns (rank bodies in tests/torch_parallel_helpers.py),
against the port's own unsharded steps and the JAX package's sharded step
(`tests/test_parallel.py`).

The mesh, the rows and offsets of `shard_episode`, the auto episode batch,
a ragged batch, the launcher's failure and device checks; the dropout
offsets bit for bit; BatchNorm synchronised over two ranks against the
whole batch; the sharded training step of MPTI, ProtoNet_Contrast and the
transformer at E = 4 over 2 and 4 ranks with dropout 0.1 against the
unsharded step (loss rtol 1e-5, every gradient within 1e-5 relative L2
but the exactly zero ones, BN buffers rtol 1e-5) and the sharded `test`;
MPTI over 4 ranks against the JAX package's step over `make_mesh(4)`; the
loss at mesh sizes 1, 2 and 4; a pretraining step over 2 ranks; and the
training, evaluation and pretraining CLIs at ``--mesh 2`` against
``--mesh 1``."""
import contextlib
import json
import os
import re
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners import MPTILearner as JaxLearner
from r3dfsseg_tpu.learners.base import TrainState
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode, stack_episodes
from r3dfsseg_tpu.parallel import make_mesh as jax_make_mesh, replicate as jax_replicate
from r3dfsseg_tpu.parallel import shard_episode as jax_shard_episode
from r3dfsseg_tpu_torch import eval_noise, mpti_train_noise, pretrain
from r3dfsseg_tpu_torch.cli import args_to_config, build_parser
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
from r3dfsseg_tpu_torch.learners import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import seeded_dropout
from r3dfsseg_tpu_torch.ops import cuda_attention
from r3dfsseg_tpu_torch.parallel import Mesh, Shard, launch, make_mesh, shard_episode
from r3dfsseg_tpu_torch.parallel.launch import check_devices
from r3dfsseg_tpu_torch.parallel.mesh import rank_device, resolve_episode_batch
from r3dfsseg_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_helpers import cli_chain, fail_on_rank_one, run_cases

DEADLINE_S = 240          # a launch's ranks are killed past this
E = 4                     # episodes in the global batch
KINDS = ("mpti", "proto", "transformer")
CPU = torch.device("cpu")


def _cfg(kind, **kw):
    cfg = tiny_config(**{**dict(pc_npts=32, dgcnn_k=4, lp_cg_iters=10, episode_batch=E,
                                attn_dropout=0.1), **kw})
    if kind == "transformer":
        cfg = cfg.replace(phase="transformertrain", d_model=8, n_head=2, n_layers=1, d_feed=8)
    return cfg


def _batch(cfg, rng):
    """E training episodes (gt masks, support flags) stacked, numpy."""
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    q = cfg.n_queries * w
    eps = []
    for _ in range(E):
        sy = (rng.uniform(size=(w, k, n)) < 0.3).astype(np.int32)
        sy[..., 0] = 1
        gt_sy = sy.copy()
        gt_sy[1, -1] = 0
        qy = rng.integers(0, w + 1, size=(q, n)).astype(np.int32)
        flag = np.tile(np.array([[3], [7]], np.int32), (1, k))
        flag[1, -1] = 3
        eps.append(Episode(rng.normal(size=(w, k, n, c)).astype(np.float32), sy,
                           rng.normal(size=(q, n, c)).astype(np.float32), qy,
                           gt_sy, qy.copy(), flag))
    return tuple(Episode(*(np.stack(f) for f in zip(*[e[:7] for e in eps]))))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for this process's torch work too: the ranks and the
    other test workers share the cores, and the tiny steps gain nothing
    from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def rendezvous_in(path):
    """The launches in this block meet in a directory under ``path`` (the
    test's own tmp_path, as the system's temporary directory)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tempfile, "tempdir", str(path))
        yield


def _launch(cases, n):
    return launch(run_cases, n, cases, device="cpu", timeout_s=DEADLINE_S)


# ------------------------------------------------------- the JAX side ----
def _jax_episode(cfg, rng):
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    sy = np.zeros((w, k, n), np.int32)
    sy[..., : n // 4] = 1
    return JaxEpisode(
        support_x=rng.normal(size=(w, k, n, c)).astype(np.float32), support_y=sy,
        query_x=rng.normal(size=(cfg.n_queries * w, n, c)).astype(np.float32),
        query_y=rng.integers(0, w + 1, size=(cfg.n_queries * w, n)).astype(np.int32),
        gt_support_y=sy.copy(), gt_query_y=np.zeros((cfg.n_queries * w, n), np.int32),
        support_flag=np.ones((w, k), np.int32))


@pytest.fixture(scope="module")
def jax_learner():
    """tests/test_parallel.py:31's learner and batch, its state built from
    the port's seeded weights (`utils/convert.py`; Flax's eager init takes
    a minute on a loaded CPU), and those weights."""
    cfg = jax_tiny_config(episode_batch=E, lp_cg_iters=10, pc_npts=32, dgcnn_k=4,
                          attn_dropout=0.0)
    rng = np.random.default_rng(0)
    eps = [_jax_episode(cfg, rng) for _ in range(E)]
    weights = jax_tree_from_state_dict(MPTILearner(_cfg("mpti", attn_dropout=0.0), "cpu").model)
    learner = JaxLearner(cfg, rng=jax.random.PRNGKey(0))
    learner.state = TrainState(jnp.zeros((), jnp.int32), *weights,
                               learner.tx.init(weights[0]))
    return learner, stack_episodes(eps), weights


def jax_sharded_step(learner, batch):
    """The step itself over make_mesh(4): its metrics and the parameters
    after it, keyed as the port's."""
    mesh = jax_make_mesh(E)
    learner.state = jax_replicate(learner.state, mesh)
    with mesh:
        metrics = learner.train(jax_shard_episode(batch, mesh))
    after = state_dict_from_jax(jax.tree.map(np.asarray, learner.state.params),
                                jax.tree.map(np.asarray, learner.state.batch_stats))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "after": after}


# ------------------------------------------------------------ the runs ---
@pytest.fixture(scope="module")
def cases(jax_learner):
    rng = np.random.default_rng(7)
    out = {kind: {"run": "learner", "kind": kind, "cfg": _cfg(kind),
                  "batch": _batch(_cfg(kind), rng)} for kind in KINDS}
    out["jax"] = {"run": "learner", "kind": "mpti", "cfg": _cfg("mpti", attn_dropout=0.0),
                  "batch": tuple(jax_learner[1]), "weights": jax_learner[2]}
    pcfg = tiny_config(pc_npts=32, dgcnn_k=4)
    out["pretrain"] = {"run": "pretrain", "cfg": pcfg, "classes": 4,
                       "x": rng.normal(size=(8, 32, pcfg.pc_in_dim)).astype(np.float32),
                       "y": rng.integers(0, 4, size=(8, 32)).astype(np.int64)}
    for fast in (False, True):
        out[f"bn_{'fast' if fast else 'exact'}"] = {
            "run": "bn", "fast": fast,
            "x": (rng.normal(size=(4, 16, 6)) * 3 + 1).astype(np.float32),
            "dy": rng.normal(size=(4, 16, 6)).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.normal(size=6).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def runs(cases, jax_learner, tmp_path_factory):
    """{1: unsharded in-process, 2: over 2 ranks, 4: over 4 ranks, "jax":
    the JAX package's sharded step}; the two launches' ranks run while
    this process computes the JAX step and the unsharded one."""
    tmp = tmp_path_factory.mktemp("mesh")
    four = {k: v for k, v in cases.items() if v["run"] == "learner"}
    with rendezvous_in(tmp), ThreadPoolExecutor(2) as pool:
        two, four = pool.submit(_launch, cases, 2), pool.submit(_launch, four, 4)
        jax_side = jax_sharded_step(*jax_learner[:2])
        return {1: run_cases(cases), 2: two.result(), 4: four.result(), "jax": jax_side}


# ---------------------------------------------------------------- (a) ----
def test_mesh_shard_rows_and_offsets():
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, device="cpu")
    batch = Episode(*_batch(_cfg("mpti"), np.random.default_rng(1)))
    for w in (1, 2, 4):
        rows = [shard_episode(batch, Mesh(None, r, w, CPU)) for r in range(w)]
        assert [off for _, off in rows] == [r * E // w for r in range(w)]
        for f, field in enumerate(batch):
            if field is None:
                assert all(ep[f] is None for ep, _ in rows)
            else:
                np.testing.assert_array_equal(np.concatenate([ep[f] for ep, _ in rows]), field)
    with pytest.raises(ValueError, match="do not split"):
        shard_episode(batch, Mesh(None, 0, 3, CPU))


def test_resolve_episode_batch():
    cfg = tiny_config(episode_batch=0)
    said = []
    assert resolve_episode_batch(cfg, said.append, device="cpu").episode_batch == 1
    assert resolve_episode_batch(cfg.replace(mesh_shape=(4,)), said.append).episode_batch == 4
    assert said == ["auto episode_batch=4 (one episode per device; pass --episode_batch "
                    "to override)"]
    assert resolve_episode_batch(cfg.replace(episode_batch=3, mesh_shape=(4,))) \
        .episode_batch == 3


def test_ragged_batch_runs_whole():
    """A mesh that does not divide the episode batch is refused (every rank
    runs whole batches, the JAX CLIs' choice); a batch the mesh does not
    divide passes whole (the JAX package's `_maybe_shard`), as does an
    unbatched episode; a dividing one splits."""
    learner = MPTILearner(_cfg("mpti"), "cpu")
    batch = Episode(*_batch(_cfg("mpti"), np.random.default_rng(2)))
    assert not learner.attach_mesh(Mesh(None, 1, 3, CPU))     # 3 does not divide E = 4
    assert learner.mesh is None
    learner.mesh = Mesh(None, 1, 3, CPU)    # a mesh taken for another batch size
    ep, offset = learner.shard(batch)
    assert offset is None and ep is batch
    one = Episode(*(None if a is None else a[0] for a in batch))
    assert learner.shard(one) == (one, None)
    assert learner.attach_mesh(Mesh(None, 1, 2, CPU))
    ep, offset = learner.shard(batch)
    assert offset == 2 and ep.support_x.shape[0] == 2


def test_launcher_stops_the_ranks_of_a_failing_one(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*failed on purpose"):
        with rendezvous_in(tmp_path):
            launch(fail_on_rank_one, 2, device="cpu", timeout_s=DEADLINE_S)
    assert not os.listdir(tmp_path)            # the rendezvous directory is gone


@pytest.mark.parametrize("cli", [mpti_train_noise, eval_noise, pretrain],
                         ids=["train", "eval", "pretrain"])
def test_mesh_needs_a_gpu_per_rank(monkeypatch, tmp_path, cli):
    """--mesh N on CUDA raises in each CLI, naming both counts, where fewer
    than N GPUs are visible; it never shrinks the mesh or moves to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--mesh 2 needs 2 CUDA devices, one per rank; "
                                           "1 visible"):
        cli.main(["--clean_data_path", str(tmp_path), "--mesh", "2", "--save_path",
                  str(tmp_path), "--model_checkpoint_path", str(tmp_path)])


def test_torchrun_over_hosts_counts_this_hosts_gpus(monkeypatch):
    """Under torchrun across hosts (2 hosts x 4 GPUs: WORLD_SIZE 8,
    LOCAL_WORLD_SIZE 4) each host needs a GPU per local rank, not per
    rank of the world; a host with fewer still raises, naming both
    counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    check_devices(8, "cuda", 4)
    assert rank_device("cuda", 8) == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="--mesh 8: the 4 ranks on this host need"):
        check_devices(8, "cuda", 4)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices here, one per rank; 2 visible"):
        rank_device("cuda", 8)


# ---------------------------------------------------------------- (b) ----
@pytest.mark.parametrize("b0,bl", [(0, 3), (2, 3), (5, 1)])
def test_dropout_words_at_an_offset_are_the_whole_batch_rows(b0, bl):
    whole = cuda_attention.dropout_words_reference(8, 13, 1234567, "cpu")
    rows = cuda_attention.dropout_words_reference(bl, 13, 1234567, "cpu", b0)
    assert torch.equal(rows, whole[b0:b0 + bl])
    mask = cuda_attention.dropout_mask_reference(bl, 13, 0.1, 99, "cpu", b0)
    assert torch.equal(mask, cuda_attention.dropout_mask_reference(8, 13, 0.1, 99, "cpu")
                       [b0:b0 + bl])
    q, k, v = (torch.randn(8, 13, 4, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    want = cuda_attention.attention_reference(q, k, v, 2.0, 0.1, 99)[b0:b0 + bl]
    got = cuda_attention.attention_reference(q[b0:b0 + bl], k[b0:b0 + bl], v[b0:b0 + bl],
                                             2.0, 0.1, 99, b0=b0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [2, 4])
def test_seeded_dropout_shards_draw_the_whole_mask(w):
    x = torch.randn(8, 5, 3)
    whole = seeded_dropout(x, 0.3, torch.Generator().manual_seed(5))
    per = 8 // w
    got = torch.cat([seeded_dropout(x[r * per:(r + 1) * per], 0.3,
                                    torch.Generator().manual_seed(5), shard=Shard(r * per, 8))
                     for r in range(w)])
    assert torch.equal(got, whole)
    # a broadcast mask (the transformer's attention weights) needs no shard
    bcast = seeded_dropout(x, 0.3, torch.Generator().manual_seed(5), shape=(1, 5, 3))
    assert torch.equal(seeded_dropout(x[:2], 0.3, torch.Generator().manual_seed(5),
                                      shape=(1, 5, 3), shard=Shard(0, 8)), bcast[:2])


# ---------------------------------------------------------------- (c) ----
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_synced_batchnorm_is_whole_batch_batchnorm(runs, mode):
    one, two = runs[1][f"bn_{mode}"], runs[2][f"bn_{mode}"]
    for key in ("y", "dx", "running_mean", "running_var"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-6, atol=1e-7, err_msg=key)


# ---------------------------------------------------------------- (d) ----
def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_same_grads(got: dict, want: dict, tol: float = 1e-5):
    """Each gradient within ``tol`` relative L2 of ``want``'s, None where
    it is None.  Two kinds of parameter have an exact gradient of 0: a
    conv bias that feeds a train-mode BatchNorm (`*.conv.bias`), and the
    transformer's attention key bias (it shifts every score of a query row
    alike, which the softmax removes).  Both sides hold rounding noise
    there, held below 1e-5 of the largest gradient entry instead."""
    top = max(float(np.abs(g).max()) for g in want.values() if g is not None)
    for name, g in want.items():
        assert (got[name] is None) == (g is None), name
        if g is None:
            continue
        if name.endswith((".conv.bias", "self_attn.key.bias")):
            noise = max(float(np.abs(g).max()), float(np.abs(got[name]).max()))
            assert noise <= 1e-5 * top, (name, noise, top)
        else:
            assert _rel_l2(got[name], g) <= tol, (name, _rel_l2(got[name], g))


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_is_the_unsharded_step(runs, kind, w):
    one, got = runs[1][kind], runs[w][kind]
    assert set(got["metrics"]) == set(one["metrics"])
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    assert_same_grads(got["grads"], one["grads"])
    for name, b in one["buffers"].items():
        np.testing.assert_allclose(got["buffers"][name], b, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------- (e) ----
def test_four_ranks_match_the_jax_sharded_step(runs):
    got, jax_step = runs[4]["jax"], runs["jax"]
    for key in ("loss", "lp_loss"):
        np.testing.assert_allclose(got["metrics"][key], jax_step["metrics"][key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    names = sorted(got["params"])
    p1 = np.concatenate([got["params"][k].ravel() for k in names])
    p2 = np.concatenate([jax_step["after"][k].numpy().ravel() for k in names])
    agree = np.isclose(p1, p2, rtol=2e-3, atol=2e-4).mean()
    assert agree > 0.98, agree


# ---------------------------------------------------------------- (f) ----
@pytest.mark.parametrize("kind", KINDS)
def test_loss_is_mesh_size_independent(runs, kind):
    base = runs[1][kind]["metrics"]["loss"]
    for w in (2, 4):
        np.testing.assert_allclose(runs[w][kind]["metrics"]["loss"], base, rtol=1e-4,
                                   atol=1e-5, err_msg=f"mesh size {w}")


# ---------------------------------------------------------------- (g) ----
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_test_gathers_the_predictions(runs, kind, w):
    one, got = runs[1][kind]["pred"], runs[w][kind]["pred"]
    assert got.shape == one.shape == (E, 2, 32)
    assert (got == one).mean() >= 0.999


# ---------------------------------------------------------------- (i) ----
def test_sharded_pretraining_step(runs):
    one, two = runs[1]["pretrain"], runs[2]["pretrain"]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["acc"], one["acc"], rtol=1e-6)
    assert_same_grads(two["grads"], one["grads"])
    for name, b in one["buffers"].items():
        np.testing.assert_allclose(two["buffers"][name], b, rtol=1e-5, atol=1e-7, err_msg=name)


# ------------------------------------------------------------ the CLIs ---
CLI_FLAGS = ["--dataset", "s3dis", "--cvfold", "0", "--pc_npts", "32", "--dgcnn_k", "4",
             "--edgeconv_widths", "[[8,8],[8,8],[8,8]]", "--dgcnn_mlp_widths", "[16,16]",
             "--base_widths", "[8,8]", "--output_dim", "8", "--use_attention",
             "--n_subprototypes", "8", "--k_connect", "8", "--lp_cg_iters", "10",
             "--k_shot", "2", "--n_episode_test", "1", "--n_workers", "2",
             "--episode_batch", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("dp_cli") / "blocks"),
                                  n_scans=40, pts_per_scan=512, seed=7)


def _cli_cfg(argv, eval_mode=False):
    return args_to_config(build_parser(eval_mode).parse_args(argv), eval_mode)


@pytest.fixture(scope="module")
def cli_runs(ds, tmp_path_factory):
    """The CLIs' runs at `--mesh 1` here and at `--mesh 2` in the two ranks
    of one launch (`cli_chain`): training (2 steps of 4 episodes and a
    validation), the evaluation of the `--mesh 1` run's checkpoint, and
    pretraining at batch 8 (10 steps).  This process trains and evaluates
    first, which writes the episode caches the ranks then read, and
    pretrains while the ranks run.  TensorBoard is blocked (it imports
    TensorFlow here: seconds), in the ranks too (`cli_chain`)."""
    tmp = tmp_path_factory.mktemp("dp_runs")

    def cfgs(mesh):
        common = CLI_FLAGS + ["--clean_data_path", ds, "--save_path", str(tmp),
                              "--mesh", str(mesh)]
        train = _cli_cfg(common + ["--log_dir", f"dp{mesh}", "--n_iters", "8",
                                   "--eval_interval", "8"])
        pre = _cli_cfg(common + ["--log_dir", f"pre{mesh}", "--n_iters", "10"])
        return train, pre.replace(phase="pretrain")

    train1, pre1 = cfgs(1)
    train2, pre2 = cfgs(2)
    evals = {mesh: _cli_cfg(CLI_FLAGS[:-4] + [
        "--episode_batch", "2", "--device", "cpu", "--clean_data_path", ds, "--noise_ratio",
        "0.5", "--noise_type", "sym", "--mesh", str(mesh), "--model_checkpoint_path",
        train1.log_dir], True) for mesh in (1, 2)}
    saved = sys.modules.get("torch.utils.tensorboard", "absent")
    sys.modules["torch.utils.tensorboard"] = None
    try:
        out = {1: {"train": mpti_train_noise.train(train1, device="cpu"),
                   "miou": eval_noise.evaluate(evals[1], device="cpu")}}
        with rendezvous_in(tmp), ThreadPoolExecutor(1) as pool:
            two = pool.submit(launch, cli_chain, 2, train2, evals[2], pre2, device="cpu",
                              timeout_s=DEADLINE_S)
            out[1]["pretrain"] = pretrain.pretrain(pre1, batch_size=8, device="cpu")
            out[2] = dict(zip(("train", "miou", "pretrain"), two.result()))
    finally:
        if saved == "absent":
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    return out, {1: train1, 2: train2}


def test_cli_train_and_eval_over_two_ranks(cli_runs):
    """tests/test_parallel.py:70's run: the training CLI sharded over two
    ranks reproduces one rank's losses; one log; the evaluation CLI's mean
    IoU over two ranks is one rank's on the same checkpoint."""
    out, cfgs = cli_runs
    logs = {mesh: open(os.path.join(cfgs[mesh].log_dir, "log_mptitrain.txt")).read()
            for mesh in (1, 2)}
    # one log of the sharded run (the evaluations log beside the --mesh 1 run's
    # checkpoint)
    assert [f for f in os.listdir(cfgs[2].log_dir) if f.startswith("log_")] == \
        ["log_mptitrain.txt"]
    assert "episode-DP: 4-episode batches sharded over 2 devices" in logs[2]
    assert "episode-DP" not in logs[1]
    assert logs[2].count("------------ Options -------------") == 1
    assert logs[2].count("==[Train] Iter") == 2
    stats = {mesh: out[mesh]["train"] for mesh in (1, 2)}
    assert stats[2]["episodes_sha256"] == stats[1]["episodes_sha256"]
    assert len(stats[2]["losses"]) == len(stats[1]["losses"]) == 2
    np.testing.assert_allclose(stats[2]["losses"][0], stats[1]["losses"][0], rtol=1e-4)
    np.testing.assert_allclose(stats[2]["losses"], stats[1]["losses"], rtol=2e-2)
    log = open(os.path.join(cfgs[1].log_dir, "log_mptinoise_eval.txt")).read()
    assert "episode-DP eval over 2 devices" in log
    np.testing.assert_allclose(out[2]["miou"], out[1]["miou"], atol=5e-3)


def test_cli_pretrain_over_two_ranks(cli_runs):
    """tests/test_parallel.py:365's run: pretraining at batch 8 over two
    ranks reproduces one rank's losses, and writes one log and one
    checkpoint."""
    out, _ = cli_runs
    losses, logs = {}, {}
    for mesh in (1, 2):
        assert os.path.exists(out[mesh]["pretrain"])
        log_dir = os.path.dirname(out[mesh]["pretrain"])
        logs[mesh] = open(os.path.join(log_dir, "log_pretrain.txt")).read()
        losses[mesh] = [json.loads(line)["value"] for line in
                        open(os.path.join(log_dir, "scalars.jsonl"))
                        if json.loads(line)["tag"] == "Pretrain/loss"]
    assert "pretrain DP: 8-scene batches sharded over 2 devices" in logs[2]
    assert "pretrain DP" not in logs[1]
    assert logs[2].count("------------ Options -------------") == 1
    assert len(losses[2]) == len(losses[1]) == 1
    np.testing.assert_allclose(losses[2], losses[1], rtol=2e-3)
    assert re.search(r"\[Pretrain\] Iter 10 \| loss [0-9.]+", logs[2])
