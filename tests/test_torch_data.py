"""The port's data pipeline (`r3dfsseg_tpu_torch/data/`, `native/`,
`utils/metrics.py`) against the JAX package's on the same synthetic
dataset and seeds: catalogs, samplers in every noise type with and without
augmentation, the native and the numpy assembly, the CLI's ordered
multi-worker stream, the static test sets (the port's .npz cache and the
JAX package's .h5 one) and IoU.  Episodes must be bit-equal."""
import os
import shutil
import sys
import warnings

import numpy as np
import pytest

from r3dfsseg_tpu import native as jax_native
from r3dfsseg_tpu.data import cache as jax_cache
from r3dfsseg_tpu.data import catalogs as jax_catalogs
from r3dfsseg_tpu.data import episodes as jax_episodes
from r3dfsseg_tpu.data import loader as jax_loader
from r3dfsseg_tpu.data import synthetic as jax_synthetic
from r3dfsseg_tpu.models import episode as jax_episode
from r3dfsseg_tpu.utils import metrics as jax_metrics
from r3dfsseg_tpu_torch import native
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.data import cache, catalogs, episodes, loader, sampler, synthetic
from r3dfsseg_tpu_torch.models.episode import stack_episodes
from r3dfsseg_tpu_torch.utils import metrics

N_SCANS, PTS = 40, 512
AUGM = {"scale": 1.3, "rot": 1, "mirror_prob": 0.4, "jitter": 1}


def _dataset(root: str) -> str:
    return jax_synthetic.make_synthetic_dataset(os.path.join(root, "blocks"), n_scans=N_SCANS,
                                                pts_per_scan=PTS, seed=7)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("torch_data")))


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Both packages on the native assembly, or both on the numpy one."""
    if request.param == "numpy":
        monkeypatch.setenv("R3D_DISABLE_NATIVE", "1")
        monkeypatch.setattr(jax_native, "assemble_scan", None)
    else:
        monkeypatch.delenv("R3D_DISABLE_NATIVE", raising=False)
        assert native.assemble_scan() is not None and jax_native.assemble_scan is not None
    return request.param


def assert_episodes_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "Episode"
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_synthetic_dataset_equals_jax(tmp_path):
    a = synthetic.make_synthetic_dataset(str(tmp_path / "a" / "blocks"), n_scans=6,
                                         pts_per_scan=256, seed=3)
    b = jax_synthetic.make_synthetic_dataset(str(tmp_path / "b" / "blocks"), n_scans=6,
                                             pts_per_scan=256, seed=3)
    names = sorted(os.listdir(os.path.join(a, "data")))
    assert names == sorted(os.listdir(os.path.join(b, "data"))) and len(names) == 6
    for n in names:
        np.testing.assert_array_equal(np.load(os.path.join(a, "data", n)),
                                      np.load(os.path.join(b, "data", n)))
    meta = "meta/s3dis_classnames.txt"
    assert (tmp_path / "a" / meta).read_text() == (tmp_path / "b" / meta).read_text()


@pytest.mark.parametrize("dataset,cvfold", [("s3dis", 0), ("s3dis", 1), ("scannet", 0),
                                            ("scannet", 1)])
def test_catalogs_equal_jax(tmp_path, dataset, cvfold):
    """Each package computes class2scans on a dataset of its own (the
    cache file is shared otherwise)."""
    got = catalogs.get_catalog(dataset, cvfold, _dataset(str(tmp_path / "port")))
    want = jax_catalogs.get_catalog(dataset, cvfold, _dataset(str(tmp_path / "jax")))
    assert got.test_classes == want.test_classes
    assert got.train_classes == want.train_classes
    assert got.class2type == want.class2type
    assert got.class2scans == want.class2scans
    with pytest.raises(NotImplementedError):
        catalogs.get_catalog("kitti", 0, str(tmp_path))


def _pair(classes):
    classes = [int(c) for c in classes]
    return {c: classes[(i + 1) % len(classes)] for i, c in enumerate(classes)}


SAMPLERS = ["clean_train", "clean_test", "noisy_train", "sym", "ood", "partial", "pair"]


def _sampler_pair(ds, kind: str, seed: int, augm: bool):
    kw = dict(cvfold=0, n_way=2, k_shot=3, n_queries=1, num_point=128, pc_augm=augm,
              pc_augm_config=AUGM if augm else None, seed=seed)
    if kind.startswith("clean"):
        mode = kind.split("_")[1]
        return (episodes.EpisodeSampler(ds, "s3dis", mode=mode, **kw),
                jax_episodes.EpisodeSampler(ds, "s3dis", mode=mode, **kw))
    if kind == "noisy_train":
        kw.update(mode="train", noise_ratio=[0.0, 0.4], noise_type="train")
    else:
        pair = _pair(jax_catalogs.get_catalog("s3dis", 0, ds).test_classes)
        kw.update(mode="test", noise_ratio=0.4, noise_type=kind,
                  noise_pair=pair if kind == "pair" else None)
    return (episodes.NoisyEpisodeSampler(ds, "s3dis", **kw),
            jax_episodes.NoisyEpisodeSampler(ds, "s3dis", **kw))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("augm", [False, True])
@pytest.mark.parametrize("kind", SAMPLERS)
def test_sampler_episodes_equal_jax(ds, path, kind, augm, seed):
    port, jax_s = _sampler_pair(ds, kind, seed, augm)
    for _ in range(2):
        assert_episodes_equal(port.sample(), jax_s.sample())
    classes = port.classes[:2]
    assert_episodes_equal(port.sample(classes), jax_s.sample(classes))


@pytest.mark.parametrize("augm", [False, True])
def test_native_and_numpy_paths_agree(ds, monkeypatch, augm):
    """The C pass and the numpy path draw the same stream: labels equal,
    points within the JAX package's tolerance (the augmentation product's
    order of sums differs)."""
    got = episodes.NoisyEpisodeSampler(ds, "s3dis", mode="test", noise_ratio=0.4, noise_type="ood",
                                       num_point=128, pc_augm=augm, pc_augm_config=AUGM,
                                       seed=4).sample()
    monkeypatch.setenv("R3D_DISABLE_NATIVE", "1")
    want = episodes.NoisyEpisodeSampler(ds, "s3dis", mode="test", noise_ratio=0.4,
                                        noise_type="ood", num_point=128, pc_augm=augm,
                                        pc_augm_config=AUGM, seed=4).sample()
    for name, g, w in zip(want._fields, got, want):
        if name.endswith("_x"):
            np.testing.assert_allclose(g, w, atol=2e-6, rtol=0, err_msg=name)
            if not augm:
                np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("support", [True, False])
def test_sample_scan_label_noise_and_errors(ds, support):
    name = sorted(os.listdir(os.path.join(ds, "data")))[0][:-4]
    data = sampler.load_scan(ds, name)
    cls = int(data[0, 6])
    kw = dict(sampled_classes=[cls, (cls + 1) % 13], sampled_class=cls, support=support,
              partial_noise=support)
    got = sampler.sample_scan(ds, name, 96, "xyzrgb", rng=np.random.default_rng(3), **kw)
    from r3dfsseg_tpu.data.sampler import sample_scan as jax_sample_scan
    want = jax_sample_scan(ds, name, 96, "xyzrgb", rng=np.random.default_rng(3), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="noise_in_fold"):
        sampler.sample_scan(ds, name, 96, "xyz", use_label_noise=True, **kw)


def test_augmented_episode_and_background_equal_jax(ds, path):
    kw = dict(mode="test", noise_ratio=0.4, noise_type="sym", num_point=128, k_shot=3, seed=9)
    port = episodes.NoisyEpisodeSampler(ds, "s3dis", **kw)
    jax_s = jax_episodes.NoisyEpisodeSampler(ds, "s3dis", **kw)
    (ep, aux), (jep, jaux) = port.sample_augmented(), jax_s.sample_augmented()
    assert_episodes_equal(ep, jep)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_array_equal(aux[k], jaux[k])
    classes = [int(c) for c in port.classes[:2]]
    for g, w in zip(port.sample_bg_pcds(classes, []), jax_s.sample_bg_pcds(classes, [])):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(2)
    pcd = rng.normal(size=(3, 50, 4))
    lab = (rng.uniform(size=(3, 50)) < 0.5).astype(np.int32)
    clu = rng.integers(0, 4, size=(3, 50))
    for g, w in zip(episodes.cut_out(pcd, lab, clu), jax_episodes.cut_out(pcd, lab, clu)):
        np.testing.assert_array_equal(g, w)


def _jax_cli_stream(cfg: R3DConfig, n_batches: int):
    """The JAX CLI's training stream (root mpti_train_noise.py:33-119): the
    learner's init draw from worker 0's sampler, then the ordered loader
    over workers seeded seed and seed + 1000 + w."""
    kw = dict(cvfold=cfg.cvfold, n_way=cfg.n_way, k_shot=cfg.k_shot, n_queries=cfg.n_queries,
              mode="train", num_point=cfg.pc_npts, pc_attribs=cfg.pc_attribs,
              pc_augm=cfg.pc_augm,
              pc_augm_config={"scale": cfg.pc_augm_scale, "rot": cfg.pc_augm_rot,
                              "mirror_prob": cfg.pc_augm_mirror_prob,
                              "jitter": cfg.pc_augm_jitter},
              noise_ratio=list(cfg.train_noise_ratio), noise_type="train")
    first = jax_episodes.NoisyEpisodeSampler(cfg.clean_data_path, cfg.dataset, seed=cfg.seed,
                                             **kw)
    first.sample()
    workers = [first] + [jax_episodes.NoisyEpisodeSampler(
        cfg.clean_data_path, cfg.dataset, seed=cfg.seed + 1000 + w, **kw)
        for w in range(max(1, min(cfg.n_workers, 8)) - 1)]
    return list(jax_loader.EpisodeLoader(
        workers[0].sample, num_batches=n_batches, episode_batch=cfg.episode_batch,
        prefetch=4, worker_fns=[s.sample for s in workers]))


@pytest.mark.parametrize("n_workers,episode_batch,augm", [(1, 1, False), (3, 1, True),
                                                         (4, 2, False)])
def test_cli_stream_equals_jax(ds, n_workers, episode_batch, augm):
    """The port's CLI samplers through the port's loader give the JAX
    CLI's stream; a loader started at batch 3 gives its tail."""
    from r3dfsseg_tpu_torch.mpti_train_noise import train_samplers
    cfg = R3DConfig(clean_data_path=ds, n_way=2, k_shot=2, pc_npts=96, n_workers=n_workers,
                    episode_batch=episode_batch, pc_augm=augm, pc_augm_scale=1.2,
                    train_noise_ratio=(0.0, 0.5), seed=11)
    want = _jax_cli_stream(cfg, 6)

    def stream(start=0):
        s = train_samplers(cfg)
        return list(loader.EpisodeLoader(s[0].sample, num_batches=6, episode_batch=episode_batch,
                                         prefetch=2, worker_fns=[x.sample for x in s],
                                         start=start))
    got = stream()
    assert len(got) == 6
    for g, w in zip(got, want):
        assert_episodes_equal(g, w)
    tail = stream(start=3)
    assert len(tail) == 3
    for g, w in zip(tail, want[3:]):
        assert_episodes_equal(g, w)


def test_loader_raises_worker_errors_and_keeps_order():
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("too few scans")
        return jax_episode.Episode(*(np.zeros(1),) * 4)

    with pytest.raises(ValueError, match="too few scans"):
        list(loader.EpisodeLoader(bad, num_batches=5))
    calls["n"] = 0
    with pytest.raises(ValueError, match="too few scans"):    # in a dropped draw
        list(loader.EpisodeLoader(bad, num_batches=5, start=4))
    # worker w yields w, w + 10, ...: batch i comes from worker i % 3, in order
    fns = [iter(range(w, 100, 10)).__next__ for w in range(3)]
    assert list(loader.EpisodeLoader(None, num_batches=7, worker_fns=fns, prefetch=1)) == \
        [0, 1, 2, 10, 11, 12, 20]
    assert list(loader.prefetch_iter(iter(range(7)), prefetch=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("missing episode")
    with pytest.raises(KeyError, match="missing episode"):
        list(loader.prefetch_iter(broken()))


def test_stack_episodes_and_to_device():
    import torch
    rng = np.random.default_rng(0)
    eps = [jax_episode.Episode(rng.normal(size=(2, 3)), rng.integers(0, 2, size=(2,)),
                               rng.normal(size=(1, 3)), rng.integers(0, 3, size=(1,)),
                               gt_support_y=rng.integers(0, 2, size=(2,)) if i else None)
           for i in range(3)]
    got, want = stack_episodes(eps), jax_episode.stack_episodes(eps)
    assert got.gt_support_y is None and want.gt_support_y is None
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g, w)
    on = loader.to_device(got, "cpu")
    assert isinstance(on.support_x, torch.Tensor) and on.gt_support_y is None
    np.testing.assert_array_equal(on.support_x.numpy(), got.support_x)
    moved = list(loader.device_prefetch(iter([got, got, got]), "cpu", n=2))
    assert len(moved) == 3 and all(m.query_x.device.type == "cpu" for m in moved)


STATIC = [dict(mode="valid"), dict(mode="test", noise_ratio=0.4, noise_type="ood"),
          dict(mode="test", noise_ratio=0.4, noise_type="sym")]


@pytest.mark.parametrize("kw", STATIC, ids=["valid", "ood", "sym"])
def test_static_sets_equal_jax(tmp_path, kw):
    """The port's .npz set equals the JAX package's .h5 set (each written on
    a dataset of its own); the port reads its set back without writing,
    and reads the JAX package's .h5 set in place of writing its own."""
    common = dict(cvfold=0, num_episode_per_comb=1, n_way=2, k_shot=2, n_queries=1,
                  num_point=64, seed=5, **kw)
    port_ds, jax_ds = _dataset(str(tmp_path / "port")), _dataset(str(tmp_path / "jax"))
    got = cache.StaticTestDataset(port_ds, "s3dis", **common)
    want = jax_cache.StaticTestDataset(jax_ds, "s3dis", **common)
    assert len(got) == len(want) == 15
    assert os.path.basename(got.root) == os.path.basename(want.root)
    assert all(f.endswith(".npz") for f in got.file_names)
    for i in range(len(want)):
        assert_episodes_equal(got[i], want[i])

    stamps = {f: os.stat(f).st_mtime_ns for f in got.file_names}
    again = cache.StaticTestDataset(port_ds, "s3dis", **common)
    assert {f: os.stat(f).st_mtime_ns for f in again.file_names} == stamps

    from_h5 = cache.StaticTestDataset(jax_ds, "s3dis", **common)
    assert all(f.endswith(".h5") for f in from_h5.file_names)
    assert not any(f.endswith(".npz") for f in os.listdir(from_h5.root))
    for i in range(len(want)):
        assert_episodes_equal(from_h5[i], want[i])


def test_static_set_regenerates_a_cut_set_and_needs_h5py_for_h5(tmp_path, monkeypatch):
    common = dict(cvfold=0, num_episode_per_comb=1, n_way=2, k_shot=2, num_point=64, seed=5)
    ds = _dataset(str(tmp_path))
    full = cache.StaticTestDataset(ds, "s3dis", **common)
    first = full[0]
    for f in full.file_names[5:]:
        os.remove(f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again = cache.StaticTestDataset(ds, "s3dis", **common)
    assert any("regenerating" in str(w.message) for w in caught)
    assert len(again) == 15
    assert_episodes_equal(again[0], first)

    h5_ds = _dataset(str(tmp_path / "h5"))
    jax_cache.StaticTestDataset(h5_ds, "s3dis", **common)
    port = cache.StaticTestDataset(h5_ds, "s3dis", **common)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        port[0]
    shutil.rmtree(port.root)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_equals_jax(seed):
    rng = np.random.default_rng(seed)
    test_classes = [0, 3, 4, 5, 9, 11]
    got, want = metrics.IoUAccumulator(test_classes), jax_metrics.IoUAccumulator(test_classes)
    preds, gts, l2cs = [], [], []
    for _ in range(5):
        l2c = rng.choice(test_classes, 2, replace=False)
        pred = rng.integers(0, 3, size=(2, 64))
        gt = np.where(rng.uniform(size=(2, 64)) < 0.6, pred, rng.integers(0, 3, size=(2, 64)))
        got.update(pred, gt, l2c)
        want.update(pred, gt, l2c)
        preds.append(pred), gts.append(gt), l2cs.append(l2c)
    np.testing.assert_array_equal(got.iou(), want.iou())
    assert got.mean_iou() == want.mean_iou()
    assert metrics.evaluate_metric(preds, gts, l2cs, test_classes) == \
        jax_metrics.evaluate_metric(preds, gts, l2cs, test_classes)
