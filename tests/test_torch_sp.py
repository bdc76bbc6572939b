"""The node-sharded scene graph of the port (`r3dfsseg_tpu_torch/parallel/sp.py`,
`predict_scene(mesh=...)`) on gloo ranks on the CPU, against the JAX
package's sharded graph (`r3dfsseg_tpu/parallel/sp.py`) on the virtual
8-device mesh, on the same inputs.

Two launches, W = 2 and W = 4, each running every case of its rank
(`tests/torch_sp_helpers.py`), while this process computes the JAX side.

- Dense (`sp_label_propagate`), gaussian at `tests/test_parallel.py:125`'s
  graph (sigma 1 and 0) and cosine at `:153`'s, against JAX's over
  `make_mesh(8)`: Z within rtol 1e-5, atol 1e-6, argmax equal on the valid
  rows.
- Blocked (`sp_blocked_label_propagate`), at `:278`'s and `:313`'s cases,
  against JAX's over `make_mesh(2)` and `make_mesh(4)`, the sizes at which
  those tests run them (M_pad is the same at 2 and 4 ranks): rtol 2e-4,
  atol 2e-5 (JAX's own
  tests' gates), argmax equal.  The split store, reached by lowering the
  byte budget, against the stored float32 sharded Z: argmax agreement
  above 0.995 (`tests/test_torch_lp_blocked.py`'s split gate).
- The cosine affinity of `ops/lp.py` against JAX's, as
  `tests/test_torch_lp.py` holds the gaussian one.
- `predict_scene(mesh=...)` at W = 2 on `tests/test_torch_scene.py`'s
  weights and scene, R3D_SCENE_LP auto and blocked, against the JAX
  package's `predict_scene(mesh=make_mesh(2))` and the port's `mesh=None`
  labels at that file's gate: at most 1% of labels differ, each where the
  reference Z's top two entries lie within MARGIN of max |Z|.  At W = 4 a
  scene of three blocks, padded with a zero block.
- Every rank holds the same Z and labels; a mesh of one with no group is
  the sharded result; the max all-reduce."""
import contextlib
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r3dfsseg_tpu.ops.lp as jax_lp
import r3dfsseg_tpu.parallel as jax_parallel
import r3dfsseg_tpu.parallel.sp as jax_sp
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu.parallel import make_mesh as jax_make_mesh
from r3dfsseg_tpu_torch import serve
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.ops.lp import local_constrained_affinity
from r3dfsseg_tpu_torch.parallel import launch
from r3dfsseg_tpu_torch.parallel.sp import sp_blocked_plan
from test_torch_scene import MARGIN, _predictors, weights  # noqa: F401 (a fixture)
from torch_sp_helpers import run_sp_cases

DEADLINE_S = 240          # a launch's ranks are killed past this
MESHES = (2, 4)
DENSE_GATE = dict(rtol=1e-5, atol=1e-6)
BLOCKED_GATE = dict(rtol=2e-4, atol=2e-5)
SPLIT_GATE = 0.995


def _dense_graphs():
    """`tests/test_parallel.py:125` (sigma 1 and 0) and `:153` (cosine)."""
    rng = np.random.default_rng(0)
    m, c, k, n_cls = 70, 24, 5, 3
    feat = rng.normal(size=(m, c)).astype(np.float32)
    valid = np.ones(m, bool)
    valid[9] = valid[33] = False
    y = np.zeros((m, n_cls), np.float32)
    y[np.arange(6), rng.integers(0, n_cls, 6)] = 1.0
    out = {f"dense_sigma{s:g}": dict(feat=feat, y=y, valid=valid,
                                     kw=dict(k=k, sigma=s, iters=30)) for s in (1.0, 0.0)}
    m, c = 64, 16
    feat = rng.normal(size=(m, c)).astype(np.float32)
    y = np.zeros((m, 2), np.float32)
    y[:4, 0] = y[4:8, 1] = 1.0
    out["dense_cosine"] = dict(feat=feat, y=y, valid=np.ones(m, bool),
                               kw=dict(k=4, method="cosine", iters=20))
    return out


def _blocked_graph(rng, m, d, n_invalid, n_labels):
    feat = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.ones(m, bool)
    valid[rng.choice(m, n_invalid, replace=False)] = False
    y = np.zeros((m, 3), np.float32)
    rows = rng.choice(m, n_labels, replace=False)
    y[rows, rng.integers(0, 3, size=n_labels)] = 1.0
    return feat, valid, y


def _blocked_graphs():
    """`tests/test_parallel.py:278` (m = 700, sigma 1 and 0) and `:313` (m =
    420, stored and rematerialised), row tile 64, each with the mesh size
    at which the JAX side runs it, as there (2 and 4: M_pad is 768 and 512
    at both sizes)."""
    rng = np.random.default_rng(0)
    feat, valid, y = _blocked_graph(rng, 700, 24, 37, 40)
    out = {f"blocked_sigma{s:g}": dict(feat=feat, y=y, valid=valid, jax_mesh=2, kw=dict(
        k=20, sigma=s, alpha=0.99, iters=60, row_tile=64)) for s in (1.0, 0.0)}
    feat, valid, y = _blocked_graph(rng, 420, 16, 21, 30)
    for store in (True, False):
        out[f"blocked_store_{store}"] = dict(feat=feat, y=y, valid=valid, jax_mesh=4, kw=dict(
            k=12, sigma=0.0, alpha=0.99, iters=40, row_tile=64, store_graph=store))
    return out


def _split_budget(m: int, w: int, row_tile: int = 64) -> float:
    """A byte budget under which m nodes over w ranks store the split graph:
    between a rank's rows in bf16 and in float32."""
    blk = sp_blocked_plan(m, w, row_tile=row_tile)[0]
    return 3.0 * blk * blk * w


@contextlib.contextmanager
def rendezvous_in(path):
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tempfile, "tempdir", str(path))
        yield


def _prefix_scene(args, n_blocks, n):
    """The scene's first points, enough for n_blocks blocks with a partial last one."""
    sx, sy, xyz, rgb = args
    p = (n_blocks - 1) * n + 5
    return sx, sy, xyz[:p], rgb[:p]


def _cases(w, weights):
    cases = {name: dict(case, run="dense") for name, case in _dense_graphs().items()}
    cases.update({name: dict(case, run="blocked") for name, case in _blocked_graphs().items()})
    split = dict(cases["blocked_store_True"])
    split["kw"] = {k: v for k, v in split["kw"].items() if k != "store_graph"}
    cases["blocked_split"] = dict(split, budget=_split_budget(420, w))
    cases["max"] = dict(run="max")
    params, stats, args = weights
    if w == 2:
        for route in ("auto", "blocked"):
            cases[f"scene_{route}"] = dict(run="scene", route=route, weights=(params, stats),
                                           args=args)
    else:
        cases["scene_padded"] = dict(run="scene", route="auto", weights=(params, stats),
                                     args=_prefix_scene(args, 3, tiny_config().pc_npts))
    return cases


# ------------------------------------------------------- the JAX side ----
def _jax_dense(case):
    return np.asarray(jax_sp.sp_label_propagate(
        jnp.asarray(case["feat"]), jnp.asarray(case["y"]), mesh=jax_make_mesh(8),
        valid=jnp.asarray(case["valid"]), **case["kw"]))


def _jax_blocked(case):
    return np.asarray(jax_sp.sp_blocked_label_propagate(
        jnp.asarray(case["feat"]), jnp.asarray(case["y"]), mesh=jax_make_mesh(case["jax_mesh"]),
        valid=jnp.asarray(case["valid"]), **case["kw"]))


def _jax_scene(jp, args, route):
    """The JAX package's labels over make_mesh(2) and the Z its sharded
    graph returned (a debug callback on the sharded LP)."""
    seen = {}
    with pytest.MonkeyPatch.context() as patch:
        for name in ("sp_label_propagate", "sp_blocked_label_propagate"):
            def wrapped(*a, _fn=getattr(jax_parallel, name), **kw):
                z = _fn(*a, **kw)
                jax.debug.callback(lambda v: seen.update(z=np.asarray(v)), z)
                return z
            patch.setattr(jax_parallel, name, wrapped)
        patch.setenv("R3D_SCENE_LP", route)
        labels = jp.predict_scene(*args, mesh=jax_make_mesh(2))
        jax.effects_barrier()
    return labels, seen["z"]


def _port_scene(port, args, route):
    """The port's mesh=None labels and Z."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("R3D_SCENE_LP", route)
        labels = port.predict_scene(*args)
        blocks, pad_mask, _ = serve.scene_blocks(args[2], args[3], port.cfg.pc_npts)
        node_feat, node_valid, y0, _ = port.scene_nodes(blocks, pad_mask, *args[:2])
        with torch.inference_mode():
            z = serve.scene_label_propagate(node_feat, y0, node_valid, port.cfg)
    return labels, z.numpy()


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):  # noqa: F811
    """{2: W = 2 rank 0's results, 4: W = 4's, 1: a mesh of one in this
    process, "jax": the JAX side, "port": the port's mesh=None scenes}."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("sp")
    cases = {w: _cases(w, weights) for w in MESHES}
    jp, port = _predictors(weights)

    def scenes():
        """Both frameworks' scenes, one after the other: each sets
        R3D_SCENE_LP, and the JAX ones patch the package's functions."""
        jax_side = {f"scene_{route}": _jax_scene(jp, weights[2], route)
                    for route in ("auto", "blocked")}
        port_side = {f"scene_{route}": _port_scene(port, weights[2], route)
                     for route in ("auto", "blocked")}
        port_side["scene_padded"] = _port_scene(
            port, _prefix_scene(weights[2], 3, port.cfg.pc_npts), "auto")
        return jax_side, port_side

    try:
        # the JAX side's programs compile on threads of their own (XLA's
        # compiler releases the GIL), beside the two launches
        with rendezvous_in(tmp), ThreadPoolExecutor(6) as pool:
            launched = {w: pool.submit(launch, run_sp_cases, w, cases[w], device="cpu",
                                       timeout_s=DEADLINE_S) for w in MESHES}
            scene_job = pool.submit(scenes)
            jax_jobs = {name: pool.submit(_jax_dense, case)
                        for name, case in _dense_graphs().items()}
            jax_jobs.update({name: pool.submit(_jax_blocked, case)
                             for name, case in _blocked_graphs().items()})
            one = run_sp_cases({name: dict(case, run="dense")
                                for name, case in _dense_graphs().items()})
            jax_side, port_side = scene_job.result()
            jax_side.update({name: f.result() for name, f in jax_jobs.items()})
            out = {w: f.result() for w, f in launched.items()}
    finally:
        torch.set_num_threads(threads)
    return dict(out, jax=jax_side, port=port_side, one=one)


def _valid_argmax_equal(got, want, valid):
    np.testing.assert_array_equal(got[valid].argmax(-1), want[valid].argmax(-1))


# ------------------------------------------------------------- dense ----
@pytest.mark.parametrize("w", MESHES)
@pytest.mark.parametrize("name", ["dense_sigma1", "dense_sigma0", "dense_cosine"])
def test_dense_matches_jax_sharded(runs, w, name):
    got, want = runs[w][name]["z"], runs["jax"][name]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **DENSE_GATE)
    _valid_argmax_equal(got, want, _dense_graphs()[name]["valid"])
    assert runs[w][name]["same_on_ranks"]


@pytest.mark.parametrize("name", ["dense_sigma1", "dense_sigma0", "dense_cosine"])
def test_mesh_of_one_is_the_sharded_graph(runs, name):
    """With no group every collective is the identity: one rank's body over
    all rows, at the same gates against JAX's 8-device result."""
    got, want = runs["one"][name]["z"], runs["jax"][name]
    np.testing.assert_allclose(got, want, **DENSE_GATE)
    _valid_argmax_equal(got, want, _dense_graphs()[name]["valid"])


@pytest.fixture
def jax_kth_kernel(monkeypatch):
    """JAX's per-row kernel in interpret mode for the affinity's radius, as
    in `tests/test_torch_lp.py` (the port's unsharded radius is kernel 4's)."""
    monkeypatch.setattr(
        jax_lp, "_kth_smallest_per_row",
        lambda d, k, iters=32: kth_smallest_per_row_pallas(d, k, iters=iters, tile_n=8,
                                                           interpret=True))


@pytest.mark.parametrize("masked", [False, True])
def test_cosine_affinity_matches_jax(jax_kth_kernel, masked):
    rng = np.random.default_rng(5 + int(masked))
    x = rng.normal(size=(48, 6)).astype(np.float32)
    valid = np.ones(48, bool)
    if masked:
        valid[[3, 10, 11, 30]] = False
    want = np.asarray(jax_lp.local_constrained_affinity(
        jnp.asarray(x), 8, valid=jnp.asarray(valid), method="cosine"))
    got = local_constrained_affinity(torch.from_numpy(x), 8, valid=torch.from_numpy(valid),
                                     method="cosine").numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.diag(got) == 0).all()
    with pytest.raises(NotImplementedError, match="method"):
        local_constrained_affinity(torch.from_numpy(x), 8, method="laplace")


# ----------------------------------------------------------- blocked ----
@pytest.mark.parametrize("w", MESHES)
@pytest.mark.parametrize("name", ["blocked_sigma1", "blocked_sigma0", "blocked_store_True",
                                  "blocked_store_False"])
def test_blocked_matches_jax_sharded(runs, w, name):
    got, want = runs[w][name]["z"], runs["jax"][name]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BLOCKED_GATE)
    _valid_argmax_equal(got, want, _blocked_graphs()[name]["valid"])
    assert runs[w][name]["mode"] == ("stream" if name.endswith("False") else "stored")
    assert runs[w][name]["same_on_ranks"]


@pytest.mark.parametrize("w", MESHES)
def test_blocked_split_store(runs, w):
    """The split store (bf16 graph, direction as bf16 hi + lo) against the
    stored float32 graph of the same sharding."""
    got, ref = runs[w]["blocked_split"], runs[w]["blocked_store_True"]["z"]
    assert got["mode"] == "split" and got["same_on_ranks"] and np.isfinite(got["z"]).all()
    valid = _blocked_graphs()["blocked_store_True"]["valid"]
    agree = (got["z"][valid].argmax(-1) == ref[valid].argmax(-1)).mean()
    assert agree > SPLIT_GATE, agree


def test_blocked_plan_follows_jax_budget():
    """blk is ceil(m / W) rounded up to the row tile; the stored graph
    takes blk x blk W bytes a rank within 9.2e9, then the split store, then
    the rebuilt one (`r3dfsseg_tpu/parallel/sp.py:221-244`)."""
    assert sp_blocked_plan(65836, 4) == (16896, "stored")
    assert sp_blocked_plan(131372, 4) == (33280, "split")
    assert sp_blocked_plan(131372, 4, compute_dtype=torch.bfloat16) == (33280, "stored")
    assert sp_blocked_plan(131372, 2) == (66048, "stream")
    assert sp_blocked_plan(33068, 1) == (33280, "stored")
    assert sp_blocked_plan(700, 2, row_tile=64) == (384, "stored")
    assert sp_blocked_plan(700, 2, row_tile=64, store_graph=False) == (384, "stream")


@pytest.mark.parametrize("w", MESHES)
def test_max_all_reduce(runs, w):
    assert runs[w]["max"]["max"] == w - 0.5
    assert runs[w]["max"]["every"] == [w - 0.5] * w


# ------------------------------------------------------------- scene ----
def _gate(got, want, z, args, n_protos, n):
    """At most 1% of labels differ, each where z (the reference's Z in
    block order) has its top two within MARGIN of max |Z|."""
    _, _, order = serve.scene_blocks(args[2], args[3], n)
    p = len(args[2])
    zs = np.empty((p, z.shape[1]), np.float32)
    zs[order] = z[n_protos:n_protos + p]
    np.testing.assert_array_equal(zs.argmax(-1), want)       # the Z the labels came from
    top2 = np.sort(zs, axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]) / np.abs(zs).max()
    differ = got != want
    assert differ.mean() <= 0.01, differ.sum()
    assert (gap[differ] < MARGIN).all(), gap[differ]


@pytest.mark.parametrize("route", ["auto", "blocked"])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_predict_scene_over_two_ranks(runs, weights, route, against):  # noqa: F811
    cfg = tiny_config()
    got = runs[2][f"scene_{route}"]
    assert got["same_on_ranks"]
    labels = got["labels"]
    assert labels.shape == (len(weights[2][2]),) and labels.dtype == np.int32
    want, z = runs[against][f"scene_{route}"]
    _gate(labels, want, z, weights[2], cfg.n_subprototypes * cfg.n_classes, cfg.pc_npts)


def test_predict_scene_pads_blocks_over_four_ranks(runs, weights):  # noqa: F811
    cfg = tiny_config()
    args = _prefix_scene(weights[2], 3, cfg.pc_npts)
    got = runs[4]["scene_padded"]
    assert got["same_on_ranks"] and got["labels"].shape == (len(args[2]),)
    want, z = runs["port"]["scene_padded"]
    _gate(got["labels"], want, z, args, cfg.n_subprototypes * cfg.n_classes, cfg.pc_npts)


def test_pad_blocks_and_sharded_paths(monkeypatch):
    """Zero blocks up to a multiple of the mesh (`r3dfsseg_tpu/serve.py:
    172-179`), and the JAX package's sharded routing (`:262-286`): blocked
    past 18,000 nodes or under R3D_SCENE_LP=blocked, else dense, `sparse`
    and `dense` included."""
    from r3dfsseg_tpu_torch.parallel import Mesh

    blocks = np.ones((3, 4, 9), np.float32)
    mask = np.ones(12, bool)
    pb, pm = serve.pad_blocks(blocks, mask, 4)
    assert pb.shape == (4, 4, 9) and (pb[3] == 0).all() and (pb[:3] == 1).all()
    assert pm.shape == (16,) and pm[:12].all() and not pm[12:].any()
    assert serve.pad_blocks(blocks, mask, 3)[0] is blocks
    cfg = tiny_config()
    mesh = Mesh(None, 0, 4, torch.device("cpu"))
    monkeypatch.delenv("R3D_SCENE_LP", raising=False)
    assert serve.scene_lp_path(18000, cfg, mesh) == "sharded-dense"
    assert serve.scene_lp_path(65836, cfg, mesh) == "sharded-blocked-stored"
    assert serve.scene_lp_path(131372, cfg, mesh) == "sharded-blocked-split"
    for impl in ("sparse", "dense"):
        monkeypatch.setenv("R3D_SCENE_LP", impl)
        assert serve.scene_lp_path(300, cfg, mesh) == "sharded-dense"
        assert serve.scene_lp_path(65836, cfg, mesh) == "sharded-blocked-stored"
    monkeypatch.setenv("R3D_SCENE_LP", "blocked")
    assert serve.scene_lp_path(300, cfg, mesh) == "sharded-blocked-stored"
    assert serve.scene_lp_path(300, cfg.replace(graph_dtype="bfloat16"), mesh) == \
        "sharded-blocked-stored"
    assert os.environ["R3D_SCENE_LP"] == "blocked"
