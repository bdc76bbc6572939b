"""Whole-scene serving: the port's `FewShotPredictor.predict_scene` vs the
JAX package's, at `tiny_config(lp_cg_iters=10)` on the same weights (the
JAX model's Flax trees, carried by `state_dict_from_jax`), support set and
scene of 3 * pc_npts + 17 points (so the last block is padded).

The block assembly is bit-equal.  The labels agree on >= 99% of points on
the dense graph, under R3D_SCENE_LP=blocked and sparse, and on the bf16
graph; every point where they differ lies where the JAX package's own Z
has its two largest entries within MARGIN of each other (relative to max
|Z|), i.e. where the two frameworks' f32 roundings may swap the label.
The JAX package's Z is read from its own jitted scene program by a debug
callback on its label propagation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import r3dfsseg_tpu.ops.lp as jax_lp
import r3dfsseg_tpu.ops.lp_blocked as jax_lpb
from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners import MPTILearner as JaxLearner
from r3dfsseg_tpu.learners.base import TrainState
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.serve import FewShotPredictor as JaxPredictor
from r3dfsseg_tpu_torch import serve
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_kth
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from torch_port_helpers import episode_arrays, random_flax_weights

MARGIN = 2e-3          # a differing label's JAX top-two gap, relative to max |Z|
CASES = [("auto", "float32"), ("blocked", "float32"), ("sparse", "float32"),
         ("auto", "bfloat16"), ("blocked", "bfloat16")]


@pytest.fixture(scope="module")
def weights():
    """Seeded Flax trees of the tiny MPTI model, a support set and a scene."""
    jcfg = jax_tiny_config(lp_cg_iters=10)
    model = jax_mpti.MPTINet(jcfg)
    w, k, n, c = jcfg.n_way, jcfg.k_shot, jcfg.pc_npts, jcfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    rng = np.random.default_rng(31)
    params, stats = random_flax_weights(shapes, rng)
    sx, sy = episode_arrays(tiny_config(), rng)[:2]
    p = 3 * n + 17
    xyz = rng.uniform(0, 4, size=(p, 3)).astype(np.float32)
    rgb = rng.uniform(size=(p, 3)).astype(np.float32)
    return params, stats, (sx, sy, xyz, rgb)


def _predictors(weights, graph_dtype="float32"):
    params, stats, _ = weights
    jcfg = jax_tiny_config(lp_cg_iters=10, graph_dtype=graph_dtype)
    learner = JaxLearner(jcfg)
    learner.state = TrainState(jnp.zeros((), jnp.int32), params, stats, learner.tx.init(params))
    port = FewShotPredictor(tiny_config(lp_cg_iters=10, graph_dtype=graph_dtype), device="cpu")
    port._learner.load_params(params, stats)
    return JaxPredictor(jcfg, learner), port


def _jax_scene(jp, args, monkeypatch):
    """The JAX package's labels and the Z its scene program propagated."""
    seen = {}
    for mod, name in ((jax_lp, "label_propagate"), (jax_lpb, "blocked_label_propagate"),
                      (jax_lpb, "sparse_label_propagate")):
        def wrapped(*a, _fn=getattr(mod, name), **kw):
            z = _fn(*a, **kw)
            jax.debug.callback(lambda v: seen.update(z=np.asarray(v)), z)
            return z
        monkeypatch.setattr(mod, name, wrapped)
    labels = jp.predict_scene(*args)
    jax.effects_barrier()
    monkeypatch.undo()
    return labels, seen["z"]


def test_block_assembly_bit_equal(weights, monkeypatch):
    """`scene_blocks` and the inverse permutation equal the JAX package's
    host code: both predictors' scene programs replaced by one that
    returns each node's block position."""
    sx, sy, xyz, rgb = weights[2]
    jp, port = _predictors(weights)
    got = {}

    def jax_program(mesh):
        def fn(variables, blocks, pad_mask, *_):
            got.update(blocks=np.asarray(blocks), pad_mask=np.asarray(pad_mask))
            return np.arange(pad_mask.shape[0], dtype=np.int32)
        return fn
    jp._scene_fn = jax_program
    want_out = jp.predict_scene(sx, sy, xyz, rgb)

    n = port.cfg.pc_npts
    blocks, pad_mask, order = serve.scene_blocks(xyz, rgb, n)
    assert blocks.dtype == np.float32 and blocks.shape == (4, n, 9)
    np.testing.assert_array_equal(blocks.view(np.int32), got["blocks"].view(np.int32))
    np.testing.assert_array_equal(pad_mask, got["pad_mask"])
    assert pad_mask.sum() == len(xyz) and pad_mask[:len(xyz)].all()

    port.scene_labels = lambda b, m, *_: np.arange(m.shape[0], dtype=np.int32)
    np.testing.assert_array_equal(port.predict_scene(sx, sy, xyz, rgb), want_out)
    # no colours: zeros, as the JAX package assembles them
    np.testing.assert_array_equal(serve.scene_blocks(xyz, None, n)[0][..., 3:6], 0.0)


@pytest.mark.parametrize("impl,graph_dtype", CASES)
def test_predict_scene_matches_jax(weights, monkeypatch, impl, graph_dtype):
    sx, sy, xyz, rgb = weights[2]
    jp, port = _predictors(weights, graph_dtype)
    monkeypatch.setenv("R3D_SCENE_LP", impl)
    want, z = _jax_scene(jp, (sx, sy, xyz, rgb), monkeypatch)
    monkeypatch.setenv("R3D_SCENE_LP", impl)
    got = port.predict_scene(sx, sy, xyz, rgb)
    assert got.shape == (len(xyz),) and got.dtype == np.int32
    assert got.min() >= 0 and got.max() <= port.cfg.n_way

    n_protos = port.cfg.n_subprototypes * port.cfg.n_classes
    _, _, order = serve.scene_blocks(xyz, rgb, port.cfg.pc_npts)
    zs = np.empty((len(xyz), z.shape[1]), np.float32)
    zs[order] = z[n_protos:n_protos + len(xyz)]
    np.testing.assert_array_equal(zs.argmax(-1), want)       # Z is the one JAX labelled by
    top2 = np.sort(zs, axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]) / np.abs(zs).max()
    differ = got != want
    assert differ.mean() <= 0.01, differ.sum()
    assert (gap[differ] < MARGIN).all(), gap[differ]


def test_scene_lp_path_follows_jax_rule(monkeypatch):
    """R3D_SCENE_LP: 'blocked' and 'sparse' force their path, 'auto' takes
    the blocked graph past 18,000 nodes, anything else the dense one."""
    cfg = tiny_config()
    monkeypatch.delenv("R3D_SCENE_LP", raising=False)
    assert serve.scene_lp_path(18000, cfg) == "dense"
    assert serve.scene_lp_path(18001, cfg) == "blocked-stored"
    assert serve.scene_lp_path(65836, cfg) == "blocked-split"
    assert serve.scene_lp_path(65836, cfg.replace(graph_dtype="bfloat16")) == "blocked-stored"
    for impl, small, large in (("blocked", "blocked-stored", "blocked-split"),
                               ("sparse", "sparse", "sparse"), ("dense", "dense", "dense"),
                               ("other", "dense", "dense")):
        monkeypatch.setenv("R3D_SCENE_LP", impl)
        assert serve.scene_lp_path(300, cfg) == small
        assert serve.scene_lp_path(65836, cfg) == large


def test_predict_scene_refuses_mesh_and_other_attributes(weights):
    sx, sy, xyz, rgb = weights[2]
    _, port = _predictors(weights)
    port.cfg = port.cfg.replace(pc_attribs="xyzrgb")
    with pytest.raises(NotImplementedError, match="9-d"):
        port.predict_scene(sx[..., :6], sy, xyz, rgb)


@pytest.mark.parametrize("graph_dtype", ["float32", "bfloat16"])
def test_scene_kernel_capture(weights, graph_dtype):
    """`chip_smoke.capture_calls` keeps the kernel calls of a scene on its
    own shapes (kNN three times and the attention forward once on the
    blocks, not on the support; kernel 4 once; kernel 7 once on the bf16
    graph), restores the wrappers, and `check_scene_kernels` passes them
    here, where each wrapper runs its plain version, and refuses a radius
    or a solve that is off."""
    sx, sy, xyz, rgb = weights[2]
    _, port = _predictors(weights, graph_dtype)
    # three blocks: a batch that the support's (n_way * k_shot = 4) does not share
    p = 2 * port.cfg.pc_npts + 5
    xyz, rgb = xyz[:p], rgb[:p]
    n_blocks = -(-p // port.cfg.pc_npts)
    assert n_blocks != port.cfg.n_way * port.cfg.k_shot
    wrappers = (cuda_kth.kth_smallest_per_row, cuda_cheby.cheby_solve)
    with chip_smoke.capture_calls(torch, chip_smoke.scene_kernel_targets(n_blocks)) as calls:
        port.predict_scene(sx, sy, xyz, rgb)
    assert (cuda_kth.kth_smallest_per_row, cuda_cheby.cheby_solve) == wrappers
    bf16 = graph_dtype == "bfloat16"
    assert {k: len(v) for k, v in calls.items()} == {
        "knn": 3, "attention_fwd": 1, "kth": 1, "cheby": int(bf16)}
    assert all(a[0].shape[0] == n_blocks for a, _, _ in calls["knn"] + calls["attention_fwd"])
    checked = chip_smoke.check_scene_kernels(torch, graph_dtype, calls)
    assert checked["kth_err"] == 0.0 and checked["knn_mismatch"] == 0.0
    for name in ("kth", "cheby")[:1 + bf16]:
        args, kw, got = calls[name][0]
        calls[name][0] = (args, kw, got * 1.01 + 1e-3)
        with pytest.raises(AssertionError):
            chip_smoke.check_scene_kernels(torch, graph_dtype, calls)
        calls[name][0] = (args, kw, got)
