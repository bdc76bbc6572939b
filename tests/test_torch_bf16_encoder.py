"""The bf16 encoder (`compute_dtype="bfloat16"`) of the port against the
JAX package, at tiny sizes on the CPU, with inputs made from a seed with
numpy and weights carried by `utils/convert.py:state_dict_from_jax`:

- `ConvBN` under each BN mode, train and eval: output dtype equal, values
  within bf16 rounding (rtol = atol = 2e-2, the JAX package's own bound in
  tests/test_backbone.py), running statistics within 1e-5;
- the per-layer resolution of every `bn_mode` ('hybrid' included) against
  the modes the JAX modules are built with;
- the plain forms of kernels 2, 5 and 6 on bf16 operands against the
  Pallas kernels in interpret mode (the attention at rate 0: the Pallas
  dropout does not run in interpret mode, and the port's Philox bits are
  not the TPU's), and `SelfAttention` with and without `attn_f32`;
- `FeatureExtractor` on the XLA paths, eval and train (features, running
  statistics, gradients);
- the slice: `FewShotPredictor.predict` and one `MPTILearner.train` step at
  tiny_config(compute_dtype='bfloat16') against the JAX model and learner.

bf16 rounds at the same points in both packages, so most values agree to
the bit; where the f32 values before a rounding differ by their sums'
order, the two round one bf16 step apart, and that step spreads through
later layers.  Each tolerance below says how far it was measured to
spread."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r3dfsseg_tpu.ops.lp as jax_lp
from chip_smoke import ATTN_BF16_FWD_TOL, BF16_ENC_GLOBAL_TOL, BF16_ENC_GRAD_TOL
from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.nn import dgcnn as jax_dgcnn
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn import dgcnn
from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_scatter
from r3dfsseg_tpu_torch.ops.fast_gather import gather_neighbors_fast
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_gather import _jax_scatter_kernel
from test_torch_lowp_graph import _check_graph_precondition, _pallas_kth
from torch_port_helpers import episode_arrays, random_flax_weights, train_episode

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
BN_TOL = 2e-2          # values within bf16 rounding (tests/test_backbone.py:215)
STATS_TOL = 1e-5       # running statistics (f32, from the same bf16 values)
# Gradients of the bf16 encoder against the JAX package's: relative L2
# distance per parameter and over all parameters, bounds set in
# chip_smoke.py beside BF16_GRAD_TOL from the spread measured here (its
# comment has the figures); chip_smoke.py holds the kernel path to the
# plain path with the same bounds.
# jit for the JAX side that rounds where the module code rounds: by default
# XLA keeps f32 values where a program rounds to bf16 and back (excess
# precision), and so skips roundings that the op-by-op model (and the port)
# makes
no_excess_jit = functools.partial(jax.jit,
                                  compiler_options={"xla_allow_excess_precision": False})


def _assert_grads_close(named_params, want_g, zero_prefix):
    """Per-parameter and global relative L2 distances within the bounds;
    the conv biases feeding a train-mode BatchNorm (exact gradient 0) only
    far below the largest gradient."""
    top = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    diff = norm = 0.0
    for name, p in named_params:
        wg = want_g[name].numpy()
        assert p.grad.dtype == torch.float32, name
        if name.startswith(zero_prefix) and name.endswith(".conv.bias"):
            assert max(np.abs(wg).max(), p.grad.abs().max().item()) < 1e-2 * top, name
            continue
        d = float(np.linalg.norm(p.grad.numpy() - wg))
        n = float(np.linalg.norm(wg))
        assert d <= BF16_ENC_GRAD_TOL * max(n, 1e-30), (name, d / n)
        diff, norm = diff + d * d, norm + n * n
    assert diff ** 0.5 <= BF16_ENC_GLOBAL_TOL * norm ** 0.5, (diff / norm) ** 0.5


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ------------------------------------------------------------- ConvBN --
@pytest.mark.parametrize("mode", ["exact", "fastvar", "stats", "relaxed"])
@pytest.mark.parametrize("train,groups", [(False, 1), (True, 1), (True, 2)])
def test_convbn_matches_jax(mode, train, groups):
    """`ConvBN(dtype=bf16, bn_mode=mode)` on an edge-shaped input whose
    channel means sit far from 0 (the single-pass variance's hard case):
    bf16 conv, f32 statistics, f32 or bf16 output by mode."""
    rng = np.random.default_rng(len(mode) + 10 * groups + int(train))
    x = (rng.normal(size=(4, 16, 3, 12)) * 2.0 + 3.0).astype(np.float32)
    jm = jax_dgcnn.ConvBN(8, use_bias=True, dtype=JBF16, bn_mode=mode)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng)
    want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                         groups=groups, mutable=["batch_stats"])
    tm = dgcnn.ConvBN(12, 8, use_bias=True, dtype=BF16, bn_mode=mode)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train, groups)
    assert _dtype_name(got) == str(want.dtype)
    assert str(want.dtype) == ("float32" if mode in ("exact", "fastvar") else "bfloat16")
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=BN_TOL, atol=BN_TOL)
    want_s = state_dict_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
    for name, w in want_s.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), w.numpy(), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=name)
    assert all(p.dtype == torch.float32 for p in tm.state_dict().values())


# --------------------------------------------------- BN mode resolution --
@pytest.mark.parametrize("mode", dgcnn.BN_MODES)
def test_bn_mode_resolution_matches_jax(mode):
    """The mode each BatchNorm of the JAX FeatureExtractor is built with
    (recorded at init) equals `resolve_bn_modes` and the port's layers."""
    cfg = jax_tiny_config()
    widths = tuple(tuple(w) for w in cfg.edgeconv_widths)
    jm = jax_dgcnn.FeatureExtractor(widths, tuple(cfg.dgcnn_mlp_widths), tuple(cfg.base_widths),
                                    cfg.output_dim, dgcnn_k=cfg.dgcnn_k, knn_impl="xla",
                                    attn_impl="xla", dtype=JBF16, bn_mode=mode)
    seen = {}

    def record(next_fun, args, kwargs, context):
        m = context.module
        if context.method_name == "__call__" and isinstance(
                m, (jax_dgcnn.ConvBN, jax_dgcnn._EdgeFirstLayer)):
            seen[".".join(m.scope.path)] = m.bn_mode
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)},
                                       jnp.zeros((1, cfg.pc_npts, cfg.pc_in_dim))))
    modes = dgcnn.resolve_bn_modes(mode, widths, cfg.dgcnn_mlp_widths, cfg.base_widths)
    assert modes == seen
    tm = dgcnn.FeatureExtractor(cfg.pc_in_dim, widths, cfg.dgcnn_mlp_widths, cfg.base_widths,
                                cfg.output_dim, dgcnn_k=cfg.dgcnn_k, dtype=BF16, bn_mode=mode)
    assert {name: tm.get_submodule(name).bn_mode for name in modes} == seen
    if mode == "hybrid":
        assert seen["encoder.edgeconv0.layer1"] == "exact"
        assert seen["encoder.mlp1"] == seen["base_learner.conv1"] == "fastvar"
        assert {seen["encoder.edgeconv1.layer1"], seen["encoder.mlp0"]} == {"relaxed"}


# ------------------------------------------------ kernels 2, 5 (bf16) --
def _bf16_pair(rng, shape):
    """The same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(JBF16)
    return j, torch.from_numpy(_as_f32(j)).to(BF16)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)


@pytest.mark.parametrize("b,n,d", [(2, 64, 16), (1, 32, 64), (2, 48, 8)])
def test_attention_bf16_forward_matches_pallas(pallas_interpret, b, n, d):
    """The port's plain bf16 forward against `_attn_fwd_kernel` on bf16 q,
    k, v.  Where 1 / tau is a power of two, q / tau (the plain version's,
    as the JAX XLA path) and q * bf16(1 / tau) (the TPU kernel's) round
    alike; at D = 8 the plain version takes the kernel's scaling
    (``kernel_scale``).  Both round the normalised P to bf16 before P V:
    within ATTN_BF16_FWD_TOL of the largest entry (an f32 P at a rounding
    boundary may round the other way)."""
    rng = np.random.default_rng(b * n + d)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (b, n, d)) for _ in range(3))
    tau = float(d) ** 0.5
    want = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))
    got = (cuda_attention.attention_reference(tq, tk, tv, tau, kernel_scale=True) if d == 8
           else cuda_attention.attention(tq, tk, tv, tau))
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATTN_BF16_FWD_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("b,n,d", [(2, 64, 16), (1, 32, 64)])
def test_attention_bf16_backward_matches_pallas(pallas_interpret, b, n, d):
    """dq, dk, dv by autograd of the port's `fused_attention` (impl 'xla':
    the plain forms) against `jax.grad` through `_attn_bwd_kernel` on bf16
    q, k, v: bf16 cotangents in both; each within 2e-2 of its largest
    entry (the Pallas kernel takes rowsum(dP * P) over the f32 P where the
    port takes rowsum(dY * Y) over the output of the bf16 P; measured below
    5e-3)."""
    rng = np.random.default_rng(b * n + d + 1)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (b, n, d)) for _ in range(3))
    w = rng.normal(size=(b, n, d)).astype(np.float32)
    tau = float(d) ** 0.5

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention(q, k, v, 0, tau, 0.0, True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    y = cuda_attention.fused_attention(*leaves, 0, tau, 0.0, True, impl="xla")
    (y * torch.from_numpy(w)).sum().backward()
    for name, a, t in zip("qkv", want, leaves):
        assert t.grad.dtype == BF16 and str(a.dtype) == "bfloat16", name
        ref = _as_f32(a)
        err = np.abs(_as_f32(t.grad) - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("attn_f32", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_selfattention_bf16_matches_jax(attn_f32, x_dtype):
    """`SelfAttention(dtype=bf16)` on the XLA path against the JAX module's
    (`score_f32` = attn_f32), eval: the output dtype is the input's; values
    within BN_TOL."""
    rng = np.random.default_rng(int(attn_f32) + 2 * len(x_dtype))
    x = jnp.asarray(rng.normal(size=(2, 32, 16)).astype(np.float32)).astype(x_dtype)
    jm = jax_dgcnn.SelfAttention(8, attn_dropout=0.1, dtype=JBF16, attn_impl="xla",
                                 score_f32=attn_f32)
    var = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x,
                  train=False)
    want = jm.apply(var, x, train=False)
    m = dgcnn.SelfAttention(16, 8, attn_impl="xla", dtype=BF16, attn_f32=attn_f32)
    m.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, var["params"])), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(_as_f32(x)).to(getattr(torch, x_dtype)))
    assert _dtype_name(got) == str(want.dtype) == x_dtype
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=BN_TOL, atol=BN_TOL)


# ------------------------------------------------------ kernel 6 (bf16) --
def test_scatter_bf16_matches_pallas():
    """The plain scatter-add on a bf16 cotangent (f32 `index_add_` of the
    upcast) against `_scatter_kernel` with a bf16 g (one-hot products,
    exact, with f32 sums): f32 sums in another order."""
    rng = np.random.default_rng(6)
    b, nq, k, c, n = 2, 64, 4, 8, 64
    jg, tg = _bf16_pair(rng, (b, nq, k, c))
    idx = rng.integers(0, n, size=(b, nq, k)).astype(np.int32)
    idx[:, :, 0] = 3                                   # a hub
    want = np.asarray(_jax_scatter_kernel(jg, jnp.asarray(idx), n, tm=32))
    got = cuda_scatter.scatter_add(tg, torch.from_numpy(idx), n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the gather's backward casts it to the table's dtype, as JAX's `_bwd`
    a = torch.zeros((b, n, c), dtype=BF16, requires_grad=True)
    gather_neighbors_fast(a, torch.from_numpy(idx), impl="xla").backward(tg)
    assert a.grad.dtype == BF16 and torch.equal(a.grad, got.to(BF16))


# ------------------------------------------------------ FeatureExtractor --
def _encoder_pair(cfg, bn_mode):
    widths = tuple(tuple(w) for w in cfg.edgeconv_widths)
    jm = jax_dgcnn.FeatureExtractor(widths, tuple(cfg.dgcnn_mlp_widths), tuple(cfg.base_widths),
                                    cfg.output_dim, dgcnn_k=cfg.dgcnn_k, attn_dropout=0.0,
                                    knn_impl="xla", attn_impl="xla", dtype=JBF16,
                                    bn_mode=bn_mode)
    tm = dgcnn.FeatureExtractor(cfg.pc_in_dim, widths, cfg.dgcnn_mlp_widths, cfg.base_widths,
                                cfg.output_dim, dgcnn_k=cfg.dgcnn_k, knn_impl="xla",
                                attn_impl="xla", attn_dropout=0.0, dtype=BF16, bn_mode=bn_mode,
                                gather_impl="xla")
    return jm, tm


def test_bf16_encoder_weights_carry_over():
    """The bf16 model's Flax tree is the f32 model's: every weight and
    statistic maps one to one, strictly, and stays f32."""
    cfg = jax_tiny_config()
    jm, tm = _encoder_pair(cfg, "hybrid")
    variables = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, cfg.pc_npts, cfg.pc_in_dim))))
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(variables))
    sd = state_dict_from_jax(*random_flax_weights(variables, np.random.default_rng(0)))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())


@pytest.mark.parametrize("bn_mode", ["fastvar", "exact"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_feature_extractor_matches_jax(bn_mode, train):
    """The 192-d (tiny: 24-d) embedding, f32, within BN_TOL; in training
    also the running statistics (rtol 1e-3: their inputs are bf16 values
    a step apart where the JAX and port sums round apart) and the
    gradients (relative L2 within BF16_ENC_GRAD_TOL)."""
    cfg = jax_tiny_config()
    rng = np.random.default_rng(100 + int(train) + 2 * len(bn_mode) % 3)
    x = rng.normal(size=(3, cfg.pc_npts, cfg.pc_in_dim)).astype(np.float32)
    w = rng.normal(size=(3, cfg.pc_npts, cfg.feat_dim)).astype(np.float32)
    jm, tm = _encoder_pair(cfg, bn_mode)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)

    def apply(p):
        return jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=train,
                        mutable=["batch_stats"])

    want, mut = no_excess_jit(apply)(params)
    got = tm(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BN_TOL, atol=BN_TOL)
    if not train:
        return
    want_s = state_dict_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
    for name, s in want_s.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), s.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    want_g = state_dict_from_jax(jax.tree.map(
        np.asarray, no_excess_jit(jax.grad(lambda p: jnp.sum(apply(p)[0] * w)))(params)))
    (got * torch.from_numpy(w)).sum().backward()
    _assert_grads_close(tm.named_parameters(), want_g, "base_learner.")


# ------------------------------------------------------------ the slice --
@pytest.fixture(scope="module")
def jax_bf16_encoder_side():
    """The JAX model at tiny_config(compute_dtype='bfloat16',
    attn_dropout=0) (so the bf16 graph too) with the k-th radius of the
    Pallas kernel in interpret mode, as tests/test_torch_lowp_graph.py,
    jitted by `no_excess_jit`."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_lp, "_kth_smallest_per_row", _pallas_kth)
    cfg = jax_tiny_config(compute_dtype="bfloat16", attn_dropout=0.0)
    model = jax_mpti.MPTINet(cfg)
    w, k, n, c = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    jit = no_excess_jit
    logits = jit(functools.partial(model.apply, train=False), static_argnames="eval_mdns")

    @jit
    def loss_and_grads(params, stats, ep):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, ep, train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(2)})
            return out.lp_loss + cfg.contrast_weight * out.contrast_loss, out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def features(train):
        return jit(lambda v, x: model.apply(
            v, x, method=lambda m, x: m.features(x, train=train), mutable=["batch_stats"])[0])

    yield cfg, shapes, logits, loss_and_grads, {False: features(False), True: features(True)}
    mp.undo()


@pytest.mark.parametrize("seed", [3])
def test_bf16_encoder_predict_matches_jax(jax_bf16_encoder_side, seed):
    """`FewShotPredictor.predict` at tiny_config(compute_dtype='bfloat16')
    against the JAX model with the same weights, after the two graphs are
    shown to select the same neighbours: logits within 1e-3 (eval
    embeddings agree to ~1e-7 here: running-statistics BatchNorms spread a
    bf16 step apart no further), labels on >= 99% of points."""
    jcfg, shapes, jax_logits, _, _ = jax_bf16_encoder_side
    cfg = tiny_config(compute_dtype="bfloat16", attn_dropout=0.0)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    port = FewShotPredictor(cfg, device="cpu")
    port._learner.load_params(params, stats)
    arrays = episode_arrays(cfg, rng)
    _check_graph_precondition(jax_bf16_encoder_side, variables, port._learner.model, cfg,
                              arrays, eval_mdns=True, train=False)
    want = np.asarray(jax_logits(variables, JaxEpisode(*map(jnp.asarray, arrays)),
                                 eval_mdns=True).query_logits)
    with torch.no_grad():
        got = port._learner.model(Episode(*map(torch.from_numpy, arrays)),
                                  eval_mdns=True).query_logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    pred = port.predict(*arrays[:3])
    assert pred.dtype == np.int32 and pred.shape == (cfg.n_way, cfg.pc_npts)
    assert (pred == want[0].argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("seed", [0, 10])
def test_bf16_encoder_train_step_matches_jax(jax_bf16_encoder_side, seed):
    """One `MPTILearner.train` step at tiny_config(compute_dtype='bfloat16')
    against the JAX loss_fn with the same weights, after the two graphs are
    shown to select the same neighbours (the seeds were picked so: in
    train mode the batch-statistics BatchNorms spread a bf16 step apart
    further, and on most seeds a few graph pairs differ): losses rtol 1e-4,
    the gradients within BF16_ENC_GRAD_TOL and BF16_ENC_GLOBAL_TOL; the
    returned metrics are f32 and the parameters stay f32."""
    jcfg, shapes, _, loss_and_grads, _ = jax_bf16_encoder_side
    cfg = tiny_config(compute_dtype="bfloat16", attn_dropout=0.0)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    arrays = train_episode(cfg, rng)
    learner = MPTILearner(cfg, "cpu")
    learner.load_params(params, stats)
    _check_graph_precondition(jax_bf16_encoder_side, variables, copy.deepcopy(learner.model),
                              cfg, arrays, eval_mdns=False, train=True)
    (loss, out), grads = loss_and_grads(params, stats, JaxEpisode(*map(jnp.asarray, arrays)))
    metrics = learner.train(arrays)
    assert all(v.dtype == torch.float32 for v in metrics.values())
    for key, want in (("loss", loss), ("lp_loss", out.lp_loss),
                      ("contrast_loss", out.contrast_loss)):
        np.testing.assert_allclose(metrics[key].item(), float(want), rtol=1e-4, err_msg=key)
    for group in learner.optimizer.param_groups:
        assert all(p.dtype == torch.float32 for p in group["params"])
    _assert_grads_close(learner.model.named_parameters(),
                        state_dict_from_jax(jax.tree.map(np.asarray, grads)),
                        "features.base_learner.")


def test_bf16_encoder_entry_points_default_to_cuda(monkeypatch):
    """`FewShotPredictor` and `MPTILearner` with the bf16 encoder run on
    "cuda" unless the caller asks for the CPU, and raise without a GPU."""
    cfg = tiny_config(compute_dtype="bfloat16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FewShotPredictor(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPTILearner(cfg)
    assert FewShotPredictor(cfg, device="cpu")._learner.device == torch.device("cpu")
