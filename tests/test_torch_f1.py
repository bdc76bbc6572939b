"""The shapes every JAX Pallas kernel takes and the port's tuned kernels do
not (kNN at any k and C, attention at any D, the k-th distance at any row
width, the scatter-add at any C and N), and the packed-key kNN
(knn_impl="pallas"): the plain versions against the JAX package (its
Pallas kernels in interpret mode), and the new kernels' designs emulated
on the CPU.  Inputs are made from seeds with numpy.

Tolerances: the kNN selections are compared exactly (integer coordinates
make every sum exact; float inputs are held to a one-ulp margin at the
packed keys' bucket edges, and the card's gate on the packed kernel to
the rounding bound of `chip_smoke.packed_agreement`); the k-th distance bit for bit; the
scatter-add at rtol = atol = 1e-6 on bf16-representable cotangents (every
version is the same f32 sum in another order); attention as the tuned
forms' CPU tests hold it (f32 rtol 1e-5, atol 1e-6; bf16 within
ATTN_BF16_FWD_TOL of the largest entry forward, 2e-2 backward)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_kth
from chip_smoke import ATTN_BF16_FWD_TOL
from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners import MPTILearner as JaxLearner
from r3dfsseg_tpu.learners.base import TrainState
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu.nn import FeatureExtractor as JaxFeatureExtractor
from r3dfsseg_tpu.ops import fast_gather as jax_fg
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu.ops import pallas_knn as jax_pk
from r3dfsseg_tpu.ops.knn import knn_indices as jax_knn_indices
from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas
from r3dfsseg_tpu.serve import FewShotPredictor as JaxPredictor
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.models import mpti
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import FeatureExtractor
from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn, cuda_kth, cuda_scatter
from r3dfsseg_tpu_torch.ops.knn import knn_indices, pairwise_sqdist
from r3dfsseg_tpu_torch.serve import FewShotPredictor
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_gather import _jax_scatter_kernel as jax_scatter_kernel
from test_torch_knn_general import emulate as emulate_general
from test_torch_scatter import general_build
from torch_port_helpers import (episode_arrays, jax_graph_margin, jax_knn_kernel,
                                random_flax_weights)

BF16 = torch.bfloat16


# ------------------------------------------------ kernel 1: packed keys --
def _jax_knn_interpret(x, k, *, tile_n: int = 256, exact: bool = False):
    """`knn_indices_pallas` with its kernel in interpret mode, for the JAX
    model's EdgeConv under knn_impl 'pallas' on the CPU."""
    n = x.shape[1]
    tile = min(tile_n, n)
    while n % tile:
        tile //= 2
    return jax_knn_kernel(x, k, tile, exact=exact)


def _edge_ulps(x: np.ndarray) -> np.ndarray:
    """(B, N, N): how many ulps each packed-mode distance (the plain
    version's grouping, f32) lies from the nearest edge of its key's
    bucket (the low packed_bits(N) bits of its pattern)."""
    xt = torch.from_numpy(x)
    xx = (xt * xt).sum(-1, keepdim=True)
    d = ((xx - 2.0 * xt @ xt.transpose(-1, -2)) + xx.transpose(-1, -2)).clamp_min(0.0)
    low = (1 << cuda_knn.packed_bits(x.shape[1])) - 1
    r = (d.view(torch.int32) & low).numpy()
    return np.minimum(r, low + 1 - r)


@pytest.mark.parametrize("b,n,c,k", [(2, 64, 8, 5), (1, 128, 3, 20), (2, 64, 300, 40)])
def test_packed_knn_plain_equals_pallas_on_integer_points(b, n, c, k):
    """Integer coordinates: every product and sum is exact in f32, so the
    plain packed version and `_knn_kernel(exact=False)` build the same keys
    and return the same indices in the same order."""
    x = np.random.default_rng(b * n + c).integers(-4, 5, size=(b, n, c)).astype(np.float32)
    want = np.asarray(_jax_knn_interpret(jnp.asarray(x), k, tile_n=32))
    got = cuda_knn.knn(torch.from_numpy(x), k, packed=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,n,c,k", [(2, 64, 8, 5), (2, 128, 16, 20), (1, 64, 64, 40)])
def test_packed_knn_plain_matches_pallas_on_floats(b, n, c, k):
    """Float inputs: the two compute qq, kk and the products in another
    order, so a distance within one ulp of its bucket's edge may fall in
    the next bucket and move its column; every row whose lists differ holds
    such a distance, and such rows are few."""
    x = np.random.default_rng(c + k).normal(size=(b, n, c)).astype(np.float32)
    want = np.asarray(_jax_knn_interpret(jnp.asarray(x), k, tile_n=32))
    got = cuda_knn.knn(torch.from_numpy(x), k, packed=True).numpy()
    edge = _edge_ulps(x) <= 1
    for cb, i in zip(*np.nonzero((got != want).any(-1))):
        assert edge[cb, i, got[cb, i]].any() or edge[cb, i, want[cb, i]].any(), (cb, i)
    assert (got != want).any(-1).mean() <= 0.05


def test_packed_key_drops_low_bits_and_orders_ties_by_column():
    """Two points at distances that agree above the packed bits swap to
    column order in packed mode and keep distance order in exact mode."""
    x = np.zeros((1, 64, 1), np.float32)
    x[0, :, 0] = np.arange(64) + 10.0
    x[0, 5, 0] = 1.0
    x[0, 3, 0] = np.float32(1.0) + np.float32(2.0 ** -20)  # 2^-20: below 2^-17 of d
    x[0, 0, 0] = 0.0
    got = cuda_knn.knn(torch.from_numpy(x), 3, packed=True)[0, 0].tolist()
    exact = cuda_knn.knn(torch.from_numpy(x), 3)[0, 0].tolist()
    assert exact == [0, 5, 3] and got == [0, 3, 5]
    assert got == np.asarray(_jax_knn_interpret(jnp.asarray(x), 3))[0, 0].tolist()


# ------------------------------------ kernel 1: the general kernel's design --
def _exact_keys(d: torch.Tensor) -> torch.Tensor:
    """csrc/knn_general.cu's exact keys: bits(d) << 32 | col, as int64
    (d >= 0, so its bits fit 31 and the keys order as unsigned)."""
    col = torch.arange(d.shape[-1], dtype=torch.int64)
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | col


def _packed_keys(x: torch.Tensor) -> torch.Tensor:
    xx = (x * x).sum(-1, keepdim=True)
    d = ((xx - 2.0 * x @ x.transpose(-1, -2)) + xx.transpose(-1, -2)).clamp_min(0.0)
    low = (1 << cuda_knn.packed_bits(x.shape[-2])) - 1
    col = torch.arange(x.shape[-2], dtype=torch.int32)
    return ((d.view(torch.int32) & ~low) | col).to(torch.int64)


@pytest.mark.parametrize("n,c,k", [(128, 300, 40), (300, 9, 70), (130, 64, 130)])
def test_general_knn_exact_keys_equal_knn_indices(n, c, k):
    """The exact keys bits(d) << 32 | col, taken through the kernel's
    tiles, batches and list merges (`test_torch_knn_general.emulate`, one
    and two key splits), give `knn_indices` (and the JAX exact Pallas
    kernel where N is a power of two) on the same distances: k in
    registers (40) and in memory (70, and k = N), ragged N, C past the
    tuned kernel's 256, exact ties."""
    x = np.random.default_rng(n + c + k).normal(size=(2, n, c)).astype(np.float32)
    x[0, 11] = x[0, 40]                                  # a distance tie
    xt = torch.from_numpy(x)
    want = knn_indices(xt, k).numpy()
    keys = _exact_keys(pairwise_sqdist(xt)).numpy().astype(np.uint64)
    for splits in (1, 2):
        np.testing.assert_array_equal(emulate_general(keys, k, splits, packed=False), want)
    if n & (n - 1) == 0:     # cloud 1, without the duplicate: JAX rounds its own distances
        jx = jnp.asarray(x[1:])
        np.testing.assert_array_equal(want[1:], np.asarray(jax_knn_kernel(jx, k, 64)))
        np.testing.assert_array_equal(want[1:], np.asarray(jax_knn_indices(jx, k)))


@pytest.mark.parametrize("n,k", [(128, 40), (200, 70)])
def test_general_knn_packed_keys_through_the_lists(n, k):
    """The packed keys through the same tiles, batches and merges give the
    plain packed version."""
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(1, n, 12)).astype(np.float32))
    keys = _packed_keys(x).numpy().astype(np.uint64)
    for splits in (1, 2):
        np.testing.assert_array_equal(emulate_general(keys, k, splits, packed=True),
                                      cuda_knn.knn_packed_reference(x, k).numpy())


def _fma_chain_packed_knn(x: np.ndarray, k: int) -> torch.Tensor:
    """csrc/knn_general.cu's packed-mode arithmetic on the CPU: each norm
    and inner product one fma chain over the channels in order (the
    product exact in f64, each step rounded to f32), d = max((qq - 2
    inner) + kk, 0), the k smallest packed keys' columns."""
    n = x.shape[1]
    low = (1 << cuda_knn.packed_bits(n)) - 1
    out = []
    for xb in x.astype(np.float64):
        nrm, inner = np.zeros(n, np.float32), np.zeros((n, n), np.float32)
        for c in range(xb.shape[1]):
            nrm = (xb[:, c] * xb[:, c] + nrm).astype(np.float32)
            inner = (np.outer(xb[:, c], xb[:, c]) + inner).astype(np.float32)
        d = np.maximum((nrm[:, None] - np.float32(2) * inner) + nrm[None, :], np.float32(0))
        key = (d.view(np.int32) & ~low) | np.arange(n, dtype=np.int32)
        out.append(np.sort(key, -1)[:, :k] & low)
    return torch.from_numpy(np.stack(out))


def test_packed_agreement_explains_rounding_and_flags_wrong_lists():
    """`chip_smoke.packed_agreement`, the card's gate on the packed kNN:
    the kernel's arithmetic (`_fma_chain_packed_knn`) on four support
    clouds of a flagship episode (C = 9) gives lists that differ from the
    plain version's on a few rows, each explained within an eighth of the
    rounding bound; a row with two places swapped (far apart or the last
    two), its last neighbour replaced by the farthest point, or a repeated
    column is not explained."""
    from chip_smoke import make_episode, packed_agreement
    from r3dfsseg_tpu_torch.config import R3DConfig
    x = make_episode(R3DConfig(), np.random.default_rng(0))[0].reshape(-1, 2048, 9)[:4]
    xt = torch.from_numpy(x)
    got, want = _fma_chain_packed_knn(x, 20), cuda_knn.knn_packed_reference(xt, 20)
    a = packed_agreement(torch, cuda_knn, xt, got, want)
    assert 0 < a["mismatch"] <= 1e-2 and a["unexplained"] == 0 and a["tol_share"] <= 1 / 8, a
    b, r = (~(got != want).any(-1)).nonzero()[7].tolist()

    def swap(v, i, j):
        v[[i, j]] = v[[j, i]]

    def farthest(v):
        v[-1] = int(((xt[b] - xt[b, r]) ** 2).sum(-1).argmax())

    def repeat(v):
        v[5] = v[4]

    for wrong in (lambda v: swap(v, 3, 12), lambda v: swap(v, 18, 19), farthest, repeat):
        bad = got.clone()
        wrong(bad[b, r])
        assert packed_agreement(torch, cuda_knn, xt, bad, want)["unexplained"] == 1


# ------------------------------------ kernel 1 packed: EdgeConv and serving --
@pytest.fixture
def jax_pallas_knn(monkeypatch):
    """The JAX package's `knn_indices_pallas` in interpret mode (its module
    attribute, which `EdgeConv._knn` imports at trace time)."""
    monkeypatch.setattr(jax_pk, "knn_indices_pallas", _jax_knn_interpret)


def test_feature_extractor_pallas_knn_matches_jax(jax_pallas_knn):
    """FeatureExtractor with knn_impl 'pallas' (packed-key kNN in every
    EdgeConv) against the JAX module with the same weights, eval mode,
    rtol = atol = 1e-4 as `test_torch_backbone.py`."""
    cfg = tiny_config()
    widths = tuple(tuple(w) for w in cfg.edgeconv_widths)
    jm = JaxFeatureExtractor(widths, tuple(cfg.dgcnn_mlp_widths), tuple(cfg.base_widths),
                             cfg.output_dim, dgcnn_k=cfg.dgcnn_k, knn_impl="pallas")
    tm = FeatureExtractor(cfg.pc_in_dim, widths, cfg.dgcnn_mlp_widths, cfg.base_widths,
                          cfg.output_dim, dgcnn_k=cfg.dgcnn_k, knn_impl="pallas",
                          attn_impl="pallas")
    rng = np.random.default_rng(31)
    x = rng.normal(size=(3, cfg.pc_npts, cfg.pc_in_dim)).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [12, 21])
def test_served_episode_pallas_knn_matches_jax(jax_pallas_knn, seed):
    """One served episode under R3DConfig(knn_impl='pallas') on both sides
    (fps_impl and attn_impl 'pallas' in the port, which take the same
    plain versions on the CPU): logits within rtol = atol = 1e-3 and
    predictions on >= 99% of points, after the affinity margin check of
    `test_torch_mpti.py`."""
    jcfg = jax_tiny_config(knn_impl="pallas")
    cfg = tiny_config(knn_impl="pallas", fps_impl="pallas", attn_impl="pallas")
    model = jax_mpti.MPTINet(jcfg)
    w, k, n, c = jcfg.n_way, jcfg.k_shot, jcfg.pc_npts, jcfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    rng = np.random.default_rng(seed)
    params, stats = random_flax_weights(shapes, rng)
    variables = {"params": params, "batch_stats": stats}
    features = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.features(x, train=False)))
    sx, sy, qx, qy = episode_arrays(cfg, rng)
    margin = jax_graph_margin(lambda x: np.asarray(features(variables, jnp.asarray(x))),
                              jcfg, sx, sy, qx, True)
    assert margin > 1e-6, f"episode has a k-th-neighbour tie at f32 rounding ({margin:.1e})"
    port = FewShotPredictor(cfg, device="cpu", eval_mdns=True)
    port._learner.load_params(params, stats)
    want = np.asarray(jax.jit(functools.partial(model.apply, train=False, eval_mdns=True))(
        variables, JaxEpisode(*map(jnp.asarray, (sx, sy, qx, qy)))).query_logits)
    with torch.no_grad():
        got = port._learner.model(Episode(*map(torch.from_numpy, (sx, sy, qx, qy))),
                                  eval_mdns=True).query_logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    learner = JaxLearner(jcfg)
    learner.state = TrainState(jnp.zeros((), jnp.int32), params, stats, learner.tx.init(params))
    jax_pred = np.asarray(JaxPredictor(jcfg, learner, eval_mdns=True).predict(sx, sy, qx))
    assert (port.predict(sx, sy, qx) == jax_pred).mean() >= 0.99


def test_knob_values_follow_the_jax_package():
    """knn_impl auto | pallas_exact | pallas | xla, fps_impl and attn_impl
    auto | pallas | xla build the model; 'approx' (and unknown values)
    raise.  Under 'pallas_exact' the exact kNN runs, under 'pallas' the
    packed one, and the k-th distance, solve and scatter-add follow every
    kernel value as 'auto'."""
    cfg = tiny_config()
    for knn in cuda_knn.IMPLS:
        for other in ("auto", "pallas", "xla"):
            mpti.MPTINet(cfg.replace(knn_impl=knn, fps_impl=other, attn_impl=other))
    arrays = episode_arrays(cfg, np.random.default_rng(0))[:3]
    for bad in ({"knn_impl": "approx"}, {"fps_impl": "pallas_exact"},
                {"attn_impl": "bogus"}):
        with pytest.raises(NotImplementedError):
            FewShotPredictor(cfg.replace(**bad), device="cpu").predict(*arrays)
    assert [cfg.replace(knn_impl=v).follower_impl for v in cuda_knn.IMPLS] == \
        ["auto", "auto", "auto", "xla"]


# ------------------------------------------ kernels 2 and 5 at any width --
def _pair(rng, shape, dtype):
    """The same values (bf16-exact for bf16) as a JAX and a torch array."""
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)
    return jnp.asarray(x), torch.from_numpy(x)


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("d", [128, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_at_wide_and_unaligned_d(monkeypatch, d, dtype):
    """The plain versions at D = 128 (the pretraining network's head) and
    D = 12 against `_attn_fwd_kernel` and `jax.grad` through
    `_attn_bwd_kernel` in interpret mode, rate 0 (the Pallas mask does not
    run in interpret mode).  The plain versions scale q as the kernels do
    (q * bf16(1 / tau) in bf16: 1 / tau is no power of two at these D).
    f32: rtol 1e-5, atol 1e-6; bf16: the forward within ATTN_BF16_FWD_TOL
    of the largest entry, each gradient within 2e-2 (the Pallas backward
    takes rowsum(dP * P), the port rowsum(dY * Y)), as the tuned forms'
    tests hold them."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    rng = np.random.default_rng(d + len(dtype))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 64, d), dtype) for _ in range(3))
    dy = rng.normal(size=(2, 64, d)).astype(np.float32)
    tau = float(d) ** 0.5
    lowp = dtype == "bfloat16"
    want_y = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))
    y, lse = cuda_attention.attention_fwd_reference(tq, tk, tv, tau, kernel_scale=True)

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention(q, k, v, 0, tau, 0.0, True) * dy)

    want_g = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    got_g = cuda_attention.attention_bwd_reference(tq, tk, tv, y, torch.from_numpy(dy), lse,
                                                   tau, kernel_scale=True)
    if lowp:
        assert np.abs(y.numpy() - want_y).max() <= ATTN_BF16_FWD_TOL * np.abs(want_y).max()
        for a, w in zip(got_g, want_g):
            ref = _as_f32(w)
            assert np.abs(_as_f32(a.to(BF16)) - ref).max() <= 2e-2 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-6)
        for a, w in zip(got_g, want_g):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,dtype,pad", [(6, torch.float32, 2), (12, BF16, 4),
                                         (10, torch.float32, 2), (1, BF16, 7)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_zero_pad_is_exact(d, dtype, pad, rate):
    """The wrapper's zero pad of an unaligned D (f32 to a multiple of 4,
    bf16 of 8) with tau of the unpadded D: the padded plain forward gives
    exactly the unpadded one's y and lse; the padded backward's extra
    columns are exactly zero, and its others are the same sums (the matrix
    products' column blocking may order them differently: rtol 1e-6)."""
    g = torch.Generator().manual_seed(d + pad)
    q, k, v, dy = (torch.randn((2, 64, d), generator=g) for _ in range(4))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    assert cuda_attention._layout(q) == pad
    tau = float(d) ** 0.5
    padded = cuda_attention._pad(pad, q, k, v, dy)
    y, lse = cuda_attention.attention_fwd_reference(q, k, v, tau, rate, 3, kernel_scale=True)
    yp, lsep = cuda_attention.attention_fwd_reference(*padded[:3], tau, rate, 3,
                                                      kernel_scale=True)
    assert torch.equal(yp[..., :d], y) and torch.equal(lsep, lse)
    assert not bool(yp[..., d:].any())
    grads = cuda_attention.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, 3,
                                                   kernel_scale=True)
    gp = cuda_attention.attention_bwd_reference(*padded[:3], yp, padded[3], lsep, tau, rate, 3,
                                                kernel_scale=True)
    for a, w in zip(gp, grads):
        assert not bool(a[..., d:].any())
        torch.testing.assert_close(a[..., :d], w, rtol=1e-6, atol=1e-7)


def test_attention_layout_rule():
    """Which kernels a CUDA call takes: aligned D <= 64 the tuned ones
    unpadded, unaligned D <= 64 them after the pad; bf16 at 64 < D <= 256
    the wide tensor-core pair and bf16 past 256 the grouped tensor-core
    pair (an unaligned D after the pad to a multiple of 8: 300 to 304);
    f32 past 64 the 3xTF32 pair in channel groups (an unaligned D after the
    pad to a multiple of 4: 65 to 68, 130 to 132)."""
    def lay(d, dtype=torch.float32):
        return cuda_attention._layout(torch.zeros((1, 1, d), dtype=dtype))

    def route(d, dtype=torch.float32):
        return cuda_attention._route(torch.zeros((1, 1, d), dtype=dtype))
    assert [lay(d) for d in (4, 12, 64, 6, 65, 128)] == [0, 0, 0, 2, 3, 0]
    assert [route(d) for d in (4, 6, 64, 65, 128, 256)] == ["tuned"] * 3 + ["wide_tf32"] * 3
    assert [lay(d, BF16) for d in (8, 64, 12, 1, 72, 128)] == [0, 0, 4, 7, 0, 0]
    assert [lay(d, BF16) for d in (72, 128, 256, 320, 100, 65, 300, 512)] == \
        [0, 0, 0, 0, 4, 7, 4, 0]
    assert [route(d, BF16) for d in (8, 1, 64, 72, 128, 256, 320, 100, 65, 300, 252, 257)] == \
        ["tuned"] * 3 + ["wide_tc"] * 3 + ["wide_group", "wide_tc", "wide_tc", "wide_group",
                                           "wide_tc", "wide_group"]


# ------------------------------------------ kernel 4 at any row width --
@pytest.mark.parametrize("dtype,m", [("float32", 60000), ("bfloat16", 120000)])
def test_kth_plain_matches_pallas_at_wide_rows(dtype, m):
    """Rows wider than one block's shared memory (60000 f32, 120000 bf16
    entries): the plain version bit-equal to `kth_smallest_per_row_pallas`
    in interpret mode (its own row tile, shrunk for wide rows), and the
    wide variant's design (the select of csrc/kth.cu with up to 256
    entries ranked directly) emulated on the bits, bit-equal to both."""
    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(m)
    d = rng.uniform(0.1, 9.0, size=(3, m)).astype(np.float32)
    d[:, -4:] = cuda_kth.SENTINEL
    d[1, :150] = rng.uniform(0.1, 2.0, 150)              # rank k = 200 among 300 ties:
    d[1, 150:450] = 2.5                                  # more than the direct rank takes
    d[1, 450:-4] = rng.uniform(3.0, 9.0, m - 454)
    td = torch.from_numpy(d)
    jd = jnp.asarray(d)
    if bf16:
        td = td.to(BF16)
        jd = jd.astype(jnp.bfloat16)
        d = td.float().numpy()
    k, iters = 200, 16 if bf16 else 32
    want = np.asarray(kth_smallest_per_row_pallas(jd, k, iters=iters, interpret=True))
    plain = cuda_kth.kth_smallest_per_row(td, k, iters).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))
    cap = test_torch_kth.CAP
    try:
        test_torch_kth.CAP = 256                         # kth.cu kWideCap
        got, _ = test_torch_kth.emulate_kth(d, k, iters, bf16)
    finally:
        test_torch_kth.CAP = cap
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------ kernel 6 at any C and N --
def _scatter_case(seed, b, nq, k, c, n):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, nq, k, c)).astype(np.float32)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, n, size=(b, nq, k)).astype(np.int32)
    idx[:, :, 0] = 7                                     # a hub of nq rows
    return g, idx


@pytest.mark.parametrize("b,nq,k,c,n", [(2, 256, 4, 63, 2048), (1, 256, 4, 64, 32768),
                                        (1, 128, 3, 63, 32768)])
def test_scatter_plain_matches_pallas_at_odd_c_and_wide_n(b, nq, k, c, n):
    """An odd C and N past the tuned kernel's build (32768 targets): the
    plain versions (`index_add_` and the kernel's order of sums) against
    `_scatter_kernel` in interpret mode and `_scatter_exact` (segment sum),
    rtol = atol = 1e-6."""
    g, idx = _scatter_case(n + c, b, nq, k, c, n)
    tg, ti = torch.from_numpy(g), torch.from_numpy(idx)
    ordered = cuda_scatter.scatter_add_ordered_reference(tg, ti, n).numpy()
    plain = cuda_scatter.scatter_add(tg, ti, n).numpy()
    kernel = np.asarray(jax_scatter_kernel(jnp.asarray(g), jnp.asarray(idx), n, tm=nq * k // 4))
    exact = np.asarray(jax_fg._scatter_exact(jnp.asarray(g), jnp.asarray(idx), n))
    for want in (kernel, exact):
        np.testing.assert_allclose(ordered, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(plain, want, rtol=1e-6, atol=1e-6)


def emulate_general_build(idx: np.ndarray, n: int):
    """csrc/scatter_general.cu's build on the CPU
    (`test_torch_scatter.general_build`): per cloud, where a histogram row
    of n fits in shared memory, the tuned kernel's build (units of rows
    counted per target, per-warp histograms, rows placed 32 at a time
    ranked by target) and its records in target order; else stable LSD
    radix passes over the target's bits placed the same way, and each
    target's offset by binary search with its records at slots offset / 32
    + target.  The offsets are the records' -> (offsets (B, n + 1), perm
    (B, M))."""
    b, m = idx.shape
    offs = np.zeros((b, n + 1), np.int64)
    perm = np.full((b, m), -1, np.int64)
    for cb in range(b):
        rows, rec = general_build(idx[cb], n, b)
        rows = rows[rows >= 0]
        perm[cb, :len(rows)] = rows
        live = rec[rec[:, 0] >= 0]
        first = live[np.searchsorted(live[:, 0], np.arange(n))]
        offs[cb, :n] = first[:, 1]
        offs[cb, n] = first[-1, 1] + first[-1, 2]
    return offs, perm


@pytest.mark.parametrize("b,m,n", [(2, 9000, 300), (1, 5000, 32768)])
def test_general_scatter_build_is_the_inverse_graph(b, m, n):
    """The general kernel's build (several units, ids out of range dropped)
    gives `inverse_graph_reference`'s offsets and rows in source order."""
    rng = np.random.default_rng(m + n)
    idx = rng.integers(-3, n + 3, size=(b, m)).astype(np.int32)
    idx[:, ::5] = 2                                      # a hub
    offs, perm = emulate_general_build(idx, n)
    counts, want_offs, want_perm = cuda_scatter.inverse_graph_reference(torch.from_numpy(idx), n)
    np.testing.assert_array_equal(offs, want_offs.numpy())
    np.testing.assert_array_equal(perm, want_perm.numpy())
