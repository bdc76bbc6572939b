"""The kernel wrappers of the port: their dispatch rule, and on a card
each kernel against its plain PyTorch version.

This file imports neither jax nor the JAX package, so the card tests run on
a machine with an NVIDIA GPU and no JAX:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures jax.)
"""
import numpy as np
import pytest
import torch

import chip_smoke
from r3dfsseg_tpu_torch.nn.dgcnn import EdgeConv
from r3dfsseg_tpu_torch.ops import (cuda_attention, cuda_cheby, cuda_fps, cuda_fused_edge,
                                    cuda_gather, cuda_knn, cuda_kth, cuda_proto_cheby,
                                    cuda_scatter)
from torch_port_helpers import cuda_or_skip


def _qkv(dev, shape=(1, 8, 4), dtype=torch.float32):
    return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(3)]


def _fused_pass(name, dev, c=cuda_fused_edge.C, dtype=torch.float32):
    """Pass ``name`` of kernel 9 on zeros of its shapes, (1, 8, 3, c) edges
    of ``dtype``."""
    n_vecs = {"stats1": 2, "fwd": 4, "bwd1": 6, "bwd2": 11, "bwd3": 14}[name]
    dout = [] if name in ("stats1", "fwd") else [torch.zeros((1, 8, c), device=dev)]
    return getattr(cuda_fused_edge, name)(
        torch.zeros((1, 8, 3, c), dtype=dtype, device=dev), *dout,
        *(torch.ones(c, device=dev) for _ in range(n_vecs)), torch.zeros((c, c), device=dev))


# name -> (module, its launch counter, a call on a device)
CALLS = {
    "knn": (cuda_knn, "launches", lambda dev: cuda_knn.knn(torch.zeros((1, 8, 3), device=dev), 4)),
    "attention": (cuda_attention, "launches", lambda dev: cuda_attention.attention(
        *_qkv(dev), 2.0)),
    "attention_train": (cuda_attention, "launches", lambda dev: cuda_attention.attention_fwd(
        *_qkv(dev), 2.0, 0.1, 5)),
    "attention_bwd": (cuda_attention, "bwd_launches", lambda dev: cuda_attention.attention_bwd(
        *_qkv(dev), *_qkv(dev)[:2], torch.zeros((1, 8), device=dev), 2.0, 0.1, 5)),
    "attention_bf16": (cuda_attention, "bf16_launches", lambda dev: cuda_attention.attention(
        *_qkv(dev, (1, 8, 8), torch.bfloat16), 2.0)),
    "attention_bwd_bf16": (cuda_attention, "bwd_bf16_launches",
                           lambda dev: cuda_attention.attention_bwd(
                               *_qkv(dev, (1, 8, 8), torch.bfloat16), *_qkv(dev, (1, 8, 8))[:2],
                               torch.zeros((1, 8), device=dev), 2.0, 0.1, 5)),
    "knn_bf16": (cuda_knn, "bf16_launches", lambda dev: cuda_knn.knn(
        torch.zeros((1, 8, 3), dtype=torch.bfloat16, device=dev), 4)),
    "scatter_add_bf16": (cuda_scatter, "bf16_launches", lambda dev: cuda_scatter.scatter_add(
        torch.zeros((1, 8, 2, 8), dtype=torch.bfloat16, device=dev),
        torch.zeros((1, 8, 2), dtype=torch.int32, device=dev), 8)),
    "fps": (cuda_fps, "launches", lambda dev: cuda_fps.fps(
        torch.zeros((1, 8, 3), device=dev), torch.ones((1, 8), dtype=torch.bool, device=dev), 2)),
    "kth": (cuda_kth, "launches", lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((8, 8), device=dev), 2, 4)),
    "kth_bf16": (cuda_kth, "launches", lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev), 2, 4)),
    "cheby": (cuda_cheby, "launches", lambda dev: cuda_cheby.cheby_solve(
        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev), torch.ones((8, 3), device=dev),
        0.99, 4)),
    "proto_cheby": (cuda_proto_cheby, "launches", lambda dev: cuda_proto_cheby.proto_cheby_solve(
        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev), torch.ones((8, 3), device=dev),
        0.99, 4)),
    "matmul_only": (cuda_proto_cheby, "matmul_only_launches",
                    lambda dev: cuda_proto_cheby.matmul_only(
                        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev),
                        torch.ones((8, 8), device=dev), 3)),
    "scatter_add": (cuda_scatter, "launches", lambda dev: cuda_scatter.scatter_add(
        torch.zeros((1, 8, 2, 8), device=dev), torch.zeros((1, 8, 2), dtype=torch.int32,
                                                          device=dev), 8)),
    "gather_onehot": (cuda_gather, "launches", lambda dev: cuda_gather.gather_onehot(
        torch.zeros((1, 8, 4), device=dev), torch.zeros((1, 8, 2), dtype=torch.int32,
                                                         device=dev))),
    "gather_onehot_bf16": (cuda_gather, "launches", lambda dev: cuda_gather.gather_onehot(
        torch.zeros((1, 8, 8), dtype=torch.bfloat16, device=dev),
        torch.zeros((1, 8, 2), dtype=torch.int32, device=dev))),
    **{f"fused_edge_{p}": (cuda_fused_edge, f"{p}_launches",
                           lambda dev, p=p: _fused_pass(p, dev))
       for p in cuda_fused_edge.PASSES},
    # the fused tail's bf16 form, and every shape past its tuned tile (F2)
    **{f"fused_edge_bf16_{p}": (cuda_fused_edge, f"bf16_{p}_launches",
                                lambda dev, p=p: _fused_pass(p, dev, dtype=torch.bfloat16))
       for p in cuda_fused_edge.PASSES},
    **{f"fused_edge_general_{p}": (cuda_fused_edge, f"general_{p}_launches",
                                   lambda dev, p=p: _fused_pass(p, dev, c=12))
       for p in cuda_fused_edge.PASSES},
    "gather_onehot_narrow": (cuda_gather, "narrow_launches", lambda dev: cuda_gather.gather_onehot(
        torch.zeros((1, 8, 3), device=dev), torch.zeros((1, 8, 2), dtype=torch.int32,
                                                         device=dev))),
    # the shapes past the tuned kernels, and the packed-key kNN
    "knn_general": (cuda_knn, "general_launches", lambda dev: cuda_knn.knn(
        torch.zeros((1, 40, 3), device=dev), 33)),
    "knn_packed": (cuda_knn, "packed_launches", lambda dev: cuda_knn.knn(
        torch.zeros((1, 8, 3), device=dev), 4, packed=True)),
    # f32 past the tuned width: the 3xTF32 kernels in channel groups
    "attention_wide": (cuda_attention, "wide_tf32_launches", lambda dev: cuda_attention.attention(
        *_qkv(dev, (1, 8, 65)), 2.0)),
    "attention_wide_bwd": (cuda_attention, "wide_tf32_bwd_launches",
                           lambda dev: cuda_attention.attention_bwd(
                               *_qkv(dev, (1, 8, 72)), *_qkv(dev, (1, 8, 72))[:2],
                               torch.zeros((1, 8), device=dev), 2.0, 0.1, 5)),
    # bf16 past the tuned width: the wide tensor-core kernels
    "attention_wide_tc": (cuda_attention, "wide_tc_bf16_launches",
                          lambda dev: cuda_attention.attention(
                              *_qkv(dev, (1, 8, 72), torch.bfloat16), 2.0)),
    "attention_wide_tc_bwd": (cuda_attention, "wide_tc_bwd_bf16_launches",
                              lambda dev: cuda_attention.attention_bwd(
                                  *_qkv(dev, (1, 8, 100), torch.bfloat16),
                                  *_qkv(dev, (1, 8, 100))[:2], torch.zeros((1, 8), device=dev),
                                  2.0, 0.1, 5)),
    # bf16 past four channel tiles: the grouped tensor-core kernels
    "attention_wide_group": (cuda_attention, "wide_group_bf16_launches",
                             lambda dev: cuda_attention.attention(
                                 *_qkv(dev, (1, 8, 320), torch.bfloat16), 2.0)),
    "attention_wide_group_bwd": (cuda_attention, "wide_group_bwd_bf16_launches",
                                 lambda dev: cuda_attention.attention_bwd(
                                     *_qkv(dev, (1, 8, 300), torch.bfloat16),
                                     *_qkv(dev, (1, 8, 300))[:2],
                                     torch.zeros((1, 8), device=dev), 2.0, 0.1, 5)),
    "kth_wide": (cuda_kth, "wide_launches", lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((1, 60000), device=dev), 2, 4)),
    "scatter_general": (cuda_scatter, "general_launches", lambda dev: cuda_scatter.scatter_add(
        torch.zeros((1, 8, 2, 7), device=dev), torch.zeros((1, 8, 2), dtype=torch.int32,
                                                          device=dev), 8)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_tensor_takes_the_plain_version(name):
    mod, counter, call = CALLS[name]
    before = getattr(mod, counter)
    call("cpu")
    assert getattr(mod, counter) == before


@pytest.mark.parametrize("name", sorted(CALLS) + ["dropout_mask"])
def test_other_devices_raise(name):
    call = (lambda dev: cuda_attention.dropout_words(1, 8, 0, dev)) if name == "dropout_mask" \
        else CALLS[name][2]
    with pytest.raises(ValueError, match="no kernel for device"):
        call("meta")


def test_shape_limits_ask_the_kernels_fit_entries(monkeypatch):
    """Kernel 7's fit is its own entry's answer for each group of at most
    8 columns (stubbed here: the rule follows whatever it answers), and
    under impl 'auto' the solve of a bf16 S takes kernel 7's wrapper where
    that fits and the plain loop elsewhere, as the JAX package leaves its
    Pallas solve for its XLA loop past 64 MiB of S."""
    from r3dfsseg_tpu_torch.kernels import build
    from r3dfsseg_tpu_torch.ops import lp
    asked = []

    def function(name, argtypes, restype=None):
        if name == "r3d_cheby_fits":
            return lambda m, c, ldk: asked.append((m, c)) or int(m * c <= 1000)
        raise AssertionError(f"unexpected entry {name}")

    monkeypatch.setattr(build, "function", function)
    assert cuda_cheby._groups(9) == [(0, 8), (8, 9)] and cuda_cheby._groups(3) == [(0, 3)]
    assert cuda_cheby.fits(100, 9) and asked == [(100, 8), (100, 1)]
    assert not cuda_cheby.fits(126, 8) and cuda_cheby.fits(125, 8)
    assert not cuda_cheby.fits(0, 3) and not cuda_cheby.fits(10, 0)

    taken = []
    monkeypatch.setattr(cuda_cheby, "cheby_solve", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(cuda_cheby, "cheby_solve_reference", lambda *a: taken.append("plain"))
    monkeypatch.setattr(cuda_cheby, "fits", lambda m, c, device=None: m * c <= 1000)
    s = torch.zeros((1, 1), dtype=torch.bfloat16)
    for m, c, impl in ((100, 9, "auto"), (126, 8, "auto"), (100, 3, "xla")):
        lp._solve(_FakeCuda(m), torch.zeros((m, c)), 0.99, 3, impl)
    assert taken == ["kernel", "plain", "plain"]
    lp._solve(s, torch.zeros((1, 3)), 0.99, 3, "auto")        # a CPU S: the wrapper
    lp._solve(s.float(), torch.zeros((1, 3)), 0.99, 3, "auto")  # an f32 S: the plain loop
    assert taken[3:] == ["kernel", "plain"]


class _FakeCuda:
    """A bf16 (M, M) S that reports a CUDA device, for the routing rule."""
    dtype = torch.bfloat16
    device = torch.device("cuda")

    def __init__(self, m):
        self.shape = (m, m)


def _points(seed, b, n, c):
    x = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    x[0, 11] = x[0, 40]            # exact duplicate: a distance tie
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k", [(2, 200, 9, 20), (1, 130, 64, 5)])
def test_knn_kernel_matches_plain_on_card(b, n, c, k):
    dev = cuda_or_skip()
    x = torch.from_numpy(_points(5, b, n, c)).to(dev)
    before = cuda_knn.launches
    got = cuda_knn.knn(x, k)
    torch.cuda.synchronize()
    assert cuda_knn.launches == before + 1
    torch.testing.assert_close(got, cuda_knn.knn_reference(x, k), rtol=0, atol=0)


@pytest.mark.cuda
def test_fps_kernel_more_instances_than_sms_on_card():
    """A batch of more instances than SMs takes one cooperative launch per
    SM count of instances, with the plain version's seeds."""
    dev = cuda_or_skip()
    p = torch.cuda.get_device_properties(dev).multi_processor_count + 3
    rng = np.random.default_rng(10)
    feat = torch.from_numpy(rng.normal(size=(p, 100, 8)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(p, 100)) < 0.5).to(dev)
    before = cuda_fps.launches
    got = cuda_fps.fps(feat, valid, 6)
    torch.cuda.synchronize()
    assert cuda_fps.launches == before + 2
    assert torch.equal(got, cuda_fps.fps_reference(feat, valid, 6))


# kNN: the flagship shapes (support and query batches, raw points and
# features; the query batch takes key splits), a ragged N, k = 1 and 32, C = 256
KNN_CASES = [(10, 2048, 9, 20), (10, 2048, 64, 20), (2, 2048, 9, 20), (2, 2048, 64, 20),
             (2, 130, 9, 20), (1, 300, 16, 1), (2, 300, 64, 32), (2, 500, 256, 20),
             (1, 130, 200, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k", KNN_CASES)
def test_knn_kernel_flagship_and_edge_shapes_on_card(b, n, c, k):
    """Held to `chip_smoke.knn_agreement`'s criterion (sets differ on at
    most 1e-3 of the rows, each differing neighbour within NEAR_TIE of xx_i
    + xx_j of the k-th distance), two calls bit-equal, one launch per call."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(b * n + c + k)
    x = torch.randn((b, n, c), generator=g, device=dev)
    before = cuda_knn.launches
    got = cuda_knn.knn(x, k)
    again = cuda_knn.knn(x, k)
    torch.cuda.synchronize()
    assert cuda_knn.launches == before + 2
    assert torch.equal(got, again)
    a = chip_smoke.knn_agreement(torch, x, got.long(), cuda_knn.knn_reference(x, k).long())
    assert a["mismatch"] <= 1e-3 and a["gap"] <= chip_smoke.NEAR_TIE, a


@pytest.mark.cuda
def test_knn_query_batch_takes_key_splits_on_card():
    """B = 2, N = 2048 on the card: more than one key split per row tile
    (the merge path), and the result equals the plain version's on points
    whose distances have no near-ties (an integer grid scaled by 1/8: every
    distance is exact in f32, ties are exact and go to the lowest index)."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cuda_knn.splits(2, 2048, sms) > 1
    rng = np.random.default_rng(9)
    x = rng.integers(0, 8, size=(2, 2048, 9)).astype(np.float32) / 8
    x = torch.from_numpy(x).to(dev)
    assert torch.equal(cuda_knn.knn(x, 20), cuda_knn.knn_reference(x, 20))


# attention shapes: the flagship support and query batches (B = 10 and 2,
# whose launches take 2 and 4 key splits), a ragged N, channel counts that
# are not a multiple of 8 (zero-padded in the staged tiles)
ATTENTION_SHAPES = [(10, 2048, 64), (2, 2048, 64), (2, 150, 64), (1, 64, 8), (1, 100, 4),
                    (2, 150, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain_on_card(b, n, d):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(3))
    tau = float(d) ** 0.5
    before = cuda_attention.launches
    got = cuda_attention.attention(q, k, v, tau)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    torch.testing.assert_close(got, cuda_attention.attention_reference(q, k, v, tau),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_fps_kernel_matches_plain_on_card():
    dev = cuda_or_skip()
    rng = np.random.default_rng(7)
    feat = torch.from_numpy(rng.normal(size=(3, 3000, 12)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(3, 3000)) < 0.4).to(dev)
    valid[1] = False
    valid[1, 10:40:3] = True                           # fewer valid points than k
    got = cuda_fps.fps(feat, valid, 20)
    torch.testing.assert_close(got, cuda_fps.fps_reference(feat, valid, 20), rtol=0, atol=0)


# FPS calls of the main paths (a request's two, a training step's third),
# and (1, 50000, 192): 38 MB of features, more than the grid's shared
# memory holds, so the kernel reads them from global memory every round
FPS_CALLS = [(2, 10240, 100), (1, 20480, 100), (10, 2048, 4), (1, 50000, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.25, 0.75])
@pytest.mark.parametrize("p,n,k", FPS_CALLS)
def test_fps_kernel_flagship_calls_on_card(p, n, k, share):
    """Seeds equal to the plain version's, or diverging only at a near-tie
    of the running min distance (the two sum the channels in another
    order); two calls bit-equal; one launch per call."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(p * n + k)
    feat = torch.randn((p, n, 192), generator=g, device=dev)
    valid = torch.rand((p, n), generator=g, device=dev) < share
    before = cuda_fps.launches
    got = cuda_fps.fps(feat, valid, k)
    again = cuda_fps.fps(feat, valid, k)
    torch.cuda.synchronize()
    assert cuda_fps.launches == before + 2
    assert torch.equal(got, again)
    want = cuda_fps.fps_reference(feat, valid, k)
    if not torch.equal(got, want):
        _, gap = chip_smoke._fps_divergence_gap(torch, cuda_fps, feat, valid, got, want)
        assert gap <= chip_smoke.NEAR_TIE


@pytest.mark.cuda
def test_fps_kernel_no_valid_point_and_exhausted_instances_on_card():
    """An instance with no valid point picks index 0 in every slot; one
    whose valid points run out repeats its lowest valid index; duplicate
    points tie across block boundaries (lowest index wins)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(3, 4096, 16)).astype(np.float32)
    feat[2, 2000:2200] = feat[2, 100]                  # duplicates over several blocks
    valid = rng.uniform(size=(3, 4096)) < 0.5
    valid[0] = False
    valid[1] = False
    valid[1, [70, 900, 3000]] = True
    feat, valid = torch.from_numpy(feat).to(dev), torch.from_numpy(valid).to(dev)
    got = cuda_fps.fps(feat, valid, 10)
    assert torch.equal(got, cuda_fps.fps_reference(feat, valid, 10))
    assert not bool(got[0].any())
    assert sorted(got[1, :3].tolist()) == [70, 900, 3000] and bool(got[1, 3:].eq(70).all())


@pytest.mark.cuda
def test_kth_kernel_bit_equals_plain_on_card():
    dev = cuda_or_skip()
    d = np.random.default_rng(0).uniform(0.1, 9.0, size=(300, 700)).astype(np.float32)
    d[:, -4:] = cuda_kth.SENTINEL
    d[0] = cuda_kth.SENTINEL
    d = torch.from_numpy(d).to(dev)
    got = cuda_kth.kth_smallest_per_row(d, 20, 32)
    assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(d, 20, 32))


@pytest.mark.cuda
def test_kth_bf16_kernel_bit_equals_plain_on_card():
    """The bf16 compare copy at a ragged width, 16 steps as the bf16 graph
    runs them."""
    dev = cuda_or_skip()
    d = np.random.default_rng(1).uniform(0.1, 9.0, size=(300, 701)).astype(np.float32)
    d[:, -4:] = cuda_kth.SENTINEL
    d[0] = cuda_kth.SENTINEL
    d = torch.from_numpy(d).to(torch.bfloat16).to(dev)
    before = cuda_kth.launches
    got = cuda_kth.kth_smallest_per_row(d, 20, 16)
    torch.cuda.synchronize()
    assert cuda_kth.launches == before + 1
    assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(d, 20, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", chip_smoke.KTH_KINDS)
def test_kth_kernel_adversarial_rows_bit_equal_on_card(kind, dtype):
    """Rows that break naive selects (`chip_smoke.kth_rows`), 9 rows of a
    ragged width: each row starts at another offset from a 16-byte
    boundary.  Bit-equal to the plain version, two calls bit-equal, one
    launch per call."""
    dev = cuda_or_skip()
    d, k = chip_smoke.kth_rows(kind, 9, 701, seed=len(kind))
    d = torch.from_numpy(d).to(dtype).to(dev)
    iters = 32 if dtype == torch.float32 else 16
    before = cuda_kth.launches
    got = cuda_kth.kth_smallest_per_row(d, k, iters)
    again = cuda_kth.kth_smallest_per_row(d, k, iters)
    torch.cuda.synchronize()
    assert cuda_kth.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(d, k, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kth_kernel_views_and_tiny_rows_on_card(dtype):
    """Rows narrower than one 16-byte load, and a view that starts one
    entry into its storage."""
    dev = cuda_or_skip()
    d = torch.from_numpy(np.random.default_rng(2).uniform(0.1, 9.0, size=(5, 301))
                         .astype(np.float32)).to(dtype).to(dev)
    for x, k in ((d[:, :3], 2), (d[:, :1], 1), (d.reshape(-1)[1:1 + 4 * 300].view(4, 300), 40)):
        got = cuda_kth.kth_smallest_per_row(x, k, 32)
        assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(x, k, 32))


@pytest.mark.cuda
def test_kth_wrapper_routes_rows_by_width_on_card():
    """A row the tuned kernel's shared memory refuses (60000 f32 entries)
    takes the wide variant, where it used to raise; 60000 bf16 entries
    (120 KB) still fit the tuned kernel.  Both bit-equal to the plain
    version."""
    dev = cuda_or_skip()
    for dtype, tuned in ((torch.float32, False), (torch.bfloat16, True)):
        x = torch.rand((2, 60000), device=dev).to(dtype)
        counts = (cuda_kth.launches, cuda_kth.wide_launches)
        got = cuda_kth.kth_smallest_per_row(x, 2, 4)
        torch.cuda.synchronize()
        assert (cuda_kth.launches, cuda_kth.wide_launches) == \
            (counts[0] + tuned, counts[1] + (not tuned))
        assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(x, 2, 4))


def _graph_system(seed, m, dev):
    """A bf16 S (M, M) normalised from a sparse random symmetric affinity,
    and a 3-column right-hand side, as the episode graph gives them."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m), dtype=np.float32) * (rng.random((m, m), dtype=np.float32) < 0.05)
    a = a + a.T
    np.fill_diagonal(a, 0.0)
    r = 1.0 / np.sqrt(a.sum(1) + 1e-16)
    s = torch.from_numpy(a * r[:, None] * r[None, :]).to(torch.bfloat16).to(dev)
    b = np.zeros((m, 3), np.float32)
    b[:100] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 100)]
    return s, torch.from_numpy(b).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4396, 1001])
@pytest.mark.parametrize("iters", [1, 50])
def test_cheby_kernel_matches_plain_on_card(m, iters):
    """The flagship graph's width (8-byte loads) and a ragged one (2-byte
    loads): f32 sums in another order over iters - 1 matvecs, within 1e-4
    of the solution's largest entry; one launch count per solve."""
    dev = cuda_or_skip()
    s, b = _graph_system(m, m, dev)
    before = cuda_cheby.launches
    got = cuda_cheby.cheby_solve(s, b, 0.99, iters)
    torch.cuda.synchronize()
    assert cuda_cheby.launches == before + 1
    want = cuda_cheby.cheby_solve_reference(s, b, 0.99, iters)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# kernel 7: the one-query 2-, 3- and 4-way episode graphs, then ragged M
# (2-byte loads of S) at every column count
CHEBY_SPLIT_CASES = [(4396, 3), (6544, 4), (8692, 5)] + [(m, c) for m in (1001, 37)
                                                        for c in range(1, 9)]


def _label_system(seed, m, c, dev):
    """A bf16 S (M, M) normalised from a sparse random symmetric affinity,
    and c label columns over its first 100 rows."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m), dtype=np.float32) * (rng.random((m, m), dtype=np.float32) < 0.05)
    a = a + a.T
    r = 1.0 / np.sqrt(a.sum(1) + 1e-16)
    s = torch.from_numpy(a * r[:, None] * r[None, :]).to(torch.bfloat16).to(dev)
    b = np.zeros((m, c), np.float32)
    b[: min(m, 100)] = np.eye(c, dtype=np.float32)[rng.integers(0, c, min(m, 100))]
    return s, torch.from_numpy(b).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", CHEBY_SPLIT_CASES)
@pytest.mark.parametrize("iters", [1, 3, 50])
def test_cheby_kernel_matches_split_plain_on_card(m, c, iters):
    """Kernel 7 against its plain version (`cheby_solve_split_reference`,
    the same split-bf16 arithmetic): within 1e-5 of max |x| at 1 and 3
    steps, 1e-4 at 50 (f32 sums in another order; after many steps a lo
    piece can round the other way); one cooperative launch per solve, two
    solves bit-equal."""
    dev = cuda_or_skip()
    s, b = _label_system(m + c, m, c, dev)
    before = cuda_cheby.launches
    got = cuda_cheby.cheby_solve(s, b, 0.99, iters)
    again = cuda_cheby.cheby_solve(s, b, 0.99, iters)
    torch.cuda.synchronize()
    assert cuda_cheby.launches == before + 2
    assert torch.equal(got, again)
    want = cuda_cheby.cheby_solve_split_reference(s, b, 0.99, iters)
    tol = 1e-4 if iters == 50 else 1e-5
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(64, 9), (7000, 8)])
def test_cheby_wrapper_refuses_what_does_not_fit_on_card(m, c):
    """What one launch of kernel 7 refuses: 9 columns take two launches (8
    + 1), each group's solve equal to its own call bit for bit; 7000 rows
    of 8 columns (both pieces of d and r, d, x of a block's rows take more
    than 227 KB of shared memory) raise, with no launch."""
    dev = cuda_or_skip()
    s, b = _label_system(m + c, m, c, dev)
    launched = cuda_cheby.launches
    if c <= cuda_cheby.MAX_COLS:
        with pytest.raises(ValueError, match="unsupported shape"):
            cuda_cheby.cheby_solve(s, b, 0.99, 3)
        assert cuda_cheby.launches == launched
        return
    got = cuda_cheby.cheby_solve(s, b, 0.99, 3)
    torch.cuda.synchronize()
    assert cuda_cheby.launches == launched + 2
    groups = [cuda_cheby.cheby_solve(s, b[:, :8].contiguous(), 0.99, 3),
              cuda_cheby.cheby_solve(s, b[:, 8:].contiguous(), 0.99, 3)]
    assert torch.equal(got, torch.cat(groups, 1))
    want = cuda_cheby.cheby_solve_reference(s, b, 0.99, 3)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4396, 1001])
def test_proto_cheby_bit_equal_across_a_cheby_call_on_card(m):
    """Kernels 7 and 10 share one tile code: a kernel 7 solve between two
    kernel 10 solves leaves kernel 10's result unchanged, bit for bit."""
    dev = cuda_or_skip()
    s, b = _graph_system(m, m, dev)
    first = cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, 50)
    cuda_cheby.cheby_solve(s, b, 0.99, 50)
    assert torch.equal(first, cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, 50))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4396, 1001, 37])
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("iters", [1, 3, 50])
def test_proto_cheby_kernel_matches_plain_on_card(m, c, iters):
    """Kernel 10 at the flagship width (8-byte loads of S), a ragged one and
    a tiny one (2-byte loads), 1 to 8 label columns: within 1e-5 of max |x|
    at 1 and 3 steps, 5e-3 at 50 (its f32 sums run in another order, so a d
    entry near a bf16 rounding boundary can round the other way and the
    flip carries through later steps); one cooperative launch per solve."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(m + c)
    a = rng.random((m, m), dtype=np.float32) * (rng.random((m, m), dtype=np.float32) < 0.05)
    a = a + a.T
    r = 1.0 / np.sqrt(a.sum(1) + 1e-16)
    s = torch.from_numpy(a * r[:, None] * r[None, :]).to(torch.bfloat16).to(dev)
    b = np.zeros((m, c), np.float32)
    b[: min(m, 100)] = np.eye(c, dtype=np.float32)[rng.integers(0, c, min(m, 100))]
    b = torch.from_numpy(b).to(dev)
    before = cuda_proto_cheby.launches
    got = cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, iters)
    torch.cuda.synchronize()
    assert cuda_proto_cheby.launches == before + 1
    want = cuda_proto_cheby.proto_cheby_solve_reference(s, b, 0.99, iters)
    tol = 5e-3 if iters == 50 else 1e-5
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4396, 1001])
@pytest.mark.parametrize("resident_rows", [0, 16, 24])
def test_proto_cheby_resident_rows_change_no_bit_on_card(m, resident_rows):
    """Rows of S kept in registers or shared memory feed the same products
    in the same order as rows read from L2: capping the rows kept on chip
    (none; one register tile; a register tile and 8 shared-memory rows)
    changes no bit of the solve."""
    dev = cuda_or_skip()
    s, b = _graph_system(m, m, dev)
    got = cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, 50)
    assert torch.equal(got, cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, 50,
                                                                 resident_rows=resident_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4480, 1000, 1001, cuda_proto_cheby.MAX_PROBE_M])
@pytest.mark.parametrize("ncols", [8, 24, 120, 128])
@pytest.mark.parametrize("iters", [3, 500])
def test_matmul_only_kernel_matches_plain_on_card(m, ncols, iters):
    """Kernel 11 on S uniform in [0, 1) scaled by 1 / its row sums (the
    archive's unscaled S overflows f32 within ~12 steps) and a normal b:
    within 1e-4 of max at 3 steps, 5e-3 at 500; one launch per call, a
    second call bit-equal.  M = 1001 loads S in 2-byte pieces (not a
    multiple of 8); MAX_PROBE_M is the largest M the wrapper takes."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(m + ncols)
    a = rng.random((m, m), dtype=np.float32)
    s = torch.from_numpy(a / a.sum(1, keepdims=True)).to(torch.bfloat16).to(dev)
    del a
    b = torch.from_numpy(rng.normal(size=(m, ncols)).astype(np.float32)).to(dev)
    before = cuda_proto_cheby.matmul_only_launches
    got = cuda_proto_cheby.matmul_only(s, b, iters)
    torch.cuda.synchronize()
    assert cuda_proto_cheby.matmul_only_launches == before + 1
    assert torch.equal(got, cuda_proto_cheby.matmul_only(s, b, iters))
    want = cuda_proto_cheby.matmul_only_reference(s, b, iters)
    tol = 5e-3 if iters == 500 else 1e-4
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cheby_c129", "probe_ncols129", "cheby_strided_s",
                                  "probe_strided_s", "probe_iters0", "probe_m_past_range"])
def test_proto_cheby_wrappers_raise_on_card(case):
    """What the kernels do not take raises: 129 live columns (the archives
    pad to 128), a non-contiguous S, no step, an M past MAX_PROBE_M."""
    dev = cuda_or_skip()
    s = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    strided = torch.zeros((64, 128), dtype=torch.bfloat16, device=dev)[:, ::2]
    calls = {
        "cheby_c129": lambda: cuda_proto_cheby.proto_cheby_solve(
            s, torch.ones((64, 129), device=dev), 0.99, 3),
        "probe_ncols129": lambda: cuda_proto_cheby.matmul_only(
            s, torch.ones((64, 129), device=dev), 3),
        "cheby_strided_s": lambda: cuda_proto_cheby.proto_cheby_solve(
            strided, torch.ones((64, 3), device=dev), 0.99, 3),
        "probe_strided_s": lambda: cuda_proto_cheby.matmul_only(
            strided, torch.ones((64, 8), device=dev), 3),
        "probe_iters0": lambda: cuda_proto_cheby.matmul_only(
            s, torch.ones((64, 8), device=dev), 0),
        "probe_m_past_range": lambda: cuda_proto_cheby.matmul_only(
            torch.zeros((cuda_proto_cheby.MAX_PROBE_M + 1,) * 2, dtype=torch.bfloat16, device=dev),
            torch.ones((cuda_proto_cheby.MAX_PROBE_M + 1, 8), device=dev), 3)}
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seed", [(2, 130, 0), (3, 64, 2**40 + 17)])
def test_dropout_mask_bits_equal_plain_on_card(b, n, seed):
    dev = cuda_or_skip()
    got = cuda_attention.dropout_words(b, n, seed, dev).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, cuda_attention.dropout_words_reference(b, n, seed, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,rate", [(2, 150, 64, 0.1), (1, 64, 8, 0.0), (2, 100, 16, 0.5),
                                        (10, 2048, 64, 0.1), (2, 2048, 64, 0.1),
                                        (1, 100, 4, 0.1), (2, 150, 12, 0.0)])
def test_attention_train_kernels_match_plain_on_card(b, n, d, rate):
    """Forward (y, lse) rtol 1e-4 / atol 1e-5; backward dq, dk, dv against
    torch autograd of the plain masked forward, within 1e-4 of each
    gradient's largest entry (f32 sums in another order)."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, dy = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(4))
    tau, seed = float(d) ** 0.5, 99
    fwd_before, bwd_before = cuda_attention.launches, cuda_attention.bwd_launches
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    want_y, want_lse = cuda_attention.attention_fwd_reference(q, k, v, tau, rate, seed)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_attention.attention_reference(*leaves, tau, rate, seed).backward(dy)
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, rtol=1e-4, atol=1e-4 * t.grad.abs().max().item())
    torch.cuda.synchronize()
    assert cuda_attention.launches == fwd_before + 1
    assert cuda_attention.bwd_launches == bwd_before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", ATTENTION_SHAPES)
def test_attention_backward_repeats_bit_for_bit_on_card(b, n, d):
    """No float atomics: two backward calls on the same inputs give dq, dk
    and dv equal bit for bit, one launch count each."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, dy = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(4))
    tau = float(d) ** 0.5
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, 0.1, 7)
    before = cuda_attention.bwd_launches
    first = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, 0.1, 7)
    second = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, 0.1, 7)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,c", [(2, 300, 20, 64), (1, 64, 5, 8)])
def test_scatter_add_kernel_matches_plain_on_card(b, n, k, c):
    """f32 sums in another order than `index_add_`: |err| <= 1e-5 * sum |g|."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(b, n, k, c)).astype(np.float32)).to(dev)
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    idx[:, :, 0] = 7                                   # a hub every row points at
    idx = torch.from_numpy(idx).to(dev)
    got = cuda_scatter.scatter_add(g, idx, n)
    want = cuda_scatter.scatter_add_reference(g, idx, n)
    bound = 1e-5 * cuda_scatter.scatter_add_reference(g.abs(), idx, n)
    assert bool(((got - want).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k,c", [(2, 300, 20, 64), (1, 64, 5, 8)])
def test_gather_kernel_bit_equals_plain_on_card(b, n, k, c, dtype):
    dev = cuda_or_skip()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, n, size=(b, n, k)).astype(np.int32)).to(dev)
    before = cuda_gather.launches
    got = cuda_gather.gather_onehot(x, idx)
    torch.cuda.synchronize()
    assert cuda_gather.launches == before + 1
    assert torch.equal(got, cuda_gather.gather_onehot_reference(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("b,n,k", [(2, 256, 20), (1, 40, 5)])
def test_fused_edge_passes_match_plain_on_card(b, n, k, train):
    """Each pass of kernel 9 on a block's e_raw, with the arguments the
    tail builds (`chip_smoke.fused_pass_args`): stats1 and fwd within 1e-5
    of each output's largest entry, the backward outputs within 1e-4."""
    dev = cuda_or_skip()
    torch.manual_seed(0)
    block = EdgeConv(9, (64, 64), k=k).to(dev)
    with torch.no_grad():
        for layer in (block.layer0, block.layer1):
            layer.bn.weight.uniform_(0.5, 1.5)
            layer.bn.bias.normal_(0.0, 0.1)
            layer.bn.running_mean.normal_(0.0, 0.5)
            layer.bn.running_var.uniform_(0.5, 1.5)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(b, n, 9)).astype(np.float32))
    _, _, e, w1 = chip_smoke.edge_operands(torch, block, x.to(dev))
    dout = torch.randn((b, n, 64), device=dev)
    args, _ = chip_smoke.fused_pass_args(torch, cuda_fused_edge, block, e, w1, dout, train)
    for name, a in args.items():
        before = getattr(cuda_fused_edge, f"{name}_launches")
        got = getattr(cuda_fused_edge, name)(*a)
        want = getattr(cuda_fused_edge, f"{name}_reference")(*a)
        torch.cuda.synchronize()
        assert getattr(cuda_fused_edge, f"{name}_launches") == before + 1
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max()), name


def _fused_args(b, n, k, c, train, dtype, dev, seed=0):
    """Each kernel-9 pass's arguments on an EdgeConv (9 -> c, c) block's
    e_raw of ``dtype``, as the tail builds them (`chip_smoke.fused_pass_args`)."""
    torch.manual_seed(seed)
    block = EdgeConv(9, (c, c), k=k).to(dev)
    with torch.no_grad():
        for layer in (block.layer0, block.layer1):
            layer.bn.weight.uniform_(0.5, 1.5)
            layer.bn.bias.normal_(0.0, 0.1)
            layer.bn.running_mean.normal_(0.0, 0.5)
            layer.bn.running_var.uniform_(0.5, 1.5)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.normal(size=(b, n, 9)).astype(np.float32)).to(dev)
    _, _, e, w1 = chip_smoke.edge_operands(torch, block, x)
    dout = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev)
    return chip_smoke.fused_pass_args(torch, cuda_fused_edge, block, e.to(dtype), w1, dout,
                                      train)[0]


def _fused_launches():
    return chip_smoke.fused_counts(cuda_fused_edge)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("b,n,k", [(2, 256, 20), (1, 40, 5)])
def test_fused_edge_bf16_bit_equals_the_f32_form_on_card(b, n, k, train):
    """Kernel 9 on a bf16 e: the tuned kernel's bf16 form (its own counter
    moves, the general kernel's not), each pass bit for bit the f32 form on
    e's upcast, d_e after one rounding to bf16."""
    dev = cuda_or_skip()
    args = _fused_args(b, n, k, 64, train, torch.bfloat16, dev)
    for name, a in args.items():
        before = _fused_launches()
        got = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(*a))
        torch.cuda.synchronize()
        moved = {m: c - before[m] for m, c in _fused_launches().items() if c != before[m]}
        assert moved == {name: 1, f"bf16_{name}": 1}, moved
        up = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(a[0].float(), *a[1:]))
        for g, u in zip(got, up):
            assert g.dtype == (torch.bfloat16 if name == "bwd3" else torch.float32)
            assert torch.equal(g, u.to(g.dtype)), name


# shapes past the tuned tile: C != 64, K past shared memory, B * N not a
# multiple of 8 (B, N, K, C); K = 1 at C = 2 (at C = 1 the train-mode BN1
# gradient is orthogonal to h0, so dW1 is zero but for rounding and has no
# scale to hold an error to)
FUSED_F2_CARD = [(1, 12, 9, 12), (1, 12, 9, 7), (2, 100, 20, 63), (1, 100, 64, 64),
                 (3, 7, 3, 130), (1, 5, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k,c", FUSED_F2_CARD)
def test_fused_edge_general_kernel_f2_shapes_on_card(b, n, k, c, dtype):
    """The general kernel 9 (`csrc/fused_edge_general.cu`): its counter
    moves once per call and the tuned kernel's not (where the tuned tile
    fits the K it is given, as stats1 at K = 64, the tuned kernel's); a
    second call is
    bit-equal; each output has the plain version's type and lies within
    the tuned kernel's tolerances of it (stats1, fwd 1e-5 of the largest
    entry; backward 1e-4; a bf16 d_e may sit one bf16 step from it where
    the two f32 values straddle a rounding edge, `chip_smoke.output_error`),
    train and eval."""
    dev = cuda_or_skip()
    for train in (True, False):
        for name, a in _fused_args(b, n, k, c, train, dtype, dev, seed=c + k).items():
            before = _fused_launches()
            got = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(*a))
            again = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(*a))
            torch.cuda.synchronize()
            moved = {m: v - before[m] for m, v in _fused_launches().items() if v != before[m]}
            if chip_smoke.fused_tuned_takes(name, b, n, k, c):     # stats1 at K = 64
                assert moved == ({name: 2, f"bf16_{name}": 2} if dtype == torch.bfloat16
                                 else {name: 2}), moved
            else:
                assert moved == {f"general_{name}": 2}, moved
            want = chip_smoke._as_tuple(getattr(cuda_fused_edge, f"{name}_reference")(*a))
            tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
            for g, g2, w in zip(got, again, want):
                assert torch.equal(g, g2) and g.dtype == w.dtype and g.shape == w.shape, name
                chip_smoke.output_error(g, w, tol, f"{name} train={train}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_edge_general_kernel_matches_the_tuned_one_on_card(dtype):
    """At a shape both take (C = 64, B * N a multiple of 8), the general
    kernel, forced by `general_only`, within the tuned kernel's tolerances
    of the tuned kernel."""
    dev = cuda_or_skip()
    for train in (True, False):
        for name, a in _fused_args(2, 256, 20, 64, train, dtype, dev).items():
            before = _fused_launches()
            with cuda_fused_edge.general_only():
                got = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(*a))
            torch.cuda.synchronize()
            moved = {m: v - before[m] for m, v in _fused_launches().items() if v != before[m]}
            assert moved == {f"general_{name}": 1}, moved
            want = chip_smoke._as_tuple(getattr(cuda_fused_edge, name)(*a))
            tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
            for g, w in zip(got, want):
                assert float((g.float() - w.float()).abs().max()) <= \
                    tol * float(w.float().abs().max()), (name, train)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(63, torch.float32), (60, torch.bfloat16),
                                     (63, torch.bfloat16), (1, torch.float32),
                                     (3, torch.bfloat16)])
def test_gather_kernel_narrow_rows_bit_equal_on_card(c, dtype):
    """Kernel 8 on rows that are not a multiple of 16 bytes (4- and 2-byte
    pieces): bit-equal to the plain version, one narrow launch per call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(2, 300, c)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, 300, size=(2, 300, 20)).astype(np.int32)).to(dev)
    counts = (cuda_gather.launches, cuda_gather.narrow_launches)
    got = cuda_gather.gather_onehot(x, idx)
    torch.cuda.synchronize()
    assert (cuda_gather.launches, cuda_gather.narrow_launches) == (counts[0], counts[1] + 1)
    assert torch.equal(got, cuda_gather.gather_onehot_reference(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(c, dt) for c in (1, 3, 7, 60, 63)
                                     for dt in (torch.float32, torch.bfloat16)
                                     if (c, dt) != (60, torch.float32)])
def test_gather_kernel_narrow_ragged_and_misaligned_on_card(c, dtype):
    """Kernel 8's narrow groups on 333 rows (a ragged last group at every
    G: the tail's halfwords), ids outside [0, N) (zero rows), on a table
    one element past an aligned start (bf16: 2 bytes past a 4-byte
    boundary) and on an aligned one:
    bit-equal to the plain version on the ids in [0, N), one narrow launch a
    call, and the bytes past the output untouched."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 100)
    b, n, nq, k = 3, 50, 37, 3
    vals = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev, dtype)
    idx = rng.integers(0, n, size=(b, nq, k)).astype(np.int32)
    idx[0, 0, 0], idx[-1, -1, -1], idx[1, 2, 1] = -1, n, 2**31 - 1
    ok = torch.from_numpy((idx >= 0) & (idx < n)).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    want = torch.where(ok[..., None], cuda_gather.gather_onehot_reference(
        vals, torch.where(ok, idx, 0)), torch.zeros((), dtype=dtype, device=dev))
    for shift in (0, 1):        # elements: a bf16 table 2 bytes off a 4-byte boundary
        store = torch.empty(vals.numel() + shift, dtype=dtype, device=dev)
        x = store[shift:].view(b, n, c)
        x.copy_(vals)
        before = (cuda_gather.launches, cuda_gather.narrow_launches)
        got = cuda_gather.gather_onehot(x, idx)
        torch.cuda.synchronize()
        assert (cuda_gather.launches, cuda_gather.narrow_launches) == (before[0], before[1] + 1)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    out = torch.full((b * nq * k * c + 64,), 7, dtype=dtype, device=dev)
    fn = cuda_gather.build.function("r3d_gather_rows_narrow",
                                    [cuda_gather.build.P] * 3 + [cuda_gather.build.I] * 4
                                    + [cuda_gather.build.P])
    vc = vals.contiguous()
    cuda_gather.build.check(fn(vc.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, nq * k,
                               c * vals.element_size(), cuda_gather.build.stream_ptr(dev)),
                            "r3d_gather_rows_narrow")
    torch.cuda.synchronize()
    assert torch.equal(out[:b * nq * k * c].view(b, nq, k, c), want)
    assert bool((out[b * nq * k * c:] == 7).all())


def _bf16_points(seed, b, n, c, dev):
    """bf16 points with an exact duplicate (a distance tie)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, c), generator=g, device=dev).to(torch.bfloat16)
    x[0, 11] = x[0, n // 2]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("n", [130, 1000, 2048])
@pytest.mark.parametrize("c", [9, 63, 64, 200])
def test_knn_bf16_route_bit_equals_the_upcast_route_on_card(c, n, k):
    """Kernel 1's bf16 route (bf16 tiles, one tensor-core pass) against the
    f32 route on the input's upcast: bit-equal, at B = 2 (key splits) and
    at the least B that takes one scan (no splits); one launch and one
    bf16 launch a call, no general kernel."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-n // cuda_knn.ROWS)
    many = -(-9 * sms // (5 * tiles))
    assert cuda_knn.splits(2, n, sms) > 1 and cuda_knn.splits(many, n, sms) == 1
    for b in (2, many):
        x = _bf16_points(c * n + k + b, b, n, c, dev)
        before = (cuda_knn.launches, cuda_knn.bf16_launches, cuda_knn.general_launches)
        got = cuda_knn.knn(x, k)
        torch.cuda.synchronize()
        assert (cuda_knn.launches, cuda_knn.bf16_launches, cuda_knn.general_launches) == \
            (before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(got, cuda_knn.knn(x.float(), k)), (b, n, c, k)


@pytest.mark.cuda
def test_knn_bf16_route_past_its_limits_takes_the_general_kernel_on_card():
    """A bf16 input with k > 32 or C > 256 goes, upcast, to the general
    kernel, as an f32 input does, with the same output."""
    dev = cuda_or_skip()
    for c, k in ((64, 40), (300, 20)):
        x = _bf16_points(c + k, 2, 300, c, dev)
        before = (cuda_knn.bf16_launches, cuda_knn.general_launches)
        got = cuda_knn.knn(x, k)
        torch.cuda.synchronize()
        assert (cuda_knn.bf16_launches, cuda_knn.general_launches) == (before[0],
                                                                       before[1] + 1)
        assert torch.equal(got, cuda_knn.knn(x.float(), k))


@pytest.mark.cuda
def test_knn_kernel_attributes_on_card():
    """Both routes report registers, no more spill than the f32 route's few
    bytes, and at least the f32 route's three blocks an SM."""
    cuda_or_skip()
    for k in (8, 20, 32):
        f32 = cuda_knn.kernel_attributes(k, bf16=False)
        bf16 = cuda_knn.kernel_attributes(k, bf16=True)
        assert f32["registers"] > 0 and bf16["registers"] > 0
        assert bf16["blocks_per_sm"] >= f32["blocks_per_sm"] >= 3, (f32, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [9, 16, 128])
def test_proto_cheby_more_than_eight_columns_on_card(c):
    """Kernel 10 on more than 8 columns: one launch per group of 8, equal
    bit for bit to the groups solved alone, within 1e-3 of max of the plain
    version at 50 steps."""
    dev = cuda_or_skip()
    s, _ = _graph_system(c, 1001, dev)
    labels = np.random.default_rng(c).integers(0, c, 300)
    b = torch.from_numpy(np.eye(c, dtype=np.float32)[labels]).to(dev)
    b = torch.cat([b, torch.zeros((701, c), device=dev)])
    before = cuda_proto_cheby.launches
    got = cuda_proto_cheby.proto_cheby_solve(s, b, 0.99, 50)
    torch.cuda.synchronize()
    assert cuda_proto_cheby.launches == before + -(-c // 8)
    groups = [cuda_proto_cheby.proto_cheby_solve(s, b[:, lo:lo + 8].contiguous(), 0.99, 50)
              for lo in range(0, c, 8)]
    assert torch.equal(got, torch.cat(groups, 1))
    want = cuda_proto_cheby.proto_cheby_solve_reference(s, b, 0.99, 50)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 12, 127])
def test_matmul_only_any_ncols_on_card(ncols):
    """Kernel 11 at a column count that is not a multiple of 8: one launch,
    the columns of a call zero-padded to a multiple of 8 bit for bit (each
    column's sums do not depend on the others), within 1e-4 of max of the
    plain version at 3 steps."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(ncols)
    a = rng.random((1000, 1000), dtype=np.float32)
    s = torch.from_numpy(a / a.sum(1, keepdims=True)).to(torch.bfloat16).to(dev)
    b = torch.from_numpy(rng.normal(size=(1000, ncols)).astype(np.float32)).to(dev)
    before = cuda_proto_cheby.matmul_only_launches
    got = cuda_proto_cheby.matmul_only(s, b, 3)
    torch.cuda.synchronize()
    assert cuda_proto_cheby.matmul_only_launches == before + 1 and got.shape == b.shape
    padded = torch.nn.functional.pad(b, (0, -ncols % 8))
    assert torch.equal(got, cuda_proto_cheby.matmul_only(s, padded, 3)[:, :ncols])
    want = cuda_proto_cheby.matmul_only_reference(s, b, 3)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_fused_route_matches_unfused_block_on_card():
    """The fused route (kernels 8, 9, the scatter-add) through one block
    against the module: outputs and gradients (relative L2 1e-3) under a
    cotangent that is zero on near-ties of the max."""
    dev = cuda_or_skip()
    torch.manual_seed(2)
    block = EdgeConv(9, (64, 64), k=20).to(dev)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 512, 9)).astype(np.float32))
    xu = x.to(dev).requires_grad_()
    out_u, _, edges = chip_smoke.unfused_edgeconv(block, xu, True)
    w = torch.randn(out_u.shape, device=dev) * ~chip_smoke.near_ties(torch, edges)[1]
    (out_u * w).sum().backward()
    want = [xu.grad.clone()] + [p.grad.clone() for p in block.parameters()]
    block.zero_grad(set_to_none=True)
    xf = x.to(dev).requires_grad_()
    out_f, _ = chip_smoke.fused_edgeconv(block, xf, True)
    (out_f * w).sum().backward()
    got = [xf.grad] + [p.grad for p in block.parameters()]
    torch.testing.assert_close(out_f, out_u, rtol=1e-5, atol=1e-5 * out_u.abs().max().item())
    for g, r in zip(got, want):
        assert float((g - r).norm() / r.norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b", [10, 2])
@pytest.mark.parametrize("graph", ["knn", "hub", "out_of_range"])
def test_scatter_add_kernel_flagship_on_card(b, graph):
    """The training step's two batch shapes (B, 2048, 20, 64) on kNN graphs of
    random clouds; with a hub that every row points at (2048 rows: 64
    pieces merged in order); with ids outside [0, N), which are dropped.
    Within 1e-5 * sum |g| of `index_add_` over the in-range rows, bit-equal
    to the kernel's order of sums emulated in PyTorch and across two calls,
    one launch per call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.normal(size=(b, 2048, 9)).astype(np.float32)).to(dev)
    idx = cuda_knn.knn_reference(x, 20)
    if graph == "hub":
        idx[:, :, 1] = 5
    elif graph == "out_of_range":
        bad = torch.from_numpy(rng.random(size=tuple(idx.shape)) < 0.01).to(dev)
        idx = torch.where(bad, torch.full_like(idx, 2048), idx)
        idx[:, :7, 0] = -3
    g = torch.from_numpy(rng.normal(size=(*idx.shape, 64)).astype(np.float32)).to(dev)
    before = cuda_scatter.launches
    got = cuda_scatter.scatter_add(g, idx, 2048)
    again = cuda_scatter.scatter_add(g, idx, 2048)
    torch.cuda.synchronize()
    assert cuda_scatter.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, cuda_scatter.scatter_add_ordered_reference(g, idx, 2048))
    ok = ((idx >= 0) & (idx < 2048))
    gv, iv = g * ok[..., None], torch.where(ok, idx, torch.zeros_like(idx))
    want = cuda_scatter.scatter_add_reference(gv, iv, 2048)
    bound = 1e-5 * cuda_scatter.scatter_add_reference(gv.abs(), iv, 2048)
    assert bool(((got - want).abs() <= bound + 1e-30).all())


# ------------------------------------------------ F1: shape limits under auto --
@pytest.mark.cuda
def test_cheby_graph_past_the_kernel_takes_the_plain_solve_on_card():
    """M = 20000 at C = 3 (kernel 7 refuses M >= 17233 at 3 columns; the JAX
    package takes its XLA loop past 64 MiB of S): the Chebyshev solve under
    impl 'auto' takes the plain loop, within CHEBY_TOL of
    `cheby_solve_reference` (it is that function), with no launch."""
    from r3dfsseg_tpu_torch.ops import lp
    dev = cuda_or_skip()
    s, b = _label_system(7, 20000, 3, dev)
    assert not cuda_cheby.fits(20000, 3, s.device)
    launched = cuda_cheby.launches
    got = lp._solve(s, b, 0.99, 50, "auto")
    torch.cuda.synchronize()
    assert cuda_cheby.launches == launched
    want = cuda_cheby.cheby_solve_reference(s, b, 0.99, 50)
    assert float((got - want).abs().max()) <= chip_smoke.CHEBY_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_cheby_nine_columns_at_the_flagship_graph_take_two_launches_on_card():
    """An 8-way episode's 9 label columns at the flagship M: two launches
    under impl 'auto', within CHEBY_TOL of the f32-product plain version."""
    from r3dfsseg_tpu_torch.ops import lp
    dev = cuda_or_skip()
    s, b = _label_system(8, 4396, 9, dev)
    launched = cuda_cheby.launches
    got = lp._solve(s, b, 0.99, 50, "auto")
    torch.cuda.synchronize()
    assert cuda_cheby.launches == launched + 2
    want = cuda_cheby.cheby_solve_reference(s, b, 0.99, 50)
    assert float((got - want).abs().max()) <= chip_smoke.CHEBY_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k", [(2, 2048, 9, 40), (2, 2048, 64, 40), (2, 2048, 320, 20),
                                     (1, 300, 16, 300), (2, 130, 300, 33), (2, 300, 9, 40),
                                     (2, 300, 300, 20)])
def test_knn_general_kernel_f1_shapes_on_card(b, n, c, k):
    """The general kernel at the F1 shapes (k = 40 at the flagship N and
    at N = 300, C = 320 and 300, k = N, ragged N): `knn_agreement`'s criterion, two calls
    bit-equal, one general launch per call and no tuned one."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(b * n + c + k)
    x = torch.randn((b, n, c), generator=g, device=dev)
    counts = (cuda_knn.launches, cuda_knn.general_launches)
    got = cuda_knn.knn(x, k)
    again = cuda_knn.knn(x, k)
    torch.cuda.synchronize()
    assert (cuda_knn.launches, cuda_knn.general_launches) == (counts[0], counts[1] + 2)
    assert torch.equal(got, again)
    a = chip_smoke.knn_agreement(torch, x, got.long(), cuda_knn.knn_reference(x, k).long())
    assert a["mismatch"] <= 1e-2 and a["gap"] <= chip_smoke.NEAR_TIE, a


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,n", [(40, 9, 2048), (20, 300, 500), (2600, 3, 2700)])
def test_knn_general_kernel_exact_ties_on_card(k, c, n):
    """On an integer grid scaled by 1/8 every distance is exact in f32:
    the general kernel equals the plain version, ties to the lowest index;
    k = 2600 keeps its lists in device memory."""
    dev = cuda_or_skip()
    x = np.random.default_rng(k + c).integers(0, 8, size=(1, n, c)).astype(np.float32) / 8
    x = torch.from_numpy(x).to(dev)
    assert torch.equal(cuda_knn.knn(x, k), cuda_knn.knn_reference(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k", [(10, 2048, 9, 20), (2, 2048, 64, 20), (2, 300, 300, 40)])
def test_knn_packed_kernel_on_card(b, n, c, k):
    """The packed-key mode (knn_impl 'pallas'): on integer points equal to
    `knn_packed_reference`; on float points at most PACKED_MISMATCH of the
    rows differ, each explained by the rounding of the distances
    (`chip_smoke.packed_agreement`), and two calls are bit-equal with one
    packed launch each."""
    dev = cuda_or_skip()
    xi = np.random.default_rng(n + c).integers(-4, 5, size=(b, n, c)).astype(np.float32)
    xi = torch.from_numpy(xi).to(dev)
    assert torch.equal(cuda_knn.knn(xi, k, packed=True), cuda_knn.knn_packed_reference(xi, k))
    g = torch.Generator(device=dev).manual_seed(b + n + c)
    x = torch.randn((b, n, c), generator=g, device=dev)
    before = cuda_knn.packed_launches
    got = cuda_knn.knn(x, k, packed=True)
    again = cuda_knn.knn(x, k, packed=True)
    torch.cuda.synchronize()
    assert cuda_knn.packed_launches == before + 2 and torch.equal(got, again)
    a = chip_smoke.packed_agreement(torch, cuda_knn, x, got, cuda_knn.knn_packed_reference(x, k))
    assert a["unexplained"] == 0 and a["mismatch"] <= chip_smoke.PACKED_MISMATCH, a


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k,packed", [
    (2, 2048, 9, 20, True), (2, 2048, 64, 40, False),      # key splits; registers, shared lists
    (2, 2048, 64, 100, True), (10, 2048, 9, 70, False),    # shared-memory lists past k = 64
    (2, 1000, 300, 40, False), (2, 2048, 300, 20, True),   # C past 256: queries staged per chunk
])
def test_knn_general_kernel_splits_long_lists_and_wide_rows_on_card(b, n, c, k, packed):
    """The general kernel's paths: key splits at B = 2 (the last block of a
    row tile merging the splits' lists) and none at B = 10, lists in
    shared memory past k = 64, and C past 256.  On a grid
    of multiples of 1/8 every distance is exact in f32 and ties abound:
    equal to the plain version (ties to the lowest index, or the packed
    keys' column order), one launch of the route's counter per call, two
    calls bit-equal."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (cuda_knn.splits(b, n, sms) > 1) == (b == 2)
    x = np.random.default_rng(b + n + c + k).integers(-4, 5, size=(b, n, c)).astype(np.float32)
    x = torch.from_numpy(x / 8).to(dev)
    counter = "packed_launches" if packed else "general_launches"
    before = (cuda_knn.launches, getattr(cuda_knn, counter))
    got = cuda_knn.knn(x, k, packed=packed)
    again = cuda_knn.knn(x, k, packed=packed)
    torch.cuda.synchronize()
    assert (cuda_knn.launches, getattr(cuda_knn, counter)) == (before[0], before[1] + 2)
    assert torch.equal(got, again)
    want = cuda_knn.knn_packed_reference(x, k) if packed else cuda_knn.knn_reference(x, k)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype,rate,route", [
    (10, 2048, 128, torch.float32, 0.1, "wide_tf32"),
    (2, 2048, 128, torch.float32, 0.0, "wide_tf32"),
    (10, 2048, 128, torch.bfloat16, 0.1, "wide_tc"),
    (2, 2048, 128, torch.bfloat16, 0.0, "wide_tc"),
    (2, 200, 300, torch.float32, 0.1, "wide_tf32"),
    (2, 2048, 100, torch.float32, 0.1, "wide_tf32"),
    (10, 2048, 320, torch.float32, 0.0, "wide_tf32"),
    (2, 2048, 320, torch.float32, 0.1, "wide_tf32"),
    (2, 130, 130, torch.float32, 0.1, "wide_tf32"),
    (1, 70, 66, torch.float32, 0.5, "wide_tf32"),
    (2, 200, 12, torch.bfloat16, 0.1, "tuned"),
    (2, 200, 12, torch.float32, 0.0, "tuned"),
    (2, 200, 6, torch.float32, 0.1, "tuned"),
    (2, 200, 80, torch.bfloat16, 0.1, "wide_tc"),
    (2, 2048, 100, torch.bfloat16, 0.1, "wide_tc"),
    (2, 200, 100, torch.bfloat16, 0.0, "wide_tc"),
    (10, 2048, 256, torch.bfloat16, 0.0, "wide_tc"),
    (2, 130, 256, torch.bfloat16, 0.1, "wide_tc"),
    (1, 70, 72, torch.bfloat16, 0.5, "wide_tc"),
    (2, 2048, 320, torch.bfloat16, 0.1, "wide_group"),
    (10, 2048, 512, torch.bfloat16, 0.0, "wide_group"),
    (2, 2048, 300, torch.bfloat16, 0.1, "wide_group"),
    (1, 130, 264, torch.bfloat16, 0.5, "wide_group")])
def test_attention_f1_shapes_on_card(b, n, d, dtype, rate, route):
    """Attention past and inside the tuned width, each case on the kernels
    ``route`` names (`chip_smoke.ATTN_ROUTE_COUNTERS`): f32 past 64 on the
    3xTF32 kernels in channel groups (`csrc/attention_wide.cu`: D = 128 at
    the training batches, D = 100 short of the 128-channel group, D = 320
    in groups of 128, 128 and 64 at both batches, D = 300 cut at 44 in its
    third group, D = 130 through the zero pad to 132 at a ragged N, D = 66
    through the pad to 68);
    bf16 64 < D <= 256 on the wide tensor-core kernels
    (`csrc/attention_wide_bf16.cu`: D = 80 short of the 128-channel tile,
    D = 100 through the zero pad to 104, D = 72, ragged N), bf16 past 256
    on the grouped tensor-core kernels (`csrc/attention_group_bf16.cu`: D
    = 320 and 512 in two groups, D = 300 through the zero pad to 304, D =
    264 in groups of 192 and 72 channels at a ragged N); D = 12 in bf16 (the
    pad) and f32 (aligned), D
    = 6 in f32 (the pad) on the tuned kernels: forward and backward within
    `chip_smoke.attention_gates`, a second call of each bit-equal, one
    launch each on the route's counters and none on any other route's."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(b * d)
    q, k, v, dy = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(4))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    tau, seed = float(d) ** 0.5, 17
    names = [n for pair in chip_smoke.ATTN_ROUTE_COUNTERS.values() for n in pair]
    before = {n: getattr(cuda_attention, n) for n in names}
    y, lse, got = chip_smoke.attention_step(cuda_attention, q, k, v, dy, tau, rate, seed)
    torch.cuda.synchronize()
    moved = {n: getattr(cuda_attention, n) - c for n, c in before.items()}
    assert moved == {n: int(n in chip_smoke.ATTN_ROUTE_COUNTERS[route]) for n in names}
    y2, lse2, again = chip_smoke.attention_step(cuda_attention, q, k, v, dy, tau, rate, seed)
    assert torch.equal(y, y2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
    errs = chip_smoke.attention_gates(torch, cuda_attention, q, k, v, dy, tau, rate, seed, y,
                                      lse, got)
    assert all(e <= 1.0 for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m", [(torch.float32, 60000), (torch.bfloat16, 120000)])
@pytest.mark.parametrize("kind", chip_smoke.KTH_KINDS)
def test_kth_wide_kernel_adversarial_rows_on_card(kind, dtype, m):
    """Rows past one block's shared memory (`chip_smoke.kth_rows` at 60000
    f32 and 120000 bf16 entries): the wide variant, bit-equal to the plain
    version, two calls bit-equal, one wide launch per call."""
    dev = cuda_or_skip()
    d, k = chip_smoke.kth_rows(kind, 3, m, seed=len(kind))
    d = torch.from_numpy(d).to(dtype).to(dev)
    iters = 32 if dtype == torch.float32 else 16
    counts = (cuda_kth.launches, cuda_kth.wide_launches)
    got = cuda_kth.kth_smallest_per_row(d, k, iters)
    again = cuda_kth.kth_smallest_per_row(d, k, iters)
    torch.cuda.synchronize()
    assert (cuda_kth.launches, cuda_kth.wide_launches) == (counts[0], counts[1] + 2)
    assert torch.equal(got, again)
    assert torch.equal(got, cuda_kth.kth_smallest_per_row_reference(d, k, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,k,c,n,dtype,graph", [
    (10, 2048, 20, 63, 2048, torch.float32, "knn"), (2, 2048, 20, 63, 2048, torch.bfloat16, "knn"),
    (10, 2048, 40, 63, 2048, torch.float32, "knn"), (2, 2048, 40, 63, 2048, torch.float32, "knn"),
    (10, 2048, 40, 63, 2048, torch.bfloat16, "knn"), (2, 2048, 40, 63, 2048, torch.bfloat16, "knn"),
    (2, 2048, 20, 1, 2048, torch.float32, "random"), (2, 2048, 20, 3, 2048, torch.bfloat16, "random"),
    (2, 2048, 20, 129, 2048, torch.float32, "random"),
    (1, 8192, 20, 320, 32768, torch.bfloat16, "random"),
    (2, 2048, 20, 63, 2048, torch.float32, "hub"), (1, 8192, 20, 64, 32768, torch.float32, "random"),
    (1, 8192, 20, 65, 32768, torch.bfloat16, "random"), (2, 10000, 20, 7, 40000, torch.bfloat16,
                                                         "random"),
    (1, 17500, 20, 3, 70000, torch.float32, "hub"), (1, 17500, 20, 129, 70000, torch.float32,
                                                      "random"),
    (2, 0, 20, 63, 2048, torch.float32, "random"), (1, 0, 20, 5, 40000, torch.bfloat16, "random"),
    (2, 64, 5, 3, 40000, torch.float32, "out_of_range")])
def test_scatter_general_kernel_on_card(b, nq, k, c, n, dtype, graph):
    """An odd C (1, 3, 7, 63, 65, 129), and N past the tuned build's shared
    memory (32768, 40000, 70000: the radix build; C = 64 and 320 there): at the
    flagship kNN graphs at K = 20 and the F1 step's K = 40, with a hub of
    5000 rows, with no rows (M = 0) and with every id outside [0, N); the
    general kernel, bit-equal to the ordered emulation and across two calls
    (a bf16 g also to the f32 form on its upcast), ids out of range
    dropped; one general launch per call and none of the tuned one."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(b + nq + k + c + n)
    if graph == "knn":
        x = torch.from_numpy(rng.normal(size=(b, n, 9)).astype(np.float32)).to(dev)
        idx = cuda_knn.knn(x, k)
        idx[:, :, 1] = 5                                # a hub of nq rows
    else:
        idx = torch.from_numpy(rng.integers(-2, n + 2, size=(b, nq, k)).astype(np.int32)).to(dev)
    if graph == "hub":
        idx[:, :5000 // k] = 5                          # 5000 rows: 157 pieces
    elif graph == "out_of_range":
        idx = torch.where(idx % 2 == 0, -idx.abs() - 1, idx.abs() + n)
    g = torch.from_numpy(rng.normal(size=(*idx.shape, c)).astype(np.float32)).to(dev, dtype)
    counts = (cuda_scatter.launches, cuda_scatter.general_launches)
    got = cuda_scatter.scatter_add(g, idx, n)
    again = cuda_scatter.scatter_add(g, idx, n)
    torch.cuda.synchronize()
    assert (cuda_scatter.launches, cuda_scatter.general_launches) == (counts[0], counts[1] + 2)
    assert got.dtype == torch.float32 and got.shape == (b, n, c) and torch.equal(got, again)
    assert torch.equal(got, cuda_scatter.scatter_add_ordered_reference(g, idx, n))
    if dtype == torch.bfloat16:
        assert torch.equal(got, cuda_scatter.scatter_add(g.float(), idx, n))
    if graph == "out_of_range" or nq == 0:
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_hub_at_an_odd_row_count_on_card(dtype):
    """The tuned kernel with B * M odd (1, 25, 3) and a hub of 75 rows (three
    pieces): the hubs' partial rows are read and written in pairs of
    channels, and start 16-byte aligned whatever B * M; bit-equal to the
    ordered emulation, one launch."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(25)
    g = torch.from_numpy(rng.normal(size=(1, 25, 3, 8)).astype(np.float32)).to(dev, dtype)
    idx = torch.full((1, 25, 3), 4, dtype=torch.int32, device=dev)
    before = cuda_scatter.launches
    got = cuda_scatter.scatter_add(g, idx, 10)
    torch.cuda.synchronize()
    assert cuda_scatter.launches == before + 1
    assert torch.equal(got, cuda_scatter.scatter_add_ordered_reference(g, idx, 10))


# ------------------------------------------------ the bf16 encoder's forms --
def _bf16_qkv(seed, b, n, d, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dy = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(4))
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), dy


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,rate", [(10, 2048, 64, 0.1), (2, 2048, 64, 0.1),
                                        (10, 2048, 64, 0.0), (2, 2048, 64, 0.0),
                                        (2, 150, 64, 0.1), (1, 100, 16, 0.5), (2, 130, 16, 0.0),
                                        (2, 200, 8, 0.1)])
def test_attention_bf16_kernels_match_plain_on_card(b, n, d, rate):
    """The bf16 forms of kernels 2 and 5 against their plain versions with
    q scaled as the kernels scale it (q * bf16(1 / tau); at D = 8, 1 / tau
    is no power of two and the JAX XLA path's q / bf16(tau) rounds q
    differently).  Forward: lse rtol/atol 1e-5 (f32 scores of exact bf16
    products); y within ATTN_BF16_FWD_TOL of its largest entry (both round
    the normalised P to bf16; an f32 P at a rounding boundary can round the
    other way).  Backward (the same roundings at the same places, f32 sums
    in another order): each gradient within 1e-2 of its largest entry (a
    dS or Pd entry at a bf16 rounding boundary can round the other way).
    A second call of each is bit-equal; one launch count each."""
    dev = cuda_or_skip()
    q, k, v, dy = _bf16_qkv(11, b, n, d, dev)
    tau, seed = float(d) ** 0.5, 21
    counts = (cuda_attention.bf16_launches, cuda_attention.bwd_bf16_launches)
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    y2, lse2 = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    assert torch.equal(y, y2) and torch.equal(lse, lse2)
    want_y, want_lse = cuda_attention.attention_fwd_reference(q, k, v, tau, rate, seed,
                                                              kernel_scale=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    bound = chip_smoke.ATTN_BF16_FWD_TOL * float(want_y.abs().max())
    assert float((y - want_y).abs().max()) <= bound
    got = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
    again = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
    want = cuda_attention.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed,
                                                  kernel_scale=True)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, a2)
        assert float((a - w).abs().max()) <= 1e-2 * float(w.abs().max())
    torch.cuda.synchronize()
    assert (cuda_attention.bf16_launches, cuda_attention.bwd_bf16_launches) == \
        (counts[0] + 2, counts[1] + 2)


def _bf16_forward_meets_gates(q, k, v, tau, rate, seed):
    """The bf16 forward at D <= 64 (`csrc/attention_fwd_bf16.cu`) against
    its plain version with q scaled as the kernel scales it: lse rtol/atol
    1e-5, y within ATTN_BF16_FWD_TOL of its largest entry; a second call
    bit-equal; one launch each."""
    before = cuda_attention.bf16_launches
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    y2, lse2 = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    torch.cuda.synchronize()
    assert cuda_attention.bf16_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(lse, lse2)
    want_y, want_lse = cuda_attention.attention_fwd_reference(q, k, v, tau, rate, seed,
                                                              kernel_scale=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert float((y - want_y).abs().max()) <= \
        chip_smoke.ATTN_BF16_FWD_TOL * float(want_y.abs().max())
    return y, lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,rate", [(1, 300, 8, 0.1), (2, 300, 16, 0.0), (10, 300, 24, 0.1),
                                        (2, 300, 64, 0.0), (10, 300, 8, 0.0), (1, 300, 64, 0.1),
                                        (2, 2049, 64, 0.1), (1, 2049, 24, 0.0),
                                        (10, 2049, 16, 0.1), (10, 2049, 64, 0.0),
                                        (2, 2049, 8, 0.0), (1, 2048, 64, 0.1)])
def test_attention_bf16_forward_ragged_and_narrow_on_card(b, n, d, rate):
    """The wgmma forward at ragged N (a cut last key tile and row tile),
    at D = 8, 16, 24 (channels zero to the next 16) and 64, B = 1, 2, 10,
    rate 0 and 0.1: the gates of `_bf16_forward_meets_gates`."""
    dev = cuda_or_skip()
    q, k, v, _ = _bf16_qkv(n + d + b, b, n, d, dev)
    _bf16_forward_meets_gates(q, k, v, float(d) ** 0.5, rate, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2049])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_attention_bf16_forward_cluster_routes_on_card(cluster, n):
    """Each cluster size C through the wrapper, reached by the shape alone:
    the smallest B that `fwd_bf16_cluster` sends to C on this card's SMs
    (on 132 SMs at N = 2048: B = 17 takes 1, B = 9 takes 2, B = 1 takes 4;
    the training shapes B = 10 and 2 take 2 and 4), D = 64, rate 0.1: the
    gates of `_bf16_forward_meets_gates`, repeats bit for bit."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = next(b for b in range(1, 4 * sms) if cuda_attention.fwd_bf16_cluster(b, n, sms) == cluster)
    q, k, v, _ = _bf16_qkv(b + 70, b, n, 64, dev)
    _bf16_forward_meets_gates(q, k, v, 8.0, 0.1, 41)


def _bf16_backward_meets_gates(q, k, v, dy, tau, rate, seed):
    """The bf16 backward at D <= 64 (`csrc/attention_bwd_bf16.cu`) from the
    kernel forward's y and lse against its plain version with q scaled as
    the kernels scale it: each gradient within ATTN_BF16_BWD_TOL of its
    largest entry; a second call bit-equal; one launch each."""
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    before = cuda_attention.bwd_bf16_launches
    got = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
    again = cuda_attention.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_bf16_launches == before + 2
    want = cuda_attention.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed,
                                                  kernel_scale=True)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == q.shape and torch.equal(a, a2)
        assert float((a - w).abs().max()) <= \
            chip_smoke.ATTN_BF16_BWD_TOL * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,rate", [(1, 300, 8, 0.1), (2, 300, 12, 0.0), (10, 300, 24, 0.1),
                                        (2, 300, 40, 0.0), (1, 300, 64, 0.1), (2, 100, 64, 0.1),
                                        (1, 64, 16, 0.0), (2, 2049, 64, 0.1), (1, 2049, 24, 0.0),
                                        (10, 2049, 40, 0.1), (10, 2049, 64, 0.0),
                                        (2, 2049, 12, 0.1), (10, 2048, 8, 0.1)])
def test_attention_bf16_backward_ragged_and_narrow_on_card(b, n, d, rate):
    """The wgmma backward at ragged N (a cut last key tile and query tile:
    their P = 0 and dS zeros), at D = 8, 12 (through the zero pad to 16),
    24, 40 (a k-step half zero) and 64, B = 1, 2, 10, rate 0 and 0.1: the
    gates of `_bf16_backward_meets_gates`."""
    dev = cuda_or_skip()
    q, k, v, dy = _bf16_qkv(n + d + b + 5, b, n, d, dev)
    _bf16_backward_meets_gates(q, k, v, dy, float(d) ** 0.5, rate, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2049])
@pytest.mark.parametrize("b", [1, 17, 40])
def test_attention_bf16_backward_cluster_routes_on_card(b, n):
    """The dK/dV kernel's clusters of two through the wrapper at a batch of
    one (32 or 33 key tiles, a cluster each: most SMs idle), and at B = 17
    and 40 (more than four blocks an SM on 132 SMs), D = 64, rate 0.1: the
    gates of `_bf16_backward_meets_gates`, repeats bit for bit."""
    dev = cuda_or_skip()
    q, k, v, dy = _bf16_qkv(b + 90, b, n, 64, dev)
    _bf16_backward_meets_gates(q, k, v, dy, 8.0, 0.1, 43)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [10, 2])
def test_scatter_add_bf16_bit_equals_the_f32_form_on_card(b):
    """Kernel 6 on a bf16 cotangent: bit-equal to the f32 form on its
    upcast and to the ordered emulation, and across two calls."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(b + 40)
    x = torch.from_numpy(rng.normal(size=(b, 2048, 9)).astype(np.float32)).to(dev)
    idx = cuda_knn.knn_reference(x, 20)
    idx[:, :, 1] = 5                                   # a hub
    g = torch.from_numpy(rng.normal(size=(*idx.shape, 64)).astype(np.float32)).to(
        dev, torch.bfloat16)
    before = cuda_scatter.bf16_launches
    got = cuda_scatter.scatter_add(g, idx, 2048)
    again = cuda_scatter.scatter_add(g, idx, 2048)
    torch.cuda.synchronize()
    assert cuda_scatter.bf16_launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert torch.equal(got, cuda_scatter.scatter_add(g.float(), idx, 2048))
    assert torch.equal(got, cuda_scatter.scatter_add_ordered_reference(g, idx, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(10, 64), (2, 64), (2, 9)])
def test_knn_bf16_input_equals_knn_of_its_upcast_on_card(b, c):
    dev = cuda_or_skip()
    x = torch.from_numpy(_points(b + c, b, 2048, c)).to(dev, torch.bfloat16)
    before = cuda_knn.bf16_launches
    got = cuda_knn.knn(x, 20)
    assert cuda_knn.bf16_launches == before + 1
    assert torch.equal(got, cuda_knn.knn(x.float(), 20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_and_scatter_take_unaligned_views_on_card(dtype):
    """Views that start one entry into their storage (off the 16-byte
    boundary the kernels' copies and loads need) give the results of
    their aligned copies."""
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(12)

    def view(*shape):
        count = int(np.prod(shape))
        return torch.randn(count + 1, generator=g, device=dev).to(dtype)[1:].view(*shape)

    q, k, v, dy = view(2, 100, 16), view(2, 100, 16), view(2, 100, 16), view(2, 100, 16).float()
    assert q.data_ptr() % 16 != 0
    aligned = [t.clone() for t in (q, k, v)]
    y, lse = cuda_attention.attention_fwd(q, k, v, 4.0, 0.1, 5)
    want_y, want_lse = cuda_attention.attention_fwd(*aligned, 4.0, 0.1, 5)
    assert torch.equal(y, want_y) and torch.equal(lse, want_lse)
    yv = torch.empty(y.numel() + 1, device=dev)[1:].view_as(y).copy_(y)
    got = cuda_attention.attention_bwd(q, k, v, yv, dy, lse, 4.0, 0.1, 5)
    want = cuda_attention.attention_bwd(*aligned, y, dy.clone(), lse, 4.0, 0.1, 5)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    gr = view(1, 50, 4, 8)
    idx = torch.randint(0, 50, (1, 50, 4), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(cuda_scatter.scatter_add(gr, idx, 50),
                       cuda_scatter.scatter_add(gr.clone(), idx, 50))
