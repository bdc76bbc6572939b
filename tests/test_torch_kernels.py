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
                                    cuda_gather, cuda_knn, cuda_kth, cuda_scatter)
from torch_port_helpers import cuda_or_skip


def _qkv(dev, shape=(1, 8, 4)):
    return [torch.zeros(shape, device=dev) for _ in range(3)]


def _fused_pass(name, dev):
    """Pass ``name`` of kernel 9 on zeros of its shapes, (1, 8, 3, 64) edges."""
    c = cuda_fused_edge.C
    n_vecs = {"stats1": 2, "fwd": 4, "bwd1": 6, "bwd2": 11, "bwd3": 14}[name]
    dout = [] if name in ("stats1", "fwd") else [torch.zeros((1, 8, c), device=dev)]
    return getattr(cuda_fused_edge, name)(
        torch.zeros((1, 8, 3, c), device=dev), *dout,
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
    "fps": (cuda_fps, "launches", lambda dev: cuda_fps.fps(
        torch.zeros((1, 8, 3), device=dev), torch.ones((1, 8), dtype=torch.bool, device=dev), 2)),
    "kth": (cuda_kth, "launches", lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((8, 8), device=dev), 2, 4)),
    "kth_bf16": (cuda_kth, "launches", lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev), 2, 4)),
    "cheby": (cuda_cheby, "launches", lambda dev: cuda_cheby.cheby_solve(
        torch.zeros((8, 8), dtype=torch.bfloat16, device=dev), torch.ones((8, 3), device=dev),
        0.99, 4)),
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
@pytest.mark.parametrize("b,n,d", [(2, 150, 64), (1, 64, 8)])
def test_attention_kernel_matches_plain_on_card(b, n, d):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, n, d), generator=g, device=dev) for _ in range(3))
    tau = float(d) ** 0.5
    got = cuda_attention.attention(q, k, v, tau)
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seed", [(2, 130, 0), (3, 64, 2**40 + 17)])
def test_dropout_mask_bits_equal_plain_on_card(b, n, seed):
    dev = cuda_or_skip()
    got = cuda_attention.dropout_words(b, n, seed, dev).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, cuda_attention.dropout_words_reference(b, n, seed, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,rate", [(2, 150, 64, 0.1), (1, 64, 8, 0.0), (2, 100, 16, 0.5)])
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
@pytest.mark.parametrize("b,n,k,c", [(2, 300, 20, 64), (1, 64, 5, 8)])
def test_scatter_add_kernel_matches_plain_on_card(b, n, k, c):
    """The order of the atomic adds varies: |err| <= 1e-5 * sum |g|."""
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
