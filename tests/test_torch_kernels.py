"""The four kernel wrappers of the port: their dispatch rule, and on a card
each kernel against its plain PyTorch version.

This file imports neither jax nor the JAX package, so the card tests run on
a machine with an NVIDIA GPU and no JAX:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures jax.)
"""
import numpy as np
import pytest
import torch

from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_fps, cuda_knn, cuda_kth
from torch_port_helpers import cuda_or_skip

CALLS = {
    "knn": (cuda_knn, lambda dev: cuda_knn.knn(torch.zeros((1, 8, 3), device=dev), 4)),
    "attention": (cuda_attention, lambda dev: cuda_attention.attention(
        *(torch.zeros((1, 8, 4), device=dev) for _ in range(3)), 2.0)),
    "fps": (cuda_fps, lambda dev: cuda_fps.fps(
        torch.zeros((1, 8, 3), device=dev), torch.ones((1, 8), dtype=torch.bool, device=dev), 2)),
    "kth": (cuda_kth, lambda dev: cuda_kth.kth_smallest_per_row(
        torch.zeros((8, 8), device=dev), 2, 4)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_tensor_takes_the_plain_version(name):
    mod, call = CALLS[name]
    before = mod.launches
    call("cpu")
    assert mod.launches == before


@pytest.mark.parametrize("name", sorted(CALLS))
def test_other_devices_raise(name):
    mod, call = CALLS[name]
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
