"""Port attention (`ops/cuda_attention.py`, `nn.dgcnn.SelfAttention`) vs
the JAX package's XLA path and its Pallas kernels in interpret mode:
`_attn_fwd_kernel` (train=False) and the backward `_attn_bwd_kernel`
through `jax.grad` of `fused_attention`.  Tolerance rtol 1e-5, atol 1e-6:
f32 sums taken in another order.

The port's dropout bits are not the TPU's (Philox per element against the
TPU generator per query tile), and the Pallas dropout does not run in
interpret mode, so the JAX comparisons run at rate 0 and the mask is tested
inside the port: Philox's known answers, the masked forward, the plain
backward against torch autograd, and the keep share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.nn import SelfAttention as JaxSelfAttention
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu_torch.nn.dgcnn import SelfAttention
from r3dfsseg_tpu_torch.ops import cuda_attention
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import jax_attention_kernel


@pytest.mark.parametrize("b,n,d", [(2, 32, 8), (1, 64, 16)])
def test_attention_matches_jax_xla_and_kernel(b, n, d):
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    tau = float(np.sqrt(d))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    xla = jnp.einsum("bnm,bmd->bnd",
                     jax.nn.softmax(jnp.einsum("bnd,bmd->bnm", jq / jnp.sqrt(d).astype(jnp.float32),
                                               jk), -1), jv)
    kernel = jax_attention_kernel(jq, jk, jv, tau, tq=16)
    got = cuda_attention.attention(*map(torch.from_numpy, (q, k, v)), tau).numpy()
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-5, atol=1e-6)


def test_selfattention_module_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    jm = JaxSelfAttention(8, attn_dropout=0.1)
    var = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                  jnp.asarray(x), train=False)
    want = np.asarray(jm.apply(var, jnp.asarray(x), train=False))
    for impl in ("auto", "xla"):
        m = SelfAttention(16, 8, attn_impl=impl)
        m.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, var["params"])),
                          strict=True)
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _inputs(seed, b, n, d, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("b,n,d", [(2, 32, 8), (1, 64, 16)])
def test_attention_backward_matches_jax_pallas_kernel(monkeypatch, b, n, d):
    """dq, dk, dv: `jax.grad` through the Pallas `_attn_bwd_kernel`
    (interpret mode) vs the port's backward, by itself and through the
    autograd Function."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    q, k, v, dy = _inputs(b + n + d, b, n, d)
    tau = float(np.sqrt(d))

    def loss(q_, k_, v_):
        y = jax_pa.fused_attention(q_, k_, v_, jnp.int32(0), tau, 0.1, False)
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdy = map(torch.from_numpy, (q, k, v, dy))
    y, lse = cuda_attention.attention_fwd(tq, tk, tv, tau)
    got = cuda_attention.attention_bwd(tq, tk, tv, y, tdy, lse, tau)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    cuda_attention.fused_attention(*leaves, 0, tau, 0.1, False).backward(tdy)
    for a, t, w in zip(got, leaves, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    out = cuda_attention.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
    assert " ".join(f"{int(w):08x}" for w in out) == want


def test_dropout_mask_is_a_function_of_seed_cloud_row_column():
    """Word (b, i, j) is element j % 4 of Philox at counter (j // 4, i, b,
    0): it does not depend on the batch or row count it is drawn with."""
    seed = 2**40 + 3
    big = cuda_attention.dropout_words_reference(3, 10, seed, "cpu")
    np.testing.assert_array_equal(big[1:2, :7, :7].numpy(),
                                  cuda_attention.dropout_words_reference(2, 7, seed, "cpu")[1:2])
    c = tuple(torch.tensor([x]) for x in (9 // 4, 5, 2, 0))
    want = cuda_attention.philox4x32_10(c, (seed & 0xFFFFFFFF, seed >> 32))[9 % 4]
    assert int(big[2, 5, 9]) == int(want)
    assert not torch.equal(big, cuda_attention.dropout_words_reference(3, 10, seed + 1, "cpu"))


def test_masked_forward_is_softmax_times_mask_times_v():
    q, k, v = map(torch.from_numpy, _inputs(0, 2, 40, 8, 3))
    tau, rate, seed = 8 ** 0.5, 0.25, 11
    m = cuda_attention.dropout_mask_reference(2, 40, rate, seed, "cpu")
    assert set(np.unique(m.numpy()).tolist()) == {0.0, np.float32(1 / (1 - rate))}
    want = torch.softmax((q / tau) @ k.transpose(1, 2), -1) * m @ v
    y, lse = cuda_attention.attention_fwd(q, k, v, tau, rate, seed)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp((q / tau) @ k.transpose(1, 2), -1))
    torch.testing.assert_close(cuda_attention.attention(q, k, v, tau, rate, seed), want)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_plain_backward_equals_autograd_of_masked_forward(rate):
    q, k, v, dy = map(torch.from_numpy, _inputs(int(rate * 10), 2, 48, 16))
    tau, seed = 4.0, 5
    y, lse = cuda_attention.attention_fwd_reference(q, k, v, tau, rate, seed)
    got = cuda_attention.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_attention.attention_reference(*leaves, tau, rate, seed).backward(dy)
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-6)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    for impl in ("auto", "xla"):
        for t in leaves2:
            t.grad = None
        cuda_attention.fused_attention(*leaves2, seed, tau, rate, True, impl).backward(dy)
        for t, w in zip(leaves2, leaves):
            torch.testing.assert_close(t.grad, w.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_four_sigma(rate):
    b, n = 2, 300
    keep = cuda_attention.dropout_mask_reference(b, n, rate, 123456789, "cpu") > 0
    m = b * n * n
    sigma = np.sqrt(rate * (1 - rate) / m)
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma


def test_selfattention_training_matches_jax_at_rate_0():
    """SelfAttention(train=True) with dropout 0: output and the gradients
    of its q, k, v maps vs Flax's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    w = rng.normal(size=(2, 32, 8)).astype(np.float32)
    jm = JaxSelfAttention(8, attn_dropout=0.0)
    var = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)

    def loss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x), train=True) * w)

    want_grads = jax.grad(loss)(var["params"])
    m = SelfAttention(16, 8, attn_dropout=0.0)
    m.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, var["params"])), strict=True)
    (m(torch.from_numpy(x), train=True) * torch.from_numpy(w)).sum().backward()
    want = state_dict_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5)

