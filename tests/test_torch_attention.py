"""Port attention (`ops/cuda_attention.py`, `nn.dgcnn.SelfAttention`) vs
the JAX package's XLA path and its Pallas `_attn_fwd_kernel` (train=False)
in interpret mode.  Tolerance rtol 1e-5, atol 1e-6: f32 sums taken in
another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.nn import SelfAttention as JaxSelfAttention
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


def test_attention_training_raises():
    q = torch.zeros((1, 4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cuda_attention.attention(q, q, q, 1.0, rate=0.1, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SelfAttention(2, 2)(q, train=True)

