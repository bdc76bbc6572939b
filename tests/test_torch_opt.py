"""Port optimizer and schedule (`learners/base.py`) vs the JAX package's
`make_optimizer` (optax Adam per parameter group + staircase decay), fed
the SAME gradients for several steps with a small `step_size`: parameters
within rtol 1e-5 (Adam's arithmetic rounds in another order).

Gradients are not computed by the two frameworks here on purpose: at step
1 Adam's update is ~ lr * sign(g), so a near-zero gradient whose sign
differs by rounding would move a parameter by 2 lr."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
from r3dfsseg_tpu.learners.base import _param_labels, make_optimizer as jax_make_optimizer
from r3dfsseg_tpu.models import mpti as jax_mpti
from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.learners.base import ENCODER_PREFIX, make_optimizer
from r3dfsseg_tpu_torch.models.mpti import MPTINet
from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import random_flax_weights


def _jax_params(jcfg, rng):
    w, k, n, c = jcfg.n_way, jcfg.k_shot, jcfg.pc_npts, jcfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: jax_mpti.MPTINet(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    return random_flax_weights(shapes, rng)[0]


@pytest.mark.parametrize("episode_batch", [1, 2])
def test_adam_step_lr_matches_optax_on_identical_gradients(episode_batch):
    over = dict(step_size=4, gamma=0.5, lr=1e-2, encoder_lr=3e-3, episode_batch=episode_batch)
    jcfg, cfg = jax_tiny_config(**over), tiny_config(**over)
    rng = np.random.default_rng(episode_batch)
    params = _jax_params(jcfg, rng)
    tx = jax_make_optimizer(jcfg)
    opt_state = tx.init(params)
    model = MPTINet(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=False)
    opt, sched = make_optimizer(model, cfg)
    named = dict(model.named_parameters())
    for step in range(7):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in state_dict_from_jax(grads).items():
            named[name].grad = g
        opt.step()
        sched.step()
        want = state_dict_from_jax(jax.tree.map(np.asarray, params))
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step} {name}")
    transition = max(4 // episode_batch, 1)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [3e-3 * 0.5 ** (7 // transition), 1e-2 * 0.5 ** (7 // transition)])


def test_parameter_groups_follow_the_jax_labels():
    """`features.encoder.*` is the 'encoder' group at encoder_lr, as the
    JAX package's `_param_labels` splits the tree; the rest is at lr."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = _jax_params(jcfg, np.random.default_rng(0))
    flat_labels = jax.tree_util.tree_flatten_with_path(_param_labels(params))[0]
    enc = {".".join(str(getattr(k, "key", k)) for k in path) for path, lab in flat_labels
           if lab == "encoder"}
    assert enc
    model = MPTINet(cfg)
    opt, _ = make_optimizer(model, cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    got_enc = {names[id(p)] for p in opt.param_groups[0]["params"]}
    assert all(n.startswith(ENCODER_PREFIX) for n in got_enc)
    assert {n.rsplit(".", 1)[0] for n in got_enc} == {e.rsplit(".", 1)[0] for e in enc}
    assert opt.param_groups[0]["lr"] == cfg.encoder_lr and opt.param_groups[1]["lr"] == cfg.lr
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
