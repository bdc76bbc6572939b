"""Shared pieces of the tests of the PyTorch/CUDA port (tests/test_torch_*.py).

The tests hand the same numpy inputs, made from a seed, to the JAX package
and to the port.  Where the JAX function reaches a Pallas kernel, it runs in
interpret mode, as the JAX package's own kernel tests run it on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    """The card for a test marked `cuda`; skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def jax_knn_kernel_exact(x, k: int, tile_n: int):
    """`_knn_kernel(exact=True)` over (B, N, C), interpret mode."""
    return jax_knn_kernel(x, k, tile_n, exact=True)


def jax_knn_kernel(x, k: int, tile_n: int, exact: bool = True):
    """`_knn_kernel` over (B, N, C), interpret mode; ``exact`` False: the
    packed-key mode (knn_impl 'pallas')."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from r3dfsseg_tpu.ops import pallas_knn as pk

    b, n, c = x.shape
    return pl.pallas_call(
        functools.partial(pk._knn_kernel, k=k, n_keys=n, exact=exact),
        out_shape=jax.ShapeDtypeStruct((b, n, k), jnp.int32),
        grid=(b, n // tile_n),
        in_specs=[pl.BlockSpec((1, tile_n, c), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, n, c), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, tile_n, k), lambda i, j: (i, j, 0)),
        interpret=True,
    )(x, x)


def jax_attention_kernel(q, k, v, tau: float, tq: int):
    """`_attn_fwd_kernel` with train=False over (B, N, D), interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from r3dfsseg_tpu.ops import pallas_attention as pa

    b, n, d = q.shape
    return pl.pallas_call(
        functools.partial(pa._attn_fwd_kernel, tau=tau, rate=0.1, train=False),
        out_shape=jax.ShapeDtypeStruct((b, n, d), jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(b, n // tq),
            in_specs=[pl.BlockSpec((1, tq, d), lambda b_, t_, s_: (b_, t_, 0)),
                      pl.BlockSpec((1, n, d), lambda b_, t_, s_: (b_, 0, 0)),
                      pl.BlockSpec((1, n, d), lambda b_, t_, s_: (b_, 0, 0))],
            out_specs=pl.BlockSpec((1, tq, d), lambda b_, t_, s_: (b_, t_, 0))),
        interpret=True,
    )(jnp.zeros((1,), jnp.int32), q, k, v)


def random_flax_weights(variables, rng: np.random.Generator, *, wscale: float = 3.0,
                        mean_sd: float = 0.5, var_lo: float = 0.1,
                        vscale: float = 0.1):
    """Numpy Flax trees (params, batch_stats) shaped like ``variables``
    (arrays or `jax.eval_shape` structs): Dense kernels ~ N(0, wscale^2 /
    fan_in), the attention value map scaled by ``vscale``, vectors ~
    N(0, 0.1^2), running means ~ N(0, mean_sd^2), running variances ~
    U(var_lo, 1.5): weights that make features vary from point to point."""
    import flax
    import jax

    def param(path, a):
        if len(a.shape) == 2:
            out = rng.normal(size=a.shape) * (wscale / np.sqrt(a.shape[0]))
            if any(getattr(p, "key", None) == "v_map" for p in path):
                out = out * vscale
            return out.astype(np.float32)
        return (rng.normal(size=a.shape) * 0.1).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "mean":
            return (rng.normal(size=a.shape) * mean_sd).astype(np.float32)
        return rng.uniform(var_lo, 1.5, size=a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        param, flax.core.unfreeze(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(
        stat, flax.core.unfreeze(variables.get("batch_stats", {})))
    return params, stats


def episode_arrays(cfg, rng: np.random.Generator):
    """(support_x, support_y, query_x, query_y) numpy arrays of one episode,
    with at least one fg point per shot."""
    w, k, n, d = cfg.n_way, cfg.k_shot, cfg.pc_npts, cfg.pc_in_dim
    q = cfg.n_queries * cfg.n_way
    sy = (rng.uniform(size=(w, k, n)) < 0.3).astype(np.int32)
    sy[..., 0] = 1
    return (rng.normal(size=(w, k, n, d)).astype(np.float32), sy,
            rng.normal(size=(q, n, d)).astype(np.float32),
            rng.integers(0, w + 1, size=(q, n)).astype(np.int32))


def train_episode(cfg, rng: np.random.Generator):
    """Episode arrays with gt masks (one noisy shot in way 1) and the
    support flags (absolute classes; the noisy shot carries way 0's)."""
    sx, sy, qx, qy = episode_arrays(cfg, rng)
    gt_sy = sy.copy()
    gt_sy[1, -1] = 0
    gt_qy = qy.copy()
    gt_qy[0, :5] = 0
    flag = np.tile(np.array([[3], [7]], np.int32), (1, cfg.k_shot))
    flag[1, -1] = 3
    return sx, sy, qx, qy, gt_sy, gt_qy, flag


def jax_graph_nodes(enc, jax_cfg, support_x, support_y, query_x, eval_mdns: bool):
    """The JAX model's episode-graph nodes, (node features (V, d), valid
    (V,)) as numpy arrays; ``enc`` maps clouds to JAX embeddings."""
    import jax.numpy as jnp
    from r3dfsseg_tpu.models import mpti as jax_mpti

    w, k, n, c = support_x.shape
    sf = enc(support_x.reshape(w * k, n, c)).reshape(w, k, n, -1)
    qf = enc(query_x).reshape(-1, sf.shape[-1])
    fg = support_y > 0
    used = fg
    if eval_mdns:
        keep, _ = jax_mpti.mdns_keep_mask(jnp.asarray(sf), jnp.asarray(fg),
                                          jnp.asarray(support_x[..., :3]), jax_cfg.mdns_scales)
        used = fg & (np.asarray(keep)[..., None] > 0.5)
    protos, pvalid, _, _ = jax_mpti.episode_graph_nodes(
        jnp.asarray(sf), jnp.asarray(used), jnp.asarray(fg), jax_cfg)
    return (np.concatenate([np.asarray(protos), qf]),
            np.concatenate([np.asarray(pvalid), np.ones(len(qf), bool)]))


def port_graph_nodes(model, cfg, support_x, support_y, query_x, eval_mdns: bool,
                     train: bool) -> np.ndarray:
    """The port model's episode-graph node features (V, d) as a numpy
    array (train=True updates the model's running statistics)."""
    from r3dfsseg_tpu_torch.models import mpti
    from r3dfsseg_tpu_torch.models.episode import Episode

    with torch.no_grad():
        ep = Episode(*(torch.from_numpy(a)[None] for a in (support_x, support_y, query_x)), None)
        sf, qf = model.extract_features(ep, train=train)
        sf, qf = sf[0], qf[0]
        fg = ep.support_y[0] > 0
        used = fg
        if eval_mdns:
            keep, _ = mpti.mdns_keep_mask(sf, fg, ep.support_x[0, ..., :3], cfg.mdns_scales)
            used = fg & (keep[..., None] > 0.5)
        protos, _, _, _ = mpti.episode_graph_nodes(sf, used, fg, cfg)
    return torch.cat([protos, qf.reshape(-1, qf.shape[-1])]).numpy()


# the reference-faithful modes new to the port since the shipped threshold
# + Chebyshev: (affinity_impl, lp_solver, graph_dtype)
PARITY_MODES = [(aff, solver, graph) for aff in ("threshold", "topk")
                for solver in ("cheby", "cg", "solve") for graph in ("float32", "bfloat16")
                if (aff, solver) != ("threshold", "cheby")]


def jax_mode_model(mode):
    """(JAX tiny config, port tiny config, JAX MPTINet, its variable
    shapes) in ``mode`` (a PARITY_MODES entry), attention dropout 0."""
    import jax
    import jax.numpy as jnp
    from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
    from r3dfsseg_tpu.models import mpti as jax_mpti
    from r3dfsseg_tpu.models.episode import Episode as JaxEpisode
    from r3dfsseg_tpu_torch.config import tiny_config

    aff, solver, graph = mode
    kw = dict(affinity_impl=aff, lp_solver=solver, graph_dtype=graph, attn_dropout=0.0)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    model = jax_mpti.MPTINet(jcfg)
    w, k, n, c = jcfg.n_way, jcfg.k_shot, jcfg.pc_npts, jcfg.pc_in_dim
    ep = JaxEpisode(jnp.zeros((w, k, n, c)), jnp.zeros((w, k, n), jnp.int32),
                    jnp.zeros((w, n, c)), jnp.zeros((w, n), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, ep))
    return jcfg, cfg, model, shapes


def _jax_selection(node: np.ndarray, valid: np.ndarray, k: int, impl: str, bf16: bool):
    """The JAX package's neighbour selection (N, N) bool on its own nodes:
    the rows' masks before the symmetrisation, the threshold radius from
    the Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    import r3dfsseg_tpu.ops.lp as jax_lp
    from r3dfsseg_tpu.ops.knn import pairwise_sqdist
    from r3dfsseg_tpu.ops.pallas_kth import kth_smallest_per_row_pallas

    f = jnp.asarray(node)
    if bf16:
        xc = f - jnp.mean(f, axis=0, keepdims=True)
        sqd = jax_lp._centered_sqdist(xc.astype(jnp.bfloat16),
                                      jnp.sum(xc * xc, axis=-1, keepdims=True))
    else:
        sqd = pairwise_sqdist(f)
    drop = jnp.asarray(np.eye(len(node), dtype=bool) | ~valid[None, :])

    def masked(d):
        return jnp.where(drop, jnp.asarray(1e30, d.dtype), d)
    if impl == "topk":
        return np.asarray(jax_lp._exact_topk_select(masked(sqd), k)[0])
    sel = masked(sqd.astype(jnp.bfloat16) if bf16 else sqd)
    radius = kth_smallest_per_row_pallas(sel, k, iters=16 if bf16 else 32, tile_n=8,
                                         interpret=True)
    return np.asarray(sel.astype(jnp.float32) <= radius)


def _port_selection(node: np.ndarray, valid: np.ndarray, k: int, impl: str, bf16: bool):
    """The port's neighbour selection, as `_jax_selection`."""
    from r3dfsseg_tpu_torch.ops import cuda_kth, lp

    x, ok = torch.from_numpy(node), torch.from_numpy(valid)
    cdt = torch.bfloat16 if bf16 else None
    if impl == "topk":
        return lp.exact_topk_select(lp._masked(lp._sqdist(x, cdt), ok), k)[0].numpy()
    _, sel = lp.graph_distances(x, ok, cdt)
    radius = cuda_kth.kth_smallest_per_row_reference(sel, k, 16 if bf16 else 32)
    return (sel.float() <= radius).numpy()


def assert_same_neighbours(enc, jax_cfg, cfg, model, support_x, support_y, query_x,
                           eval_mdns: bool, train: bool) -> None:
    """Each framework's neighbour selection (the config's `affinity_impl`
    and graph dtype) on its own episode-graph nodes keeps the same (i, j)
    pairs; ``enc`` maps clouds to JAX embeddings, ``model`` is the port's
    (copied, so train=True leaves it as it was)."""
    import copy

    node_j, valid = jax_graph_nodes(enc, jax_cfg, support_x, support_y, query_x, eval_mdns)
    node_t = port_graph_nodes(copy.deepcopy(model), cfg, support_x, support_y, query_x,
                              eval_mdns, train)
    args = (valid, cfg.k_connect, cfg.affinity_impl, cfg.graph_bf16)
    keep_j, keep_t = _jax_selection(node_j, *args), _port_selection(node_t, *args)
    assert (keep_j == keep_t).all(), f"the selections differ on {(keep_j != keep_t).sum()} pairs"


def jax_graph_margin(enc, jax_cfg, support_x, support_y, query_x, eval_mdns: bool) -> float:
    """Smallest gap, over the rows of the JAX model's episode graph, between
    the k-th and the (k+1)-th neighbour distance, relative to the squared
    norms that the Gram form cancels (float64).  ``enc`` maps clouds to
    JAX embeddings.  Near 1e-7 the two frameworks' f32 roundings can swap
    those neighbours, and the logits then differ by O(0.1) while both are
    right."""
    node, valid = jax_graph_nodes(enc, jax_cfg, support_x, support_y, query_x, eval_mdns)
    node = node.astype(np.float64)
    d = ((node[:, None] - node[None]) ** 2).sum(-1)
    d[np.eye(len(d), dtype=bool) | ~valid[None]] = np.inf
    s = np.sort(d, axis=1)
    kc = jax_cfg.k_connect
    nrm = (node * node).sum(1)
    return float(((s[:, kc] - s[:, kc - 1]) / (nrm + np.median(nrm)))[valid].min())
