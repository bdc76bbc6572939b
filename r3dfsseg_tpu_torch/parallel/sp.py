"""Node-sharded scene label propagation on `torch.distributed`
(counterpart of `r3dfsseg_tpu/parallel/sp.py`).

The graph of a whole scene is sharded by rows over the ranks of a mesh
(`parallel/mesh.py`), so its node count grows with the mesh's total memory
rather than one device's.  Each function here is the body of ONE rank:
every rank of the mesh calls it with the same (replicated) node features,
labels and mask, builds and keeps the graph rows it owns, and returns the
replicated (M, C) Z.  The collectives:

  * one max all-reduce for the dense form's bisection bound,
  * all-gathers of the per-row radii and of the inverse-sqrt degrees,
  * one (M, C) all-gather per Chebyshev matvec.

A rank owns rows [r blk, (r + 1) blk) and computes them whole, with the
unsharded grouping of each term, so the degrees are exact and the
affinity is symmetrised without a transpose.  The radius is the plain
bisection (`cuda_kth.kth_smallest_per_row_reference`) over ONE bracket
that every rank shares: the max all-reduce of the finite distances
(`sp_label_propagate`), or 4 max |x|^2 from the replicated norms
(`sp_blocked_label_propagate`).  Kernel 4 brackets each row by its own
maximum, so it does not run here, as the JAX package leaves this
bisection to XLA; nor does kernel 7, whose matvec is not sharded.  On a
mesh with no group (size 1) every collective is the identity.

Forward only (serving).  Everything is plain PyTorch, with TF32 off
(`pin_f32_matmul`).
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_kth, lp_blocked
from r3dfsseg_tpu_torch.ops.lp import _BIG, _EPS, AFFINITY_METHODS, auto_sigma2, cosine_rows
from r3dfsseg_tpu_torch.ops.lp_blocked import ROW_TILE, padded, tile_sqdist
from r3dfsseg_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_max


def sp_label_propagate(node_feat: torch.Tensor, y: torch.Tensor, *, mesh: Mesh, k: int,
                       sigma: float = 1.0, alpha: float = 0.99,
                       valid: torch.Tensor | None = None, method: str = "gaussian",
                       iters: int = 50) -> torch.Tensor:
    """Z = (I - alpha S)^-1 Y, (M, C) float32, with the dense threshold
    graph sharded by rows over ``mesh``: this rank's body.

    Args:
      node_feat: (M, d) node features, the same on every rank.
      y: (M, C) label matrix, the same on every rank.
      mesh: the mesh; M is padded to a multiple of its size with invalid
        rows, which are masked whole and left out of the bisection bound
        (invalid rows of M are not).
      k, sigma, method: the graph (`ops/lp.py:local_constrained_affinity`
        with impl 'threshold'; sigma <= 0 the auto bandwidth).
      alpha, iters: the Chebyshev solve (`label_propagate`, 'cheby').
      valid: optional (M,) bool mask of real nodes.
    """
    if method not in AFFINITY_METHODS:
        raise NotImplementedError(f"affinity method {method!r}: one of {AFFINITY_METHODS}")
    m, dev = node_feat.shape[0], node_feat.device
    if valid is None:
        valid = torch.ones(m, dtype=torch.bool, device=dev)
    mp = -(-m // mesh.size) * mesh.size
    feat = padded(node_feat.float(), mp)
    vp = padded(valid, mp, torch.bool)
    blk = mp // mesh.size
    own = slice(mesh.rank * blk, (mesh.rank + 1) * blk)
    fb, vb = feat[own], vp[own]

    # this rank's (blk, Mp) distances, in the unsharded grouping
    xx = (fb * fb).sum(-1, keepdim=True)
    yy = (feat * feat).sum(-1, keepdim=True)
    d = (xx + yy.t()).sub_(torch.mm(fb, feat.t()).mul_(2.0)).clamp_min_(0.0)
    iota = torch.arange(mp, device=dev)
    eye = iota[own, None] == iota[None, :]
    dmask = d.masked_fill(eye | ~vp[None, :] | (iota[own] >= m)[:, None], _BIG)

    # one bracket for every row of every rank: the largest finite distance
    local_hi = torch.where(dmask < 0.5 * _BIG, dmask, 0.0).amax()
    hi = all_reduce_max(local_hi, mesh).clamp_min(1e-6)
    radius = cuda_kth.kth_smallest_per_row_reference(dmask, k, 32, hi=hi)     # (blk, 1)
    r_all = all_gather_rows(radius.reshape(-1), mesh)                           # (Mp,)

    if method == "cosine":
        sim = torch.mm(cosine_rows(fb), cosine_rows(feat).t())
    else:
        sigma2 = auto_sigma2(r_all, vp) if sigma <= 0 else sigma * sigma
        sim = torch.exp(-0.5 * d / sigma2)
    del d
    # symmetrised without a transpose: sim_ij ([d_ij <= r_i] + [d_ij <= r_j])
    cnt = (dmask <= radius).float().add_(dmask <= r_all[None, :])
    del dmask
    a = sim.mul_(cnt).masked_fill_(eye, 0.0)
    del cnt
    a.mul_(vb.float()[:, None]).mul_(vp.float()[None, :])

    # S = D^-1/2 A D^-1/2: the degrees are exact, each row is whole here
    rinv = torch.sqrt(1.0 / (a.sum(1) + _EPS))
    rinv_all = all_gather_rows(rinv, mesh)
    s_blk = a.mul_(rinv[:, None]).mul_(rinv_all[None, :])

    def matvec(z):
        return z - alpha * all_gather_rows(torch.mm(s_blk, z), mesh)

    z = cuda_cheby.chebyshev(matvec, padded(y.float(), mp), alpha, max(iters, 1))
    return z[:m]


def sp_blocked_plan(m: int, size: int, *, row_tile: int = ROW_TILE,
                    compute_dtype: torch.dtype | None = None,
                    store_graph: bool | None = None) -> tuple[int, str]:
    """(blk, mode) of `sp_blocked_label_propagate` for m nodes over ``size``
    ranks: each rank's rows, ceil(m / size) rounded up to ``row_tile``, and
    "stored" (at compute_dtype), "split" (an f32-built graph stored in
    bf16) or "stream" (rebuilt in every matvec): store_graph as given,
    else by `lp_blocked.STORE_BUDGET` bytes of blk x blk * size a rank, as
    the JAX package decides."""
    r_t, per_rank = int(row_tile), -(-m // size)
    blk = -(-per_rank // r_t) * r_t
    if store_graph is not None:
        return blk, "stored" if store_graph else "stream"
    cells = blk * blk * size
    if cells * (compute_dtype or torch.float32).itemsize <= lp_blocked.STORE_BUDGET:
        return blk, "stored"
    if compute_dtype is None and cells * 2 <= lp_blocked.STORE_BUDGET:
        return blk, "split"
    return blk, "stream"


def sp_blocked_label_propagate(node_feat: torch.Tensor, y: torch.Tensor, *, mesh: Mesh, k: int,
                               sigma: float = 1.0, alpha: float = 0.99,
                               valid: torch.Tensor | None = None, iters: int = 50,
                               row_tile: int = ROW_TILE,
                               compute_dtype: torch.dtype | None = None,
                               store_graph: bool | None = None) -> torch.Tensor:
    """Z, (M, C) float32, with the graph sharded by rows over ``mesh`` and
    each rank's rows built in tiles of ``row_tile`` (`ops/lp_blocked.py`'s
    recipe): this rank's body.

    The preamble is replicated: the features centred on the valid rows'
    mean, their norms, the rows padded to blk * size (`sp_blocked_plan`).
    The radii bisect [0, 4 max |x|^2] (32 steps on f32 distances, 16 on a
    bf16 copy under compute_dtype bf16), so they depend neither on the
    tiling nor on the sharding and need no collective.  The graph is
    stored (f32, bf16, or split: bf16 with the direction kept as bf16 hi
    + lo columns) or rebuilt in every matvec, by `sp_blocked_plan`.  The
    split store selects on the f32 distances, as the JAX package's
    sharded form does, where the single-device split selects on a bf16
    copy."""
    m, dev = node_feat.shape[0], node_feat.device
    if valid is None:
        valid = torch.ones(m, dtype=torch.bool, device=dev)
    r_t = int(row_tile)
    blk, mode = sp_blocked_plan(m, mesh.size, row_tile=r_t, compute_dtype=compute_dtype,
                                store_graph=store_graph)
    mp, n_tiles, i0 = blk * mesh.size, blk // r_t, mesh.rank * blk
    cmp_bf16 = compute_dtype is not None

    f32 = node_feat.float()
    xc = f32 - torch.where(valid[:, None], f32, 0.0).mean(0, keepdim=True)
    fpad = padded(xc.to(compute_dtype or torch.float32), mp,
                   compute_dtype or torch.float32).float()   # products in f32: exact
    npad = padded((xc * xc).sum(-1), mp)
    vpad = padded(valid, mp, torch.bool)
    iota = torch.arange(mp, device=dev)

    def masked_tile(t):
        s = slice(i0 + t * r_t, i0 + (t + 1) * r_t)
        dist = tile_sqdist(fpad[s], fpad, npad[s], npad)
        dead = (iota[s, None] == iota[None, :]) | ~vpad[None, :] | ~vpad[s, None]
        return dist.masked_fill_(dead, _BIG), dead

    hi_global = 4.0 * torch.where(vpad, npad, 0.0).max().clamp_min(1e-6)

    def radius_tile(t):
        dist = masked_tile(t)[0]
        cmp, steps = (dist.to(torch.bfloat16), 16) if cmp_bf16 else (dist, 32)
        return cuda_kth.kth_smallest_per_row_reference(cmp, k, steps, hi=hi_global).reshape(-1)

    radii = torch.cat([radius_tile(t) for t in range(n_tiles)])
    radii = torch.where(vpad[i0:i0 + blk], radii, _BIG)
    r_all = all_gather_rows(radii, mesh)                                        # (Mp,)
    sigma2 = (auto_sigma2(r_all, vpad) if sigma <= 0 else
              torch.tensor(sigma * sigma, dtype=torch.float32, device=dev))

    def affinity_tile(t):
        dist, dead = masked_tile(t)
        cmp = dist.to(torch.bfloat16) if cmp_bf16 else dist
        rr = r_all[i0 + t * r_t:i0 + (t + 1) * r_t]
        cnt = ((cmp <= rr[:, None].to(cmp.dtype)).float()
               + (cmp <= r_all[None, :].to(cmp.dtype)).float())
        sim = torch.exp(-0.5 * dist / sigma2)
        return (sim * cnt).masked_fill_(dead, 0.0)

    tiles = [slice(t * r_t, (t + 1) * r_t) for t in range(n_tiles)]
    deg = torch.empty(blk, dtype=torch.float32, device=dev)
    if mode == "stream":
        for t, s in enumerate(tiles):
            deg[s] = affinity_tile(t).sum(1)

        def product(zt):
            return torch.cat([torch.mm(affinity_tile(t), zt) for t in range(n_tiles)])
    else:
        store_dt = torch.bfloat16 if mode == "split" else (compute_dtype or torch.float32)
        a_blk = torch.empty((blk, mp), dtype=store_dt, device=dev)
        for t, s in enumerate(tiles):
            a_blk[s] = affinity_tile(t)
            deg[s] = a_blk[s].sum(1, dtype=torch.float32)

        def product(zt):
            # one row tile of the stored rows upcast at a time
            return torch.cat([torch.mm(a_blk[s].float(), zt) for s in tiles])

    rinv = torch.sqrt(1.0 / (deg + _EPS))
    rinv_all = all_gather_rows(rinv, mesh)

    def matvec(z):
        zt = z * rinv_all[:, None]
        if mode == "split":
            c = z.shape[1]
            sz2 = product(cuda_cheby.split_columns(zt).float())   # [hi | lo]
            sz = sz2[:, :c] + sz2[:, c:]
        else:
            sz = product(zt)
        return z - alpha * all_gather_rows(sz * rinv[:, None], mesh)

    z = cuda_cheby.chebyshev(matvec, padded(y.float(), mp), alpha, max(iters, 1))
    return z[:m]
