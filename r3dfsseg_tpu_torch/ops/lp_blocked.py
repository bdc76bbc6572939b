"""Label propagation on scene-scale graphs, built in row tiles
(counterpart of `r3dfsseg_tpu/ops/lp_blocked.py`).

The dense path (`ops/lp.py`) materialises several (M, M) buffers while it
builds the affinity.  Whole-scene serving reaches M = 300 + P nodes, so
past 18,000 nodes `serve.py:FewShotPredictor.predict_scene` takes this
module instead.  It runs the same threshold affinity and Chebyshev solve
with at most one (row_tile, M) float32 intermediate alive at a time:

  * per-row k-th-distance radius r_i by the value-space bisection of the
    dense threshold path, over ONE global bracket [0, 4 max |x|^2], so that
    the radii do not depend on the tiling;
  * A_ij = exp(-0.5 d_ij / sigma^2) * ([d_ij <= r_i] + [d_ij <= r_j]),
    zero diagonal, invalid rows and columns zeroed;
  * the auto bandwidth sigma^2 = median(valid r_i) / 4 when sigma <= 0;
  * S = D^-1/2 A D^-1/2 with the same eps, and the Chebyshev recurrence on
    the eigenvalue bounds [1 - alpha, 1 + alpha] (`cuda_cheby.chebyshev`;
    its scalars in double on the host).

`blocked_label_propagate` stores the graph once when it fits a byte
budget (float32, bf16, or "split": an f32-built graph stored in bf16 with
the direction kept as bf16 hi + lo columns) and otherwise rebuilds every
tile in every matvec.  `sparse_label_propagate` keeps each row's largest
entries once and runs gather matvecs.

Everything here is plain PyTorch: the JAX package computes it in XLA,
outside any Pallas kernel, and its bisection is the plain one
(`cuda_kth.kth_smallest_per_row_reference` with ``hi``), not kernel 4,
which brackets each row by its own maximum.  Forward only (serving).

bf16 x bf16 products with float32 output (the JAX package's
``preferred_element_type=float32``) are taken as float32 products of the
upcast operands, which is exact; TF32 stays off (`pin_f32_matmul`).  A
stored graph is upcast one row tile at a time in the matvec, so the peak
stays near the stored graph plus a few (row_tile, M_pad) float32 tiles.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_kth
from r3dfsseg_tpu_torch.ops.lp import _BIG, _EPS, auto_sigma2
# the stored graph's byte budget and the row tile: the JAX package's
# numbers, so that the port takes the JAX package's branch for a scene
STORE_BUDGET = 9.2e9
ROW_TILE = 512


def tile_sqdist(fi: torch.Tensor, f_all: torch.Tensor, ni: torch.Tensor,
                n_all: torch.Tensor) -> torch.Tensor:
    """(R, M) squared distances of the row tile fi (R, d) to f_all (M, d),
    float32, from their norms ni (R,) and n_all (M,) and one Gram, clamped
    at 0: the JAX package's `_tile_sqdist`."""
    gram = torch.mm(fi, f_all.t())
    return ((ni[:, None] + n_all[None, :]) - 2.0 * gram).clamp_min_(0.0)


def _graph_build(node_feat: torch.Tensor, valid: torch.Tensor, *, k: int, sigma: float,
                 row_tile: int, compute_dtype: torch.dtype | None,
                 compare_dtype: torch.dtype | None = None):
    """The build shared by both variants: pad to ``row_tile`` and centre
    the features, the masked distance row tiles, the per-row radii and the
    bandwidth.

    compare_dtype (default: compute_dtype) is the dtype of the neighbour
    selection's compares only, the bisection's reads and the membership
    tests; the split store passes bf16 here, with 16 bisection steps,
    while distances, exp and the solve stay float32.

    Returns (m_pad, n_tiles, affinity_tile): ``affinity_tile(t)`` is the
    (row_tile, M_pad) float32 symmetrised affinity of row tile t."""
    m, d = node_feat.shape
    r_t = int(row_tile)
    m_pad = -(-m // r_t) * r_t
    n_tiles = m_pad // r_t
    dev = node_feat.device

    f32 = node_feat.float()
    vpad = torch.zeros(m_pad, dtype=torch.bool, device=dev)
    vpad[:m] = valid
    # centred features: a bf16 Gram's rounding lands relative, not absolute
    xc = f32 - torch.where(valid[:, None], f32, 0.0).mean(0, keepdim=True)
    norms = (xc * xc).sum(-1)
    fpad = torch.zeros((m_pad, d), dtype=compute_dtype or torch.float32, device=dev)
    fpad[:m] = xc.to(fpad.dtype)
    fpad = fpad.float()               # exact: the products are taken in float32
    npad = torch.zeros(m_pad, dtype=torch.float32, device=dev)
    npad[:m] = norms
    iota = torch.arange(m_pad, device=dev)

    def masked_tile(t):
        """(R, M_pad) distances of row tile t with self, invalid and pad
        entries at the sentinel, and the mask of those entries."""
        s = slice(t * r_t, (t + 1) * r_t)
        dist = tile_sqdist(fpad[s], fpad, npad[s], npad)
        dead = (iota[s, None] == iota[None, :]) | ~vpad[None, :] | ~vpad[s, None]
        return dist.masked_fill_(dead, _BIG), dead

    # d_ij = |x_i - x_j|^2 <= 4 max |x|^2 bounds every real distance, does
    # not depend on the tiling and needs no extra distance pass
    hi_global = 4.0 * torch.where(vpad, npad, 0.0).max().clamp_min(1e-6)
    cmp_dtype = compare_dtype if compare_dtype is not None else compute_dtype
    # 16 steps on a half-width copy resolve past bf16's own resolution
    iters = 32 if cmp_dtype is None else 16

    def compare_copy(dist):
        return dist if cmp_dtype is None else dist.to(cmp_dtype)

    radii = torch.cat([
        cuda_kth.kth_smallest_per_row_reference(compare_copy(masked_tile(t)[0]), k, iters,
                                                hi=hi_global).reshape(-1)
        for t in range(n_tiles)])
    radii = torch.where(vpad, radii, _BIG)

    if sigma <= 0:
        sigma2 = auto_sigma2(radii, vpad)
    else:
        sigma2 = torch.tensor(sigma * sigma, dtype=torch.float32, device=dev)

    def affinity_tile(t):
        """(R, M_pad) symmetrised affinity rows.  The membership compares
        run on the compare copy that the bisection resolved the radii on,
        with the radii cast to its dtype, so that ties enter as on the
        dense path; the similarities stay float32."""
        dist, dead = masked_tile(t)
        cmp = compare_copy(dist)
        r_rows = radii[t * r_t:(t + 1) * r_t]
        cnt = ((cmp <= r_rows[:, None].to(cmp.dtype)).float()
               + (cmp <= radii[None, :].to(cmp.dtype)).float())
        sim = torch.exp(-0.5 * dist / sigma2)
        return (sim * cnt).masked_fill_(dead, 0.0)

    return m_pad, n_tiles, affinity_tile


def padded(x: torch.Tensor, rows: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (R, ...) in a zero tensor of ``rows`` rows and ``dtype``."""
    out = torch.zeros((rows, *x.shape[1:]), dtype=dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def scene_lp_mode(m: int, *, row_tile: int = ROW_TILE, compute_dtype: torch.dtype | None = None,
                  store_graph: bool | None = None, split_store: bool | None = None) -> str:
    """Which of `blocked_label_propagate`'s modes a graph of m nodes takes:
    "split" (an f32-built graph stored in bf16), "stored" (at compute_dtype)
    or "stream" (rematerialised in every matvec).  store_graph and
    split_store as given, else by STORE_BUDGET, as in the JAX package."""
    m_pad = -(-m // int(row_tile)) * int(row_tile)
    if split_store:
        if compute_dtype is not None:
            raise ValueError("split_store builds the graph in float32 and stores it in bf16: "
                             "compute_dtype must be None")
        return "split"
    if store_graph is None:
        itemsize = (compute_dtype or torch.float32).itemsize
        store_graph = m_pad * m_pad * itemsize <= STORE_BUDGET
        if (not store_graph and compute_dtype is None and split_store is None
                and m_pad * m_pad * 2 <= STORE_BUDGET):
            # f32 accuracy past the f32 storage budget: f32 distances and
            # exp, selection on a bf16 compare copy, similarities stored
            # once in bf16, the direction kept exact as bf16 hi + lo
            return "split"
    return "stored" if store_graph else "stream"


def blocked_label_propagate(node_feat: torch.Tensor, y: torch.Tensor, *, k: int, sigma: float,
                            alpha: float, valid: torch.Tensor, iters: int = 50,
                            row_tile: int = ROW_TILE, compute_dtype: torch.dtype | None = None,
                            store_graph: bool | None = None,
                            split_store: bool | None = None) -> torch.Tensor:
    """Z = (I - alpha S)^-1 Y with the affinity built in row tiles, (M, C)
    float32.

    Args:
      node_feat: (M, d) node features (prototypes ++ scene points).
      y: (M, C) label matrix.
      k: neighbours per node (k_connect).
      sigma: gaussian bandwidth; <= 0 selects the auto bandwidth.
      alpha: propagation coefficient.
      valid: (M,) bool; invalid nodes leave the graph entirely.
      iters: Chebyshev iterations.
      row_tile: rows per built tile.
      compute_dtype: None or torch.bfloat16, the dtype of the Gram's
        operands, the selection compares and the stored graph.
      store_graph, split_store: the mode (`scene_lp_mode`): the graph built
        once and stored, at compute_dtype or, split, in bf16 from an f32
        build; or rebuilt in every matvec.
    """
    mode = scene_lp_mode(node_feat.shape[0], row_tile=row_tile, compute_dtype=compute_dtype,
                         store_graph=store_graph, split_store=split_store)
    split = mode == "split"
    m_pad, n_tiles, affinity_tile = _graph_build(
        node_feat, valid, k=k, sigma=sigma, row_tile=row_tile, compute_dtype=compute_dtype,
        compare_dtype=torch.bfloat16 if split else None)
    tiles = [slice(t * row_tile, (t + 1) * row_tile) for t in range(n_tiles)]
    dev = node_feat.device
    deg = torch.empty(m_pad, dtype=torch.float32, device=dev)

    if mode == "stream":
        for t, s in enumerate(tiles):
            deg[s] = affinity_tile(t).sum(1)

        def product(zt):
            return torch.cat([torch.mm(affinity_tile(t), zt) for t in range(n_tiles)])
    else:
        store_dt = torch.bfloat16 if split else (compute_dtype or torch.float32)
        a_full = torch.empty((m_pad, m_pad), dtype=store_dt, device=dev)
        for t, s in enumerate(tiles):
            a_full[s] = affinity_tile(t)
            deg[s] = a_full[s].sum(1, dtype=torch.float32)

        def product(zt):
            # one row tile of the stored graph upcast at a time
            return torch.cat([torch.mm(a_full[s].float(), zt) for s in tiles])

    rinv = torch.sqrt(1.0 / (deg + _EPS))[:, None]

    def matvec(z):
        zt = z * rinv
        if split:
            c = z.shape[1]
            sz2 = product(cuda_cheby.split_columns(zt).float())   # [hi | lo]
            sz = sz2[:, :c] + sz2[:, c:]
        else:
            sz = product(zt)
        return z - alpha * sz * rinv

    z = cuda_cheby.chebyshev(matvec, padded(y.float(), m_pad), alpha, max(iters, 1))
    return z[:node_feat.shape[0]]


def sparse_label_propagate(node_feat: torch.Tensor, y: torch.Tensor, *, k: int, sigma: float,
                           alpha: float, valid: torch.Tensor, iters: int = 50,
                           row_tile: int = ROW_TILE, width: int | None = None,
                           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Like `blocked_label_propagate`, but each row keeps its ``width``
    largest affinity entries (default min(2k + 112, M_pad)) from one build
    pass, the degrees are the kept mass, and every Chebyshev matvec is a
    gather (``R3D_SCENE_LP=sparse``)."""
    m_pad, n_tiles, affinity_tile = _graph_build(
        node_feat, valid, k=k, sigma=sigma, row_tile=row_tile, compute_dtype=compute_dtype)
    w = int(width) if width is not None else min(2 * k + 112, m_pad)
    kept = [torch.topk(affinity_tile(t), w, dim=1) for t in range(n_tiles)]
    vals = torch.cat([v for v, _ in kept])
    idx = torch.cat([i for _, i in kept]).reshape(-1)
    del kept
    rinv = torch.sqrt(1.0 / (vals.sum(1) + _EPS))[:, None]

    def matvec(z):
        g = (z * rinv)[idx].reshape(m_pad, w, -1)
        return z - alpha * ((g * vals[..., None]).sum(1) * rinv)

    z = cuda_cheby.chebyshev(matvec, padded(y.float(), m_pad), alpha, max(iters, 1))
    return z[:node_feat.shape[0]]
