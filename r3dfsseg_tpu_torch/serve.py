"""Serving API (counterpart of `r3dfsseg_tpu/serve.py`).

    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.serve import FewShotPredictor

    p = FewShotPredictor.from_checkpoint("<log_dir>", R3DConfig())   # on "cuda"
    labels = p.predict(support_x, support_y, query_x)   # (Q, N) int32

`support_x` is (n_way, k_shot, n_points, 9) xyzrgbXYZ, `support_y`
(n_way, k_shot, n_points) binary fg masks, `query_x` (Q, n_points, 9);
labels are 0 = background, 1..n_way = way.  MDNS clean-shot suppression is
on by default.  The learner follows ``cfg.phase``, as in the JAX package:
the MPTI phases serve the MPTI model, ``protoeval``/``prototrain``
ProtoNet_Contrast and ``transformereval``/``transformertrain`` the
transformer baseline (`learners/__init__.py:make_learner`); any other phase
raises.  The predictor runs on ``device``, "cuda" unless the caller asks
for "cpu".  Checkpoints: the JAX package's `checkpoint.msgpack`
(`utils/checkpoint.py`) and the original PyTorch model's `checkpoint.tar`
(`utils/torch_convert.py`).

Whole-scene serving, `predict_scene`: the scene's P points, cut into
blocks of ``pc_npts`` on the host (`scene_blocks`), join one
label-propagation graph with the support prototypes, M = (n_way + 1) *
n_subprototypes + P nodes, whatever ``cfg.phase`` is (the learner model's
encoder and MPTI's graph nodes, as in the JAX package).  The graph is
dense (`ops/lp.py`: kernel 4, and kernel 7 on a bf16 graph where it fits)
up to 18,000 nodes and blocked past them (`ops/lp_blocked.py`: stored in
float32 up to 47,616 nodes, then split-stored in bf16).  The environment
variable ``R3D_SCENE_LP``, read at each call, selects the path: ``auto``
(the default) by size, ``blocked`` or ``sparse`` that graph, any other
value the dense graph.

``predict_scene(..., mesh=mesh)`` shards the graph by rows over a mesh
(`parallel/sp.py`), so that its node count grows with the mesh's memory.
Every rank calls it with the same host inputs: the blocks are padded to a
multiple of the mesh's size with zero blocks, each rank encodes its own
blocks and the scene's features are all-gathered in block order; the
support, MDNS and prototypes are computed on every rank and rank 0's nodes
broadcast (`replicate_scene_nodes`).  The sharded graph is dense up to
18,000 nodes and blocked past them or under ``R3D_SCENE_LP=blocked``
(``sparse`` takes the dense one), as in the JAX package; every rank
returns the whole scene's labels.

    mesh = make_mesh(device="cuda")        # in each rank (parallel.launch, torchrun)
    labels = predictor.predict_scene(support_x, support_y, xyz, rgb, mesh=mesh)
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners import make_learner
from r3dfsseg_tpu_torch.learners.base import Learner
from r3dfsseg_tpu_torch.models import mpti
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.ops import lp, lp_blocked
from r3dfsseg_tpu_torch.parallel import sp
from r3dfsseg_tpu_torch.parallel.mesh import Mesh, all_gather_rows, replicate, shard_rows
from r3dfsseg_tpu_torch.utils.checkpoint import restore

# past this many nodes the dense graph's several M^2 float32 build buffers
# crowd one device, and the blocked graph takes over (the JAX package's
# number, sized for a 16 GB TPU)
DENSE_MAX_NODES = 18000


def scene_blocks(scene_xyz: np.ndarray, scene_rgb: Optional[np.ndarray], n: int, *,
                 cell: float = 1.0):
    """The host's block assembly of `predict_scene`: points sorted by
    ``cell``-metre (x, y) cells and then z, cut into blocks of n points
    (the last one padded by cycling the sorted points), each block's xyz
    shifted to its minimum, rgb, and xyz normalised by the scene's extent.

    Returns (blocks (ceil(P / n), n, 9) float32 xyzrgbXYZ, pad_mask
    (blocks * n,) bool, True on the first P nodes, order (P,): the point at
    each sorted position)."""
    xyz = np.asarray(scene_xyz, np.float32)
    p = xyz.shape[0]
    rgb = (np.zeros((p, 3), np.float32) if scene_rgb is None
           else np.asarray(scene_rgb, np.float32))
    mn = xyz.min(0)
    cid = np.floor((xyz[:, :2] - mn[:2]) / max(cell, 1e-6)).astype(np.int64)
    order = np.lexsort((xyz[:, 2], cid[:, 1], cid[:, 0]))
    n_blocks = -(-p // n)
    idx = np.resize(order, n_blocks * n)     # cycle the sorted points into the pad
    blocks_xyz = xyz[idx].reshape(n_blocks, n, 3)
    blocks_rgb = rgb[idx].reshape(n_blocks, n, 3)
    # per-block min shift and scene-extent normalisation, the sampler's
    # attribute conventions
    local = blocks_xyz - blocks_xyz.min(axis=1, keepdims=True)
    scale = np.maximum((xyz - mn).max(0), 1e-6)
    glob = (blocks_xyz - mn) / scale
    blocks = np.concatenate([local, blocks_rgb, glob], axis=-1)
    pad_mask = np.zeros(n_blocks * n, bool)
    pad_mask[:p] = True
    return blocks, pad_mask, order


def pad_blocks(blocks: np.ndarray, pad_mask: np.ndarray, size: int):
    """(blocks, pad_mask) with zero blocks (and False nodes) appended up to
    a multiple of ``size`` blocks, the JAX package's mesh-divisible batch."""
    nb, n = blocks.shape[:2]
    more = -(-nb // size) * size - nb
    if not more:
        return blocks, pad_mask
    return (np.concatenate([blocks, np.zeros((more, *blocks.shape[1:]), blocks.dtype)]),
            np.concatenate([pad_mask, np.zeros(more * n, bool)]))


def scene_lp_path(m: int, cfg: R3DConfig, mesh: Optional[Mesh] = None) -> str:
    """The scene graph a graph of m nodes takes under ``R3D_SCENE_LP``
    (default "auto"): "dense", "sparse", or "blocked-" and
    `lp_blocked.scene_lp_mode`'s "stored", "split" or "stream"; over a
    ``mesh``, "sharded-dense", or "sharded-blocked-" and
    `sp.sp_blocked_plan`'s mode."""
    impl = os.environ.get("R3D_SCENE_LP", "auto")
    if mesh is not None:
        if impl == "blocked" or m > DENSE_MAX_NODES:
            lowp = torch.bfloat16 if cfg.graph_bf16 else None
            return "sharded-blocked-" + sp.sp_blocked_plan(m, mesh.size, compute_dtype=lowp)[1]
        return "sharded-dense"
    if impl == "sparse":
        return "sparse"
    if impl == "blocked" or (impl == "auto" and m > DENSE_MAX_NODES):
        lowp = torch.bfloat16 if cfg.graph_bf16 else None
        return "blocked-" + lp_blocked.scene_lp_mode(m, compute_dtype=lowp)
    return "dense"


def scene_label_propagate(node_feat: torch.Tensor, y0: torch.Tensor, node_valid: torch.Tensor,
                          cfg: R3DConfig, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Z (M, n_classes) of the scene graph, on the path `scene_lp_path`
    names: the dense threshold affinity and Chebyshev solve at the graph
    dtype (`graph_dtype`, "auto" following `compute_dtype`), or
    `lp_blocked`'s blocked or sparse graph.  Kernels 4 and 7 follow
    ``cfg.follower_impl``, as on the episode graph.  Over a ``mesh``, this
    rank's part of the sharded graph (`parallel/sp.py`): the dense one in
    float32 (no graph dtype, as in the JAX package), or the blocked one,
    bf16 where the graph dtype is."""
    c = cfg
    lowp = torch.bfloat16 if c.graph_bf16 else None
    path = scene_lp_path(node_feat.shape[0], c, mesh)
    kw = dict(k=c.k_connect, sigma=c.sigma, alpha=c.lp_alpha, valid=node_valid,
              iters=c.lp_cg_iters)
    if path == "sharded-dense":
        return sp.sp_label_propagate(node_feat, y0, mesh=mesh, **kw)
    if path.startswith("sharded-blocked"):
        return sp.sp_blocked_label_propagate(node_feat, y0, mesh=mesh, compute_dtype=lowp, **kw)
    if path != "dense":
        fn = (lp_blocked.sparse_label_propagate if path == "sparse"
              else lp_blocked.blocked_label_propagate)
        return fn(node_feat, y0, compute_dtype=lowp, **kw)
    a = lp.local_constrained_affinity(node_feat, c.k_connect, c.sigma, valid=node_valid,
                                      compare_dtype=lowp, impl="threshold",
                                      kth_impl=c.follower_impl)
    return lp.label_propagate(a, y0, c.lp_alpha, solver="cheby", cg_iters=c.lp_cg_iters,
                              matvec_dtype=lowp, impl=c.follower_impl)


def replicate_scene_nodes(node_feat: torch.Tensor, node_valid: torch.Tensor, y0: torch.Tensor,
                          mesh: Mesh) -> int:
    """Rank 0's scene nodes on every rank, in place, in one broadcast: the
    ranks compute the prototypes each on their own, and a device's
    reductions (`index_add_` adds in atomic order on CUDA) may differ by
    rounding between them.  Returns the number of this rank's node-feature
    entries that differed from rank 0's."""
    if mesh.group is None:
        return 0
    flat = torch.cat([node_feat.reshape(-1), y0.reshape(-1), node_valid.float()])
    replicate([flat], mesh)
    nf, ny = node_feat.numel(), y0.numel()
    differed = int((node_feat.reshape(-1) != flat[:nf]).sum())
    node_feat.copy_(flat[:nf].view_as(node_feat))
    y0.copy_(flat[nf:nf + ny].view_as(y0))
    node_valid.copy_(flat[nf + ny:] > 0.5)
    return differed


class FewShotPredictor:
    """The learner of ``cfg.phase`` on ``device`` that segments query clouds."""

    def __init__(self, cfg: R3DConfig, learner: Optional[Learner] = None, *,
                 device: str | torch.device | None = None, eval_mdns: bool = True):
        self.cfg = cfg
        self.eval_mdns = eval_mdns
        self._learner = learner if learner is not None else make_learner(cfg, device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[R3DConfig] = None, *,
                        device: str | torch.device | None = None,
                        eval_mdns: bool = True) -> "FewShotPredictor":
        """A predictor whose weights come from ``path``: the JAX package's
        `checkpoint.msgpack`, a `checkpoint.tar` of the original PyTorch
        model (any schema of `utils/torch_convert.py:load_torch_checkpoint`;
        a pretraining checkpoint replaces the feature extractor's encoder
        only), or a log directory holding one, searched for
        `checkpoint.msgpack` first, then `checkpoint.tar`, as in the JAX
        package (`utils/checkpoint.py:restore`)."""
        self = cls(cfg or R3DConfig(), device=device, eval_mdns=eval_mdns)
        restore(path, self._learner)
        return self

    def predict(self, support_x: np.ndarray, support_y: np.ndarray,
                query_x: np.ndarray) -> np.ndarray:
        """Segment `query_x` against the support set: (Q, N) int32 labels."""
        c = self.cfg
        q, n = query_x.shape[0], query_x.shape[1]
        if (support_x.shape[:2] != (c.n_way, c.k_shot)
                or n != c.pc_npts or q != c.n_way * c.n_queries):
            raise ValueError(
                f"episode shape mismatch: support {support_x.shape}, "
                f"query {query_x.shape} vs config "
                f"({c.n_way}-way {c.k_shot}-shot, {c.pc_npts} pts, "
                f"{c.n_way * c.n_queries} queries)")
        ep = Episode(
            support_x=np.asarray(support_x, np.float32),
            support_y=np.asarray(support_y, np.int32),
            query_x=np.asarray(query_x, np.float32),
            query_y=np.zeros((q, n), np.int32))          # dummy: the loss is unused
        pred, _, _ = self._learner.test(ep, eval_mdns=self.eval_mdns)
        return pred[0].cpu().numpy()

    __call__ = predict

    def predict_scene(self, support_x: np.ndarray, support_y: np.ndarray,
                      scene_xyz: np.ndarray, scene_rgb: Optional[np.ndarray] = None, *,
                      mesh=None, cell: float = 1.0) -> np.ndarray:
        """Segment a whole scene in one transductive graph: (P,) int32
        labels (0 = bg, 1..n_way) in the input point order.

        support_x / support_y as `predict`; scene_xyz (P, 3) raw
        coordinates, scene_rgb (P, 3) colours in [0, 1] (zeros if
        omitted); ``cell`` the metres of the sort's (x, y) cells that group
        the points into blocks (`scene_blocks`).  ``mesh`` (`parallel.Mesh`,
        this rank's; every rank calls with the same inputs) shards the
        encoder's blocks and the graph over its ranks (module docstring)."""
        c = self.cfg
        if c.pc_in_dim != 9:
            raise NotImplementedError("predict_scene assembles xyzrgbXYZ attributes (9-d)")
        blocks, pad_mask, order = scene_blocks(scene_xyz, scene_rgb, c.pc_npts, cell=cell)
        if mesh is not None:
            blocks, pad_mask = pad_blocks(blocks, pad_mask, mesh.size)
        pred = self.scene_labels(blocks, pad_mask, support_x, support_y, mesh)
        out = np.empty(order.shape[0], np.int32)
        out[order] = pred[:order.shape[0]]
        return out

    def scene_nodes(self, blocks, pad_mask, support_x, support_y, mesh: Optional[Mesh] = None):
        """The scene graph's nodes on the device: the learner model's
        encoder on the blocks and on the support, MDNS (``eval_mdns``) and
        MPTI's prototypes.  Over a ``mesh`` this rank encodes its rows of
        the blocks (their number a multiple of the mesh's size) and the
        features are all-gathered in block order.  Returns (node_feat (M,
        d) float32, node_valid (M,), y0 (M, n_classes), the number of
        prototype nodes)."""
        c = self.cfg
        dev = self._learner.device
        features = self._learner.model.features
        with torch.inference_mode():
            blocks = np.asarray(blocks, np.float32)
            nbk, n = blocks.shape[:2]
            if mesh is None:
                scene_feat = features(torch.as_tensor(blocks, device=dev), False)
            else:
                own = torch.as_tensor(shard_rows(blocks, mesh), device=dev)
                scene_feat = all_gather_rows(features(own, False), mesh)
            d = scene_feat.shape[-1]
            sup_x = torch.as_tensor(np.asarray(support_x, np.float32), device=dev)
            sup_y = torch.as_tensor(np.asarray(support_y, np.int32), device=dev)
            sf = features(sup_x.reshape(c.n_way * c.k_shot, n, -1), False).reshape(
                c.n_way, c.k_shot, n, d)
            fg = sup_y > 0
            fg_used = fg
            if self.eval_mdns:
                keep, _ = mpti.mdns_keep_mask(sf, fg, sup_x[..., :3], c.mdns_scales)
                fg_used = fg & (keep[..., None] > 0.5)
            protos, pvalid, proto_labels, _ = mpti.episode_graph_nodes(sf, fg_used, fg, c)
            node_feat = torch.cat([protos.float(), scene_feat.reshape(nbk * n, d).float()])
            node_valid = torch.cat([pvalid, torch.as_tensor(pad_mask, device=dev)])
            y0 = torch.cat([proto_labels,
                            torch.zeros((nbk * n, c.n_classes), dtype=torch.float32, device=dev)])
        return node_feat, node_valid, y0, protos.shape[0]

    def scene_labels(self, blocks, pad_mask, support_x, support_y,
                     mesh: Optional[Mesh] = None) -> np.ndarray:
        """The scene program on assembled blocks: (nb * n,) int32 labels of
        the blocks' nodes, in block order; over a ``mesh`` from rank 0's
        nodes and the sharded graph."""
        node_feat, node_valid, y0, n_protos = self.scene_nodes(blocks, pad_mask, support_x,
                                                               support_y, mesh)
        with torch.inference_mode():
            if mesh is not None:
                replicate_scene_nodes(node_feat, node_valid, y0, mesh)
            z = scene_label_propagate(node_feat, y0, node_valid, self.cfg, mesh)
            return z[n_protos:].argmax(-1).to(torch.int32).cpu().numpy()

