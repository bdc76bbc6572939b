"""Multi-prototype transductive inference with noise robustness
(counterpart of `r3dfsseg_tpu/models/mpti.py`).

Pipeline per episode: features -> [train: WayContrast loss | eval: MDNS
clean-shot detection] -> FPS multi-prototypes (fg per way + bg) -> kNN
affinity over [prototypes ++ query points] -> label propagation -> query
logits + cross-entropy.  Shapes are fixed: every way and the background
own `n_subprototypes` slots with validity masks, and invalid slots drop
out of the graph.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode, encode_episode
from r3dfsseg_tpu_torch.nn.dgcnn import BN_MODES, FeatureExtractor, init_linear_weights
from r3dfsseg_tpu_torch.ops.fps import multi_prototypes
from r3dfsseg_tpu_torch.ops.grid import grid_seed_pool
from r3dfsseg_tpu_torch.ops.lp import (AFFINITY_IMPLS, SOLVERS, label_propagate,
                                       local_constrained_affinity)
from r3dfsseg_tpu_torch.utils.diagnostics import (clean_detection_precision_recall,
                                                  support_mask_accuracy)


# ======================================================================
# MDNS: multi-scale degree-based noise suppression
# ======================================================================
def _mdns_flags_one_scale(support_feat: torch.Tensor, support_fg: torch.Tensor,
                          support_xyz: torch.Tensor,
                          n_cells: Tuple[int, int, int]) -> torch.Tensor:
    """Per-shot clean flags at one grid scale, (n_way, k_shot) in {0, 1}.

    Per shot, fg features pool into spatial cells; per way, the seeds are
    L2-normalised, their pairwise cosines (zero diagonal, cubed at the
    1x1x1 scale) summed into degrees, and a seed is clean when its degree
    exceeds the way's mean degree.  A shot is clean when more than half of
    its occupied cells are.
    """
    cells = n_cells[0] * n_cells[1] * n_cells[2]
    seeds, seed_ok = grid_seed_pool(support_xyz, support_feat, support_fg, n_cells)
    n_way = seeds.shape[0]
    s = seeds.reshape(n_way, -1, seeds.shape[-1]).float()   # (w, k*cells, d)
    ok = seed_ok.reshape(n_way, -1)
    s = s / torch.sqrt((s * s).sum(-1, keepdim=True)).clamp_min(1e-12)
    n = s.shape[1]
    cos = torch.matmul(s, s.transpose(-1, -2))
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    cos = torch.where(ok[:, :, None] & ok[:, None, :] & ~eye, cos, 0.0)
    if cells == 1:
        cos = cos * cos * cos
    deg = cos.sum(-1)
    okf = ok.float()
    mean_deg = torch.where(ok, deg, 0.0).sum(-1, keepdim=True) / okf.sum(-1, keepdim=True).clamp_min(1.0)
    clean_seed = (deg > mean_deg) & ok
    frac = (clean_seed.reshape(n_way, -1, cells).float().sum(-1)
            / okf.reshape(n_way, -1, cells).sum(-1).clamp_min(1.0))
    return (frac > 0.5).float()


def mdns_keep_mask(support_feat: torch.Tensor, support_fg: torch.Tensor,
                   support_xyz: torch.Tensor,
                   scales: Tuple[Tuple[int, int, int], ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale MDNS: a shot whose flags average below 0.5 loses its
    foreground; a way left with no fg point keeps all its shots.
    Returns (keep, clean_flag), both (n_way, k_shot) float in {0, 1}."""
    flags = [_mdns_flags_one_scale(support_feat, support_fg, support_xyz, sc) for sc in scales]
    total = torch.stack(flags, 0).mean(0)
    keep = (total >= 0.5).float()
    n_fg = support_fg.float().sum(-1)
    alive = (keep * n_fg).sum(-1, keepdim=True) > 0
    keep = torch.where(alive, keep, 1.0)
    return keep, keep


# ======================================================================
# WayContrast: per-way supervised contrastive loss (training)
# ======================================================================
def way_contrast_loss(proj_feat: torch.Tensor, proto_valid: torch.Tensor,
                      labels: torch.Tensor, slot_valid: torch.Tensor,
                      temp: float = 0.1) -> torch.Tensor:
    """Supervised InfoNCE per way, averaged over ways.

    proj_feat (n_way, k_shot+2, fps_k, p) projected prototypes,
    proto_valid (n_way, k_shot+2, fps_k) bool, labels (n_way, k_shot+2)
    absolute classes (-1 = borrowed negative), slot_valid (n_way,
    k_shot+2) bool.  Anchors are valid rows with at least one positive."""
    n_way, slots, fps_k, p = proj_feat.shape
    z = proj_feat.reshape(n_way, slots * fps_k, p).float()
    valid = (proto_valid & slot_valid[..., None]).reshape(n_way, -1)      # (w, S)
    lab = labels.float().repeat_interleave(fps_k, dim=1)                 # (w, S)
    n = z.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    pair_ok = valid[:, :, None] & valid[:, None, :] & ~eye
    logits = torch.matmul(z, z.transpose(-1, -2)) / temp
    gt = (lab[:, :, None] == lab[:, None, :]) & pair_ok
    ex = torch.exp(logits) * pair_ok.float()
    log_prob = logits - torch.log(ex.sum(-1, keepdim=True).clamp_min(1e-12))
    pos_cnt = gt.float().sum(-1)
    mean_log_prob_pos = (gt.float() * log_prob).sum(-1) / pos_cnt.clamp_min(1.0)
    row_ok = valid & (pos_cnt > 0)
    loss = -torch.where(row_ok, mean_log_prob_pos, 0.0).sum(-1)
    return (loss / row_ok.float().sum(-1).clamp_min(1.0)).mean()


def _contrast_prototypes(support_feat: torch.Tensor, support_y: torch.Tensor,
                         support_flag: torch.Tensor, fps_k: int, fps_impl: str = "auto"):
    """Per-shot FPS prototypes with labels and validity for WayContrast,
    one episode: (n_way, k_shot+2, fps_k, d) prototypes, their validity,
    (n_way, k_shot+2) labels and slot validity.

    Slots [0:k_shot] are the way's own shots; slots [k_shot:k_shot+2] are
    shots 0 and 1 borrowed from the next way as label -1 negatives, valid
    only when the episode is clean, judged from way 0's flags only."""
    n_way, k_shot, n, d = support_feat.shape
    fg = support_y > 0
    mp = multi_prototypes(support_feat.reshape(n_way * k_shot, n, d),
                          fg.reshape(n_way * k_shot, n), fps_k, impl=fps_impl)
    protos = mp.prototypes.reshape(n_way, k_shot, fps_k, d)
    pvalid = mp.proto_valid.reshape(n_way, k_shot, fps_k)

    flag = support_flag.float()
    clean = (flag[0, 0] * k_shot) == flag[0].sum()
    nxt = (torch.arange(n_way, device=protos.device) + 1) % n_way
    protos = torch.cat([protos, protos[nxt][:, :2]], 1)
    pvalid = torch.cat([pvalid, pvalid[nxt][:, :2]], 1)
    labels = torch.cat([flag, torch.full((n_way, 2), -1.0, device=flag.device)], 1)
    slot_valid = torch.cat([torch.ones((n_way, k_shot), dtype=torch.bool, device=flag.device),
                            clean.expand(n_way, 2)], 1)
    return protos, pvalid, labels, slot_valid


# ======================================================================
# The episode graph
# ======================================================================
def episode_graph_nodes(support_feat: torch.Tensor, fg_used: torch.Tensor,
                        fg: torch.Tensor, cfg: R3DConfig):
    """Prototype nodes in the order [bg | way0 | way1 | ...]: FPS fg
    prototypes per way from the (MDNS-filtered) fg points, bg prototypes
    from the raw fg complement.

    Returns (protos ((w+1)*P, d), pvalid ((w+1)*P,), proto_labels
    ((w+1)*P, n_classes), fg_assign (w, k*N))."""
    n_way, k_shot, n, d = support_feat.shape
    np_ = cfg.n_subprototypes
    fg_mp = multi_prototypes(support_feat.reshape(n_way, k_shot * n, d),
                             fg_used.reshape(n_way, k_shot * n), np_, impl=cfg.fps_impl)
    bg_mp = multi_prototypes(support_feat.reshape(1, -1, d), (~fg).reshape(1, -1), np_,
                             impl=cfg.fps_impl)
    protos = torch.cat([bg_mp.prototypes, fg_mp.prototypes], 0).reshape(-1, d)
    pvalid = torch.cat([bg_mp.proto_valid, fg_mp.proto_valid], 0).reshape(-1)
    block_labels = torch.eye(cfg.n_classes, device=support_feat.device)[: n_way + 1]
    proto_labels = block_labels.repeat_interleave(np_, dim=0) * pvalid[:, None]
    return protos, pvalid, proto_labels, fg_mp.assignments


def _mpti_core(support_feat: torch.Tensor, query_feat: torch.Tensor, ep: Episode,
               cfg: R3DConfig, *, train: bool = False, eval_mdns: bool = False):
    """One episode: [eval: MDNS] -> prototypes -> affinity -> LP -> CE, with
    the JAX package's diagnostics: MDNS's against the clean masks in eval
    (where the episode has them), the train step's in training."""
    c = cfg
    n_way, k_shot, n, d = support_feat.shape
    fg = ep.support_y > 0
    aux: Dict[str, torch.Tensor] = {}
    if eval_mdns and not train:
        keep, clean_flag = mdns_keep_mask(support_feat, fg, ep.support_x[..., :3], c.mdns_scales)
        fg_used = fg & (keep[..., None] > 0.5)
        if ep.gt_support_y is not None:
            # MDNS against the clean masks, shot and point level
            gt_flag = (ep.gt_support_y.sum(-1) > 0).float()
            aux["mdns_shot_clean_ratio"] = ((clean_flag * gt_flag).sum()
                                            / clean_flag.sum().clamp_min(1.0))
            sm = support_mask_accuracy(fg_used, fg, ep.gt_support_y > 0)
            aux["mdns_point_clean_ratio"] = sm["clean_ratio"]
            aux["mdns_size_ratio"] = sm["size_ratio"]
            aux["mdns_precision"], aux["mdns_recall"] = clean_detection_precision_recall(
                gt_flag, clean_flag)
    else:
        fg_used = fg
    protos, pvalid, proto_labels, fg_assign = episode_graph_nodes(support_feat, fg_used, fg, c)

    qflat = query_feat.reshape(-1, d)
    nq = qflat.shape[0]
    dev = qflat.device
    node_feat = torch.cat([protos, qflat], 0)
    node_valid = torch.cat([pvalid, torch.ones(nq, dtype=torch.bool, device=dev)], 0)
    y0 = torch.cat([proto_labels, torch.zeros((nq, c.n_classes), device=dev)], 0)

    # the bf16 graph: the centred bf16 Gram's distances, and under the
    # threshold selection a bf16 compare copy and affinity; the Chebyshev
    # and CG steps read a bf16 S (kernel 7's solve under 'cheby')
    lowp = torch.bfloat16 if c.graph_bf16 else None
    impl = c.follower_impl
    a = local_constrained_affinity(node_feat, c.k_connect, c.sigma, valid=node_valid,
                                   compare_dtype=lowp, impl=c.affinity_impl, kth_impl=impl)
    z = label_propagate(a, y0, c.lp_alpha, solver=c.lp_solver, cg_iters=c.lp_cg_iters,
                        adjoint_iters=(c.lp_adjoint_iters or None) if train else None,
                        matvec_dtype=lowp, impl=impl)
    n_protos = protos.shape[0]
    query_logits = z[n_protos:].reshape(c.n_queries * n_way, n, c.n_classes)

    query_y = ep.query_y.long()
    logp = F.log_softmax(query_logits, dim=-1)
    lp_loss = -logp.gather(-1, query_y[..., None]).mean()
    pred = query_logits.argmax(-1)
    aux["accuracy"] = (pred == query_y).float().mean()
    if train and ep.gt_query_y is not None:
        gt_q = ep.gt_query_y.long()
        aux["query_acc_LP"] = (pred == gt_q).float().mean()
        aux["query_acc_original"] = (query_y == gt_q).float().mean()
    if train and ep.gt_support_y is not None:
        # clean ratio after LP: per way, each fg point takes its prototype's
        # LP prediction, compared with the clean gt mask
        with torch.no_grad():
            proto_pred = z[:n_protos].reshape(n_way + 1, -1, c.n_classes)[1:].argmax(-1)
            way_ids = torch.arange(n_way, device=dev)[:, None]
            proto_is_cls = proto_pred == way_ids + 1                     # (w, NP)
            point_pred = proto_is_cls.gather(1, fg_assign.long())        # (w, k*N)
            gt_flat = ep.gt_support_y.reshape(n_way, -1) > 0
            fgf = fg_used.reshape(n_way, -1).float()
            denom = fgf.sum(-1).clamp_min(1.0)
            aux["clean_ratio_LP"] = (((point_pred == gt_flat).float() * fgf).sum(-1)
                                     / denom).mean()
            aux["clean_ratio_original"] = ((gt_flat.float() * fgf).sum(-1) / denom).mean()
    return query_logits, lp_loss, aux


# ======================================================================
# The model
# ======================================================================
class MPTIOutput(NamedTuple):
    query_logits: torch.Tensor    # (E, n_q*n_way, n_points, n_classes)
    lp_loss: torch.Tensor
    contrast_loss: torch.Tensor
    aux: Dict[str, torch.Tensor]


def check_encoder(cfg: R3DConfig) -> None:
    """Raise on encoder settings outside the port: the float32 or bf16
    encoder (`compute_dtype`, with every `bn_mode` and `attn_f32`) and the
    unfused EdgeConv (`fuse_edge='on'` raises, as in the JAX package)."""
    if cfg.fuse_edge == "on":
        raise NotImplementedError(
            "fuse_edge='on': the JAX package's EdgeConv refuses it too (the fused tail is an "
            "archived kernel there); ops/fused_edge.py holds the port's version")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}")
    if cfg.bn_mode not in BN_MODES:
        raise NotImplementedError(f"bn_mode {cfg.bn_mode!r}: one of {BN_MODES}")
    if not isinstance(cfg.attn_f32, bool):
        raise TypeError(f"attn_f32 must be a bool, got {cfg.attn_f32!r}")


def check_servable(cfg: R3DConfig) -> None:
    """Raise on settings outside the port's slice: the encoder's
    (`check_encoder`) on a float32 or bf16 episode graph (`graph_dtype`),
    threshold or exact top-k affinity (`affinity_impl`), the Chebyshev, CG
    or dense solve (`lp_solver`; any `lp_adjoint_iters`, 0 meaning
    `lp_cg_iters`)."""
    check_encoder(cfg)
    if cfg.graph_dtype not in ("auto", "float32", "bfloat16"):
        raise NotImplementedError(f"graph_dtype {cfg.graph_dtype!r}")
    if cfg.affinity_impl not in AFFINITY_IMPLS:
        raise NotImplementedError(f"affinity_impl {cfg.affinity_impl!r}: one of {AFFINITY_IMPLS}")
    if cfg.lp_solver not in SOLVERS:
        raise NotImplementedError(f"lp_solver {cfg.lp_solver!r}: one of {SOLVERS}")


class MPTINet(nn.Module):
    """FeatureExtractor + WayContrast projection + the episode algorithm.
    `forward` takes an Episode of tensors, with or without a leading
    episode axis."""

    def __init__(self, cfg: R3DConfig):
        super().__init__()
        check_servable(cfg)
        c = cfg
        self.cfg = cfg
        self.features = FeatureExtractor.from_config(c)
        self.proj = nn.Linear(c.feat_dim, c.proj_dim)   # WayContrast head (training)

    def init_weights(self, generator: torch.Generator) -> None:
        """Linear weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (PyTorch's default bound), drawn from ``generator``; BatchNorm at
        identity (`nn/dgcnn.py:init_linear_weights`)."""
        init_linear_weights(self, generator)

    def extract_features(self, ep: Episode, train: bool = False,
                         generator: Optional[torch.Generator] = None, shard=None):
        """Support and query features of a batched episode
        (`models/episode.py:encode_episode`)."""
        return encode_episode(self.features, self.cfg, ep, train, generator, shard)

    def forward(self, ep: Episode, train: bool = False, eval_mdns: bool = False,
                generator: Optional[torch.Generator] = None, shard=None) -> MPTIOutput:
        """Training needs ``ep.support_flag`` and, with attention dropout,
        a ``generator`` for the mask seeds; ``shard`` places ep's episodes
        in a data-parallel batch (`models/episode.py:encode_episode`)."""
        c = self.cfg
        ep = ep.with_batch_dim()
        sf, qf = self.extract_features(ep, train, generator, shard)
        eps = [Episode(*(None if a is None else a[i] for a in ep)) for i in range(sf.shape[0])]
        if train:
            losses = []
            for i, one in enumerate(eps):
                protos, pvalid, labels, svalid = _contrast_prototypes(
                    sf[i], one.support_y, one.support_flag, c.contrast_fps_k, c.fps_impl)
                z = self.proj(protos)
                z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
                losses.append(way_contrast_loss(z, pvalid, labels, svalid, c.contrast_temp))
            contrast = torch.stack(losses).mean()
        else:
            contrast = torch.zeros((), device=sf.device)
        outs = [_mpti_core(sf[i], qf[i], one, c, train=train, eval_mdns=eval_mdns)
                for i, one in enumerate(eps)]
        logits = torch.stack([o[0] for o in outs])
        lp_loss = torch.stack([o[1] for o in outs]).mean()
        aux = {k: torch.stack([o[2][k] for o in outs]).mean() for k in outs[0][2]}
        return MPTIOutput(logits, lp_loss, contrast, aux)
