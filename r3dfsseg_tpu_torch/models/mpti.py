"""Multi-prototype transductive inference with MDNS, eval mode
(counterpart of `r3dfsseg_tpu/models/mpti.py`).

Pipeline per episode: features -> MDNS clean-shot detection -> FPS
multi-prototypes (fg per way + bg) -> kNN affinity over [prototypes ++
query points] -> label propagation -> query logits.  Shapes are fixed:
every way and the background own `n_subprototypes` slots with validity
masks, and invalid slots drop out of the graph.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import FeatureExtractor, _eval_only
from r3dfsseg_tpu_torch.ops.fps import multi_prototypes
from r3dfsseg_tpu_torch.ops.grid import grid_seed_pool
from r3dfsseg_tpu_torch.ops.lp import label_propagate, local_constrained_affinity


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
               cfg: R3DConfig, *, eval_mdns: bool):
    """One episode, eval mode: MDNS -> prototypes -> affinity -> LP -> CE."""
    c = cfg
    n_way, k_shot, n, d = support_feat.shape
    fg = ep.support_y > 0
    if eval_mdns:
        keep, _ = mdns_keep_mask(support_feat, fg, ep.support_x[..., :3], c.mdns_scales)
        fg_used = fg & (keep[..., None] > 0.5)
    else:
        fg_used = fg
    protos, pvalid, proto_labels, _ = episode_graph_nodes(support_feat, fg_used, fg, c)

    qflat = query_feat.reshape(-1, d)
    nq = qflat.shape[0]
    dev = qflat.device
    node_feat = torch.cat([protos, qflat], 0)
    node_valid = torch.cat([pvalid, torch.ones(nq, dtype=torch.bool, device=dev)], 0)
    y0 = torch.cat([proto_labels, torch.zeros((nq, c.n_classes), device=dev)], 0)

    a = local_constrained_affinity(node_feat, c.k_connect, c.sigma, valid=node_valid,
                                   kth_impl=c.knn_impl)
    z = label_propagate(a, y0, c.lp_alpha, cg_iters=c.lp_cg_iters)
    query_logits = z[protos.shape[0]:].reshape(c.n_queries * n_way, n, c.n_classes)

    query_y = ep.query_y.long()
    logp = F.log_softmax(query_logits, dim=-1)
    lp_loss = -logp.gather(-1, query_y[..., None]).mean()
    accuracy = (query_logits.argmax(-1) == query_y).float().mean()
    return query_logits, lp_loss, {"accuracy": accuracy}


# ======================================================================
# The model
# ======================================================================
class MPTIOutput(NamedTuple):
    query_logits: torch.Tensor    # (E, n_q*n_way, n_points, n_classes)
    lp_loss: torch.Tensor
    aux: Dict[str, torch.Tensor]


def check_servable(cfg: R3DConfig) -> None:
    """Raise on settings outside the port's float32 threshold/Chebyshev slice."""
    gd = cfg.compute_dtype if cfg.graph_dtype == "auto" else cfg.graph_dtype
    if cfg.compute_dtype != "float32" or gd != "float32":
        raise NotImplementedError("bf16 compute/graph modes come later (ROADMAP.md)")
    if cfg.affinity_impl != "threshold" or cfg.lp_solver != "cheby":
        raise NotImplementedError(
            "the port has affinity_impl='threshold' with lp_solver='cheby'; the "
            "parity modes come later (ROADMAP.md)")


class MPTINet(nn.Module):
    """FeatureExtractor + WayContrast projection + the episode algorithm.
    `forward` takes an Episode of tensors, with or without a leading
    episode axis."""

    def __init__(self, cfg: R3DConfig):
        super().__init__()
        check_servable(cfg)
        c = cfg
        self.cfg = cfg
        self.features = FeatureExtractor(
            c.pc_in_dim, c.edgeconv_widths, c.dgcnn_mlp_widths, c.base_widths,
            c.output_dim, dgcnn_k=c.dgcnn_k, use_attention=c.use_attention,
            knn_impl=c.knn_impl, attn_impl=c.attn_impl)
        self.proj = nn.Linear(c.feat_dim, c.proj_dim)   # WayContrast head (training)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Linear weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (PyTorch's default bound), drawn from ``generator``; BatchNorm at
        identity."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    def extract_features(self, ep: Episode):
        """Encode support and query clouds as two separate batches."""
        c = self.cfg
        e = ep.support_x.shape[0]
        sx = ep.support_x.reshape(e * c.n_way * c.k_shot, c.pc_npts, -1)
        qx = ep.query_x.reshape(e * c.n_queries * c.n_way, c.pc_npts, -1)
        sf = self.features(sx)
        qf = self.features(qx)
        d = sf.shape[-1]
        return (sf.reshape(e, c.n_way, c.k_shot, c.pc_npts, d),
                qf.reshape(e, c.n_queries * c.n_way, c.pc_npts, d))

    def forward(self, ep: Episode, train: bool = False, eval_mdns: bool = False) -> MPTIOutput:
        _eval_only(train)
        ep = ep.with_batch_dim()
        sf, qf = self.extract_features(ep)
        outs = [_mpti_core(sf[i], qf[i], Episode(*(None if a is None else a[i] for a in ep)),
                           self.cfg, eval_mdns=eval_mdns)
                for i in range(sf.shape[0])]
        logits = torch.stack([o[0] for o in outs])
        lp_loss = torch.stack([o[1] for o in outs]).mean()
        aux = {"accuracy": torch.stack([o[2]["accuracy"] for o in outs]).mean()}
        return MPTIOutput(logits, lp_loss, aux)
