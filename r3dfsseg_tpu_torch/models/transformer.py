"""The TraNFS-style transformer baseline (counterpart of
`r3dfsseg_tpu/models/transformer.py`).

The masked-average fg feature of every support shot is projected to
``d_model`` (`proj_trans_in`) and passes through a small post-norm
transformer together with one class token per way; the class tokens'
outputs, projected back (`proj_trans_out`), are the fg prototypes, and the
bg prototype is the mean of the shots' bg features.  Training adds a
binary outlier head (BCE, weight 0.5) on the shots' outputs and an MSE
pulling each way's prototype to the mean of its clean shots (weight 1).

The attention over the ``n_way * (k_shot + 1)`` tokens is Flax's
`MultiHeadDotProductAttention` in plain PyTorch ops: q scaled by
1 / sqrt(head_dim) before the product, softmax, dropout on the weights
with one mask for every head and episode (Flax's `broadcast_dropout`),
and the query/key/value/out projections held as Linear layers named as
the Flax tree's `DenseGeneral`s (`utils/convert.py` folds their head
axes).  Every dropout draws from the caller's generator
(`nn/dgcnn.py:seeded_dropout`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.models.episode import Episode, encode_episode
from r3dfsseg_tpu_torch.models.mpti import check_encoder
from r3dfsseg_tpu_torch.models.protonet import check_dist_method, cross_entropy, similarity
from r3dfsseg_tpu_torch.nn.dgcnn import FeatureExtractor, init_linear_weights, seeded_dropout
from r3dfsseg_tpu_torch.ops.segment import masked_mean

CLS_TYPES = ("rand_const", "cls_learn", "proto")
POS_TYPES = ("pos_learn", "rand_const")


def gen_prototypes(embeddings: torch.Tensor, ways: int, shots: int,
                   agg_method: str = "mean") -> torch.Tensor:
    """Aggregate (ways * shots, d) shot embeddings into (ways, d)
    prototypes: the mean; 'median', a soft geometric median by 5 Newton
    steps from the mean; or a softmax over each shot's summed similarity
    to the way's shots ('cosine', 'euclidean', 'abs', with an optional
    temperature suffix, 'cosine_2')."""
    emb = embeddings.reshape(ways, shots, -1)
    mean_emb = emb.mean(1)
    if agg_method == "mean":
        return mean_emb
    if agg_method == "median":
        med = mean_emb[:, None, :]
        c = 0.5
        for _ in range(5):
            err = med - emb
            denom = torch.sqrt((err * err).sum(2, keepdim=True) + c * c)
            dw = -(err / denom).sum(1, keepdim=True) / (1.0 / denom).sum(1, keepdim=True)
            med = med + dw
        return med[:, 0, :]
    if agg_method.split("_")[0] in ("cosine", "euclidean", "abs"):
        if agg_method.startswith("cosine"):
            nrm = emb / (torch.linalg.vector_norm(emb, dim=2, keepdim=True) + 1e-6)
            cos = torch.einsum("wsd,wtd->wst", nrm, nrm)
            attn = (cos.sum(1) - 1.0) / (shots - 1)
        elif agg_method.startswith("euclidean"):
            d = ((emb[:, :, None] - emb[:, None]) ** 2).sum(-1)
            attn = -d.sum(1) / (shots - 1)
        else:
            d = (emb[:, :, None] - emb[:, None]).abs().sum(-1)
            attn = -d.sum(1) / (shots - 1)
        t = float(agg_method.split("_")[-1]) if "_" in agg_method else 1.0
        w = torch.softmax(attn / t, dim=1)[..., None]
        return (emb * w).sum(1)
    raise NotImplementedError(agg_method)


class MultiHeadAttention(nn.Module):
    """Flax's `MultiHeadDotProductAttention` self-attention over (B, L,
    d_model) tokens with ``n_head`` heads (module docstring)."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} does not split into {n_head} heads")
        self.n_head = n_head
        self.dropout = dropout
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, d = x.shape
        h = self.n_head
        q, k, v = (m(x).reshape(b, n, h, d // h).transpose(1, 2)
                   for m in (self.query, self.key, self.value))          # (B, h, L, hd)
        q = q / (d // h) ** 0.5
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        if train and self.dropout > 0.0:
            w = seeded_dropout(w, self.dropout, generator, shape=(1, 1, n, n))
        y = torch.matmul(w, v).transpose(1, 2).reshape(b, n, d)
        return self.out(y)


class EncoderLayer(nn.Module):
    """Post-norm transformer encoder layer, as torch's
    TransformerEncoderLayer defaults: ReLU, LayerNorm eps 1e-5, dropout on
    the attention weights, the attention output and the feed-forward path
    (after its ReLU and after its output)."""

    def __init__(self, d_model: int, n_head: int, d_feed: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_feed)
        self.linear2 = nn.Linear(d_feed, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = dropout

    def _drop(self, x, train, generator, shard):
        return seeded_dropout(x, self.dropout, generator, shard=shard) if train else x

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        """``shard`` places x's episodes in a data-parallel batch: the
        masks of x's shape are the whole batch's rows (the attention
        weights' mask broadcasts over episodes)."""
        attn = self._drop(self.self_attn(x, train, generator), train, generator, shard)
        x = self.norm1(x + attn)
        h = self._drop(F.relu(self.linear1(x)), train, generator, shard)
        h = self._drop(self.linear2(h), train, generator, shard)
        return self.norm2(x + h)


class ShotTransformer(nn.Module):
    """[class tokens; shot embeddings] plus each token's way embedding ->
    ``num_layers`` encoder layers: (E, ways * shots, d_model) ->
    (E, ways * (shots + 1), d_model).  ``cls_type`` 'rand_const' takes
    the class tokens from an embedding table with their gradient stopped,
    'cls_learn' from a trained one, 'proto' from `gen_prototypes` of the
    shots; ``pos_type`` 'rand_const' stops the way embeddings' gradient."""

    def __init__(self, ways: int, shots: int, num_layers: int = 3, n_head: int = 8,
                 d_model: int = 128, d_feed: int = 128, dropout: float = 0.1,
                 cls_type: str = "rand_const", pos_type: str = "pos_learn",
                 agg_method: str = "mean"):
        super().__init__()
        if cls_type not in CLS_TYPES:
            raise NotImplementedError(cls_type)
        if pos_type not in POS_TYPES:
            raise NotImplementedError(pos_type)
        self.ways, self.shots = ways, shots
        self.cls_type, self.pos_type, self.agg_method = cls_type, pos_type, agg_method
        if cls_type != "proto":
            self.cls_embeddings = nn.Embedding(ways, d_model)
        self.pos_embeddings = nn.Embedding(ways, d_model)
        self.n_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", EncoderLayer(d_model, n_head, d_feed, dropout))
        pos_idx = torch.cat([torch.arange(ways), torch.arange(ways).repeat_interleave(shots)])
        self.register_buffer("pos_idx", pos_idx, persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        e = x.shape[0]
        if self.cls_type == "proto":
            cls = torch.stack([gen_prototypes(xe, self.ways, self.shots, self.agg_method)
                               for xe in x])
        else:
            cls = self.cls_embeddings.weight
            if self.cls_type == "rand_const":
                cls = cls.detach()
            cls = cls.expand(e, -1, -1)
        pos = self.pos_embeddings(self.pos_idx)
        if self.pos_type == "rand_const":
            pos = pos.detach()
        h = torch.cat([cls, x], 1) + pos
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i}")(h, train, generator, shard)
        return h


class TransformerOutput(NamedTuple):
    query_logits: torch.Tensor
    loss: torch.Tensor
    binary_loss: torch.Tensor
    clean_proto_loss: torch.Tensor
    aux: Dict[str, torch.Tensor]


class ProtoNetTransformer(nn.Module):
    """ProtoNet with transformer-refined fg prototypes and the outlier
    losses (module docstring).  `forward` takes an Episode of tensors,
    with or without a leading episode axis; the losses of training need
    ``ep.gt_support_y``."""

    def __init__(self, cfg: R3DConfig, d_model: int = 128, n_layers: int = 3, n_head: int = 8,
                 d_feed: int = 128, dropout: float = 0.1, binary_loss_weight: float = 0.5,
                 clean_proto_loss_weight: float = 1.0):
        super().__init__()
        check_encoder(cfg)
        check_dist_method(cfg)
        self.cfg = cfg
        self.binary_loss_weight = binary_loss_weight
        self.clean_proto_loss_weight = clean_proto_loss_weight
        self.features = FeatureExtractor.from_config(cfg)
        self.proj_trans_in = nn.Parameter(torch.zeros(cfg.feat_dim, d_model))
        self.proj_trans_out = nn.Parameter(torch.zeros(cfg.feat_dim, d_model))
        self.transformer = ShotTransformer(cfg.n_way, cfg.k_shot, n_layers, n_head, d_model,
                                           d_feed, dropout)
        self.binary_outlier_detector = nn.Linear(cfg.feat_dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """From ``generator``: Linear weights and biases
        (`nn/dgcnn.py:init_linear_weights`), the embeddings ~ N(0,
        1 / d_model) as Flax's `Embed` draws them, and one orthogonal
        matrix that both projections start from, as in the original model
        (each then trains on its own)."""
        init_linear_weights(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.weight.shape[1] ** -0.5)
        a = torch.randn(self.proj_trans_in.shape, generator=generator, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))          # a unique, uniformly drawn basis
        self.proj_trans_in.copy_(q.float())
        self.proj_trans_out.copy_(q.float())

    def forward(self, ep: Episode, train: bool = False, eval_mdns: bool = False,
                generator: Optional[torch.Generator] = None, shard=None) -> TransformerOutput:
        """``eval_mdns`` is accepted and ignored, as by the JAX model;
        ``shard`` places ep's episodes in a data-parallel batch."""
        c = self.cfg
        ep = ep.with_batch_dim()
        sf, qf = encode_episode(self.features, c, ep, train, generator, shard)
        e, d = sf.shape[0], sf.shape[-1]
        fg = ep.support_y > 0
        fg_feat = masked_mean(sf, fg[..., None], dim=3)               # (E, w, k, d)
        bg_feat = masked_mean(sf, ~fg[..., None], dim=3)

        z = fg_feat.reshape(e, c.n_way * c.k_shot, d) @ self.proj_trans_in
        trans_out = self.transformer(z, train, generator, shard) @ self.proj_trans_out.T
        fg_protos = trans_out[:, :c.n_way]                             # (E, w, d)
        shot_out = trans_out[:, c.n_way:]                              # (E, w*k, d)
        bg_proto = bg_feat.reshape(e, -1, d).mean(1)
        protos = torch.cat([bg_proto[:, None], fg_protos], 1)          # (E, w+1, d)

        sim = similarity(qf, protos[:, None], c.dist_method)           # (E, Q, N, w+1)
        loss = cross_entropy(sim, ep.query_y)
        binary_loss = torch.zeros((), device=sf.device)
        clean_proto_loss = torch.zeros((), device=sf.device)
        if train and ep.gt_support_y is not None:
            is_clean = (ep.gt_support_y.sum(-1) > 0).float()           # (E, w, k)
            logits = self.binary_outlier_detector(shot_out)[..., 0]    # (E, w*k)
            binary_loss = self.binary_loss_weight * F.binary_cross_entropy_with_logits(
                logits, is_clean.reshape(e, -1))
            w_clean = is_clean[..., None]
            clean_proto = (fg_feat * w_clean).sum(2) / w_clean.sum(2).clamp_min(1.0)
            clean_proto_loss = self.clean_proto_loss_weight * (
                (fg_protos - clean_proto).square().sum() / (e * c.n_way))
        aux = {"accuracy": (sim.argmax(-1) == ep.query_y).float().mean()}
        return TransformerOutput(sim, loss, binary_loss, clean_proto_loss, aux)
