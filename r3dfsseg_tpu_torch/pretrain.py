"""Encoder pretraining of the port (counterpart of the root `pretrain.py`):
full-scene semantic segmentation over the training classes with the
DGCNN + attention segmentation model (`nn/dgcnn.py:DGCNNSegAttention`),
whose trunk then starts meta-training through
``--pretrain_checkpoint_path``.

    python -m r3dfsseg_tpu_torch.pretrain --clean_data_path <dataset> --n_iters 2000 \\
        [--pretrain_batch_size 16] [--pretrain_lr 0.001] [--device cpu]

(``python -m r3dfsseg_tpu_torch.mpti_train_noise --phase pretrain`` or
``finetune`` runs it too, at the defaults.)  Step by step as the JAX
package: labels with the training classes at 1..C and everything else 0;
batches of ``batch_size`` scans drawn with `data/sampler.py:sample_scan`
from ``np.random.default_rng(seed)``, after the one batch the JAX run
draws for its model's init; finetune (a ``pretrain_checkpoint_path``)
starts the trunk from that checkpoint, `.msgpack` or `.tar`; Adam at
``lr`` over every parameter; the mean cross-entropy over every point;
``n_iters`` steps, a log line and the scalars every 10.  Batches are
assembled on a background thread and copied to the device a batch ahead.
The model runs in float32 whatever the config's compute dtype, as the JAX
model does.  It writes ``log_dir/pretrain_checkpoint.tar`` in the
original code's ``{'params': encoder.state_dict()}`` schema.

``--mesh N`` pretrains on N data-parallel ranks (`parallel/launch.py`)
where N divides the batch, as the JAX package's scene-batch DP: each rank
takes its rows of every batch, BatchNorm takes its statistics over the
whole batch (`nn/dgcnn.py:BatchNorm`'s ``sync``), the dropout masks are
the whole batch's rows, and the gradient is averaged over the ranks; rank
0 alone writes the log, the scalars and the checkpoint.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from r3dfsseg_tpu_torch import pin_f32_matmul
from r3dfsseg_tpu_torch.cli import args_to_config, build_parser
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.nn.dgcnn import DGCNNSegAttention, init_linear_weights
from r3dfsseg_tpu_torch.parallel import Mesh, Shard, launch, make_mesh, replicate
from r3dfsseg_tpu_torch.parallel.mesh import (all_reduce_grads_, all_reduce_mean, divides,
                                              mesh_size, shard_rows, sync_group)
from r3dfsseg_tpu_torch.utils.logger import ScalarWriter, Silent, init_logger

LOG_EVERY = 10      # steps between log lines, as in the JAX package


def pretrain_scans(cfg: R3DConfig) -> Tuple[List[int], List[str]]:
    """(the fold's training classes, the sorted scans that hold any)."""
    from r3dfsseg_tpu_torch.data.catalogs import get_catalog

    catalog = get_catalog(cfg.dataset, cfg.cvfold, cfg.clean_data_path)
    classes = list(catalog.train_classes)
    return classes, sorted({s for c in classes for s in catalog.class2scans[c]})


def batch_stream(cfg: R3DConfig, batch_size: int, classes, scans
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (x (B, N, C) float32, y (B, N) int32) batches, the JAX
    package's `make_batch` draws: ``batch_size`` scans by
    ``rng.choice(scans, batch_size)``, each sampled with its labels mapped
    (training classes 1..C, the rest 0) and augmented, one
    ``np.random.default_rng(seed)`` for all of it."""
    from r3dfsseg_tpu_torch.data.sampler import sample_scan

    rng = np.random.default_rng(cfg.seed)
    augm = {"scale": cfg.pc_augm_scale, "rot": cfg.pc_augm_rot,
            "mirror_prob": cfg.pc_augm_mirror_prob, "jitter": cfg.pc_augm_jitter}
    while True:
        xs, ys = [], []
        for name in rng.choice(scans, batch_size):
            pt, lb, _, _ = sample_scan(cfg.clean_data_path, name, cfg.pc_npts, cfg.pc_attribs,
                                       sampled_classes=classes, random_sample=True,
                                       pc_augm=cfg.pc_augm, pc_augm_config=augm, rng=rng)
            xs.append(pt)
            ys.append(lb)
        yield np.stack(xs), np.stack(ys).astype(np.int32)


def seg_model(cfg: R3DConfig, num_classes: int) -> DGCNNSegAttention:
    """The JAX pretraining's model at the config's widths (dropout 0.3,
    attention dropout 0.1: the model's own defaults), with the config's
    kernel choices."""
    return DGCNNSegAttention(cfg.pc_in_dim, num_classes, cfg.edgeconv_widths,
                             cfg.dgcnn_mlp_widths, cfg.dgcnn_k, atten_dim=cfg.dg_atten_dim,
                             knn_impl=cfg.knn_impl, attn_impl=cfg.attn_impl,
                             gather_impl=cfg.follower_impl)


def pretrain_step(model: DGCNNSegAttention, optimizer: torch.optim.Optimizer,
                  x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
                  mesh: Optional[Mesh] = None, offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch: the mean cross-entropy over every
    point, backward and ``optimizer.step()``.  Returns (loss, accuracy) as
    0-d tensors on the device, without a host sync.  With a ``mesh`` of
    more than one rank, x and y are this rank's rows of the batch from
    ``offset``: BatchNorm's statistics and the dropout masks are the whole
    batch's, the gradient and the returned figures the mean over the
    ranks."""
    dp = mesh is not None and mesh.size > 1
    shard = Shard(offset, x.shape[0] * mesh.size) if dp else None
    optimizer.zero_grad(set_to_none=True)
    logits = model(x, train=True, generator=generator, shard=shard, sync=sync_group(mesh))
    y = y.long()
    loss = -F.log_softmax(logits, -1).gather(-1, y[..., None]).mean()
    loss.backward()
    if dp:
        all_reduce_grads_(list(model.parameters()), mesh)
    optimizer.step()
    acc = (logits.detach().argmax(-1) == y).float().mean()
    if dp:
        return tuple(all_reduce_mean([loss.detach(), acc], mesh))
    return loss.detach(), acc


def pretrain(cfg: R3DConfig, *, batch_size: int = 16, lr: float = 0.001,
             device=None) -> str:
    """Pretrain (or, with ``cfg.pretrain_checkpoint_path``, finetune) for
    ``cfg.n_iters`` steps on ``device`` ("cuda" when None), on `mesh_size`
    ranks (started here unless this is a rank already); returns the path
    of the encoder checkpoint written."""
    from r3dfsseg_tpu_torch.data.loader import device_prefetch, prefetch_iter
    from r3dfsseg_tpu_torch.utils.checkpoint import (load_pretrain_checkpoint,
                                                     save_pretrain_checkpoint)

    n_dev = mesh_size(cfg, device)
    if n_dev > 1 and not dist.is_initialized():
        return launch(pretrain, n_dev, cfg, batch_size=batch_size, lr=lr, device=device)
    pin_f32_matmul()
    mesh = make_mesh(n_dev, device)
    device = mesh.device
    lead = mesh.rank == 0
    phase = cfg.phase if cfg.phase in ("pretrain", "finetune") else "pretrain"
    logger = init_logger(cfg.log_dir, cfg, phase=phase) if lead else Silent()
    writer = ScalarWriter(cfg.log_dir) if lead else Silent()
    try:
        classes, scans = pretrain_scans(cfg)
        logger.cprint(f"pretrain classes: {classes} (+bg)")
        batches = batch_stream(cfg, batch_size, classes, scans)
        next(batches)           # the batch the JAX run draws to initialise its model
        generator = torch.Generator().manual_seed(cfg.seed)
        model = seg_model(cfg, len(classes) + 1)
        init_linear_weights(model, generator)
        if cfg.pretrain_checkpoint_path:
            model.encoder.load_state_dict(load_pretrain_checkpoint(
                cfg.pretrain_checkpoint_path, model.encoder, log=logger.cprint))
            logger.cprint("finetune: loaded encoder from %s" % cfg.pretrain_checkpoint_path)
        model.to(device)
        optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        host = itertools.islice(batches, cfg.n_iters)
        dp = divides(mesh, batch_size)
        if dp:
            gen = generator.get_state()
            replicate([*model.parameters(), *model.buffers(), gen], mesh)
            generator.set_state(gen)
            host = ((shard_rows(x, mesh), shard_rows(y, mesh)) for x, y in host)
            logger.cprint("pretrain DP: %d-scene batches sharded over %d devices"
                          % (batch_size, mesh.size))
        elif mesh.size > 1:
            logger.cprint("WARNING: pretrain DP disabled — batch_size %d does not divide the "
                          "%d visible devices" % (batch_size, mesh.size))
        offset = mesh.rank * (batch_size // mesh.size) if dp else 0

        t0 = time.perf_counter()
        t_first = None
        stream = device_prefetch(prefetch_iter(host, prefetch=4), device, n=2)
        for it, (x, y) in enumerate(stream):
            loss, acc = pretrain_step(model, optimizer, x, y, generator,
                                      mesh if dp else None, offset)
            if it == 0 and device.type == "cuda":
                torch.cuda.synchronize(device)
            if it == 0:
                t_first = time.perf_counter()
            if (it + 1) % LOG_EVERY == 0:
                loss, acc = float(loss), float(acc)
                logger.cprint("[Pretrain] Iter %d | loss %.4f | acc %.4f | %.1f clouds/s"
                              % (it + 1, loss, acc,
                                 batch_size * (it + 1) / (time.perf_counter() - t0)))
                writer.add_scalar("Pretrain/loss", loss, it)
                writer.add_scalar("Pretrain/accuracy", acc, it)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if t_first is not None and cfg.n_iters > 1:
            logger.cprint("== throughput: %.2f clouds/s (from the end of the first step) =="
                          % (batch_size * (cfg.n_iters - 1) / (time.perf_counter() - t_first)))
        out = os.path.join(cfg.log_dir, "pretrain_checkpoint.tar")
        if lead:
            save_pretrain_checkpoint(out, model)
        logger.cprint(f"saved encoder checkpoint to {out}")
        return out
    finally:
        writer.close()
        logger.close()


def main(argv=None):
    parser = build_parser(eval_mode=False)
    parser.add_argument("--pretrain_batch_size", type=int, default=16)
    parser.add_argument("--pretrain_lr", type=float, default=0.001)
    args = parser.parse_args(argv)
    cfg = args_to_config(args, eval_mode=False).replace(phase="pretrain")
    np.random.seed(cfg.seed)
    return pretrain(cfg, batch_size=args.pretrain_batch_size, lr=args.pretrain_lr,
                    device=args.device)


if __name__ == "__main__":
    main()
