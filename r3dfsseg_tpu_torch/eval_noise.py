"""Meta-test evaluation CLI of the port (counterpart of the root
`eval_noise.py`), with the JAX CLI's flags and ``--device``:

    python -m r3dfsseg_tpu_torch.eval_noise --clean_data_path <dataset> \\
        --model_checkpoint_path <log dir> --noise_ratio 0.4 --noise_type ood [--device cpu]

Builds (or reads) the cached clean or noisy test episodes, runs the learner
of ``--phase`` (`learners/__init__.py:make_learner`: the MPTI model,
``protoeval`` ProtoNet_Contrast, ``transformereval`` the transformer) over
each with MDNS on, and reports per-class IoU and the foreground mean IoU.  The checkpoint is a `checkpoint.tar` (the port's training writes
one, in the original code's schema) or the JAX package's
`checkpoint.msgpack`, which a log directory holding both gives first.
``--mesh N`` evaluates on N data-parallel ranks (`parallel/launch.py`):
each batch of ``--episode_batch`` episodes is split over them and the
predictions gathered in episode order; rank 0 alone writes the log and the
record.
"""
from __future__ import annotations

import os
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from r3dfsseg_tpu_torch.cli import args_to_config, build_parser
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners import make_learner
from r3dfsseg_tpu_torch.parallel import launch, make_mesh, resolve_episode_batch
from r3dfsseg_tpu_torch.parallel.mesh import mesh_size
from r3dfsseg_tpu_torch.utils.logger import Silent, init_logger
from r3dfsseg_tpu_torch.utils.metrics import IoUAccumulator


def test_few_shot(dataset, learner, logger, test_classes, *, eval_mdns=False,
                  log_every=50, save_record=None):
    """Evaluate every cached episode; returns (mean loss, mean IoU).

    Episode files are read and stacked on a background thread; each batch
    is copied to the device before the previous one's results are fetched,
    and a step's loss and MDNS scalars come back in one transfer.  The IoU
    counts accumulate on the host.  With ``save_record``, per-episode
    predictions, labels and classes go to ``<save_record>.npz``.  On a
    learner with a mesh, only this rank's rows of a batch go to its
    device."""
    from r3dfsseg_tpu_torch.data.loader import prefetch_iter, to_device
    from r3dfsseg_tpu_torch.models.episode import stack_episodes

    acc = IoUAccumulator(list(test_classes))
    total_loss = 0.0
    n = len(dataset)
    ebatch = max(1, learner.cfg.episode_batch)
    t0 = time.perf_counter()
    done = 0
    mdns_stats: dict = {}
    record = {"pred": [], "label": [], "classes": []} if save_record else None

    def batches():
        for start in range(0, n, ebatch):
            eps = [dataset[i] for i in range(start, min(start + ebatch, n))]
            yield eps, stack_episodes(eps) if len(eps) > 1 else eps[0]

    def dispatch(batch, offset):
        pred, loss, _, aux = learner.test(batch, eval_mdns=eval_mdns, return_aux=True,
                                          offset=offset)
        keys = sorted(k for k in aux if k.startswith("mdns"))
        return pred, torch.stack([loss.float()] + [aux[k].float() for k in keys]), keys

    def consume(eps, pred, packed, keys):
        nonlocal total_loss, done
        pred = pred.cpu().numpy()
        scalars = packed.cpu().numpy()
        loss = float(scalars[0])
        for k, v in zip(keys, scalars[1:]):
            mdns_stats.setdefault(k, []).append(float(v))
        total_loss += loss * len(eps)
        for j, ep in enumerate(eps):       # pred is (E, Q, N)
            acc.update(pred[j], np.asarray(ep.query_y), np.asarray(ep.sampled_classes))
            if record is not None:
                record["pred"].append(pred[j])
                record["label"].append(np.asarray(ep.query_y))
                record["classes"].append(np.asarray(ep.sampled_classes))
        done += len(eps)
        if done % max(log_every, 1) < len(eps):
            logger.cprint("[Eval] Iter: %d | Loss: %.4f | %s" % (done, loss, str(datetime.now())))

    pending = None
    for eps, host_batch in prefetch_iter(batches(), prefetch=4):
        rows, offset = learner.shard(host_batch)
        refs = dispatch(to_device(rows, learner.device), offset)
        if pending is not None:
            consume(*pending)
        pending = (eps, *refs)
    if pending is not None:
        consume(*pending)
    mean_loss = total_loss / max(n, 1)
    for k, vals in sorted(mdns_stats.items()):
        logger.cprint("%s: %.4f" % (k, float(np.mean(vals))))
    for c, v in enumerate(acc.iou()):
        logger.cprint("----- [class %d]  IoU: %f -----" % (c, v))
    mean_iou = acc.mean_iou()
    if record is not None:
        np.savez(save_record, pred=np.stack(record["pred"]), label=np.stack(record["label"]),
                 classes=np.stack(record["classes"]))
        logger.cprint("saved test record to %s.npz" % save_record)
    dt = time.perf_counter() - t0
    logger.cprint("eval throughput: %.2f episodes/s" % (n / max(dt, 1e-9)))
    return mean_loss, mean_iou


def evaluate(cfg: R3DConfig, device=None) -> float:
    """Meta-test the checkpoint in ``cfg.model_checkpoint_path`` on the
    noisy (or clean) cached test set, MDNS on, on `mesh_size`
    data-parallel ranks (started here unless this is a rank already);
    returns the mean IoU."""
    from r3dfsseg_tpu_torch.data.cache import StaticTestDataset
    from r3dfsseg_tpu_torch.utils.checkpoint import restore
    from r3dfsseg_tpu_torch.utils.torch_convert import checkpoint_file

    if not cfg.model_checkpoint_path:
        raise ValueError("Model checkpoint file must be given (--model_checkpoint_path).")
    n_dev = mesh_size(cfg, device)
    if n_dev > 1 and not dist.is_initialized():
        return launch(evaluate, n_dev, cfg, device=device)
    mesh = make_mesh(n_dev, device)
    ckpt = checkpoint_file(cfg.model_checkpoint_path)
    # the log and the record go beside the checkpoint
    cfg = cfg.replace(log_dir=os.path.dirname(ckpt))
    logger = init_logger(cfg.log_dir, cfg) if mesh.rank == 0 else Silent()
    try:
        logger.cprint(
            "\n------------------- noise ratio= {}, noise type={} "
            "--------------------\n".format(cfg.noise_ratio, cfg.noise_type))
        cfg = resolve_episode_batch(cfg, log=logger.cprint, device=device)
        learner = make_learner(cfg, mesh.device)
        dataset = StaticTestDataset(
            cfg.clean_data_path or cfg.data_path, cfg.dataset, cvfold=cfg.cvfold,
            num_episode_per_comb=cfg.n_episode_test, n_way=cfg.n_way,
            k_shot=cfg.k_shot, n_queries=cfg.n_queries, num_point=cfg.pc_npts,
            pc_attribs=cfg.pc_attribs, mode="test",
            noise_ratio=cfg.noise_ratio, noise_type=cfg.noise_type,
            noise_pair=cfg.noise_pair_dict, seed=cfg.seed)

        info = restore(ckpt, learner, log=logger.cprint)
        logger.cprint("Load model checkpoint %s at Iteration %d (IoU %f)..." % (
            ckpt, info["iteration"], info["IoU"]))
        if mesh.size > 1:
            logger.cprint("episode-DP eval over %d devices" % mesh.size
                          if learner.attach_mesh(mesh) else
                          "WARNING: episode-DP disabled — episode_batch %d does not divide "
                          "the %d visible devices" % (cfg.episode_batch, mesh.size))

        record_path = None
        if cfg.save_test_record and mesh.rank == 0:
            # the original code's layout: '{noise_type}_{ratio:.3f}_test_record'
            # under model_checkpoint_path
            record_path = os.path.join(cfg.log_dir, "%s_%.3f_test_record" % (
                cfg.noise_type, cfg.noise_ratio))
        test_loss, mean_iou = test_few_shot(
            dataset, learner, logger, list(dataset.classes), eval_mdns=True,
            save_record=record_path)
        logger.cprint("\n=====[TEST] Loss: %.4f | Mean IoU: %f =====\n" % (test_loss, mean_iou))
    finally:
        logger.close()
    return mean_iou


def main(argv=None):
    args = build_parser(eval_mode=True).parse_args(argv)
    cfg = args_to_config(args, eval_mode=True)
    np.random.seed(cfg.seed)
    evaluate(cfg, device=args.device)


if __name__ == "__main__":
    main()
