"""Noise-robust meta-training CLI of the port (counterpart of the root
`mpti_train_noise.py`), with the JAX CLI's flags and ``--device``:

    python -m r3dfsseg_tpu_torch.mpti_train_noise --clean_data_path <dataset> \\
        --n_iters 40000 --eval_interval 2000 --use_attention [--device cpu]

Per-episode noisy meta-training of the learner of ``--phase`` (MPTI with
WayContrast; ``prototrain`` ProtoNet_Contrast, ``transformertrain`` the
transformer baseline) on episodes from a pool of worker threads,
validation on the clean cached set every ``eval_interval`` episodes, and
the best (`checkpoint.tar`) and periodic (`checkpoint_<it>.tar`)
checkpoints in the original code's schema, with the Adam state for the
MPTI model.  ``--model_checkpoint_path`` resumes from such a file, or
from the JAX package's `checkpoint.msgpack`: the weights, the Adam
moments (a baseline's from a `.msgpack` only, as in the JAX package), the
StepLR position and the episode stream continue where it was written, up
to ``n_iters`` episodes in all.  ``--pretrain_checkpoint_path``
starts the encoder trunk from a pretraining checkpoint (`.tar` or
`.msgpack`).  ``--phase pretrain`` and ``finetune`` run `pretrain.py`.

``--mesh N`` (default: every visible GPU on "cuda", else 1) trains on N
data-parallel ranks (`parallel/launch.py`), each batch of
``--episode_batch`` episodes split over them (`learners/base.py`).  Every
rank runs the same seeded loader and takes its rows; rank 0 alone writes
the log, the scalars and the checkpoints.
"""
from __future__ import annotations

import hashlib
import os
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from r3dfsseg_tpu_torch.cli import args_to_config, build_parser
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.eval_noise import make_learner, test_few_shot
from r3dfsseg_tpu_torch.parallel import launch, make_mesh, resolve_episode_batch
from r3dfsseg_tpu_torch.parallel.mesh import divides, mesh_size, shard_episode
from r3dfsseg_tpu_torch.utils.logger import ScalarWriter, Silent, init_logger

LOG_WINDOW = 8          # steps whose metrics come to the host in one transfer
DIGEST_EPISODES = 4     # training episodes in `episodes_sha256`'s digest


def episodes_sha256(episodes) -> str:
    """sha256 over the fields of unbatched numpy episodes, in field order
    (None fields skipped): a fingerprint of a stream of episodes."""
    h = hashlib.sha256()
    for ep in episodes:
        for a in ep:
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def train_samplers(cfg: R3DConfig):
    """One sampler per loader worker, worker w > 0 seeded ``seed + 1000 +
    w``, as the JAX CLI seeds them.  Worker 0's (seeded ``seed``) has made
    the one draw with which the JAX CLI initialises its learner, so the
    stream equals the JAX CLI's."""
    from r3dfsseg_tpu_torch.data.episodes import NoisyEpisodeSampler

    kw = dict(cvfold=cfg.cvfold, n_way=cfg.n_way, k_shot=cfg.k_shot, n_queries=cfg.n_queries,
              mode="train", num_point=cfg.pc_npts, pc_attribs=cfg.pc_attribs,
              pc_augm=cfg.pc_augm,
              pc_augm_config={"scale": cfg.pc_augm_scale, "rot": cfg.pc_augm_rot,
                              "mirror_prob": cfg.pc_augm_mirror_prob,
                              "jitter": cfg.pc_augm_jitter},
              noise_ratio=list(cfg.train_noise_ratio), noise_type="train")
    n_workers = max(1, min(cfg.n_workers, 8))
    seeds = [cfg.seed] + [cfg.seed + 1000 + w for w in range(n_workers - 1)]
    samplers = [NoisyEpisodeSampler(cfg.clean_data_path, cfg.dataset, seed=s, **kw)
                for s in seeds]
    samplers[0].sample()
    return samplers


def train(cfg: R3DConfig, device=None) -> dict:
    """Meta-train ``cfg.n_iters`` episodes on ``device`` ("cuda" when None),
    on `mesh_size` data-parallel ranks (started here unless this is a rank
    already).
    Returns the run's figures (rank 0's): train episodes/s with validation
    left out, the median host-clock step (ms), the median and mean wait
    per step for the next batch on the device (ms) and the median of its
    part blocked on the loader's queue, the losses logged, the best
    validation IoU, and the digest of the first training episodes."""
    from r3dfsseg_tpu_torch.data.cache import StaticTestDataset
    from r3dfsseg_tpu_torch.data.loader import EpisodeLoader, device_prefetch
    from r3dfsseg_tpu_torch.utils.checkpoint import load_pretrain_checkpoint, restore
    from r3dfsseg_tpu_torch.utils.torch_convert import save_reference_checkpoint

    n_dev = mesh_size(cfg, device)
    if n_dev > 1 and not dist.is_initialized():
        return launch(train, n_dev, cfg, device=device)
    mesh = make_mesh(n_dev, device)
    lead = mesh.rank == 0
    logger = init_logger(cfg.log_dir, cfg) if lead else Silent()
    writer = ScalarWriter(cfg.log_dir) if lead else Silent()
    try:
        cfg = resolve_episode_batch(cfg, log=logger.cprint, device=device)
        eb = cfg.episode_batch
        learner = make_learner(cfg, mesh.device)
        samplers = train_samplers(cfg)
        valid_set = StaticTestDataset(
            cfg.clean_data_path, cfg.dataset, cvfold=cfg.cvfold,
            num_episode_per_comb=cfg.n_episode_test, n_way=cfg.n_way,
            k_shot=cfg.k_shot, n_queries=cfg.n_queries, num_point=cfg.pc_npts,
            pc_attribs=cfg.pc_attribs, mode="valid", seed=cfg.seed)
        logger.cprint("--------- cvfold=%d, train class: %s, test class: %s ------"
                      % (cfg.cvfold, samplers[0].classes, valid_set.classes))

        best_iou, start = 0.0, 0
        if cfg.model_checkpoint_path:
            info = restore(cfg.model_checkpoint_path, learner, log=logger.cprint)
            best_iou, start = info["IoU"], info["iteration"] // eb
            logger.cprint("Resume from checkpoint %s at Iteration %d (IoU %f)..."
                          % (info["path"], info["iteration"], info["IoU"]))
        elif cfg.pretrain_checkpoint_path:
            learner.load_encoder_state(load_pretrain_checkpoint(
                cfg.pretrain_checkpoint_path, learner.model.features.encoder, log=logger.cprint))
            logger.cprint("Load encoder module from pretrained checkpoint...")

        if mesh.size > 1:
            logger.cprint("episode-DP: %d-episode batches sharded over %d devices"
                          % (eb, mesh.size) if learner.attach_mesh(mesh) else
                          "WARNING: episode-DP disabled — episode_batch %d does not divide "
                          "the %d visible devices (pass --episode_batch 0 for auto, or a "
                          "multiple of %d)" % (eb, mesh.size, mesh.size))
        # every batch is eb episodes: a rank's rows start at one offset
        sharded = divides(learner.mesh, eb)
        offset = mesh.rank * (eb // mesh.size) if sharded else None
        # the `.tar`s carry the Adam state in the original MPTI model's layout;
        # a baseline's are written without one (`Learner.reference_adam`)
        adam = learner.optimizer if learner.reference_adam else None
        n_steps = max(cfg.n_iters // eb, 1)
        loader = EpisodeLoader(samplers[0].sample, num_batches=n_steps, episode_batch=eb,
                               prefetch=4, worker_fns=[s.sample for s in samplers], start=start)
        eval_every = max(cfg.eval_interval // eb, 1)
        first = []          # the first DIGEST_EPISODES episodes, for the digest
        queue_s = []        # time blocked on the loader's queue, per batch

        def recorded(batches):
            it = iter(batches)
            while True:
                t = time.perf_counter()
                b = next(it, None)
                if b is None:
                    return
                queue_s.append(time.perf_counter() - t)
                if len(first) < DIGEST_EPISODES:
                    first.extend([b] if eb == 1 else [type(b)(*(
                        None if a is None else a[j] for a in b)) for j in range(eb)])
                yield b

        losses, step_s, wait_s = [], [], []
        eval_s = 0.0
        pending = []

        def flush():
            """The window's metrics in one transfer, then their log lines."""
            if not pending:
                return
            keys = sorted(pending[0][1])
            vals = torch.stack([torch.stack([m[k].float() for k in keys])
                                for _, m in pending]).cpu().numpy()
            for (step, _), row in zip(pending, vals):
                log_step(step, dict(zip(keys, row)))
            pending.clear()

        def log_step(step, metrics):
            it = (step + 1) * eb
            lp = metrics.get("lp_loss", metrics["loss"])
            contrast = metrics.get("contrast_loss", 0.0)
            losses.append(float(metrics["loss"]))
            logger.cprint("==[Train] Iter: %d | Loss: %.4f |  lp_loss: %.4f | "
                          "contrast_loss: %.4f | Accuracy: %f  ==" % (
                              it, metrics["loss"], lp, contrast, metrics["accuracy"]))
            writer.add_scalar("Train/loss", metrics["loss"], it)
            writer.add_scalar("Train/lp_loss", lp, it)
            writer.add_scalar("Train/edge_loss", contrast, it)
            writer.add_scalar("Train/accuracy", metrics["accuracy"], it)
            for k in ("clean_ratio_LP", "clean_ratio_original", "query_acc_LP",
                      "query_acc_original"):
                if k in metrics:
                    writer.add_scalar(f"Train/{k}", metrics[k], it)
            if (step + 1) % 100 == 0 and len(step_s) > 1:
                eps_s = eb * (len(step_s) - 1) / max(sum(step_s[1:]), 1e-9)
                writer.add_scalar("Train/episodes_per_sec", eps_s, it)
                logger.cprint("== throughput: %.2f episodes/s ==" % eps_s)

        profiler = None
        if cfg.profile_dir and lead:
            # a trace of the first three steps
            acts = [torch.profiler.ProfilerActivity.CPU]
            if learner.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()

        host = recorded(loader)
        if sharded:                 # only this rank's rows go to the device
            host = (shard_episode(b, mesh)[0] for b in host)
        batches = iter(device_prefetch(host, learner.device, n=2))
        t_prev = t_first = time.perf_counter()
        for step in range(start, n_steps):
            t0 = time.perf_counter()
            batch = next(batches)
            wait_s.append(time.perf_counter() - t0)
            if profiler is not None and step == start + 3:
                profiler.stop()
                profiler.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                profiler = None
            pending.append((step, learner.train(batch, offset)))
            if len(pending) >= LOG_WINDOW:
                flush()
            t_now = time.perf_counter()
            step_s.append(t_now - t_prev)
            t_prev = t_now
            if step == start:
                t_first, eval_s = t_now, 0.0

            if (step + 1) % eval_every == 0:
                flush()                            # drain before validating
                it = (step + 1) * eb
                valid_loss, mean_iou = test_few_shot(valid_set, learner, logger,
                                                     list(valid_set.classes))
                logger.cprint("\n=====[VALID] Loss: %.4f | Mean IoU: %f  =====\n"
                              % (valid_loss, mean_iou))
                writer.add_scalar("Valid/loss", valid_loss, it)
                writer.add_scalar("Valid/meanIoU", mean_iou, it)
                # every rank holds the same IoU (the predictions are gathered),
                # so every rank takes the same decision; rank 0 writes
                if mean_iou > best_iou:
                    best_iou = mean_iou
                    logger.cprint("*******************Model Saved*******************")
                    if lead:
                        save_reference_checkpoint(
                            os.path.join(cfg.log_dir, "checkpoint.tar"), learner.model,
                            iteration=it, loss=valid_loss, iou=best_iou, optimizer=adam)
                if lead:
                    save_reference_checkpoint(
                        os.path.join(cfg.log_dir, f"checkpoint_{it}.tar"), learner.model,
                        iteration=it, loss=valid_loss, iou=best_iou, optimizer=adam)
                t_prev = time.perf_counter()
                eval_s += t_prev - t_now
        flush()
        if profiler is not None:
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
        if learner.device.type == "cuda":
            torch.cuda.synchronize(learner.device)
        # throughput from the end of the first step (the first step pays
        # the allocator's and the kernels' first calls) to the device's
        # end, validation left out
        t_run = time.perf_counter() - t_first - eval_s
        eps_s = eb * (len(step_s) - 1) / max(t_run, 1e-9) if len(step_s) > 1 else 0.0
        logger.cprint("== throughput: %.2f episodes/s (validation left out) ==" % eps_s)
        return {"episodes_per_s": eps_s,
                "step_ms_median": 1e3 * statistics.median(step_s) if step_s else 0.0,
                "loader_wait_ms_median": 1e3 * statistics.median(wait_s) if wait_s else 0.0,
                "loader_wait_ms_mean": 1e3 * statistics.fmean(wait_s) if wait_s else 0.0,
                "loader_queue_ms_median": 1e3 * statistics.median(queue_s) if queue_s else 0.0,
                "eval_s": eval_s, "losses": losses, "best_iou": best_iou,
                "episodes_sha256": episodes_sha256(first[:DIGEST_EPISODES])}
    finally:
        writer.close()
        logger.close()


def main(argv=None):
    args = build_parser(eval_mode=False).parse_args(argv)
    cfg = args_to_config(args, eval_mode=False)
    np.random.seed(cfg.seed)
    if cfg.phase in ("pretrain", "finetune"):
        # encoder (re-)pretraining; finetune starts from
        # --pretrain_checkpoint_path (the JAX CLI's dispatch)
        from r3dfsseg_tpu_torch.pretrain import pretrain
        pretrain(cfg, device=args.device)
    else:
        train(cfg, device=args.device)


if __name__ == "__main__":
    main()
