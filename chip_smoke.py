#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (r3dfsseg_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc.  Phases, each of which raises (exit code != 0) on failure:

  1. build every kernel of `r3dfsseg_tpu_torch/csrc/` with nvcc;
  2. call each kernel at the flagship shapes of the serving path and hold
     it against its plain PyTorch version on the same inputs (kNN: the
     neighbour sets, differences only at near-ties; attention: rtol 1e-4,
     atol 1e-5; FPS: the seeds, a divergence only at a near-tie; k-th
     distance: bit-equal), and time both with CUDA events;
  3. serve flagship episodes (R3DConfig(): 2-way 5-shot, 2048 points x 9,
     a 4396-node graph) through `FewShotPredictor.predict` with seeded
     random weights, count each kernel's launches, and compare the
     predictions with the same requests served by the plain versions.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.  Without a
CUDA device it exits with code 1 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

NEAR_TIE = 1e-5     # relative distance gap that counts as a tie


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in milliseconds (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- data --
def make_episode(cfg, rng: np.random.Generator):
    """One flagship episode as numpy arrays.  Each cloud is a unit block of
    uniform background points; a way's foreground is a Gaussian blob with
    its own colour, so support masks and MDNS see real structure.  One
    support shot per way is noisy: its mask marks the other way's blob."""
    w, k, n = cfg.n_way, cfg.k_shot, cfg.pc_npts
    centres = rng.uniform(0.25, 0.75, size=(w, 3))
    colours = rng.uniform(0.0, 1.0, size=(w, 3))

    def cloud(ways):
        xyz = rng.uniform(0.0, 1.0, size=(n, 3))
        rgb = rng.uniform(0.0, 1.0, size=(n, 3))
        lab = np.zeros(n, np.int32)
        per = n // 4
        for j, way in enumerate(ways):
            sl = slice(j * per, (j + 1) * per)
            xyz[sl] = np.clip(centres[way] + 0.06 * rng.normal(size=(per, 3)), 0, 1)
            rgb[sl] = np.clip(colours[way] + 0.05 * rng.normal(size=(per, 3)), 0, 1)
            lab[sl] = way + 1
        x = np.concatenate([xyz - xyz.min(0), rgb, xyz], axis=1).astype(np.float32)
        return x, lab

    sx = np.zeros((w, k, n, 9), np.float32)
    sy = np.zeros((w, k, n), np.int32)
    for way in range(w):
        for shot in range(k):
            noisy = shot == k - 1
            x, lab = cloud([(way + 1) % w] if noisy else [way])
            sx[way, shot] = x
            sy[way, shot] = lab > 0
    qx = np.zeros((w * cfg.n_queries, n, 9), np.float32)
    for q in range(w * cfg.n_queries):
        qx[q], _ = cloud(list(range(w)))
    return sx, sy, qx


# ------------------------------------------------------------ kernels --
def check_knn(torch, knn_mod, sx):
    """Flagship EdgeConv shapes: the 10 support clouds at C = 9 (raw points)
    and C = 64 (features).  Sets must match on >= 99.9% of rows, and every
    differing neighbour must be a rounding-level tie of the row's k-th
    distance: the Gram form (xx + yy) - 2 x.y rounds at the scale of the
    norms, so the gap is measured against xx_i + xx_j, not against d."""
    from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist
    k = 20
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = {9: torch.from_numpy(sx.reshape(-1, *sx.shape[2:])).cuda(),
          64: torch.randn((10, 2048, 64), generator=g, device="cuda")}
    worst_err, mismatch = 0.0, {}
    for c, x in xs.items():
        got = knn_mod.knn(x, k).long()
        want = knn_mod.knn_reference(x, k).long()
        d = pairwise_sqdist(x)
        xx = (x * x).sum(-1)
        dk = d.gather(-1, want[..., -1:])                       # k-th distance
        same = (got.sort(-1).values == want.sort(-1).values).all(-1)
        mismatch[c] = 1.0 - same.float().mean().item()
        extra = ~(got[..., :, None] == want[..., None, :]).any(-1)   # in got, not in want
        diff = (d.gather(-1, got) - dk).abs() * extra
        norm_scale = xx[..., None] + xx.gather(-1, got.flatten(1)).view_as(got)
        gap_rel = (diff / dk.clamp_min(1e-30)).amax().item()
        gap = (diff / norm_scale.clamp_min(1e-30)).amax().item()
        err = (d.gather(-1, got).sort(-1).values - d.gather(-1, want).sort(-1).values)
        worst_err = max(worst_err, err.abs().max().item())
        self_first = (got[..., 0] == torch.arange(x.shape[1], device="cuda")).float().mean().item()
        log(f"  knn C={c}: row mismatch rate {mismatch[c]:.3e}; worst differing neighbour "
            f"off the k-th distance by {gap_rel:.3e} of it, {gap:.3e} of xx_i + xx_j; "
            f"self first on {self_first:.5f} of rows")
        if mismatch[c] > 1e-3 or gap > NEAR_TIE:
            raise AssertionError(f"knn C={c}: mismatch {mismatch[c]}, gap {gap}")
    shapes = [(10, 9), (10, 64), (10, 64), (2, 9), (2, 64), (2, 64)]
    feats = {(b, c): torch.randn((b, 2048, c), generator=g, device="cuda") for b, c in set(shapes)}
    ms = cuda_ms(lambda: [knn_mod.knn(feats[s], k) for s in shapes], 10)
    plain = cuda_ms(lambda: [knn_mod.knn_reference(feats[s], k) for s in shapes], 10)
    return worst_err, ms, plain


def check_attention(torch, attn_mod):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((10, 2048, 64), generator=g, device="cuda") for _ in range(3))
    got = attn_mod.attention(q, k, v, 8.0)
    want = attn_mod.attention_reference(q, k, v, 8.0)
    err = (got - want).abs().max().item()
    log(f"  attention (10, 2048, 64): max abs err {err:.3e}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    small = [tuple(t[:2] for t in (q, k, v))]
    full = [(q, k, v)] + small
    ms = cuda_ms(lambda: [attn_mod.attention(*a, 8.0) for a in full], 10)
    plain = cuda_ms(lambda: [attn_mod.attention_reference(*a, 8.0) for a in full], 10)
    return err, ms, plain


def _fps_divergence_gap(torch, fps_mod, feat, valid, got, want):
    """Replay the plain FPS up to the first differing slot; return the
    largest absolute and relative gap between the two candidates' running
    min distances there."""
    worst, worst_abs = 0.0, 0.0
    for p in range(feat.shape[0]):
        diff = (got[p] != want[p]).nonzero()
        if len(diff) == 0:
            continue
        r = int(diff[0])
        mind = torch.where(valid[p], torch.tensor(fps_mod.BIG, device="cuda"),
                           torch.tensor(fps_mod.NEG, device="cuda"))
        for i in range(r):
            d = ((feat[p] - feat[p, want[p, i]]) ** 2).sum(-1)
            mind = torch.minimum(mind, torch.where(valid[p], d, fps_mod.NEG))
        a, b = mind[got[p, r]].item(), mind[want[p, r]].item()
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        worst_abs = max(worst_abs, abs(a - b))
        log(f"  fps instance {p}: first divergence at slot {r}, gap {worst:.3e}")
    return worst_abs, worst


def check_fps(torch, fps_mod):
    g = torch.Generator(device="cuda").manual_seed(2)
    ways = torch.randn((2, 10240, 192), generator=g, device="cuda")
    ways_ok = torch.rand((2, 10240), generator=g, device="cuda") < 0.25
    bg = torch.randn((1, 20480, 192), generator=g, device="cuda")
    bg_ok = torch.rand((1, 20480), generator=g, device="cuda") < 0.75
    err = 0.0
    for feat, ok in ((ways, ways_ok), (bg, bg_ok)):
        got = fps_mod.fps(feat, ok, 100)
        want = fps_mod.fps_reference(feat, ok, 100)
        equal = bool((got == want).all())
        log(f"  fps {tuple(feat.shape)} k=100: seeds equal {equal}")
        if not equal:
            abs_gap, gap = _fps_divergence_gap(torch, fps_mod, feat, ok, got, want)
            err = max(err, abs_gap)
            if gap > NEAR_TIE:
                raise AssertionError(f"fps diverged at a relative gap of {gap}")
    ms = cuda_ms(lambda: (fps_mod.fps(ways, ways_ok, 100), fps_mod.fps(bg, bg_ok, 100)), 5)
    plain = cuda_ms(lambda: (fps_mod.fps_reference(ways, ways_ok, 100),
                             fps_mod.fps_reference(bg, bg_ok, 100)), 5)
    return err, ms, plain


def check_kth(torch, kth_mod):
    from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist
    g = torch.Generator(device="cuda").manual_seed(3)
    m = 4396
    d = pairwise_sqdist(torch.randn((m, 192), generator=g, device="cuda"))
    d.fill_diagonal_(kth_mod.SENTINEL)
    d[:, 100:300] = kth_mod.SENTINEL          # invalid prototype slots
    got = kth_mod.kth_smallest_per_row(d, 200, 32)
    want = kth_mod.kth_smallest_per_row_reference(d, 200, 32)
    equal = torch.equal(got, want)
    err = (got - want).abs().max().item()
    log(f"  kth ({m}, {m}) k=200 iters=32: bit-equal {equal}")
    if not equal:
        raise AssertionError(f"kth differs from its plain version by up to {err}")
    ms = cuda_ms(lambda: kth_mod.kth_smallest_per_row(d, 200, 32), 10)
    plain = cuda_ms(lambda: kth_mod.kth_smallest_per_row_reference(d, 200, 32), 10)
    return err, ms, plain


# ------------------------------------------------------------ serving --
def serve(torch, cfg, episodes, kernels, seed):
    """Serve every episode on the kernel path, then on the plain path with
    the same weights; return latencies, predictions and launch counts."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.serve import FewShotPredictor

    fast = FewShotPredictor(cfg, MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed)))
    plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")
    plain = FewShotPredictor(plain_cfg, MPTILearner(plain_cfg, "cuda"))
    plain._learner.model.load_state_dict(fast._learner.model.state_dict())

    fast.predict(*episodes[0])                 # warm-up: first allocations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    lat, preds = [], []
    for i, ep in enumerate(episodes):
        before = {n: m.launches for n, m in kernels.items()}
        t0 = time.perf_counter()
        pred = fast.predict(*ep)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        grew = {n: m.launches - before[n] for n, m in kernels.items()}
        if min(grew.values()) <= 0:
            raise AssertionError(f"request {i}: a kernel was not launched: {grew}")
        preds.append(pred)
    launches = {n: m.launches for n, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    plain.predict(*episodes[0])
    plain_lat, plain_preds = [], []
    for ep in episodes:
        t0 = time.perf_counter()
        plain_preds.append(plain.predict(*ep))
        torch.cuda.synchronize()
        plain_lat.append((time.perf_counter() - t0) * 1e3)
    if {n: m.launches for n, m in kernels.items()} != launches:
        raise AssertionError("the plain path launched a kernel")

    sx, sy, qx = episodes[0]
    ep = Episode(*(torch.as_tensor(a).cuda() for a in (sx, sy, qx)),
                 torch.zeros(qx.shape[:2], dtype=torch.int64, device="cuda"))
    with torch.inference_mode():
        logits = fast._learner.model(ep, eval_mdns=True).query_logits
    return lat, preds, plain_lat, plain_preds, launches, peak, logits, fast._learner.model


def stage_breakdown(torch, model, cfg, episode, reps: int = 5):
    """Median device time (ms) of each stage of one request on the kernel
    path, between CUDA events: encoder (support and query batches), MDNS,
    graph nodes (FPS prototypes), affinity, label propagation."""
    from r3dfsseg_tpu_torch.models import mpti
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.ops.lp import label_propagate, local_constrained_affinity

    sx, sy, qx = (torch.as_tensor(a).cuda() for a in episode)
    names = ["encoder", "mdns", "graph_nodes", "affinity", "label_propagation"]
    times = {n: [] for n in names}
    with torch.inference_mode():
        for _ in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            ep = Episode(sx[None], sy[None], qx[None], None)
            sf, qf = model.extract_features(ep)
            sf, qf = sf[0], qf[0]
            ev[1].record()
            fg = sy > 0
            keep, _ = mpti.mdns_keep_mask(sf, fg, sx[..., :3], cfg.mdns_scales)
            fg_used = fg & (keep[..., None] > 0.5)
            ev[2].record()
            protos, pvalid, labels, _ = mpti.episode_graph_nodes(sf, fg_used, fg, cfg)
            ev[3].record()
            q = qf.reshape(-1, qf.shape[-1])
            node = torch.cat([protos, q])
            valid = torch.cat([pvalid, torch.ones(len(q), dtype=torch.bool, device="cuda")])
            a = local_constrained_affinity(node, cfg.k_connect, cfg.sigma, valid=valid)
            ev[4].record()
            y0 = torch.cat([labels, torch.zeros((len(q), cfg.n_classes), device="cuda")])
            label_propagate(a, y0, cfg.lp_alpha, cg_iters=cfg.lp_cg_iters)
            ev[5].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                times[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(t[1:]) for n, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from r3dfsseg_tpu_torch import pin_f32_matmul
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.kernels import build
    from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_fps, cuda_knn, cuda_kth
    pin_f32_matmul()

    # ---- 1. build
    t0 = time.perf_counter()
    lib = build.library_path()
    build.library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    # ---- 2. kernels against their plain versions
    cfg = R3DConfig()
    rng = np.random.default_rng(args.seed)
    episodes = [make_episode(cfg, rng) for _ in range(max(args.requests, 3))]
    log("[kernels] flagship shapes, kernel vs plain PyTorch on the card")
    knn_err, knn_ms, knn_plain = check_knn(torch, cuda_knn, episodes[0][0])
    attn_err, attn_ms, attn_plain = check_attention(torch, cuda_attention)
    fps_err, fps_ms, fps_plain = check_fps(torch, cuda_fps)
    kth_err, kth_ms, kth_plain = check_kth(torch, cuda_kth)
    torch.cuda.synchronize()

    # ---- 3. serving
    kernels = {"knn": cuda_knn, "attention_fwd": cuda_attention, "fps": cuda_fps,
               "kth": cuda_kth}
    lat, preds, plain_lat, plain_preds, launches, peak, logits, model = serve(
        torch, cfg, episodes, kernels, args.seed)
    q, n = cfg.n_way * cfg.n_queries, cfg.pc_npts
    if tuple(logits.shape) != (1, q, n, cfg.n_classes) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits: shape {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    for i, (a, b) in enumerate(zip(preds, plain_preds)):
        if a.shape != (q, n) or a.dtype != np.int32 or a.min() < 0 or a.max() > cfg.n_way:
            raise AssertionError(f"request {i}: bad labels {a.shape} {a.dtype} "
                                 f"[{a.min()}, {a.max()}]")
        agree = float((a == b).mean())
        fg = float((a > 0).mean())
        log(f"  request {i}: {lat[i]:.2f} ms kernels, {plain_lat[i]:.2f} ms plain; "
            f"agreement with plain {agree:.4f}; fg share {fg:.3f}")
        if agree < 0.99:
            raise AssertionError(f"request {i}: kernel and plain paths agree on {agree}")
    log(f"[serve] {len(lat)} requests; median latency {statistics.median(lat):.2f} ms "
        f"(kernels) vs {statistics.median(plain_lat):.2f} ms (plain); peak memory "
        f"{peak / 2**20:.1f} MiB; launches {launches}")

    stages = stage_breakdown(torch, model, cfg, episodes[0])
    log("[stages] kernel path, device ms per request (median of 5): " +
        ", ".join(f"{n} {t:.3f}" for n, t in stages.items()) +
        f"; sum {sum(stages.values()):.3f}")

    rows = [
        ("knn", "knn.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27", knn_err, knn_ms, knn_plain),
        ("attention_fwd", "attention_fwd.cu", "r3dfsseg_tpu/ops/pallas_attention.py:54",
         attn_err, attn_ms, attn_plain),
        ("fps", "fps.cu", "r3dfsseg_tpu/ops/pallas_fps.py:46", fps_err, fps_ms, fps_plain),
        ("kth", "kth.cu", "r3dfsseg_tpu/ops/pallas_kth.py:33", kth_err, kth_ms, kth_plain),
    ]
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"r3dfsseg_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms}
        for name, src, rep, err, ms, plain_ms in rows]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
