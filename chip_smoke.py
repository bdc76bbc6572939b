#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (r3dfsseg_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc.  Phases, each of which raises (exit code != 0) on failure:

  1. build every kernel of `r3dfsseg_tpu_torch/csrc/` with nvcc;
  2. call each kernel at the flagship shapes of its path and hold it
     against its plain PyTorch version on the same inputs (kNN: the
     neighbour sets, differences only at near-ties; attention forward:
     rtol 1e-4, atol 1e-5, eval and with dropout; the dropout mask: the
     Philox words bit-equal; attention backward: within 1e-4 of each
     gradient's largest entry of torch autograd through the plain masked
     forward; FPS: the seeds, a divergence only at a near-tie; k-th
     distance: bit-equal, on f32 distances and on the bf16 compare copy
     of a flagship episode's graph; scatter-add: within 1e-5 of sum |g|;
     the Chebyshev solve on that episode's bf16 S: within 1e-4 of the
     solution's largest entry), and time the kernel, the plain version
     and, where one exists, the one PyTorch call computing the same
     function, with CUDA events; and measure the peak memory of that
     episode graph alone, forward and backward, in float32 and bf16;
  3. serve flagship episodes (R3DConfig(): 2-way 5-shot, 2048 points x 9,
     a 4396-node graph) through `FewShotPredictor.predict` with seeded
     random weights, count each kernel's launches, and compare the
     predictions with the same requests served by the plain versions;
     then the same requests with the bf16 episode graph
     (graph_dtype="bfloat16"), against its plain path (>= 99% of points)
     and against the float32 graph's predictions (>= 98%);
  4. train: one f32 meta-training step (`MPTILearner.train`, attention
     dropout 0.1, WayContrast) on the kernel path and on the plain path
     from the same weights and generator seed, on the same kNN graphs
     (where the two kNN versions keep different neighbours at a checked
     rounding-level tie, the plain path takes the kernel path's choice):
     losses rtol 1e-4, each parameter's gradient within a relative L2
     distance of 1e-3 (the biases feeding a train-mode BatchNorm, whose
     exact gradient is 0, below 1e-5 of the largest gradient entry); then
     kernel-path steps that must each launch all six kernels of the f32
     graph, and a torch.profiler window over three more; then the same
     with the bf16 episode graph (gradients within a relative L2 distance
     of 1e-1: see `train`), whose steps must each launch all seven
     kernels, the Chebyshev solve twice (forward and adjoint) and the
     k-th distance once.

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
F32_FLOPS = 67e12   # H100 SXM peak f32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM device-memory bytes/s
GRAD_TOL = 1e-3     # kernel vs plain training step: relative L2 per parameter
BF16_GRAD_TOL = 1e-1  # the same on the bf16 graph, whose gradients carry ~1e-2 of
                      # bf16 rounding noise (see `train`)
CHEBY_TOL = 1e-4    # Chebyshev kernel vs plain: f32 sums in another order, 49 matvecs
TRAIN_STEPS = 4     # timed kernel-path training steps after step 1, per graph dtype


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row(err, ms, plain_ms, library_ms, flops, nbytes, **extra):
    b, by = bound(flops, nbytes)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms, **extra)


# ---------------------------------------------------------------- data --
def make_episode(cfg, rng: np.random.Generator):
    """One flagship episode as numpy arrays (support_x, support_y, query_x,
    query_y, gt_support_y, gt_query_y, support_flag).  Each cloud is a unit
    block of uniform background points; a way's foreground is a Gaussian
    blob with its own colour, so support masks and MDNS see real structure.
    One support shot per way is noisy: its mask marks the other way's blob,
    its gt mask is empty and its flag is the other way's class."""
    w, k, n = cfg.n_way, cfg.k_shot, cfg.pc_npts
    classes = rng.choice(12, size=w, replace=False) + 1
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
    gt_sy = np.zeros((w, k, n), np.int32)
    flag = np.zeros((w, k), np.int32)
    for way in range(w):
        for shot in range(k):
            noisy = shot == k - 1
            other = (way + 1) % w
            x, lab = cloud([other] if noisy else [way])
            sx[way, shot] = x
            sy[way, shot] = lab > 0
            gt_sy[way, shot] = 0 if noisy else lab > 0
            flag[way, shot] = classes[other if noisy else way]
    qx = np.zeros((w * cfg.n_queries, n, 9), np.float32)
    qy = np.zeros((w * cfg.n_queries, n), np.int32)
    for q in range(w * cfg.n_queries):
        qx[q], qy[q] = cloud(list(range(w)))
    return sx, sy, qx, qy, gt_sy, qy.copy(), flag


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
    flops = sum(2.0 * b * 2048 ** 2 * c for b, c in shapes)
    nbytes = sum(4.0 * b * 2048 * (c + k) for b, c in shapes)
    return row(worst_err, ms, plain, None, flops, nbytes)


def check_attention(torch, attn_mod):
    """Eval mode at the serving shapes (B = 10 and 2, no dropout)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((10, 2048, 64), generator=g, device="cuda") for _ in range(3))
    got = attn_mod.attention(q, k, v, 8.0)
    want = attn_mod.attention_reference(q, k, v, 8.0)
    err = (got - want).abs().max().item()
    log(f"  attention eval (10, 2048, 64): max abs err {err:.3e}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    full = [(q, k, v), tuple(t[:2] for t in (q, k, v))]
    ms = cuda_ms(lambda: [attn_mod.attention(*a, 8.0) for a in full], 10)
    plain = cuda_ms(lambda: [attn_mod.attention_reference(*a, 8.0) for a in full], 10)
    lib = cuda_ms(lambda: [F.scaled_dot_product_attention(*a, scale=1 / 8.0) for a in full], 10)
    return err, ms, plain, lib


def check_dropout_mask(torch, attn_mod):
    """The kernel's Philox words at the support batch's shape equal the
    plain version's bit for bit."""
    for b, seed in ((10, 123456789), (2, 2**61 + 5)):
        got = attn_mod.dropout_words(b, 2048, seed, "cuda").to(torch.int64) & 0xFFFFFFFF
        want = attn_mod.dropout_words_reference(b, 2048, seed, "cuda")
        equal = torch.equal(got, want)
        keep = ((want >> 8) >= attn_mod.dropout_threshold(0.1)).float().mean().item()
        log(f"  dropout mask ({b}, 2048, 2048) seed {seed}: kernel bits equal plain {equal}; "
            f"keep share {keep:.5f}")
        if not equal:
            raise AssertionError("dropout mask: kernel and plain bits differ")


def check_attention_train(torch, attn_mod):
    """Training shapes (B = 10 and 2, N = 2048, D = 64, dropout 0.1): the
    forward (y and lse) against the plain version, rtol 1e-4 / atol 1e-5;
    the backward against torch autograd through the plain masked forward
    with the same mask, each gradient within 1e-4 of its largest entry."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(4)
    rate, tau = 0.1, 8.0
    calls = []
    for b, seed in ((10, 77), (2, 78)):
        q, k, v, dy = (torch.randn((b, 2048, 64), generator=g, device="cuda") for _ in range(4))
        calls.append((q, k, v, dy, seed))
    fwd_err = bwd_err = 0.0
    saved = []
    for q, k, v, dy, seed in calls:
        y, lse = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
        want_y, want_lse = attn_mod.attention_fwd_reference(q, k, v, tau, rate, seed)
        torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
        fwd_err = max(fwd_err, (y - want_y).abs().max().item())
        got = attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attn_mod.attention_reference(*leaves, tau, rate, seed).backward(dy)
        for name, a, t in zip("qkv", got, leaves):
            e = (a - t.grad).abs().max().item()
            scale = t.grad.abs().max().item()
            log(f"  attention bwd B={q.shape[0]} d{name}: max abs err {e:.3e} "
                f"({e / scale:.3e} of the largest entry)")
            if e > 1e-4 * scale:
                raise AssertionError(f"attention bwd d{name}: error {e} > 1e-4 x {scale}")
            bwd_err = max(bwd_err, e)
        saved.append((q, k, v, dy, seed, y, lse))
    log(f"  attention fwd with dropout: max abs err {fwd_err:.3e}")

    def sdpa_fwd():
        for q, k, v, *_ in calls:
            F.scaled_dot_product_attention(q, k, v, dropout_p=rate, scale=1 / tau)

    def sdpa_fwd_bwd():
        for q, k, v, dy, _ in calls:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            F.scaled_dot_product_attention(*leaves, dropout_p=rate, scale=1 / tau).backward(dy)

    fwd = [cuda_ms(lambda: [f(q, k, v, tau, rate, seed) for q, k, v, _, seed in calls], 10)
           for f in (attn_mod.attention_fwd, attn_mod.attention_fwd_reference)]
    bwd = [cuda_ms(lambda: [f(q, k, v, y, dy, lse, tau, rate, seed)
                            for q, k, v, dy, seed, y, lse in saved], 10)
           for f in (attn_mod.attention_bwd, attn_mod.attention_bwd_reference)]
    lib_fwd, lib_bwd = cuda_ms(sdpa_fwd, 10), cuda_ms(sdpa_fwd_bwd, 10)
    bn2d = sum(q.shape[0] for q, *_ in calls) * 2048 ** 2 * 64
    io = sum(q.numel() for q, *_ in calls) * 4.0
    return (row(fwd_err, fwd[0], fwd[1], lib_fwd, 4.0 * bn2d, 4 * io),
            row(bwd_err, bwd[0], bwd[1], lib_bwd, 10.0 * bn2d, 8 * io))


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
    pts = 2 * 10240 + 20480
    return row(err, ms, plain, None, 3.0 * pts * 192 * 100, pts * (192 * 4.0 + 1) + 3 * 100 * 4)


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
    lib = cuda_ms(lambda: torch.kthvalue(d, 200, dim=1), 10)
    return row(err, ms, plain, lib, 32.0 * m * m, 4.0 * m * (m + 1))


def flagship_graph(torch, cfg, episode, seed):
    """A flagship episode's bf16 graph, as the serving path builds it with
    seeded random weights: the bf16 compare copy (4396, 4396) with its
    sentinels, the bf16 S, the label columns b (4396, 3), and the graph's
    node features (4396, 192) and validity."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models import mpti
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.ops import lp

    model = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed)).model
    sx, sy, qx = (torch.as_tensor(a).cuda() for a in episode[:3])
    with torch.inference_mode():
        sf, qf = model.extract_features(Episode(sx[None], sy[None], qx[None], None))
        sf, qf = sf[0], qf[0].reshape(-1, sf.shape[-1])
        fg = sy > 0
        keep, _ = mpti.mdns_keep_mask(sf, fg, sx[..., :3], cfg.mdns_scales)
        protos, pvalid, labels, _ = mpti.episode_graph_nodes(sf, fg & (keep[..., None] > 0.5),
                                                             fg, cfg)
        node = torch.cat([protos, qf])
        valid = torch.cat([pvalid, torch.ones(len(qf), dtype=torch.bool, device="cuda")])
        _, sel = lp.graph_distances(node, valid, torch.bfloat16)
        a = lp.local_constrained_affinity(node, cfg.k_connect, cfg.sigma, valid=valid,
                                          compare_dtype=torch.bfloat16)
        s = lp.propagation_matrix(a)
        b = torch.cat([labels, torch.zeros((len(qf), cfg.n_classes), device="cuda")])
    return sel, s, b, node.clone(), valid.clone()


def graph_peak(torch, cfg, node, valid, b, compare_dtype):
    """Peak device memory, above what was allocated before, of the episode
    graph alone in training: the affinity and label propagation forward,
    then the backward to the node features."""
    from r3dfsseg_tpu_torch.ops import lp
    x = node.detach().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = lp.local_constrained_affinity(x, cfg.k_connect, cfg.sigma, valid=valid,
                                      compare_dtype=compare_dtype)
    z = lp.label_propagate(a, b.clone(), cfg.lp_alpha, cg_iters=cfg.lp_cg_iters)
    z.square().sum().backward()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def check_kth_bf16(torch, kth_mod, sel):
    """The bf16 compare copy of a flagship graph, k = 200, 16 steps:
    bit-equal.  Returns the kth row's *_bf16 fields."""
    m = sel.shape[0]
    got = kth_mod.kth_smallest_per_row(sel, 200, 16)
    want = kth_mod.kth_smallest_per_row_reference(sel, 200, 16)
    equal = torch.equal(got, want)
    log(f"  kth bf16 ({m}, {m}) k=200 iters=16: bit-equal {equal}")
    if not equal:
        raise AssertionError(f"kth bf16 differs from its plain version by up to "
                             f"{(got - want).abs().max().item()}")
    ms = cuda_ms(lambda: kth_mod.kth_smallest_per_row(sel, 200, 16), 10)
    plain = cuda_ms(lambda: kth_mod.kth_smallest_per_row_reference(sel, 200, 16), 10)
    lib = cuda_ms(lambda: torch.kthvalue(sel, 200, dim=1), 10)
    r = row(0.0, ms, plain, lib, 16.0 * m * m, 2.0 * m * m + 4.0 * m)
    return {f"{key}_bf16": v for key, v in r.items()}


def check_cheby(torch, cheby_mod, s, b, alpha, iters):
    """The Chebyshev solve on a flagship bf16 S, with the episode's label
    columns b (the forward solve) and with a dense random b (as the
    adjoint solve's): kernel vs plain within CHEBY_TOL of the solution's
    largest entry; both are also held against the same solve in f64
    (`exact_solve`) and the distances logged.  Its bound counts S read
    once (it fits in the 50 MB L2); `bound_ms_hbm` is the time to read S
    from device memory at every step."""
    g = torch.Generator(device="cuda").manual_seed(6)
    m = s.shape[0]
    for rhs, bb in (("labels", b), ("dense", torch.randn(b.shape, generator=g, device="cuda"))):
        got = cheby_mod.cheby_solve(s, bb, alpha, iters)
        want = cheby_mod.cheby_solve_reference(s, bb, alpha, iters)
        exact = exact_solve(cheby_mod)(s, bb, alpha, iters)
        e, scale = (got - want).abs().max().item(), want.abs().max().item()
        exact_err = {name: (x - exact).abs().max().item() / scale
                     for name, x in (("kernel", got), ("plain", want))}
        log(f"  cheby bf16 S ({m}, {m}), {rhs} b {tuple(bb.shape)}, {iters} steps: max abs err "
            f"{e:.3e}, {e / scale:.3e} of max |x| = {scale:.4f}; from the f64 solve: kernel "
            f"{exact_err['kernel']:.3e}, plain {exact_err['plain']:.3e} of max |x|")
        if not (np.isfinite(e) and e <= CHEBY_TOL * scale):
            raise AssertionError(f"cheby, {rhs} b: error {e} > {CHEBY_TOL} x {scale}")
        if rhs == "labels":
            err, rel_err, label_exact = e, e / scale, exact_err
    ms = cuda_ms(lambda: cheby_mod.cheby_solve(s, b, alpha, iters), 10)
    plain = cuda_ms(lambda: cheby_mod.cheby_solve_reference(s, b, alpha, iters), 10)
    steps = iters - 1
    s_bytes = 2.0 * m * m
    return row(err, ms, plain, None, steps * 2.0 * m * m * b.shape[1],
               s_bytes + 8.0 * b.numel(), max_rel_err=rel_err,
               exact_rel_err=label_exact["kernel"], plain_exact_rel_err=label_exact["plain"],
               bound_ms_hbm=steps * s_bytes / HBM_BYTES * 1e3)


def check_scatter(torch, knn_mod, scatter_mod, sx, qx):
    """The gather backward at a training step's shapes: the kNN graphs of
    the episode's support (B = 10) and query (B = 2) clouds, a random
    (B, 2048, 20, 64) cotangent.  The atomics add in a varying order:
    |got - want| <= 1e-5 * sum |g| per entry."""
    g = torch.Generator(device="cuda").manual_seed(5)
    calls = []
    for x in (sx.reshape(-1, *sx.shape[2:]), qx):
        xt = torch.from_numpy(np.ascontiguousarray(x)).cuda()
        idx = knn_mod.knn(xt, 20)
        calls.append((torch.randn((*idx.shape, 64), generator=g, device="cuda"), idx))
    err = 0.0
    for gr, idx in calls:
        got = scatter_mod.scatter_add(gr, idx, 2048)
        want = scatter_mod.scatter_add_reference(gr, idx, 2048)
        tol = 1e-5 * scatter_mod.scatter_add_reference(gr.abs(), idx, 2048)
        e = (got - want).abs()
        hub = torch.bincount(idx[0].flatten().long()).max().item()
        log(f"  scatter-add {tuple(gr.shape)}: max abs err {e.max().item():.3e}, "
            f"largest share of the bound {(e / tol.clamp_min(1e-30)).max().item():.3e}; "
            f"busiest point of cloud 0 is the neighbour of {hub} rows")
        if not bool((e <= tol).all()):
            raise AssertionError("scatter-add outside 1e-5 * sum |g|")
        err = max(err, e.max().item())
    step = calls * 3                        # three EdgeConv blocks per batch

    def library():
        for gr, idx in step:
            b = gr.shape[0]
            off = (torch.arange(b, device="cuda") * 2048)[:, None, None]
            flat = (idx.long() + off).reshape(-1)
            gr.new_zeros((b * 2048, 64)).index_add_(0, flat, gr.reshape(-1, 64))

    ms = cuda_ms(lambda: [scatter_mod.scatter_add(gr, idx, 2048) for gr, idx in step], 10)
    plain = cuda_ms(lambda: [scatter_mod.scatter_add_reference(gr, idx, 2048)
                             for gr, idx in step], 10)
    lib = cuda_ms(library, 10)
    nbytes = sum(4.0 * (gr.numel() + idx.numel() + gr.shape[0] * 2048 * 64) for gr, idx in step)
    return row(err, ms, plain, lib, sum(float(gr.numel()) for gr, _ in step), nbytes)


# ------------------------------------------------------------ serving --
SERVE_KERNELS = ("knn", "attention_fwd", "fps", "kth")


def counts(kernels) -> dict:
    return {n: getattr(mod, attr) for n, (mod, attr) in kernels.items()}


def zero_counts(kernels) -> None:
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)


def serve(torch, cfg, episodes, kernels, seed, required=SERVE_KERNELS):
    """Serve every episode on the kernel path, then on the plain path with
    the same weights; return latencies, predictions and launch counts.
    Every request must launch each kernel in ``required``."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.serve import FewShotPredictor

    fast = FewShotPredictor(cfg, MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed)))
    plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")
    plain = FewShotPredictor(plain_cfg, MPTILearner(plain_cfg, "cuda"))
    plain._learner.model.load_state_dict(fast._learner.model.state_dict())

    fast.predict(*episodes[0][:3])             # warm-up: first allocations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    lat, preds = [], []
    for i, ep in enumerate(episodes):
        before = counts(kernels)
        t0 = time.perf_counter()
        pred = fast.predict(*ep[:3])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        grew = {n: c - before[n] for n, c in counts(kernels).items()}
        if min(grew[n] for n in required) <= 0:
            raise AssertionError(f"request {i}: a kernel was not launched: {grew}")
        preds.append(pred)
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    plain.predict(*episodes[0][:3])
    plain_lat, plain_preds = [], []
    for ep in episodes:
        t0 = time.perf_counter()
        plain_preds.append(plain.predict(*ep[:3]))
        torch.cuda.synchronize()
        plain_lat.append((time.perf_counter() - t0) * 1e3)
    if counts(kernels) != launches:
        raise AssertionError("the plain path launched a kernel")

    sx, sy, qx = episodes[0][:3]
    ep = Episode(*(torch.as_tensor(a).cuda() for a in (sx, sy, qx)),
                 torch.zeros(qx.shape[:2], dtype=torch.int64, device="cuda"))
    with torch.inference_mode():
        logits = fast._learner.model(ep, eval_mdns=True).query_logits
    return lat, preds, plain_lat, plain_preds, launches, peak, logits, fast._learner.model


# ----------------------------------------------------------- training --
def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def near_tie_gap(torch, x, got, want) -> float:
    """Largest gap, relative to xx_i + xx_j, between a neighbour in ``got``
    but not in ``want`` and the k-th distance of ``want`` (see check_knn)."""
    from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist
    d = pairwise_sqdist(x)
    xx = (x * x).sum(-1)
    dk = d.gather(-1, want[..., -1:])
    extra = ~(got[..., :, None] == want[..., None, :]).any(-1)
    diff = (d.gather(-1, got) - dk).abs() * extra
    norm_scale = xx[..., None] + xx.gather(-1, got.flatten(1)).view_as(got)
    return (diff / norm_scale.clamp_min(1e-30)).amax().item()


class KnnReplay:
    """Step 1 compares the two paths on the same kNN graphs.  The kNN
    kernel and the plain version round distances differently, so at
    near-ties (1-6 rows of 20,480 per call at these shapes) they keep
    different neighbours, and the losses then differ by up to 1e-3
    relative while both are right.  This records the kernel path's
    neighbour lists; the plain path computes its own and, where a row
    differs, checks that the difference is a rounding-level tie (gap
    <= NEAR_TIE of xx_i + xx_j) and takes the kernel path's row.  The
    plain path launches no kernel doing so."""

    def __init__(self, torch, knn_mod, dgcnn_mod):
        self.torch, self.knn_mod, self.dgcnn_mod = torch, knn_mod, dgcnn_mod
        self.recorded, self.swapped = [], []

    def record(self):
        kernel = self.knn_mod.knn

        def knn(x, k):
            out = kernel(x, k)
            self.recorded.append(out.clone())
            return out
        self.knn_mod.knn = knn
        return kernel

    def replay(self):
        plain = self.dgcnn_mod.knn_indices
        queue = list(self.recorded)

        def knn_indices(x, k):
            want, rec = plain(x, k).long(), queue.pop(0).long()
            rows = (want.sort(-1).values != rec.sort(-1).values).any(-1)
            self.swapped.append(int(rows.sum()))
            if bool(rows.any()):
                gap = near_tie_gap(self.torch, x, rec, want)
                if gap > NEAR_TIE:
                    raise AssertionError(f"kNN kernel and plain differ beyond a tie: {gap}")
            return rec.to(self.torch.int32)
        self.dgcnn_mod.knn_indices = knn_indices
        return plain


def _rel_distances(g_a: dict, g_b: dict, skip) -> dict:
    """Relative L2 distance of each parameter's gradient in g_a from g_b."""
    return {n: ((g_a[n] - g_b[n]).norm() / g_b[n].norm().clamp_min(1e-30)).item()
            for n in g_b if n not in skip}


def exact_solve(cheby_mod):
    """The plain Chebyshev solve run in f64 (S, iterates and sums),
    rounded to f32 at the end: the reference both paths' f32 solves round
    away from (by ~8e-7 of max |x| at the flagship graph)."""
    def solve(s, b, alpha, iters):
        sd = s.double()
        return cheby_mod.chebyshev(lambda z: z - alpha * (sd @ z), b.double(), alpha,
                                   max(iters, 1)).float()
    return solve


def train(torch, cfg, episodes, kernels, seed, required, per_step=None, steps=TRAIN_STEPS):
    """One kernel-path and one plain-path step from the same weights and
    generator seed, on the same kNN graphs (`KnnReplay`), compared; then
    ``steps`` kernel-path steps, each of which must launch every kernel in
    ``required`` (and exactly ``per_step[name]`` times where given), timed
    by the host clock; then one step split into forward, backward and
    optimizer by CUDA events; then a profiled window.

    The bf16 graph's gradients are far more sensitive to f32 rounding than
    the float32 graph's: dS is rounded to bf16 (as in the JAX package), so
    a change of 4e-7 in the solution flips the rounding of thousands of its
    19.3M entries, and the Gram's backward rounds d_xb to bf16 before the
    norms' term cancels most of it; a parameter's gradient then moves by
    up to ~2e-2, between two runs of the same path as between the kernel
    and plain paths.  There the gradients are held to BF16_GRAD_TOL, which
    a wrong solve (a wrong step count, coefficient or layout moves them by
    O(1)) does not meet; the solves' precision is checked in the kernels
    phase (`check_cheby`, label and dense right-hand sides).  A third step,
    on the plain path with the solve in f64 (`exact_solve`), shows how far
    each path's gradients are from it."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.ops import cuda_cheby, cuda_knn

    fast = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
    plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")
    plain = MPTILearner(plain_cfg, "cuda", torch.Generator().manual_seed(seed))
    for (n, a), b in zip(fast.model.state_dict().items(), plain.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"the two learners start from different weights at {n}")

    # ---- step 1 on both paths
    replay = KnnReplay(torch, cuda_knn, dgcnn)
    zero_counts(kernels)
    kernel_knn = replay.record()
    try:
        m_fast = fast.train(episodes[0])
    finally:
        cuda_knn.knn = kernel_knn
    torch.cuda.synchronize()
    first = counts(kernels)
    plain_knn = replay.replay()
    try:
        m_plain = plain.train(episodes[0])
    finally:
        dgcnn.knn_indices = plain_knn
    torch.cuda.synchronize()
    log(f"  step 1 kNN rows where the plain path took the kernel path's near-tie choice, "
        f"per call: {replay.swapped}")
    if counts(kernels) != first:
        raise AssertionError(f"the plain training path launched a kernel: {counts(kernels)}")
    if min(first[n] for n in required) <= 0:
        raise AssertionError(f"step 1: a kernel was not launched: {first}")
    for key in ("loss", "lp_loss", "contrast_loss"):
        a, b = m_fast[key].item(), m_plain[key].item()
        log(f"  step 1 {key}: kernels {a:.7f}, plain {b:.7f}, rel diff "
            f"{abs(a - b) / max(abs(b), 1e-30):.3e}")
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"step 1 {key}: kernel path {a} vs plain path {b}")
    g_fast, g_plain = _grads(fast.model), _grads(plain.model)
    if set(g_fast) != set(g_plain) or len(g_fast) != len(list(fast.model.parameters())):
        raise AssertionError("the two paths produced gradients for different parameters")
    # A conv bias feeding a train-mode BatchNorm (`*.conv.bias`, the
    # BaseLearner's) has an exact gradient of 0: both paths hold rounding
    # noise there, which must stay far below the largest gradient.
    zero = {n for n in g_plain if n.endswith(".conv.bias")}
    top = max(g.abs().max().item() for g in g_plain.values())
    noise = max(max(g_fast[n].abs().max().item(), g_plain[n].abs().max().item())
                for n in zero) if zero else 0.0
    rel = _rel_distances(g_fast, g_plain, zero)
    worst, med = max(rel, key=rel.get), statistics.median(rel.values())
    log(f"  step 1 gradients: {len(rel)} parameters, largest relative L2 distance "
        f"{rel[worst]:.3e} ({worst}); median {med:.3e}; "
        f"{len(zero)} biases with an exact zero gradient at {noise / top:.3e} of the "
        f"largest entry")
    if cfg.graph_dtype == "bfloat16":
        exact = MPTILearner(plain_cfg, "cuda", torch.Generator().manual_seed(seed))
        plain_knn, reference_solve = replay.replay(), cuda_cheby.cheby_solve_reference
        cuda_cheby.cheby_solve_reference = exact_solve(cuda_cheby)
        try:
            exact.train(episodes[0])
        finally:
            dgcnn.knn_indices = plain_knn
            cuda_cheby.cheby_solve_reference = reference_solve
        g_exact = _grads(exact.model)
        for name, g in (("kernel", g_fast), ("plain", g_plain)):
            d = _rel_distances(g, g_exact, zero)
            log(f"  step 1 gradients, {name} path vs the exact-solve path: largest relative "
                f"L2 distance {max(d.values()):.3e}, median {statistics.median(d.values()):.3e}")
    tol = BF16_GRAD_TOL if cfg.graph_dtype == "bfloat16" else GRAD_TOL
    if rel[worst] > tol:
        raise AssertionError(f"step 1 gradient of {worst}: relative distance {rel[worst]} > {tol}")
    if noise > 1e-5 * top:
        raise AssertionError(f"step 1: a zero-gradient bias holds {noise} (top {top})")

    # ---- the kernel path's steps: the main path of this phase
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    times, metrics = [], []
    for i in range(steps):
        before = counts(kernels)
        t0 = time.perf_counter()
        m = fast.train(episodes[(i + 1) % len(episodes)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        grew = {n: c - before[n] for n, c in counts(kernels).items()}
        if min(grew[n] for n in required) <= 0 or any(
                grew[n] != c for n, c in (per_step or {}).items()):
            raise AssertionError(f"training step {i + 2}: launches {grew}")
        vals = {k: v.item() for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"training step {i + 2}: non-finite metrics {vals}")
        metrics.append(vals)
        log(f"  step {i + 2}: {times[-1]:.2f} ms; launches {grew}; " +
            ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = dict(step_ms=statistics.median(times), times=times, launches=launches, peak=peak,
               stages=train_stages(torch, fast, episodes[0]), metrics=metrics)
    profile_train(torch, fast, episodes)
    return out


def profile_train(torch, learner, episodes, steps: int = 3, top: int = 12) -> None:
    """`torch.profiler` over ``steps`` kernel-path training steps: the
    device time by kernel (the CUDA events, largest first) and the
    device's busy share of the window (kernel time over wall time;
    overlapping kernels would count twice, and the profiler's own host
    overhead lengthens the window)."""
    from torch.profiler import ProfilerActivity, profile
    learner.train(episodes[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            learner.train(episodes[i % len(episodes)])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
                   for e in kernels), key=lambda r: -r[1])
    kernel_ms = sum(r[1] for r in rows)
    log(f"[profile] {steps} training steps: {wall / steps:.2f} ms per step (wall, profiled); "
        f"device busy {kernel_ms:.2f} ms per step ({kernel_ms / (wall / steps):.1%}); "
        f"largest device times per step:")
    for name, ms, n in rows[:top]:
        log(f"  {ms:8.3f} ms  x{n:<4d} {name[:90]}")


def train_stages(torch, learner, episode, reps: int = 3) -> dict:
    """Median device ms of forward (with the loss), backward and optimizer
    of a training step between CUDA events; the calls of
    `MPTILearner.train`."""
    from r3dfsseg_tpu_torch.models.episode import Episode
    names = ["forward", "backward", "optimizer"]
    times = {n: [] for n in names}
    for _ in range(reps):
        ep = Episode(*(learner._tensor(a) for a in episode))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        learner.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        out = learner.model(ep, train=True, generator=learner.generator)
        loss = out.lp_loss + learner.cfg.contrast_weight * out.contrast_loss
        ev[1].record()
        loss.backward()
        ev[2].record()
        learner.optimizer.step()
        learner.scheduler.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(t) for n, t in times.items()}


def stage_breakdown(torch, model, cfg, episode, reps: int = 5):
    """Median device time (ms) of each stage of one request on the kernel
    path, between CUDA events: encoder (support and query batches), MDNS,
    graph nodes (FPS prototypes), affinity, label propagation."""
    from r3dfsseg_tpu_torch.models import mpti
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.ops.lp import label_propagate, local_constrained_affinity

    sx, sy, qx = (torch.as_tensor(a).cuda() for a in episode[:3])
    lowp = torch.bfloat16 if cfg.graph_dtype == "bfloat16" else None
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
            a = local_constrained_affinity(node, cfg.k_connect, cfg.sigma, valid=valid,
                                           compare_dtype=lowp)
            ev[4].record()
            y0 = torch.cat([labels, torch.zeros((len(q), cfg.n_classes), device="cuda")])
            label_propagate(a, y0, cfg.lp_alpha, cg_iters=cfg.lp_cg_iters)
            ev[5].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                times[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(t[1:]) for n, t in times.items()}


def serve_phase(torch, cfg, episodes, kernels, seed, required):
    """Serve the episodes on the kernel and plain paths (`serve`), check the
    labels and the agreement, log latency, memory, launches and the stage
    split; return the kernel path's predictions and launch counts."""
    graph = "bf16" if cfg.graph_dtype == "bfloat16" else "float32"
    lat, preds, plain_lat, plain_preds, launches, peak, logits, model = serve(
        torch, cfg, episodes, kernels, seed, required)
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
    log(f"[serve] {graph} graph: {len(lat)} requests; median latency "
        f"{statistics.median(lat):.2f} ms (kernels) vs {statistics.median(plain_lat):.2f} ms "
        f"(plain); peak memory {peak / 2**20:.1f} MiB; launches {launches}")
    stages = stage_breakdown(torch, model, cfg, episodes[0])
    log(f"[stages] {graph} graph, kernel path, device ms per request (median of 5): " +
        ", ".join(f"{n} {t:.3f}" for n, t in stages.items()) +
        f"; sum {sum(stages.values()):.3f}")
    return preds, launches


def train_phase(torch, cfg, episodes, kernels, seed, required, per_step=None):
    """`train` with its log lines."""
    graph = "bf16" if cfg.graph_dtype == "bfloat16" else "float32"
    log(f"[train] {graph} graph: meta-training step, kernel path vs plain path, then "
        f"{TRAIN_STEPS} kernel-path steps")
    tr = train(torch, cfg, episodes, kernels, seed, required, per_step)
    log(f"[train] {graph} graph: median step {tr['step_ms']:.2f} ms (host clock, "
        f"synchronised); device ms per step: " +
        ", ".join(f"{n} {t:.3f}" for n, t in tr["stages"].items()) +
        f"; peak memory {tr['peak'] / 2**20:.1f} MiB; launches over {TRAIN_STEPS} steps "
        f"{tr['launches']}")
    return tr


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
    from r3dfsseg_tpu_torch.ops import (cuda_attention, cuda_cheby, cuda_fps, cuda_knn, cuda_kth,
                                        cuda_scatter)
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
    rows = {"knn": check_knn(torch, cuda_knn, episodes[0][0])}
    attn_eval = check_attention(torch, cuda_attention)
    check_dropout_mask(torch, cuda_attention)
    rows["attention_fwd"], rows["attention_bwd"] = check_attention_train(torch, cuda_attention)
    rows["attention_fwd"].update(ms_eval=attn_eval[1], plain_ms_eval=attn_eval[2],
                                 library_ms_eval=attn_eval[3], max_abs_err_eval=attn_eval[0])
    rows["fps"] = check_fps(torch, cuda_fps)
    rows["kth"] = check_kth(torch, cuda_kth)
    rows["scatter_add"] = check_scatter(torch, cuda_knn, cuda_scatter, episodes[0][0],
                                        episodes[0][2])
    cfg16 = cfg.replace(graph_dtype="bfloat16")
    sel, s16, b16, node, valid = flagship_graph(torch, cfg16, episodes[0], args.seed)
    rows["kth"].update(check_kth_bf16(torch, cuda_kth, sel))
    rows["cheby"] = check_cheby(torch, cuda_cheby, s16, b16, cfg.lp_alpha, cfg.lp_cg_iters)
    del sel, s16
    peaks = {name: graph_peak(torch, cfg, node, valid, b16, dt)
             for name, dt in (("float32", None), ("bf16", torch.bfloat16))}
    log("  episode graph alone, forward and backward at the flagship nodes: peak memory " +
        ", ".join(f"{name} graph {p / 2**20:.1f} MiB" for name, p in peaks.items()))
    del b16, node, valid
    torch.cuda.synchronize()
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.3f} ms kernel, {r['plain_ms']:.3f} plain, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    r = rows["kth"]
    log(f"  kth bf16: {r['ms_bf16']:.3f} ms kernel, {r['plain_ms_bf16']:.3f} plain, library "
        f"{r['library_ms_bf16']:.3f}, bound {r['bound_ms_bf16']:.4f} ({r['bound_by_bf16']})")
    log(f"  cheby: bound with S read from device memory at every step "
        f"{rows['cheby']['bound_ms_hbm']:.4f} ms")

    kernels = {"knn": (cuda_knn, "launches"), "attention_fwd": (cuda_attention, "launches"),
               "attention_bwd": (cuda_attention, "bwd_launches"), "fps": (cuda_fps, "launches"),
               "kth": (cuda_kth, "launches"), "scatter_add": (cuda_scatter, "launches"),
               "cheby": (cuda_cheby, "launches")}
    f32_kernels = tuple(n for n in kernels if n != "cheby")

    # ---- 3. serving, float32 graph then bf16 graph
    preds, serve_launches = serve_phase(torch, cfg, episodes, kernels, args.seed, SERVE_KERNELS)
    preds16, serve_launches16 = serve_phase(torch, cfg16, episodes, kernels, args.seed,
                                            SERVE_KERNELS + ("cheby",))
    for i, (a, b) in enumerate(zip(preds16, preds)):
        agree = float((a == b).mean())
        log(f"  request {i}: bf16 graph agrees with the float32 graph on {agree:.4f}")
        if agree < 0.98:
            raise AssertionError(f"request {i}: bf16 and float32 graphs agree on {agree}")

    # ---- 4. training, float32 graph then bf16 graph
    tr = train_phase(torch, cfg, episodes, kernels, args.seed, f32_kernels)
    tr16 = train_phase(torch, cfg16, episodes, kernels, args.seed, tuple(kernels),
                       per_step={"cheby": 2, "kth": 1})
    log(f"[train] peak memory: float32 graph {tr['peak'] / 2**20:.1f} MiB, bf16 graph "
        f"{tr16['peak'] / 2**20:.1f} MiB")

    sources = {"knn": ("knn.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27"),
               "attention_fwd": ("attention_fwd.cu", "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_bwd": ("attention_bwd.cu", "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "fps": ("fps.cu", "r3dfsseg_tpu/ops/pallas_fps.py:46"),
               "kth": ("kth.cu", "r3dfsseg_tpu/ops/pallas_kth.py:33"),
               "scatter_add": ("scatter_add.cu", "r3dfsseg_tpu/ops/fast_gather.py:40"),
               "cheby": ("cheby.cu", "r3dfsseg_tpu/ops/pallas_cheby.py:42")}
    log(smi)
    # launches: the float32 graph's training run (the bf16 graph's for
    # cheby, which only it launches); every path's counts beside them
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"r3dfsseg_tpu_torch/csrc/{src}",
         "replaces": rep,
         "launches": (tr16 if name == "cheby" else tr)["launches"][name],
         "launches_serve": (serve_launches16 if name == "cheby" else serve_launches)[name],
         "launches_train_f32": tr["launches"][name], "launches_serve_f32": serve_launches[name],
         "launches_train_bf16": tr16["launches"][name],
         "launches_serve_bf16": serve_launches16[name], **rows[name]}
        for name, (src, rep) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
