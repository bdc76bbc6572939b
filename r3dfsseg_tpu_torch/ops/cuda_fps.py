"""Masked farthest point sampling: the Hopper kernel `csrc/fps.cu` and its
plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_fps.py:masked_fps_pallas`
(`_fps_kernel`).  Semantics are `r3dfsseg_tpu/ops/fps.py:masked_fps` with
the direct sum((x - c)^2) distance: the first pick is the first valid
point, each round the argmax of the running min distance (lowest index on
ties), invalid points held at -1.

What bounds it on the H100: k strictly sequential rounds, each a sweep
over N x C features (20,480 x 192 = 15.7 MB at the flagship background
instance) plus an argmax over N.  The plain version launches about six
kernels per round.  The kernel runs all k rounds in one cooperative launch
of one block per SM: the instances share the blocks, each block keeps its
range's valid points' features and running min distance in shared memory
for the whole call, and the rounds are separated by one grid-wide barrier
each, after which every block reduces the block argmaxes of its instance
itself.  What remains per round is a short sweep, two block barriers and
the grid barrier.  Batches of more instances than SMs take one launch per
SM count of instances.

Dispatch: a CPU tensor takes `fps_reference`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build

POINTS_PER_BLOCK = 64          # csrc/fps.cu kMinPoints: a block's range, at least
BIG = 3.4e38
NEG = -1.0

launches = 0


def fps_reference(feat: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """feat (P, N, C) f32, valid (P, N) bool -> (P, k) int32 seeds, the
    plain version."""
    p = feat.shape[0]
    rows = torch.arange(p, device=feat.device)
    neg = torch.tensor(NEG, dtype=torch.float32, device=feat.device)
    mind = torch.where(valid, torch.tensor(BIG, dtype=torch.float32,
                                           device=feat.device), neg)
    seeds = torch.empty((p, k), dtype=torch.int32, device=feat.device)
    for i in range(k):
        pick = torch.argmax(mind, dim=-1)
        seeds[:, i] = pick
        d = ((feat - feat[rows, pick][:, None, :]) ** 2).sum(-1)
        mind = torch.minimum(mind, torch.where(valid, d, neg))
    return seeds


def fps(feat: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """feat (P, N, C) f32, valid (P, N) bool -> (P, k) int32 seed indices."""
    global launches
    if feat.device.type == "cpu":
        return fps_reference(feat, valid, k)
    if feat.device.type != "cuda":
        raise ValueError(f"fps: no kernel for device {feat.device}")
    if feat.dtype != torch.float32 or feat.dim() != 3:
        raise ValueError(f"fps: want (P, N, C) float32, got {tuple(feat.shape)} {feat.dtype}")
    p, n, c = feat.shape
    if valid.shape != (p, n) or valid.dtype != torch.bool or valid.device != feat.device:
        raise ValueError(f"fps: want a ({p}, {n}) bool mask on {feat.device}")
    if not (p > 0 and n > 0 and c > 0 and k > 0):
        raise ValueError(f"fps: unsupported shape P={p} N={n} C={c} k={k}")
    feat, valid = feat.contiguous(), valid.contiguous()
    dev = feat.device
    seeds = torch.empty((p, k), dtype=torch.int32, device=dev)
    fn = build.function("r3d_fps", [build.P] * 8 + [build.I] * 4 + [build.P])
    step = torch.cuda.get_device_properties(dev).multi_processor_count
    for p0 in range(0, p, step):
        p1 = min(p, p0 + step)
        mind = torch.empty((p1 - p0, n), dtype=torch.float32, device=dev)
        cand = 2 * (p1 - p0) * -(-n // POINTS_PER_BLOCK)   # both parities' candidates
        cand_v = torch.empty((cand,), dtype=torch.float32, device=dev)
        cand_i = torch.empty((cand,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = fn(feat[p0:p1].data_ptr(), valid[p0:p1].data_ptr(), seeds[p0:p1].data_ptr(),
                     mind.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), None, None,
                     p1 - p0, n, c, k, build.stream_ptr(dev))
        build.check(err, "r3d_fps")
        launches += 1
    return seeds
