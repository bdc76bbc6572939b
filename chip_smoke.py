#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (r3dfsseg_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--requests N]
                          [--only knn,fps | cheby,scatter | kth | bf16 | f1 | f2 | fused
                                  | attn | probe | parity | cli | pretrain | baselines
                                  | scene | parallel]

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc.  Phases, each of which raises (exit code != 0) on failure:

  1. build every kernel of `r3dfsseg_tpu_torch/csrc/` with nvcc, and print
     the kNN, FPS, Chebyshev, matvec probe, scatter-add, k-th distance and
     attention kernels' registers and spills (-Xptxas -v); the wide and
     grouped tensor-core attention kernels, the six instantiations of
     kernel 2's wgmma bf16 form, the five of kernel 5's and kernel 11's
     six must not spill;
  2. call each kernel at the flagship shapes of its path and hold it
     against its plain PyTorch version on the same inputs (kNN: the
     neighbour sets, differences only at near-ties, two calls bit-equal,
     the self-first share logged, each of the six calls of a request
     timed; attention forward:
     rtol 1e-4, atol 1e-5, eval and with dropout; the dropout mask: the
     Philox words bit-equal; attention backward: within 1e-4 of each
     gradient's largest entry of torch autograd through the plain masked
     forward; FPS, a request's two calls and a training step's WayContrast
     call: the seeds, a divergence only at a near-tie, two calls
     bit-equal, one launch per call, each call timed; k-th
     distance: bit-equal and two calls bit-equal, on f32 distances, on the
     bf16 compare copy of a flagship episode's graph and on rows that break
     naive selects (`kth_rows`) at the flagship width; scatter-add at a training step's two
     batch shapes: within 1e-5 of sum |g|, bit-equal to its order of sums
     emulated in PyTorch and across two calls, each call timed; the
     Chebyshev solve (kernel 7, one cooperative launch, d split into bf16
     hi + lo) on that episode's bf16 S, label and dense b: within 1e-5 of
     max |x| of its split plain version at 1 and 3 steps and 1e-4 at 50,
     within 1e-4 of the f32-product plain version, two solves bit-equal;
     kernel 10 (the same solve with d rounded to one bf16) on that S:
     within 1e-5 of max |x| at 3 steps and 5e-3 at 50, bit-equal across a
     kernel 7 call, beside kernel 7, all held against the f64 solve; on
     the three EdgeConv blocks' inputs of
     the support batch: the row gather (kernel 8) bit-equal, f32 and
     bf16, and the fused EdgeConv tail's five passes (kernel 9) in train
     and eval, stats1 and fwd within 1e-5 and each backward output within
     1e-4 of its largest entry; then the same on the bf16 encoder's blocks'
     bf16 e_raw through kernel 9's bf16 form, each pass also bit for bit the
     f32 form on e's upcast), and time the kernel, the plain version
     and, where one exists, the one PyTorch call computing the same
     function (attention: SDPA pinned to its memory-efficient backend, its
     forward against kernel 2 and its backward alone against kernel 5),
     with CUDA events; and measure the peak memory of that
     episode graph alone, forward and backward, in float32 and bf16.
     The bf16 forms of the bf16 encoder: attention forward and backward
     on bf16 q, k, v (B = 10 and 2, with dropout 0.1 and without; the
     forward within ATTN_BF16_FWD_TOL of its plain version, the backward
     within ATTN_BF16_BWD_TOL, a second call of each bit-equal;
     SDPA pinned to flash on the same bf16 inputs as the yardstick), the
     scatter-add on a bf16 cotangent (bit-equal to the f32 form on its
     upcast, to its emulated order and across calls) and kNN on a bf16
     input (equal to kNN on its f32 upcast, and to its plain version up to
    rounding-level ties);
  3. serve flagship episodes (R3DConfig(): 2-way 5-shot, 2048 points x 9,
     a 4396-node graph) through `FewShotPredictor.predict` with seeded
     random weights, count each kernel's launches (FPS: exactly two, one
     cooperative launch per call), and compare the
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
     graph (FPS exactly three times), and a torch.profiler window over
     three more (one FPS kernel per call there too); then the same
     with the bf16 episode graph (gradients within a relative L2 distance
     of 1e-1: see `train`), whose steps must each launch all seven
     kernels, the Chebyshev solve twice (forward and adjoint; the profile
     shows its kernel twice per step) and the k-th distance once.  Serving and training launch kernels 8 to 11
     no time, as in the JAX package, and the float32 encoder launches no
     bf16 form;
  4b. the bf16 encoder (R3DConfig(compute_dtype="bfloat16"): bf16 convs,
     the default 'fastvar' BatchNorm, bf16 attention operands, the bf16
     graph): the same requests against its plain path (>= 99% of points;
     its agreement with the float32 encoder on the same weights logged),
     two requests under bn_mode 'hybrid' (kNN on bf16 block outputs),
     then the training step against its plain path on the same kNN graphs
     (losses rtol BF16_ENC_LOSS_RTOL, gradients within
     BF16_ENC_CARD_GRAD_TOL per parameter and BF16_ENC_CARD_GLOBAL_TOL
     over all) and four steps, each launching kernels 1, 2 (bf16), 3, 4
     (bf16), 5 (bf16), 6 (bf16) and 7; peak memory of a request and of a
     step;
  5. the fused EdgeConv route (`fused_edgeconv`: kNN, kernel 8, kernel 9,
     the scatter-add backward) through the encoder's three blocks, against
     the blocks' own forward and backward (`fused_phase`: outputs, batch
     statistics, gradients; the query batch in eval), each pass launched
     once per block, and both routes timed per block; then the same on the
     bf16 encoder (R3DConfig(compute_dtype="bfloat16")): bf16 a, b and
     e_raw, kernel 8 and kernel 9 in their bf16 forms and kernel 6's bf16
     form, against the bf16 blocks (FUSED_BF16_GATES: the block rounds h0,
     W1 and l1 to bf16 where the fused tail keeps f32);
  6. the archived Chebyshev probes' main() (`probe_phase`): kernel 10 on
     `scripts/archive/proto_cheby_pallas.py`'s own problem (its "rel max
     err" against kernel 7's plain version; within 1e-3 of max of its own
     plain version; ms per solve over a chain of 10 beside kernel 7), and
     kernel 11 on `scripts/archive/proto_cheby2.py`'s input at
     PROBE_COLS columns (within 1e-4 of max at 3 steps; 5e-3 at 500 steps
     on that S scaled by 1 / its row sums; a second 500-step call at 128
     columns bit-equal; us per matvec beside 500 single `torch.mm`
     calls); each launched as counted, and by no other phase.

  2b. the F1 kernels, at shapes the JAX package's Pallas kernels run and
     the tuned kernels do not take (`check_f1`): the general kNN (k = 40
     at C = 9 and 64, C = 320), the packed-key kNN (knn_impl "pallas") at
     a request's six calls, attention (B = 10 and 2, rate 0.1 and 0,
     forward and backward) in f32 at D = 128, 100, 256, 320 and 512 (the
     3xTF32 kernels in channel groups of 128) and in bf16 at D = 128, 100
     (the zero pad to 104) and 256 (the wide tensor-core kernels) and 320,
     300 (the zero pad to 304) and 512 (the grouped tensor-core kernels),
     and at D = 12 (f32, and bf16 through the zero pad: the tuned
     kernels), the k-th distance on
     rows of 60000 f32 and 120000 bf16 entries, the scatter-add at C = 63
     and at N = 32768; each shape's own counter moves and the tuned
     kernel's not, against the plain versions (kNN as kernel 1, the packed
     kNN's differing rows at most 1e-2, each explained by the rounding of
     the distances, attention
     within the tuned gates scaled to D, k-th distance and scatter-add bit
     for bit), two calls bit-equal;
  4c. a configuration past the tuned shapes (dgcnn_k 40, output_dim 128, a
     63-wide first EdgeConv layer), two requests and a training step on
     the float32 encoder and a step on the bf16 encoder, against their
     plain paths, through the general kNN, the wide attention (the 3xTF32
     pair in f32, the wide bf16 tensor-core pair on the bf16 encoder) and
     the general scatter-add (the tuned kNN and attention launch no time);
     then a
     step of the bf16 encoder at output_dim 320 (the grouped tensor-core
     pair, two launches of each per step: the support and query batches),
     against a plain path whose
     attention scales q as the kernels do (`plain_attention_as_kernels`);
  4d. knn_impl "pallas" at full flagship width: two requests and a
     training step through the packed-key kNN, against the packed mode's
     plain path (labels >= 99%, step 1 within the f32 gates), the labels'
     agreement with the exact kNN path printed;
  4e. the reference-faithful modes (`parity_phase`): the golden fixtures
     (`tests/fixtures/reference_parity*.npz`, the original PyTorch model's
     weights through the port's key map) replayed with every kernel on
     under the CPU test's gates (features, MDNS flags, logits, losses and
     gradients, with the dense solve and Chebyshev-150; a kNN row that
     differs from the plain version only at a near-tie); then the seeded
     flagship model written by `save_reference_checkpoint` and served (2
     requests) and trained (one step, held against the plain path on the
     same kNN graphs, then one more, timed) through
     `FewShotPredictor.from_checkpoint` with the exact top-k affinity and
     the dense solve, CG, and Chebyshev on the bf16 graph (labels >= 99%,
     losses rtol 1e-4, gradients GRAD_TOL, BF16_GRAD_TOL on the bf16
     graph): kernels 1, 2, 3, 5 and 6 launched, kernel 4 not, kernel 7 on
     the bf16 graph only; request and step times, peak memory, and the
     device times of the top-k select, the dense solve and CG on a served
     graph;
  4f. the CLIs (`cli_phase`): a synthetic S3DIS-format dataset of 40 scans
     of 4096 points in a temporary directory, then the port's meta-training
     CLI (`mpti_train_noise.train`) at full flagship width for CLI_ITERS
     episodes on CLI_WORKERS loader threads, validating every
     CLI_EVAL_INTERVAL on CLI_EPISODE_TEST episodes a class pair, and the
     meta-test CLI (`eval_noise.evaluate`) on its best `checkpoint.tar`
     with ood noise at 0.4 and MDNS on; the checkpoint loads, every logged
     loss is finite, the mean IoU lies in [0, 1], the first training
     episodes' sha256 equals the samplers' for the seed, training launches
     kernels 1-6 and evaluation kernels 1-4 and not 5 or 6; it prints
     episodes/s, the median step, the loader's wait per step, peak memory,
     the same loop's on one loader thread, the loader's own rate with no
     step running, and an episode's pin and copy on an idle and a busy card;
  4g. encoder pretraining (`pretrain_phase`): on a synthetic dataset like
     phase 4f's, `pretrain.pretrain` at full width (batch 16, 2048 points,
     widths 64/512/256, the f32 attention at dg_atten_dim 128, dropout 0.3
     and attention dropout 0.1) for PRETRAIN_STEPS steps, which must
     launch kNN and the scatter-add 3 times a step and the f32 wide
     attention forward and backward once (PRETRAIN_PER_STEP) and no other
     kernel, every logged loss finite and the checkpoint in the original
     `{'params': ...}` schema; one step on the kernel path against the
     plain path (knn_impl and attn_impl "xla") from the same weights, batch
     and generator on the same kNN graphs (losses rtol 1e-4, gradients
     GRAD_TOL, times sqrt(D / 64) for the attention's maps); timed steps,
     a profiled step (device busy, the wide pair's device time), the wide
     pair alone at B = 16 beside SDPA, peak memory; finetune 2 steps from
     the `.tar`, meta-training 4 episodes at flagship width from it (the
     trunk of the learner the run trained equal to the artifact's as it
     was installed, and moved after the run); then the seeded flagship
     learner after 2 steps written by `utils/checkpoint.save_checkpoint`
     (`.msgpack`) and `save_reference_checkpoint` (`.tar`): 2 requests
     from each with equal labels, the two resumed states bit-equal, one
     resumed step from each, and from the `.tar` again, with bit-equal
     losses under `torch.use_deterministic_algorithms` (the card's step
     is not bit-reproducible in the default mode: the same step from each
     file and RESUME_REPEATS times more from the `.tar` is recorded);
  4h. the baselines (`baselines_phase`), ProtoNet_Contrast (phases
     protoeval / prototrain, MDNS on in serving) and the transformer
     (transformereval / transformertrain; d_model 128, 8 heads, 3 layers,
     d_feed 128) at flagship width on seeded weights: the golden fixtures
     `proto/*` (`reference_parity.npz`), `pc/*` and `pt/*`
     (`reference_parity_extra.npz`) with every kernel on, at the JAX
     package's tolerances (BASELINE_GATES); for each baseline the requests
     served by `FewShotPredictor` on the kernel path against the plain path
     (labels >= 99%), step 1 on both paths on the same kNN graphs (losses
     rtol 1e-4, gradients GRAD_TOL with their norms floored at GRAD_FLOOR of
     the largest entry) and TRAIN_STEPS kernel-path steps: each request
     launches kNN and the attention forward only, each step kNN, the
     attention pair and the scatter-add, FPS once on ProtoNet_Contrast and
     never on the transformer, kernels 4 and 7-11 never; the learner after
     its steps written as `.msgpack` and `.tar`, both served with equal
     labels; the training CLI for BASELINE_CLI_ITERS episodes and the
     evaluation CLI from its `.tar`; request latency, step time, a profiled
     step's device time and peak memory printed;
  4i. whole-scene serving (`scene_phase`): `FewShotPredictor.predict_scene`
     at flagship width on seeded weights, with the flagship support set,
     on synthetic scenes (points uniform over 8 x 8 x 3 m, colours in [0,
     1]): 16,384 points on the dense graph (8 blocks, 16,684 nodes), f32
     and bf16 (kernel 7 at M = 16,684), 32,768 points on the blocked graph
     stored in f32 and 65,536 on the blocked graph split-stored in bf16;
     each scene launches kernels 1, 2 and 3, the dense graph kernel 4 and
     the dense bf16 graph kernel 7, and no other; each scene is called
     SCENE_CALLS times: the first call's kernel calls on the scene's own
     shapes (kNN and the attention forward on the 8, 16 or 32 blocks,
     kernel 4 on the (16,684, 16,684) f32 and bf16 compare copies, kernel
     7 on the bf16 S) are kept and held against their plain versions
     (`check_scene_kernels`: kernel 4 bit-equal, kernel 7 within
     SPLIT_TOL and CHEBY_TOL, kNN and attention at check_knn's and
     check_attention's gates), the later calls' labels against the first's
     (>= SCENE_REPEAT_GATE); the dense scene's labels against
     R3D_SCENE_LP=blocked (>= SCENE_BLOCKED_GATE), and each dense scene's
     against the plain path at its graph dtype (>= SCENE_PLAIN_GATE); on
     an 8,192-point scene's nodes, the stored and rematerialised blocked
     graphs' Z within SCENE_STREAM_TOL, and the split-stored against the
     stored f32 graph within SCENE_SPLIT_GATE and SCENE_SPLIT_ATOL; each
     scene's path, launches, host ms, device ms of encode, graph build and
     solve (CUDA events) of the later calls and peak memory printed;
  4j. data parallelism (`parallel_phase`, `r3dfsseg_tpu_torch/parallel/`):
     (1) in a NCCL process group of world size 1, the flagship DP training
     step at E = DP_E (attention dropout 0.1) bit-equal to the unwrapped
     learner's (metrics, every parameter, BN buffers, Adam state), a DP
     pretraining step at batch 16 bit-equal to the plain one, and the
     training CLI at --mesh 1 bit-equal to no --mesh (losses, episode
     digest), under deterministic algorithms; the W = 1 DP step is the
     phase's main path and launches DP_STEP; (2) each attention family
     (DP_ATTN: tuned f32 and wgmma bf16 at D = 64, the wide f32, wide bf16
     and grouped bf16 pairs), forward and backward at rate 0.1, on rows
     [b0, b0 + 2) of 4 clouds with batch offset b0: bit-equal to those rows
     of the whole batch's call, and the mask's words at b0 to the plain
     version's; (3) world size 2 on the one card (`parallel.launch`: two
     processes on cuda:0 over gloo, all-gathers through host copies): the
     DP step against the unsharded E = DP_E step and a DP pretraining step
     in two shards of 8 against W = 1, on the unsharded steps' kNN graphs
     (`knn_rows`), at DP_GATES (loss, each gradient's relative L2, BN
     running statistics); the W = 2 step, run under deterministic
     algorithms, against its witness (`dp_witness`: each rank's rows run
     alone in this process at their offsets, with no collective, and
     averaged by hand) at DP_WITNESS_GATES, the CPU tests' gates with
     each BN statistic against its own entry; host-clock and profiled
     device times of each
     step at W = 1 and of rank 0's at W = 2 (two processes sharing one
     card: not a scaling figure);
  2c. the F2 paths, at shapes the archived TPU kernels 8-11 take and the
     tuned kernels do not (`check_f2`): the general kernel 9
     (`csrc/fused_edge_general.cu`) at FUSED_F2_SHAPES, f32 and bf16, every
     pass in train and eval, within the tuned tolerances of its plain
     version and, at the flagship shape, of the tuned kernel; kernel 8 on
     rows that are not a multiple of 16 bytes; kernel 10 at 16 and 128
     columns (groups of 8); kernel 11 at 12 columns (a 32-column block); each
     path's own counter moves and the tuned one's not, repeats bit-equal;

It prints the card's name and power limit, one JSON line describing the
eleven kernels (kernels 1, 2, 5 and 6 with a second row each for their
bf16 form, a row for each F1 kernel, the packed kNN and the wide and
grouped tensor-core attention pairs, a row for each
pass of kernel 9's bf16 form and of its general kernel, and the narrow
gather's), and as its
last line {"ok": true, "device": {...}}.  Without a
CUDA device it exits with code 1 and prints no result.  `--only knn,fps`
runs the build and the kNN and FPS checks alone and prints their rows,
`--only cheby,scatter` the Chebyshev and scatter-add checks, and `--only
kth` the k-th distance's three checks (f32, adversarial rows, bf16), `--only
bf16` the checks of the bf16 forms of kernels 1, 2, 5 and 6, `--only f1`
phase 2b alone, `--only f2` phase 2c alone, `--only fused` a digest
of kernel 9's f32 passes' output bits at the flagship shape on seeded
inputs with their times (the same on two trees shows the f32 form
unchanged), and `--only attn` the same for the attention kernels
(`attention_digest`, with a digest of the bf16 backward alone at D = 64
fed the plain forward's y and lse), with the f32 pair's times at D = 128
and the bf16 pair's at D = 320 on whichever kernels the tree runs (and each
kernel's device time) and the bf16 forward's and backward's at D = 64
per call beside flash's, so that another tree's kernels can be timed with the same
code (put that tree's root first on sys.path and run this file with
runpy; the tree's modules need the plain versions these checks call:
`cheby_solve_split_reference` and `scatter_add_ordered_reference`);
`--only probe` the same for the Chebyshev probes (`probe_digest`):
digests of kernels 7 and 10, kernel 11's us per matvec at
PROBE_DIGEST_COLS columns beside `torch.mm` with each case's device time,
and its us per step over a range of M (`probe_sweep`); `--only parity`
phase 4e alone, `--only cli` phase 4f alone, `--only pretrain` phase 4g
alone, `--only baselines` phase 4h alone, `--only scene` phase 4i alone,
`--only parallel` phase 4j alone.
The `launches_pretrain` entry of
every kernel row counts phase 4g's pretraining run, the f32 wide attention
pair's main path; `launches_baselines_proto` and
`launches_baselines_transformer` count phase 4h's served requests and
kernel-path training steps of each baseline, `launches_scene_<name>` each
scene of phase 4i, `launches_parallel_w1` and
`launches_parallel_pretrain_w1` phase 4j's W = 1 DP training and
pretraining steps, `launches_parallel_w2` and
`launches_parallel_pretrain_w2` rank 0's at W = 2; the attention rows'
`batch_offsets` are phase 4j's offset checks.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

NEAR_TIE = 1e-5     # relative distance gap that counts as a tie
PACKED_MISMATCH = 1e-2  # share of rows whose packed-kNN lists may differ from the plain
                        # version's (2.2e-3 at C = 9, 2.0e-4 at C = 64 on an H100)
F32_FLOPS = 67e12   # H100 SXM peak f32 FLOP/s outside the tensor cores
TF32_TC_FLOPS = 495e12  # H100 SXM dense tf32 tensor-core peak FLOP/s
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak FLOP/s
HBM_BYTES = 3.35e12  # H100 SXM device-memory bytes/s
GRAD_TOL = 1e-3     # kernel vs plain training step: relative L2 per parameter
BF16_GRAD_TOL = 1e-1  # the same on the bf16 graph, whose gradients carry ~1e-2 of
                      # bf16 rounding noise (see `train`)
# The bf16 encoder (compute_dtype="bfloat16") at training step 1: losses,
# and each parameter's gradient (relative L2) and all of them at once.
# tests/test_torch_bf16_encoder.py holds the port's plain path to the JAX
# package on the CPU with BF16_ENC_GRAD_TOL and BF16_ENC_GLOBAL_TOL, set
# from the spread measured there: the backward rounds every cotangent to bf16 at
# the same points in both, but its train-mode BatchNorms cancel most of
# each sum, so a rounding one bf16 step apart moves a small gradient by far
# more than 2^-8 of itself.  Measured on the CPU against the JAX package:
# the tiny encoder alone (12 cases, 'exact' and 'fastvar', train mode) per
# parameter median 0.9-1.7e-2, largest 0.175 (a BN bias), over all
# parameters at most 0.052; the tiny model's training step (6 seeds whose
# graphs select alike) largest 0.083, over all at most 0.014, losses
# within 1.5e-5.  Between the bf16 and the f32 encoder on the same weights
# the median distance is 0.25-0.54, for JAX as for the port.
BF16_ENC_LOSS_RTOL = 1e-2
BF16_ENC_GRAD_TOL = 0.25
BF16_ENC_GLOBAL_TOL = 0.08
# On the card, kernel path vs plain path (same weights, same kNN graphs):
# measured on an H100 at most 2.5e-2 per parameter and 1.7e-2 over all
# (PERF.md), so these limits keep about 2x room above that spread and stay
# far below a fault that moves a few gradients by 20%
BF16_ENC_CARD_GRAD_TOL = 0.06
BF16_ENC_CARD_GLOBAL_TOL = 0.03
# The bf16 attention forward (kernel 2) vs its plain version, of the largest
# |y|: both round the normalised P to bf16 before P V, so they differ only
# where their f32 P (exp and sums in another order) straddles a bf16
# rounding boundary, each such entry moving y by a bf16 step of p v.
# Measured on an H100 up to 5.7e-4 (PERF.md); rounding the unnormalised P
# instead, 3.1e-3
ATTN_BF16_FWD_TOL = 2e-3
# The bf16 attention backward (kernel 5) vs its plain version, of each
# gradient's largest entry: the same bf16 roundings at the same points, but
# f32 sums in another order can round a dS or Pd entry the other way
ATTN_BF16_BWD_TOL = 1e-2
# The F1 kernels (shapes past the tuned kernels: csrc/knn_general.cu,
# attention_wide.cu, kth.cu's wide variant, scatter_general.cu) hold the
# tuned forms' gates.  Attention's are scaled to the head width: a score
# sums D products whose roundings add like a random walk, so its error, and
# with it the chance of a P entry at a bf16 rounding boundary, grows as
# sqrt(D); the tuned gates were set at D = 64, so a wide call's bound is
# the tuned bound times sqrt(D / 64) (1.41 at D = 128), and never below it.
ATTN_F32_FWD_RTOL, ATTN_F32_FWD_ATOL = 1e-4, 1e-5   # the tuned f32 forward's
ATTN_F32_BWD_TOL = 1e-4     # the tuned f32 backward's, of each gradient's largest entry
CHEBY_TOL = 1e-4    # Chebyshev kernel vs the f32-product plain version: the split of d
                    # (5e-6 of max |x| on a dense b) and f32 sums in another order, 49 steps
# Chebyshev kernel vs its plain version (the same split-bf16 arithmetic): f32 sums
# in another order; after 49 steps a lo piece can round the other way
SPLIT_TOL = {1: 1e-5, 3: 1e-5, 50: 1e-4}
# kernels 10 and 11 vs plain: their f32 sums run in another order, so a d entry
# near a bf16 rounding boundary can round the other way, and the flip carries
# through later steps; a few steps stay at f32 rounding
PROTO_TOL = {3: 1e-5, 50: 5e-3}
PROBE_TOL = {3: 1e-4, 500: 5e-3}
PROBE_COLS = (8, 12, 24, 120, 128)   # kernel 11's columns in the probe phase
PROBE_DIGEST_COLS = (8, 12, 16, 24, 64, 120, 128)   # --only probe's timed columns
TRAIN_STEPS = 4     # timed kernel-path training steps after step 1, per graph dtype


def log(*a):
    print(*a, flush=True)


def describe(cfg) -> str:
    """The encoder and graph of cfg, for the log."""
    enc = "float32 encoder" if cfg.compute_dtype == "float32" else \
        f"bf16 encoder ({cfg.bn_mode}{', attn_f32' if cfg.attn_f32 else ''})"
    base = type(cfg)()
    knobs = [f"{f} {getattr(cfg, f)}" for f in ("knn_impl", "dgcnn_k", "output_dim",
                                               "edgeconv_widths")
             if getattr(cfg, f) != getattr(base, f)]
    return ", ".join([enc, f"{'bf16' if cfg.graph_bf16 else 'float32'} graph"] + knobs)


PTXAS_NAMES = ("knn_kernel", "fps_kernel", "cheby_kernel", "scatter_add_kernel", "kth_kernel",
               "attn_fwd_bf16", "attn_bwd_dkdv_bf16", "attn_bwd_dq_bf16", "knn_general_kernel",
               "attn_wide_tc", "attn_wide", "attn_group", "attn_scale", "kth_wide_kernel",
               "fill_kernel", "sum_kernel", "fused_edge_kernel", "edge_route_kernel",
               "edge_rows_kernel", "gather_rows_kernel", "matmul_probe_kernel")


def ptxas_report(build_log: str, names=PTXAS_NAMES) -> list[str]:
    """nvcc's -Xptxas -v lines of the entry functions whose mangled name
    holds one of ``names``: registers, barriers, stack and spill, each
    under the mangled name from that name on (its template arguments:
    ILi2ELb1E is <2, true>)."""
    out, entry = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((mangled[mangled.index(n):][:48] for n in names if n in mangled), None)
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def ptxas_notes(build_log: str, code: str = "C7519") -> dict:
    """The count of ptxas's ``code`` notes per function, under the mangled
    name from the kernel's name on (as `ptxas_report`), and the text of the
    first note (C7519: a `warpgroup.arrive` that ptxas injected so that a
    wgmma may read registers)."""
    counts, first = {}, None
    for line in build_log.splitlines():
        if f"({code})" not in line or "function '" not in line:
            continue
        mangled = line.split("function '")[1].split("'")[0]
        name = next((mangled[mangled.index(n):][:48] for n in PTXAS_NAMES if n in mangled),
                    mangled[:48])
        counts[name] = counts.get(name, 0) + 1
        first = first or line.split(f"({code})", 1)[1].split(" in function")[0].strip()
    return {"counts": counts, "first": first}


def cuda_ms(fn, reps: int, per: int = 1) -> float:
    """Median device time of fn() in milliseconds (CUDA events), over
    ``per`` calls enqueued back to back between the events: with per > 1
    the host enqueues a call while the card runs the one before, so a
    short kernel is not timed with the host's gap in front of it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def device_ms(fn, key, reps: int = 20) -> float:
    """Device time (ms) per call of fn() of the kernels whose name holds
    ``key`` (a string, or a tuple of strings that the name holds all of),
    from `torch.profiler`: the kernels alone, without the host's gaps that
    CUDA events around a call include."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = (key,) if isinstance(key, str) else key
    return sum(e.self_device_time_total for e in prof.key_averages()
               if all(p in e.key for p in parts)) / reps / 1e3


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the peak of their type (f32 on CUDA cores unless a
    kernel's products are bf16 or tf32 tensor-core tiles) and the bytes
    over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row(err, ms, plain_ms, library_ms, flops, nbytes, peak=F32_FLOPS, **extra):
    b, by = bound(flops, nbytes, peak)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                share_of_bound=b / ms, library_ms=library_ms, **extra)


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


def _bisection_mid(v: float, hi: float, step: int) -> np.float32:
    """The mid-point that the k-th distance's bisection tests at ``step``
    when the row's k-th value is v and its bracket top hi (f32 steps)."""
    lo, hi, half = np.float32(0), np.float32(hi), np.float32(0.5)
    for _ in range(step):
        mid = half * (lo + hi)
        lo, hi = (lo, mid) if np.float32(v) <= mid else (mid, hi)
    return half * (lo + hi)


# Rows that break a naive k-th select, by kind (`kth_rows`).
KTH_KINDS = ("uniform", "ties_at_radius", "ties_over_cap", "sentinels_only", "few_finite",
             "k_is_0", "k_is_1", "k_is_m", "special_values", "midpoint", "wide_cluster",
             "all_equal")


def kth_rows(kind: str, n: int, m: int, seed: int, big: float = 1e30):
    """(d, k): n rows of m >= 701 f32 distances of one kind of KTH_KINDS,
    the entries of each row shuffled, and the k to select.

    ties_at_radius: 20 equal entries around rank k; ties_over_cap: 300; a
    row of sentinels only; fewer than k entries below the sentinel; k = 0,
    1 and m; zeros, -0.0, subnormals, +-inf and NaN with k among them;
    the k-th entry equal to the bisection's 7th mid-point (bf16-exact);
    a cluster 5e-4 wide holding rank k between outliers at 1e-30 and 1e20,
    so that the select narrows the key range more than once; all equal."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.1, 9.0, (n, m)).astype(np.float32)
    k = 37
    for row in d:
        if kind == "ties_at_radius":
            row[:30] = rng.uniform(0.1, 2.0, 30)
            row[30:50] = 2.5
            row[50:] = rng.uniform(3.0, 9.0, m - 50)
        elif kind == "ties_over_cap":
            k = 200
            row[:150] = rng.uniform(0.1, 2.0, 150)
            row[150:450] = 2.5
            row[450:] = rng.uniform(3.0, 9.0, m - 450)
        elif kind == "sentinels_only":
            row[:] = big
        elif kind == "few_finite":
            row[30:] = big
        elif kind == "k_is_0":
            k = 0
        elif kind == "k_is_1":
            k = 1
        elif kind == "k_is_m":
            k = m
        elif kind == "special_values":
            k = 25      # among the subnormals, after 2 -inf and 20 signed zeros
            row[:2] = -np.inf
            row[2:12] = -0.0
            row[12:22] = 0.0
            row[22:32] = [1e-45, 1e-44, 1e-42, 1e-40, 1e-39, 5e-39, 1e-38, 1.1e-38,
                          1e-45, 3e-41]
            row[32:37] = np.inf
            row[37:40] = np.nan
            row[40:44] = big
        elif kind == "midpoint":
            x = _bisection_mid(rng.uniform(1.0, 7.0), 8.0, 6)
            row[:k - 1] = rng.uniform(0.1, 0.9 * x, k - 1)
            row[k - 1] = x
            row[k:] = rng.uniform(1.1 * x, 8.0, m - k)
            row[k] = 8.0        # the bracket's top
        elif kind == "wide_cluster":
            k = 300
            row[:5] = 1e-30
            row[5:10] = 1e20
            row[10:110] = rng.uniform(0.1, 1.9, 100)
            c = min(600, m - 114)
            row[110:110 + c] = rng.uniform(2.0, 2.0005, c)
        elif kind == "all_equal":
            row[:] = 3.0
        elif kind != "uniform":
            raise ValueError(kind)
        if kind not in ("sentinels_only", "few_finite", "k_is_m", "special_values"):
            row[-4:] = big      # invalid columns
        rng.shuffle(row)
    return d, k


# ------------------------------------------------------------ kernels --
KNN_SHAPES = [(10, 9), (10, 64), (10, 64), (2, 9), (2, 64), (2, 64)]  # (B, C) per request


def knn_agreement(torch, x, got, want) -> dict:
    """The kNN kernel's lists ``got`` against the plain version's ``want``
    on x: the share of rows whose sets differ, the worst differing
    neighbour's gap to the row's k-th distance (relative to that distance
    and to xx_i + xx_j: the Gram form (xx + yy) - 2 x.y rounds at the scale
    of the norms), the largest error of the sorted distances, and the share
    of rows that list their own point first."""
    from r3dfsseg_tpu_torch.ops.knn import pairwise_sqdist
    d = pairwise_sqdist(x)
    xx = (x * x).sum(-1)
    dk = d.gather(-1, want[..., -1:])                       # k-th distance
    same = (got.sort(-1).values == want.sort(-1).values).all(-1)
    extra = ~(got[..., :, None] == want[..., None, :]).any(-1)   # in got, not in want
    diff = (d.gather(-1, got) - dk).abs() * extra
    norm_scale = xx[..., None] + xx.gather(-1, got.flatten(1)).view_as(got)
    err = d.gather(-1, got).sort(-1).values - d.gather(-1, want).sort(-1).values
    return dict(mismatch=1.0 - same.float().mean().item(),
                gap_rel=(diff / dk.clamp_min(1e-30)).amax().item(),
                gap=(diff / norm_scale.clamp_min(1e-30)).amax().item(),
                err=err.abs().max().item(),
                self_first=(got[..., 0] == torch.arange(x.shape[1], device=x.device))
                .float().mean().item())


def packed_agreement(torch, knn_mod, x, got, want) -> dict:
    """The packed-key kNN's lists ``got`` against the plain packed
    version's ``want`` on x: the share of rows that differ, how many of
    them the rounding of the distances cannot explain, and the least share
    of that rounding's bound (``tol_share``, of 1/16, 1/8, ... 1) that
    explains them all.

    The kernel and the plain version sum d = (qq - 2 inner) + kk in
    different orders, so their distances differ by rounding, of the order
    of eps = 2^-23 times the magnitudes summed, s = qq + kk + 2 sum_c
    |x_ic x_jc|, and growing as sqrt(C + 2) for C + 2 summed products.
    The bound used is tol = sqrt(C + 2) eps s: an emulation of the
    kernel's fma chains on the CPU, against the plain version, measured at
    most 1.0 eps s on the episode's points (C = 9) and 2.4 on normal
    features (C = 64), a third of sqrt(11) and sqrt(66).  A packed key
    keeps d's bits above the low packed_bits(N) ones, so such a difference
    moves a column near a bucket's edge into the next bucket.  A differing
    row is explained when ``got`` is the packed top k for some distances
    within tol of the plain ones: each column's key may be that of any
    bucket [d - tol, d + tol] reaches (its low bits stay the column), the
    keys must rise along the list (a greedy choice of the least key at
    each place decides it), and every column not listed must be able to
    lie above the last.  A column whose interval reaches no edge keeps its
    key, so a list out of order, or one that misses a neighbour, is
    explained only where each column it moves lies within tol of an edge;
    a list with a repeated column never is."""
    n, c = x.shape[1], x.shape[2]
    rows = (got != want).any(-1)
    out = dict(mismatch=rows.float().mean().item(), unexplained=0, tol_share=0.0)
    if not bool(rows.any()):
        return out
    bi, ri = rows.nonzero(as_tuple=True)
    xx = (x * x).sum(-1, keepdim=True)
    d = ((xx - 2.0 * torch.matmul(x, x.transpose(-1, -2))) + xx.transpose(-1, -2))[bi, ri]
    ax = x.abs()
    s = xx[bi, ri] + xx[bi, :, 0] + 2.0 * torch.matmul(ax[bi], ax[bi, ri][..., None])[..., 0]
    tol = (c + 2) ** 0.5 * 2.0 ** -23 * s
    g = got[bi, ri].long()
    low = (1 << knn_mod.packed_bits(n)) - 1
    col = torch.arange(n, device=x.device)

    def key(v):
        return (v.clamp_min(0.0).view(torch.int32).long() & ~low) | col

    repeated = (g.sort(-1).values.diff(dim=-1) == 0).any(-1)
    listed = torch.zeros_like(d, dtype=torch.bool).scatter_(1, g, True)

    def explained(t):
        k_min, k_max = key(d - t).gather(1, g), key(d + t)
        last = torch.full_like(g[:, 0], -1)
        ok = ~repeated
        for p in range(g.shape[1]):
            least = (last & ~low) | g[:, p]          # the least key of the column above last
            least = torch.where(least > last, least, least + low + 1)
            last = torch.maximum(least, k_min[:, p])
            ok &= last <= k_max.gather(1, g[:, p:p + 1])[:, 0]
        return ok & ((k_max > last[:, None]) | listed).all(-1)

    out["unexplained"] = int((~explained(tol)).sum())
    shares = [f for f in (1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0) if bool(explained(f * tol).all())]
    out["tol_share"] = shares[0] if shares else float("inf")
    return out


def attention_gates(torch, attn_mod, q, k, v, dy, tau, rate, seed, y, lse, grads) -> dict:
    """Each error of a kernel call's (y, lse, dq, dk, dv) as a share of its
    bound (<= 1 passes), against the plain versions on the same inputs
    with q scaled as the kernels scale it (the backward's from the
    kernel's y and lse).  f32: y within ATTN_F32_FWD_RTOL |y| +
    ATTN_F32_FWD_ATOL, each gradient within ATTN_F32_BWD_TOL of its largest
    entry; bf16: y within ATTN_BF16_FWD_TOL of the largest |y|, each
    gradient within ATTN_BF16_BWD_TOL; every bound times sqrt(max(D, 64) /
    64) (see ATTN_F32_FWD_RTOL); lse within 1e-5 relative and absolute."""
    scale = (max(q.shape[-1], 64) / 64) ** 0.5
    want_y, want_lse = attn_mod.attention_fwd_reference(q, k, v, tau, rate, seed,
                                                        kernel_scale=True)
    want = attn_mod.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed,
                                            kernel_scale=True)
    out = {"lse": ((lse - want_lse).abs() / (1e-5 + 1e-5 * want_lse.abs())).max().item()}
    if q.dtype == torch.bfloat16:
        out["y"] = ((y - want_y).abs().max() / (ATTN_BF16_FWD_TOL * scale
                                                * want_y.abs().max())).item()
        tol = ATTN_BF16_BWD_TOL * scale
    else:
        out["y"] = ((y - want_y).abs() / (scale * (ATTN_F32_FWD_ATOL + ATTN_F32_FWD_RTOL
                                                   * want_y.abs()))).max().item()
        tol = ATTN_F32_BWD_TOL * scale
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        out[name] = ((a - w).abs().max() / (tol * w.abs().max())).item()
    return out


def check_knn(torch, knn_mod, sx):
    """Flagship EdgeConv shapes: the 10 support clouds at C = 9 (raw points)
    and C = 64 (features).  Sets must match on >= 99.9% of rows, and every
    differing neighbour must be a rounding-level tie of the row's k-th
    distance (`knn_agreement`: within NEAR_TIE of xx_i + xx_j); two calls
    must be bit-equal.  Times: the six calls of a request, each shape
    alone (five calls back to back), and each batch at C = 1 (the least
    channel work a call can have: what stays is selection, staging and
    launch).  Bound: three tf32 tensor-core passes per product (the FFMA
    bound beside it)."""
    k = 20
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = {9: torch.from_numpy(sx.reshape(-1, *sx.shape[2:])).cuda(),
          64: torch.randn((10, 2048, 64), generator=g, device="cuda")}
    worst_err, self_first = 0.0, {}
    for c, x in xs.items():
        got = knn_mod.knn(x, k)
        if not torch.equal(got, knn_mod.knn(x, k)):
            raise AssertionError(f"knn C={c}: two calls on the same input differ")
        a = knn_agreement(torch, x, got.long(), knn_mod.knn_reference(x, k).long())
        worst_err = max(worst_err, a["err"])
        self_first[f"self_first_c{c}"] = a["self_first"]
        log(f"  knn C={c}: row mismatch rate {a['mismatch']:.3e}; worst differing neighbour "
            f"off the k-th distance by {a['gap_rel']:.3e} of it, {a['gap']:.3e} of xx_i + xx_j; "
            f"self first on {a['self_first']:.5f} of rows; a second call bit-equal")
        if a["mismatch"] > 1e-3 or a["gap"] > NEAR_TIE:
            raise AssertionError(f"knn C={c}: mismatch {a['mismatch']}, gap {a['gap']}")
    feats = {(b, c): torch.randn((b, 2048, c), generator=g, device="cuda")
             for b, c in set(KNN_SHAPES) | {(10, 1), (2, 1)}}
    ms = cuda_ms(lambda: [knn_mod.knn(feats[s], k) for s in KNN_SHAPES], 10)
    plain = cuda_ms(lambda: [knn_mod.knn_reference(feats[s], k) for s in KNN_SHAPES], 10)
    shape_ms = {f"ms_b{b}_c{c}": cuda_ms(lambda x=feats[(b, c)]: knn_mod.knn(x, k), 10, per=5)
                for b, c in sorted(feats)}
    log("  knn ms per call: " + ", ".join(f"{n[3:]} {v:.4f}" for n, v in shape_ms.items()))
    flops = sum(2.0 * b * 2048 ** 2 * c for b, c in KNN_SHAPES)
    nbytes = sum(4.0 * b * 2048 * (c + k) for b, c in KNN_SHAPES)
    return row(worst_err, ms, plain, None, 3 * flops, nbytes, TF32_TC_FLOPS,
               bound_ms_ffma=bound(flops, nbytes)[0], **self_first, **shape_ms)


def sdpa(torch, q, k, v, rate, tau):
    """The yardstick for kernels 2 and 5: one `scaled_dot_product_attention`
    call on (B, 1, N, D) views (a 3-D input takes the unfused math
    backend), pinned to the memory-efficient backend, the one SDPA picks
    for f32 with dropout on sm80+ (CUTLASS's f32 kernels, `fmha_cutlassF`
    and `fmha_cutlassB` in the profile) and the one that takes bf16 past
    flash's D = 256; if that backend is refused the call raises."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1),
                                              dropout_p=rate, scale=1 / tau).squeeze(1)


def check_attention(torch, attn_mod):
    """Eval mode at the serving shapes (B = 10 and 2, no dropout): the
    kernel against the plain version, and the times of each batch."""
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
    lib = cuda_ms(lambda: [sdpa(torch, *a, 0.0, 8.0) for a in full], 10)
    per_b = {f"ms_eval_b{a[0].shape[0]}": cuda_ms(lambda: attn_mod.attention(*a, 8.0), 10)
             for a in full}
    return err, ms, plain, lib, per_b


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
    with the same mask, each gradient within 1e-4 of its largest entry.
    Times: kernels 2 and 5 per step (both batches), each batch alone, and
    at rate 0; the yardstick SDPA (`sdpa`) forward alone and backward alone
    (one forward keeps the graph, `torch.autograd.grad` is timed), so that
    kernel 5 is held against a backward and the pair against SDPA's forward
    + backward.  Bounds: 3 tf32 tensor-core passes per product (the old
    FFMA bound beside it)."""
    from torch.profiler import ProfilerActivity, profile
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
        again = attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError("attention bwd: two calls on the same inputs differ")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attn_mod.attention_reference(*leaves, tau, rate, seed).backward(dy)
        for name, a, t in zip("qkv", got, leaves):
            e = (a - t.grad).abs().max().item()
            scale = t.grad.abs().max().item()
            log(f"  attention bwd B={q.shape[0]} d{name}: max abs err {e:.3e} "
                f"({e / scale:.3e} of the largest entry); a second call bit-equal")
            if e > 1e-4 * scale:
                raise AssertionError(f"attention bwd d{name}: error {e} > 1e-4 x {scale}")
            bwd_err = max(bwd_err, e)
        saved.append((q, k, v, dy, seed, y, lse))
    log(f"  attention fwd with dropout: max abs err {fwd_err:.3e}")

    def fwd(f, r=rate, which=saved):
        return lambda: [f(q, k, v, tau, r, seed) for q, k, v, dy, seed, *_ in which]

    def bwd(f, r=rate, which=saved):
        return lambda: [f(q, k, v, y, dy, lse, tau, r, seed) for q, k, v, dy, seed, y, lse in which]

    sdpa_graphs = []
    for q, k, v, dy, *_ in saved:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_graphs.append((sdpa(torch, *leaves, rate, tau), leaves, dy))

    def sdpa_bwd():
        for out, leaves, dy in sdpa_graphs:
            torch.autograd.grad(out, leaves, dy, retain_graph=True)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(torch, *saved[0][:3], rate, tau)
        sdpa_bwd()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if "fmha" in e.key or "ttention" in e.key})
    log(f"  SDPA (memory-efficient backend pinned) ran: {[n[:70] for n in names]}")
    t = dict(fwd=cuda_ms(fwd(attn_mod.attention_fwd), 10),
             fwd_plain=cuda_ms(fwd(attn_mod.attention_fwd_reference), 10),
             bwd=cuda_ms(bwd(attn_mod.attention_bwd), 10),
             bwd_plain=cuda_ms(bwd(attn_mod.attention_bwd_reference), 10),
             lib_fwd=cuda_ms(lambda: [sdpa(torch, q, k, v, rate, tau) for q, k, v, *_ in saved], 10),
             lib_bwd=cuda_ms(sdpa_bwd, 10),
             fwd_rate0=cuda_ms(fwd(attn_mod.attention_fwd, 0.0), 10),
             bwd_rate0=cuda_ms(bwd(attn_mod.attention_bwd, 0.0), 10))
    for i, b in enumerate(q.shape[0] for q, *_ in saved):
        t[f"fwd_b{b}"] = cuda_ms(fwd(attn_mod.attention_fwd, rate, saved[i:i + 1]), 10)
        t[f"bwd_b{b}"] = cuda_ms(bwd(attn_mod.attention_bwd, rate, saved[i:i + 1]), 10)
    log("  attention per step (ms): " + ", ".join(f"{n} {v:.4f}" for n, v in t.items()) +
        f"; kernels 2 + 5 {t['fwd'] + t['bwd']:.4f} against SDPA forward + backward "
        f"{t['lib_fwd'] + t['lib_bwd']:.4f}")
    bn2d = sum(q.shape[0] for q, *_ in calls) * 2048 ** 2 * 64
    io = sum(q.numel() for q, *_ in calls) * 4.0
    extra_fwd = dict(ms_rate0=t["fwd_rate0"], ms_b10=t["fwd_b10"], ms_b2=t["fwd_b2"],
                     bound_ms_ffma=bound(4.0 * bn2d, 4 * io)[0])
    extra_bwd = dict(ms_rate0=t["bwd_rate0"], ms_b10=t["bwd_b10"], ms_b2=t["bwd_b2"],
                     bound_ms_ffma=bound(10.0 * bn2d, 8 * io)[0],
                     ms_pair=t["fwd"] + t["bwd"], library_ms_pair=t["lib_fwd"] + t["lib_bwd"])
    return (row(fwd_err, t["fwd"], t["fwd_plain"], t["lib_fwd"], 3 * 4.0 * bn2d, 4 * io,
                TF32_TC_FLOPS, **extra_fwd),
            row(bwd_err, t["bwd"], t["bwd_plain"], t["lib_bwd"], 3 * 10.0 * bn2d, 8 * io,
                TF32_TC_FLOPS, **extra_bwd))


def sdpa_flash(torch, q, k, v, rate, tau):
    """The yardstick for the bf16 forms of kernels 2 and 5: one
    `scaled_dot_product_attention` call on bf16 (B, 1, N, D) views pinned
    to the flash backend (its own dropout mask; a bf16 output); if that
    backend is refused the call raises."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1),
                                              dropout_p=rate, scale=1 / tau).squeeze(1)


def bf16_forward_times(torch, attn_mod, calls, tau, rate, reps: int = 10) -> dict:
    """Per call of the bf16 forward at D <= 64 on each of ``calls`` ((q,
    k, v, dy, seed), one per batch size) and of SDPA pinned to flash on the
    same inputs: CUDA events around one call (the host's enqueue included,
    as a step sees it), around 20 calls back to back (the host hidden), and
    the device time of the kernels alone (`device_ms`: names holding
    "attn_fwd_bf16", "flash"), also at rate 0 (what the dropout mask
    costs)."""
    out = {}
    for q, k, v, _, seed in calls:
        b = q.shape[0]

        def kernel(q=q, k=k, v=v, seed=seed):
            return attn_mod.attention_fwd(q, k, v, tau, rate, seed)

        def flash(q=q, k=k, v=v):
            return sdpa_flash(torch, q, k, v, rate, tau)

        def kernel0(q=q, k=k, v=v, seed=seed):
            return attn_mod.attention_fwd(q, k, v, tau, 0.0, seed)

        def flash0(q=q, k=k, v=v):
            return sdpa_flash(torch, q, k, v, 0.0, tau)

        for tag, fn, fn0, key in (("", kernel, kernel0, "attn_fwd_bf16"),
                                  ("lib_", flash, flash0, "flash")):
            out[f"{tag}ms_b{b}"] = cuda_ms(fn, reps)
            out[f"{tag}ms20_b{b}"] = cuda_ms(fn, reps, per=20)
            out[f"{tag}device_ms_b{b}"] = device_ms(fn, key)
            out[f"{tag}device_ms_b{b}_rate0"] = device_ms(fn0, key)
    return out


def bf16_backward_times(torch, attn_mod, calls, tau, reps: int = 10) -> dict:
    """Per call of the bf16 backward at D <= 64 on each of ``calls`` ((q,
    k, v, dy, seed), one per batch size), at rate 0.1 and at rate 0, from
    the kernel forward's y and lse, and of SDPA pinned to flash on the same
    inputs (`torch.autograd.grad` through one kept flash forward): CUDA
    events around one call, and the device time of the kernels alone
    (`device_ms`): the port's kernels whose name holds "attn_bwd" and "bf16"
    (its prep pass included, on any tree), flash's those holding
    "flash_bwd" (its dq accumulator's fill, an elementwise kernel, left
    out)."""
    out = {}
    for q, k, v, dy, seed in calls:
        b = q.shape[0]
        for rate, tag in ((0.1, ""), (0.0, "_rate0")):
            y, lse = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            graph = sdpa_flash(torch, *leaves, rate, tau)

            def kernel(q=q, k=k, v=v, y=y, dy=dy, lse=lse, rate=rate, seed=seed):
                return attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)

            def flash(graph=graph, leaves=leaves, dy=dy.to(q.dtype)):
                return torch.autograd.grad(graph, leaves, dy, retain_graph=True)

            for pre, fn, key in (("", kernel, ("attn_bwd", "bf16")),
                                 ("lib_", flash, ("flash_bwd",))):
                out[f"{pre}bwd_ms_b{b}{tag}"] = cuda_ms(fn, reps)
                out[f"{pre}bwd_device_ms_b{b}{tag}"] = device_ms(fn, key)
            if rate > 0.0:      # the port's kernels one by one
                for name, ms in device_kernels(torch, kernel):
                    if "attn_bwd" in name and "bf16" in name:
                        short = re.search(r"attn_bwd\w*", name).group(0)
                        out[f"bwd_device_ms_b{b}_{short}"] = ms
    return out


def check_attention_bf16(torch, attn_mod):
    """The bf16 forms of kernels 2 and 5 (the bf16 encoder's) at the
    training shapes, B = 10 and 2, N = 2048, D = 64, with dropout 0.1 and
    without: the forward against its plain version (lse rtol/atol 1e-5; y
    within ATTN_BF16_FWD_TOL of its largest entry), the backward within
    ATTN_BF16_BWD_TOL of each gradient's largest entry of its plain
    version, a second call of each bit-equal.
    Times per step (both batches, rate 0.1): kernels, plain versions, and
    SDPA pinned to flash on the same bf16 inputs (`sdpa_flash`), forward
    alone and backward alone.  Bounds: 4 B N^2 D and 10 B N^2 D operations
    on the bf16 tensor cores; bytes: q, k, v bf16 read, y (and dy) f32,
    lse, and dq, dk, dv f32 written.  The forward also per call at each
    batch size beside flash (`bf16_forward_times`: events around one call
    and around 20, and device time), and the backward per call beside
    flash's (`bf16_backward_times`: events around one call, device time, at
    rate 0.1 and 0)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    tau, bf16 = 8.0, torch.bfloat16
    calls = []
    for b, seed in ((10, 87), (2, 88)):
        q, k, v, dy = (torch.randn((b, 2048, 64), generator=g, device="cuda") for _ in range(4))
        calls.append((q.to(bf16), k.to(bf16), v.to(bf16), dy, seed))
    fwd_err = bwd_err = 0.0
    saved = []
    for q, k, v, dy, seed in calls:
        for rate in (0.1, 0.0):
            y, lse = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
            y2, lse2 = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
            want_y, want_lse = attn_mod.attention_fwd_reference(q, k, v, tau, rate, seed)
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
            e = (y - want_y).abs().max().item()
            bound_y = ATTN_BF16_FWD_TOL * want_y.abs().max().item()
            got = attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
            again = attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)
            want = attn_mod.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, seed)
            rel = [((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want)]
            same = (torch.equal(y, y2) and torch.equal(lse, lse2)
                    and all(torch.equal(a, c) for a, c in zip(got, again)))
            log(f"  attention bf16 B={q.shape[0]} rate {rate}: forward max abs err {e:.3e} "
                f"(bound {bound_y:.3e}); backward dq, dk, dv off their plain versions by "
                f"{', '.join(f'{r:.3e}' for r in rel)} of their largest entry; a second call "
                f"of each bit-equal {same}")
            if e > bound_y or max(rel) > ATTN_BF16_BWD_TOL or not same:
                raise AssertionError(f"attention bf16 B={q.shape[0]} rate {rate}: forward {e}, "
                                     f"backward {rel}, repeat bit-equal {same}")
            fwd_err, bwd_err = max(fwd_err, e), max(bwd_err, max(rel))
            if rate > 0.0:
                saved.append((q, k, v, dy, seed, y, lse))
    rate = 0.1

    def fwd(f, which=saved):
        return lambda: [f(q, k, v, tau, rate, seed) for q, k, v, dy, seed, *_ in which]

    def bwd(f, which=saved):
        return lambda: [f(q, k, v, y, dy, lse, tau, rate, seed)
                        for q, k, v, dy, seed, y, lse in which]

    graphs = []
    for q, k, v, dy, *_ in saved:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        graphs.append((sdpa_flash(torch, *leaves, rate, tau), leaves, dy.to(bf16)))

    def sdpa_bwd():
        for out, leaves, dy in graphs:
            torch.autograd.grad(out, leaves, dy, retain_graph=True)

    t = dict(fwd=cuda_ms(fwd(attn_mod.attention_fwd), 10),
             fwd_plain=cuda_ms(fwd(attn_mod.attention_fwd_reference), 10),
             bwd=cuda_ms(bwd(attn_mod.attention_bwd), 10),
             bwd_plain=cuda_ms(bwd(attn_mod.attention_bwd_reference), 10),
             lib_fwd=cuda_ms(lambda: [sdpa_flash(torch, q, k, v, rate, tau)
                                      for q, k, v, *_ in saved], 10),
             lib_bwd=cuda_ms(sdpa_bwd, 10))
    for i, b in enumerate(q.shape[0] for q, *_ in saved):
        t[f"fwd_b{b}"] = cuda_ms(fwd(attn_mod.attention_fwd, saved[i:i + 1]), 10)
        t[f"bwd_b{b}"] = cuda_ms(bwd(attn_mod.attention_bwd, saved[i:i + 1]), 10)
    log("  attention bf16 per step (ms): " + ", ".join(f"{n} {v:.4f}" for n, v in t.items()))
    per_call = bf16_forward_times(torch, attn_mod, [(q, k, v, dy, seed)
                                                    for q, k, v, dy, seed, *_ in saved], tau, rate)
    log("  attention bf16 forward per call (ms; lib_ is flash): " +
        ", ".join(f"{n} {v:.4f}" for n, v in per_call.items()))
    bwd_call = bf16_backward_times(torch, attn_mod, [(q, k, v, dy, seed)
                                                     for q, k, v, dy, seed, *_ in saved], tau)
    log("  attention bf16 backward per call (ms; lib_ is flash): " +
        ", ".join(f"{n} {v:.4f}" for n, v in bwd_call.items()))
    bn2d = sum(q.shape[0] for q, *_ in saved) * 2048 ** 2 * 64
    n = sum(q.numel() for q, *_ in saved)
    rows = sum(q.shape[0] * q.shape[1] for q, *_ in saved)
    fwd_bytes = 3 * 2.0 * n + 4.0 * n + 4.0 * rows
    bwd_bytes = 3 * 2.0 * n + 2 * 4.0 * n + 4.0 * rows + 3 * 4.0 * n
    extra = {n: v for n, v in per_call.items() if not n.startswith("ms_")}
    extra["device_ms"] = extra["device_ms_b10"] + extra["device_ms_b2"]
    extra["library_device_ms"] = extra["lib_device_ms_b10"] + extra["lib_device_ms_b2"]
    bwd_extra = dict(bwd_call, device_ms=bwd_call["bwd_device_ms_b10"]
                     + bwd_call["bwd_device_ms_b2"],
                     library_device_ms=bwd_call["lib_bwd_device_ms_b10"]
                     + bwd_call["lib_bwd_device_ms_b2"])
    return (row(fwd_err, t["fwd"], t["fwd_plain"], t["lib_fwd"], 4.0 * bn2d, fwd_bytes,
                BF16_TC_FLOPS, ms_b10=t["fwd_b10"], ms_b2=t["fwd_b2"], **extra),
            row(bwd_err, t["bwd"], t["bwd_plain"], t["lib_bwd"], 10.0 * bn2d, bwd_bytes,
                BF16_TC_FLOPS, ms_b10=t["bwd_b10"], ms_b2=t["bwd_b2"],
                ms_pair=t["fwd"] + t["bwd"], library_ms_pair=t["lib_fwd"] + t["lib_bwd"],
                **bwd_extra))


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
    """The flagship calls: a request's two (the ways' foreground, 2 x
    10,240 points at 25% valid; the background, 20,480 at 75%; k = 100) and
    a training step's third (WayContrast, 10 clouds x 2048 at 25%, k = 4),
    192 channels.  Seeds must be equal, or diverge only at a near-tie of
    the running min distance (NEAR_TIE relative); two calls bit-equal; one
    launch per call.  ms is the request's two calls; each call is also
    timed alone."""
    g = torch.Generator(device="cuda").manual_seed(2)
    calls = {"ways": (2, 10240, 0.25, 100), "bg": (1, 20480, 0.75, 100),
             "contrast": (10, 2048, 0.25, 4)}
    args, err = {}, 0.0
    for name, (p, n, share, k) in calls.items():
        feat = torch.randn((p, n, 192), generator=g, device="cuda")
        ok = torch.rand((p, n), generator=g, device="cuda") < share
        args[name] = (feat, ok, k)
        before = fps_mod.launches
        got = fps_mod.fps(feat, ok, k)
        again = fps_mod.fps(feat, ok, k)
        if fps_mod.launches != before + 2 or not torch.equal(got, again):
            raise AssertionError(f"fps {name}: {fps_mod.launches - before} launches for two "
                                 f"calls, bit-equal {torch.equal(got, again)}")
        want = fps_mod.fps_reference(feat, ok, k)
        equal = bool((got == want).all())
        log(f"  fps {tuple(feat.shape)} k={k}: seeds equal {equal}; a second call bit-equal")
        if not equal:
            abs_gap, gap = _fps_divergence_gap(torch, fps_mod, feat, ok, got, want)
            err = max(err, abs_gap)
            if gap > NEAR_TIE:
                raise AssertionError(f"fps diverged at a relative gap of {gap}")
    request = ("ways", "bg")
    ms = cuda_ms(lambda: [fps_mod.fps(*args[c]) for c in request], 5)
    plain = cuda_ms(lambda: [fps_mod.fps_reference(*args[c]) for c in request], 5)
    call_ms = {f"ms_{c}": cuda_ms(lambda a=args[c]: fps_mod.fps(*a), 5, per=3) for c in calls}
    log("  fps ms per call: " + ", ".join(f"{n[3:]} {v:.4f}" for n, v in call_ms.items()))
    # operations: the distance to each round's centre of every valid point
    # (3 per channel); bytes: the valid points' features and the masks read
    # once, the seeds written once
    valid = {c: int(args[c][1].sum()) for c in request}
    flops = sum(3.0 * valid[c] * 192 * (args[c][2] - 1) for c in request)
    nbytes = sum(valid[c] * 192 * 4.0 + args[c][1].numel() + 4.0 * args[c][2] * args[c][1].shape[0]
                 for c in request)
    return row(err, ms, plain, None, flops, nbytes, **call_ms)


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
    repeat = torch.equal(got, kth_mod.kth_smallest_per_row(d, 200, 32))
    err = (got - want).abs().max().item()
    log(f"  kth ({m}, {m}) k=200 iters=32: bit-equal {equal}, two calls bit-equal {repeat}")
    if not (equal and repeat):
        raise AssertionError(f"kth differs from its plain version by up to {err}, or "
                             f"between two calls")
    return kth_row(torch, kth_mod, d, 32, 4.0)


def kth_row(torch, kth_mod, d, iters, itemsize):
    """Times of the k-th distance at k = 200 on d: the kernel (CUDA events
    over calls enqueued back to back, and its device time from the
    profiler), the plain version and `torch.kthvalue`, with the bound: the
    bisection's compares, and d read once and the radii written once."""
    m = d.shape[0]
    ms = cuda_ms(lambda: kth_mod.kth_smallest_per_row(d, 200, iters), 10, per=10)
    dev = device_ms(lambda: kth_mod.kth_smallest_per_row(d, 200, iters), "kth_kernel")
    plain = cuda_ms(lambda: kth_mod.kth_smallest_per_row_reference(d, 200, iters), 10)
    lib = cuda_ms(lambda: torch.kthvalue(d, 200, dim=1), 10)
    return row(0.0, ms, plain, lib, float(iters) * m * m, itemsize * m * m + 4.0 * m,
               device_ms=dev)


def check_kth_rows(torch, kth_mod, m: int = 4396, n: int = 3):
    """n rows of each kind of KTH_KINDS at width m (n odd: a bf16 row of
    4396 entries starts 8 bytes off a 16-byte boundary every other row), f32
    with 32 steps and bf16 with 16: the kernel bit-equal to its plain
    version, and two calls bit-equal."""
    for kind in KTH_KINDS:
        d, k = kth_rows(kind, n, m, seed=len(kind))
        for dt, iters in ((torch.float32, 32), (torch.bfloat16, 16)):
            x = torch.from_numpy(d).to(dt).cuda()
            got = kth_mod.kth_smallest_per_row(x, k, iters)
            want = kth_mod.kth_smallest_per_row_reference(x, k, iters)
            again = kth_mod.kth_smallest_per_row(x, k, iters)
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"kth {kind} {dt} k={k}: kernel {got.flatten().tolist()}, "
                                     f"again {again.flatten().tolist()}, plain "
                                     f"{want.flatten().tolist()}")
    log(f"  kth adversarial rows ({len(KTH_KINDS)} kinds x {n} rows, m = {m}, f32 and bf16): "
        f"bit-equal to plain, two calls bit-equal")


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
    bit-equal, two calls bit-equal.  Returns the kth row's *_bf16 fields."""
    m = sel.shape[0]
    got = kth_mod.kth_smallest_per_row(sel, 200, 16)
    want = kth_mod.kth_smallest_per_row_reference(sel, 200, 16)
    equal = torch.equal(got, want)
    repeat = torch.equal(got, kth_mod.kth_smallest_per_row(sel, 200, 16))
    log(f"  kth bf16 ({m}, {m}) k=200 iters=16: bit-equal {equal}, two calls bit-equal {repeat}")
    if not (equal and repeat):
        raise AssertionError(f"kth bf16 differs from its plain version by up to "
                             f"{(got - want).abs().max().item()}, or between two calls")
    return {f"{key}_bf16": v for key, v in kth_row(torch, kth_mod, sel, 16, 2.0).items()}


def check_cheby(torch, cheby_mod, s, b, alpha, iters):
    """The Chebyshev solve (kernel 7) on a flagship bf16 S, with the
    episode's label columns b (the forward solve) and with a dense random b
    (as the adjoint solve's): the kernel within SPLIT_TOL of max |x| of its
    plain version (`cheby_solve_split_reference`, the same split-bf16
    arithmetic) at 1, 3 and `iters` steps, and within CHEBY_TOL of the
    f32-product plain version (`cheby_solve_reference`, the plain path); the
    three are held against the same solve in f64 (`exact_solve`) and the
    distances logged; two calls bit-equal, one launch per solve; timed with
    CUDA events and by the profiler (its kernels' device time).  Its bound
    counts S read once and the bf16 tensor-core products of both pieces of
    d; `bound_ms_hbm` is the time to read S from device memory at every
    step.  `max_abs_err` and `plain_ms` are against the f32-product plain
    version, as in earlier rows; `split_max_abs_err` and `split_plain_ms`
    against the split one."""
    g = torch.Generator(device="cuda").manual_seed(6)
    m = s.shape[0]
    split = cheby_mod.cheby_solve_split_reference
    for rhs, bb in (("labels", b), ("dense", torch.randn(b.shape, generator=g, device="cuda"))):
        before = cheby_mod.launches
        got = cheby_mod.cheby_solve(s, bb, alpha, iters)
        again = cheby_mod.cheby_solve(s, bb, alpha, iters)
        torch.cuda.synchronize()
        if cheby_mod.launches != before + 2 or not torch.equal(got, again):
            raise AssertionError(f"cheby, {rhs} b: launches {cheby_mod.launches - before} for two "
                                 f"solves, bit-equal {torch.equal(got, again)}")
        want = cheby_mod.cheby_solve_reference(s, bb, alpha, iters)
        exact = exact_solve(cheby_mod)(s, bb, alpha, iters)
        e, scale = (got - want).abs().max().item(), want.abs().max().item()
        versions = {"kernel": got, "f32 plain": want, "split plain": split(s, bb, alpha, iters)}
        for steps in sorted(SPLIT_TOL):
            k_t = got if steps == iters else cheby_mod.cheby_solve(s, bb, alpha, steps)
            p_t = versions["split plain"] if steps == iters else split(s, bb, alpha, steps)
            e_t, sc_t = (k_t - p_t).abs().max().item(), p_t.abs().max().item()
            log(f"  cheby {rhs} b, {steps} steps: kernel vs split plain {e_t:.3e}, "
                f"{e_t / sc_t:.3e} of max |x| (tolerance {SPLIT_TOL[steps]})")
            if not (np.isfinite(e_t) and e_t <= SPLIT_TOL[steps] * sc_t):
                raise AssertionError(f"cheby, {rhs} b, {steps} steps: {e_t} > "
                                     f"{SPLIT_TOL[steps]} x {sc_t}")
            if rhs == "labels" and steps == iters:
                split_err = (e_t, e_t / sc_t)
        exact_err = {name: (x - exact).abs().max().item() / scale for name, x in versions.items()}
        log(f"  cheby bf16 S ({m}, {m}), {rhs} b {tuple(bb.shape)}, {iters} steps: kernel vs f32 "
            f"plain {e:.3e}, {e / scale:.3e} of max |x| = {scale:.4f}; from the f64 solve: " +
            ", ".join(f"{n} {v:.3e}" for n, v in exact_err.items()) + " of max |x|")
        if not (np.isfinite(e) and e <= CHEBY_TOL * scale):
            raise AssertionError(f"cheby, {rhs} b: error {e} > {CHEBY_TOL} x {scale}")
        if rhs == "labels":
            err, rel_err, label_exact = e, e / scale, exact_err
        else:
            dense_exact = exact_err
    ms = cuda_ms(lambda: cheby_mod.cheby_solve(s, b, alpha, iters), 10)
    dev = device_ms(lambda: cheby_mod.cheby_solve(s, b, alpha, iters), "cheby")
    plain = cuda_ms(lambda: cheby_mod.cheby_solve_reference(s, b, alpha, iters), 10)
    split_plain = cuda_ms(lambda: split(s, b, alpha, iters), 10)
    steps = iters - 1
    s_bytes = 2.0 * m * m
    log(f"  cheby {iters} steps, label b: kernel {ms:.3f} ms (device {dev:.3f}), f32 plain "
        f"{plain:.3f}, split plain {split_plain:.3f}")
    return row(err, ms, plain, None, steps * 2.0 * m * m * 2 * b.shape[1],
               s_bytes + 8.0 * b.numel(), peak=BF16_TC_FLOPS, max_rel_err=rel_err,
               split_max_abs_err=split_err[0], split_max_rel_err=split_err[1],
               split_plain_ms=split_plain, exact_rel_err=label_exact["kernel"],
               plain_exact_rel_err=label_exact["f32 plain"],
               split_plain_exact_rel_err=label_exact["split plain"],
               exact_rel_err_dense=dense_exact, device_ms=dev,
               bound_ms_hbm=steps * s_bytes / HBM_BYTES * 1e3)


def check_proto_cheby(torch, proto_mod, cheby_mod, s, b, alpha, iters):
    """Kernel 10 (one bf16 d per step) on the flagship bf16 S beside kernel
    7, with the label columns b and a dense random b: kernel 10 vs its plain
    version within PROTO_TOL of max |x| at 3 and at `iters` steps; kernel 10,
    its plain version and kernel 7 held against the f64 solve
    (`exact_solve`) and the distances logged: what a single bf16 d costs.
    Then the three timed on the label columns.  Its bound counts S read once
    and the live columns' bf16 tensor-core products."""
    g = torch.Generator(device="cuda").manual_seed(7)
    m = s.shape[0]
    exact = exact_solve(cheby_mod)
    out = {}
    for rhs, bb in (("labels", b), ("dense", torch.randn(b.shape, generator=g, device="cuda"))):
        for steps in (3, iters):
            got = proto_mod.proto_cheby_solve(s, bb, alpha, steps)
            want = proto_mod.proto_cheby_solve_reference(s, bb, alpha, steps)
            e, scale = (got - want).abs().max().item(), want.abs().max().item()
            tol = PROTO_TOL[3 if steps == 3 else 50]
            log(f"  proto_cheby bf16 S ({m}, {m}), {rhs} b {tuple(bb.shape)}, {steps} steps: "
                f"max abs err {e:.3e}, {e / scale:.3e} of max |x| = {scale:.4f} (tolerance {tol})")
            if not (np.isfinite(e) and e <= tol * scale):
                raise AssertionError(f"proto_cheby, {rhs} b, {steps} steps: error {e} > "
                                     f"{tol} x {scale}")
        ref = exact(s, bb, alpha, iters)
        dist = {name: (x - ref).abs().max().item() / scale for name, x in (
            ("kernel 10", got), ("plain 10", want),
            ("kernel 7", cheby_mod.cheby_solve(s, bb, alpha, iters)))}
        log(f"  {rhs} b, {iters} steps, distance from the f64 solve / max |x|: " +
            ", ".join(f"{n} {v:.3e}" for n, v in dist.items()))
        if not torch.equal(got, proto_mod.proto_cheby_solve(s, bb, alpha, iters)):
            raise AssertionError(f"proto_cheby, {rhs} b: not bit-equal across a kernel 7 call")
        if rhs == "labels":
            out = dict(err=e, rel_err=e / scale, exact=dist)
        else:
            out["exact_dense"] = dist
    ms = cuda_ms(lambda: proto_mod.proto_cheby_solve(s, b, alpha, iters), 10)
    plain = cuda_ms(lambda: proto_mod.proto_cheby_solve_reference(s, b, alpha, iters), 10)
    k7 = cuda_ms(lambda: cheby_mod.cheby_solve(s, b, alpha, iters), 10)
    no_res = cuda_ms(lambda: proto_mod.proto_cheby_solve(s, b, alpha, iters, resident_rows=0),
                     10)
    log(f"  proto_cheby {iters} steps, label b: kernel 10 {ms:.3f} ms ({no_res:.3f} with no "
        f"rows of S kept on chip), plain {plain:.3f}, kernel 7 {k7:.3f}")
    return row(out["err"], ms, plain, None, (iters - 1) * 2.0 * m * m * b.shape[1],
               2.0 * m * m + 8.0 * b.numel(), peak=BF16_TC_FLOPS, max_rel_err=out["rel_err"],
               exact_rel_err=out["exact"]["kernel 10"],
               plain_exact_rel_err=out["exact"]["plain 10"],
               cheby_exact_rel_err=out["exact"]["kernel 7"],
               exact_rel_err_dense=out["exact_dense"], cheby_ms=k7, ms_no_resident=no_res)


def check_scatter(torch, knn_mod, scatter_mod, sx, qx):
    """The gather backward at a training step's shapes: the kNN graphs of
    the episode's support (B = 10) and query (B = 2) clouds, a random
    (B, 2048, 20, 64) cotangent.  Within 1e-5 * sum |g| of `index_add_` per
    entry, bit-equal to the kernel's order of sums emulated in PyTorch
    (`scatter_add_ordered_reference`) and across two calls, one launch per
    call.  Each call is timed (five back to back; and the kernel's device
    time from the profiler) and the six calls of a training step (three
    EdgeConv blocks per batch), beside `index_add_`."""
    g = torch.Generator(device="cuda").manual_seed(5)
    calls = []
    for x in (sx.reshape(-1, *sx.shape[2:]), qx):
        xt = torch.from_numpy(np.ascontiguousarray(x)).cuda()
        idx = knn_mod.knn(xt, 20)
        calls.append((torch.randn((*idx.shape, 64), generator=g, device="cuda"), idx))
    err = 0.0
    per_call = {}
    for gr, idx in calls:
        before = scatter_mod.launches
        got = scatter_mod.scatter_add(gr, idx, 2048)
        again = scatter_mod.scatter_add(gr, idx, 2048)
        torch.cuda.synchronize()
        want = scatter_mod.scatter_add_reference(gr, idx, 2048)
        tol = 1e-5 * scatter_mod.scatter_add_reference(gr.abs(), idx, 2048)
        e = (got - want).abs()
        hub = max(torch.bincount(i.flatten().long()).max().item() for i in idx)
        same = torch.equal(got, again)
        emulated = torch.equal(got, scatter_mod.scatter_add_ordered_reference(gr, idx, 2048))
        log(f"  scatter-add {tuple(gr.shape)}: max abs err {e.max().item():.3e}, "
            f"largest share of the bound {(e / tol.clamp_min(1e-30)).max().item():.3e}; two calls "
            f"bit-equal {same}; bit-equal to the ordered emulation {emulated}; busiest point is "
            f"the neighbour of {hub} rows")
        if not bool((e <= tol).all()):
            raise AssertionError("scatter-add outside 1e-5 * sum |g|")
        if scatter_mod.launches != before + 2:
            raise AssertionError(f"scatter-add: {scatter_mod.launches - before} launches for 2 calls")
        if not (same and emulated):
            raise AssertionError("scatter-add: not bit-equal across calls or to its emulation")
        err = max(err, e.max().item())
        call = (lambda: scatter_mod.scatter_add(gr, idx, 2048))
        per_call[f"B{gr.shape[0]}"] = dict(   # five calls back to back: see `cuda_ms`
            ms=cuda_ms(call, 10, per=5), device_ms=device_ms(call, "scatter_add"),
            library_ms=cuda_ms(lambda: index_add(torch, gr, idx), 10, per=5), hub=hub)
    step = calls * 3                        # three EdgeConv blocks per batch
    ms = cuda_ms(lambda: [scatter_mod.scatter_add(gr, idx, 2048) for gr, idx in step], 10)
    plain = cuda_ms(lambda: [scatter_mod.scatter_add_reference(gr, idx, 2048)
                             for gr, idx in step], 10)
    lib = cuda_ms(lambda: [index_add(torch, gr, idx) for gr, idx in step], 10)
    log("  scatter-add per call: " + ", ".join(
        f"{k} {v['ms']:.4f} ms, device {v['device_ms']:.4f} (index_add_ {v['library_ms']:.4f})"
        for k, v in per_call.items()) +
        f"; a training step's six calls {ms:.4f} ms (index_add_ {lib:.4f})")
    nbytes = sum(4.0 * (gr.numel() + idx.numel() + gr.shape[0] * 2048 * 64) for gr, idx in step)
    return row(err, ms, plain, lib, sum(float(gr.numel()) for gr, _ in step), nbytes,
               per_call=per_call)


def check_scatter_bf16(torch, knn_mod, scatter_mod, sx, qx):
    """Kernel 6 on a bf16 cotangent (the bf16 encoder's) at a training
    step's shapes: bit-equal to the f32 form on its upcast, to the ordered
    emulation and across two calls, one launch per call.  Times: a step's
    six calls, kernel and plain version (the f32 `index_add_` of the
    upcast).  No one PyTorch call computes it: `index_add_` wants the
    table's dtype, and a bf16 table would round its sums.  Bound: bytes, g
    read at 2 bytes an entry."""
    g = torch.Generator(device="cuda").manual_seed(15)
    calls = []
    for x in (sx.reshape(-1, *sx.shape[2:]), qx):
        xt = torch.from_numpy(np.ascontiguousarray(x)).cuda()
        idx = knn_mod.knn(xt, 20)
        gr = torch.randn((*idx.shape, 64), generator=g, device="cuda").to(torch.bfloat16)
        calls.append((gr, idx))
    err = 0.0
    for gr, idx in calls:
        before = scatter_mod.bf16_launches
        got = scatter_mod.scatter_add(gr, idx, 2048)
        again = scatter_mod.scatter_add(gr, idx, 2048)
        torch.cuda.synchronize()
        upcast = torch.equal(got, scatter_mod.scatter_add(gr.float(), idx, 2048))
        emulated = torch.equal(got, scatter_mod.scatter_add_ordered_reference(gr, idx, 2048))
        same = torch.equal(got, again)
        e = (got - scatter_mod.scatter_add_reference(gr, idx, 2048)).abs().max().item()
        log(f"  scatter-add bf16 {tuple(gr.shape)}: bit-equal to the f32 form on the upcast "
            f"{upcast}, to the ordered emulation {emulated}, across two calls {same}; "
            f"max abs err against index_add_ {e:.3e}")
        if scatter_mod.bf16_launches != before + 2 or not (upcast and emulated and same):
            raise AssertionError("scatter-add bf16: not bit-equal, or not one launch per call")
        err = max(err, e)
    step = calls * 3
    ms = cuda_ms(lambda: [scatter_mod.scatter_add(gr, idx, 2048) for gr, idx in step], 10)
    plain = cuda_ms(lambda: [scatter_mod.scatter_add_reference(gr, idx, 2048)
                             for gr, idx in step], 10)
    per_call = {f"ms_b{gr.shape[0]}": cuda_ms(lambda gr=gr, idx=idx: scatter_mod.scatter_add(
        gr, idx, 2048), 10, per=5) for gr, idx in calls}
    log(f"  scatter-add bf16: a training step's six calls {ms:.4f} ms (plain {plain:.4f}); "
        + ", ".join(f"{k[3:]} {v:.4f} ms per call" for k, v in per_call.items()))
    nbytes = sum(2.0 * gr.numel() + 4.0 * (idx.numel() + gr.shape[0] * 2048 * 64)
                 for gr, idx in step)
    return row(err, ms, plain, None, sum(float(gr.numel()) for gr, _ in step), nbytes,
               **per_call)


def check_knn_bf16(torch, knn_mod):
    """Kernel 1 on a bf16 input (under the 'stats', 'relaxed' and 'hybrid'
    BN modes the second and third EdgeConv blocks take a bf16 block
    output): equal to kNN on its f32 upcast, one launch per call, and to
    the plain version up to rounding-level ties (`knn_agreement`).  Times:
    those four calls of a request (B = 10 and 2, C = 64), kernel and plain
    version, both on the bf16 input.  Bound: the distances' products on
    the bf16 tensor cores, 2 B N^2 C operations: bf16 fits in tf32, so the
    lo parts of the kernel's 3xTF32 split are zero and one bf16 pass with
    f32 sums gives the same sums; bytes: x bf16 read, indices written."""
    k = 20
    g = torch.Generator(device="cuda").manual_seed(16)
    xs = [torch.randn((b, 2048, 64), generator=g, device="cuda").to(torch.bfloat16)
          for b in (10, 10, 2, 2)]
    err = 0.0
    for x in xs[::2]:
        before = knn_mod.bf16_launches
        got = knn_mod.knn(x, k)
        torch.cuda.synchronize()
        equal = torch.equal(got, knn_mod.knn(x.float(), k))
        a = knn_agreement(torch, x.float(), got.long(), knn_mod.knn_reference(x, k).long())
        err = max(err, a["err"])
        log(f"  knn bf16 input {tuple(x.shape)}: equal to the kNN of its f32 upcast {equal}; "
            f"against the plain version: row mismatch rate {a['mismatch']:.3e}, sorted "
            f"distances off by {a['err']:.3e}")
        if not equal or knn_mod.bf16_launches != before + 1 or a["gap"] > NEAR_TIE:
            raise AssertionError(f"knn bf16: differs from its upcast, or not one launch, or "
                                 f"from the plain version beyond a tie ({a['gap']})")
    ms = cuda_ms(lambda: [knn_mod.knn(x, k) for x in xs], 10)
    plain = cuda_ms(lambda: [knn_mod.knn_reference(x, k) for x in xs], 10)
    log(f"  knn bf16: a request's four calls {ms:.4f} ms (plain {plain:.4f})")
    flops = sum(2.0 * x.shape[0] * 2048 ** 2 * 64 for x in xs)
    nbytes = sum(2.0 * x.numel() + 4.0 * x.shape[0] * 2048 * k for x in xs)
    return row(err, ms, plain, None, flops, nbytes, BF16_TC_FLOPS)


# ------------------------------------------------------------ F1 kernels --
# Shapes the JAX package's Pallas kernels run and the tuned kernels do not
# take: each goes to its own simple kernel (or, for attention at an
# unaligned D <= 64, to the tuned kernels after an exact zero pad).
KNN_F1_SHAPES = [(2, 9, 40), (2, 64, 40), (2, 320, 20)]     # (B, C, k) at N = 2048


def expect_launches(counters: dict, call, want: dict, what: str):
    """Run call(), and fail unless each counter moved by exactly want[name]
    (0 for the tuned kernel a shape must not reach)."""
    import torch
    before = counts(counters)
    out = call()
    torch.cuda.synchronize()
    got = {n: c - before[n] for n, c in counts(counters).items()}
    if any(got[n] != c for n, c in want.items()):
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return out


def check_knn_general(torch, knn_mod):
    """The general kNN kernel at k = 40 (N = 2048, C = 9 and 64, B = 2) and
    C = 320 (k = 20): the general counter moves once per call and the tuned
    one not; the lists held to kernel 1's criterion (`knn_agreement`: sets
    differ on at most 1e-3 of the rows, each differing neighbour within
    NEAR_TIE of xx_i + xx_j of the k-th distance), two calls bit-equal.
    Times: the three calls, kernel and plain version; no single PyTorch
    call computes a kNN.  Bound: the products 2 B N^2 C as three tf32
    tensor-core passes, as kernel 1's row (the FFMA bound, what this
    kernel runs, beside it); x read and the lists written."""
    counters = {"general": (knn_mod, "general_launches"), "tuned": (knn_mod, "launches")}
    g = torch.Generator(device="cuda").manual_seed(21)
    xs = [(torch.randn((b, 2048, c), generator=g, device="cuda"), k) for b, c, k in KNN_F1_SHAPES]
    err, rates = 0.0, {}
    for x, k in xs:
        got = expect_launches(counters, lambda: knn_mod.knn(x, k), {"general": 1, "tuned": 0},
                              f"knn general {tuple(x.shape)} k={k}")
        same = torch.equal(got, knn_mod.knn(x, k))
        a = knn_agreement(torch, x, got.long(), knn_mod.knn_reference(x, k).long())
        err = max(err, a["err"])
        rates[f"mismatch_c{x.shape[-1]}_k{k}"] = a["mismatch"]
        log(f"  knn general {tuple(x.shape)} k={k}: row mismatch rate {a['mismatch']:.3e} "
            f"(bound 1e-3); worst differing neighbour {a['gap']:.3e} of xx_i + xx_j (bound "
            f"{NEAR_TIE:.0e}); a second call bit-equal {same}")
        if a["mismatch"] > 1e-3 or a["gap"] > NEAR_TIE or not same:
            raise AssertionError(f"knn general {tuple(x.shape)} k={k}: {a}, repeat {same}")
    ms = cuda_ms(lambda: [knn_mod.knn(x, k) for x, k in xs], 5)
    plain = cuda_ms(lambda: [knn_mod.knn_reference(x, k) for x, k in xs], 5)
    per = {f"ms_c{x.shape[-1]}_k{k}": cuda_ms(lambda x=x, k=k: knn_mod.knn(x, k), 5)
           for x, k in xs}
    log("  knn general ms per call: " + ", ".join(f"{n[3:]} {v:.4f}" for n, v in per.items()))
    flops = sum(2.0 * x.shape[0] * x.shape[1] ** 2 * x.shape[2] for x, _ in xs)
    nbytes = sum(4.0 * x.numel() + 4.0 * x.shape[0] * x.shape[1] * k for x, k in xs)
    return row(err, ms, plain, None, 3 * flops, nbytes, TF32_TC_FLOPS,
               bound_ms_ffma=bound(flops, nbytes)[0], **rates, **per)


def check_knn_packed(torch, knn_mod, sx):
    """The packed-key kNN (knn_impl "pallas") at a request's six EdgeConv
    calls (`KNN_SHAPES`, k = 20): on integer points (every sum exact) equal
    to `knn_packed_reference`; on the episode's points and random features
    at most PACKED_MISMATCH of the rows differ from it and each differing
    row is explained by the rounding of the distances (`packed_agreement`),
    two calls bit-equal, one packed launch per call and no tuned one.
    Times: the six calls, kernel and plain version (no single PyTorch
    call).  Bound: the products 2 B N^2 C as three tf32 tensor-core passes,
    as kernel 1's row (FFMA beside it); x read, the lists written."""
    k = 20
    counters = {"packed": (knn_mod, "packed_launches"), "tuned": (knn_mod, "launches")}
    rng = np.random.default_rng(22)
    xi = torch.from_numpy(rng.integers(-4, 5, size=(2, 2048, 64)).astype(np.float32)).cuda()
    if not torch.equal(knn_mod.knn(xi, k, packed=True), knn_mod.knn_packed_reference(xi, k)):
        raise AssertionError("knn packed: differs from its plain version on integer points")
    g = torch.Generator(device="cuda").manual_seed(23)
    xs = {9: torch.from_numpy(sx.reshape(-1, *sx.shape[2:])).cuda(),
          64: torch.randn((10, 2048, 64), generator=g, device="cuda")}
    rates = {}
    for c, x in xs.items():
        got = expect_launches(counters, lambda: knn_mod.knn(x, k, packed=True),
                              {"packed": 1, "tuned": 0}, f"knn packed C={c}")
        same = torch.equal(got, knn_mod.knn(x, k, packed=True))
        a = packed_agreement(torch, knn_mod, x, got, knn_mod.knn_packed_reference(x, k))
        rates[f"mismatch_c{c}"] = a["mismatch"]
        rates[f"tol_share_c{c}"] = a["tol_share"]
        log(f"  knn packed {tuple(x.shape)}: equal to plain on integer points; rows that differ "
            f"from plain {a['mismatch']:.3e} (bound {PACKED_MISMATCH:.0e}), of them unexplained "
            f"by rounding {a['unexplained']}, explained within {a['tol_share']} of the rounding "
            f"bound; a second call bit-equal {same}")
        if a["unexplained"] or a["mismatch"] > PACKED_MISMATCH or not same:
            raise AssertionError(f"knn packed C={c}: {a}, repeat {same}")
    feats = {(b, c): torch.randn((b, 2048, c), generator=g, device="cuda")
             for b, c in set(KNN_SHAPES)}
    ms = cuda_ms(lambda: [knn_mod.knn(feats[s], k, packed=True) for s in KNN_SHAPES], 10)
    plain = cuda_ms(lambda: [knn_mod.knn_packed_reference(feats[s], k) for s in KNN_SHAPES], 10)
    per = {f"ms_b{b}_c{c}": cuda_ms(lambda x=feats[(b, c)]: knn_mod.knn(x, k, packed=True), 5)
           for b, c in sorted(feats)}
    log("  knn packed ms per call: " + ", ".join(f"{n[3:]} {v:.4f}" for n, v in per.items()))
    flops = sum(2.0 * b * 2048 ** 2 * c for b, c in KNN_SHAPES)
    nbytes = sum(4.0 * b * 2048 * (c + k) for b, c in KNN_SHAPES)
    return row(0.0, ms, plain, None, 3 * flops, nbytes, TF32_TC_FLOPS,
               bound_ms_ffma=bound(flops, nbytes)[0], **rates, **per)


# Attention past the tuned kernels' 64 channels: (dtype, D, the route's
# counters).  bf16 at 64 < D <= 256 takes csrc/attention_wide_bf16.cu's
# tensor-core tiles (D = 100 through the zero pad to 104), bf16 past 256
# csrc/attention_group_bf16.cu's channel groups of those tiles (D = 300
# through the zero pad to 304), f32 at D > 64 csrc/attention_wide.cu's
# 3xTF32 tiles in groups of 128 channels (D = 100 one group short of 128,
# 256 two groups, 320 three, the last 64 wide, 512 four).
ATTN_WIDE_CASES = [("float32", 128, "wide_tf32"), ("float32", 100, "wide_tf32"),
                   ("float32", 256, "wide_tf32"), ("float32", 320, "wide_tf32"),
                   ("float32", 512, "wide_tf32"), ("bfloat16", 128, "wide_tc"),
                   ("bfloat16", 100, "wide_tc"), ("bfloat16", 256, "wide_tc"),
                   ("bfloat16", 320, "wide_group"), ("bfloat16", 300, "wide_group"),
                   ("bfloat16", 512, "wide_group")]
ATTN_ROUTE_COUNTERS = {"tuned": ("launches", "bwd_launches"),
                       "wide_tf32": ("wide_tf32_launches", "wide_tf32_bwd_launches"),
                       "wide_tc": ("wide_tc_bf16_launches", "wide_tc_bwd_bf16_launches"),
                       "wide_group": ("wide_group_bf16_launches", "wide_group_bwd_bf16_launches")}
# each route's row in the kernels line, and the width its times are at
# (the route's other widths join that row)
ATTN_ROUTE_ROWS = {"wide_tf32": "attention_wide_tf32", "wide_tc": "attention_wide_tc",
                   "wide_group": "attention_wide_group"}
ATTN_ROW_D = {"wide_tf32": 128, "wide_tc": 128, "wide_group": 320}


def attention_step(attn_mod, q, k, v, dy, tau, rate, seed):
    """A training step's attention: the forward (y, lse), then the
    backward's (dq, dk, dv)."""
    y, lse = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
    return y, lse, attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed)


def attention_times(torch, attn_mod, saved, tau, rate, lib, reps: int = 5) -> dict:
    """Per step (the saved calls of B = 10 and 2): the forward and the
    backward, kernels and plain versions, each batch alone, and ``lib``
    (SDPA pinned to a backend) forward alone and backward alone (one
    forward keeps the graph; `torch.autograd.grad` is timed), None where
    the backend refuses the shape."""
    def fwd(f, which=saved):
        return lambda: [f(q, k, v, tau, rate, seed) for q, k, v, dy, seed, *_ in which]

    def bwd(f, which=saved):
        return lambda: [f(q, k, v, y, dy, lse, tau, rate, seed)
                        for q, k, v, dy, seed, y, lse in which]

    t = dict(fwd=cuda_ms(fwd(attn_mod.attention_fwd), reps),
             fwd_plain=cuda_ms(fwd(attn_mod.attention_fwd_reference), reps),
             bwd=cuda_ms(bwd(attn_mod.attention_bwd), reps),
             bwd_plain=cuda_ms(bwd(attn_mod.attention_bwd_reference), reps))
    for i, b in enumerate(q.shape[0] for q, *_ in saved):
        t[f"fwd_b{b}"] = cuda_ms(fwd(attn_mod.attention_fwd, saved[i:i + 1]), reps)
        t[f"bwd_b{b}"] = cuda_ms(bwd(attn_mod.attention_bwd, saved[i:i + 1]), reps)
    graphs = []
    try:
        for q, k, v, dy, *_ in saved:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            graphs.append((lib(torch, *leaves, rate, tau), leaves, dy.to(q.dtype)))
    except RuntimeError as e:       # no kernel of that backend takes the shape
        log(f"  {lib.__name__} refuses D={saved[0][0].shape[-1]}: {str(e).splitlines()[0]}")
        return dict(t, lib_fwd=None, lib_bwd=None)

    def lib_bwd():
        for out, leaves, dy in graphs:
            torch.autograd.grad(out, leaves, dy, retain_graph=True)

    t["lib_fwd"] = cuda_ms(lambda: [lib(torch, q, k, v, rate, tau) for q, k, v, *_ in saved],
                           reps)
    t["lib_bwd"] = cuda_ms(lib_bwd, reps)
    return t


def check_attention_wide(torch, attn_mod):
    """Attention past the tuned kernels' width (`ATTN_WIDE_CASES`): f32 at
    D = 128 (the pretraining network's head), 100, 256, 320 and 512 on the
    3xTF32 kernels in channel groups, bf16 at D = 128, 100 (zero
    pad to 104) and 256 on the wide tensor-core kernels, bf16 at D = 320,
    300 (zero pad to 304) and 512 on the grouped tensor-core kernels; each
    at B = 10 and 2, N = 2048, rate 0.1 and 0,
    forward and backward: the route's counters move once each and no other
    route's, every error within `attention_gates`' bound, a second call of
    each bit-equal; then D = 12 in f32 (aligned: the tuned kernels as they
    are) and in bf16 (the zero pad to 16, then the tuned bf16 kernels).
    Times per step (both batches, rate 0.1) at each width: kernels, plain
    versions, and SDPA (f32, and bf16 past flash's 256: the
    memory-efficient backend; bf16 up to 256: flash) forward alone and
    backward alone.  Bounds: 4 B N^2 D and 10 B N^2 D operations
    at the peak of the function's type, as the tuned rows count them: f32
    as three tf32 tensor-core passes (the FFMA bound beside it), bf16 on
    the bf16 tensor cores; bytes as the tuned rows count them.  Returns
    the rows: the 3xTF32 pair in f32 at D = 128 (D = 100, 256, 320 and 512
    beside), the bf16 tensor-core pair at D = 128 (D = 100 and 256 beside),
    the grouped pair at D = 320 (D = 300 and 512 beside)."""
    counters = {f"{route}_{i}": (attn_mod, name) for route, names in ATTN_ROUTE_COUNTERS.items()
                for i, name in zip(("fwd", "bwd"), names)}
    g = torch.Generator(device="cuda").manual_seed(24)
    rows, extra = {}, {route: {} for route in ATTN_ROUTE_ROWS}
    for dtype_name, d, route in ATTN_WIDE_CASES:
        dtype = getattr(torch, dtype_name)
        calls = []
        for b, seed in ((10, 97), (2, 98)):
            q, k, v, dy = (torch.randn((b, 2048, d), generator=g, device="cuda") for _ in range(4))
            calls.append((q.to(dtype), k.to(dtype), v.to(dtype), dy, seed))
        tau = d ** 0.5
        want = {n: int(n.rsplit("_", 1)[0] == route) for n in counters}
        worst = {"y": 0.0, "grads": 0.0}
        what = f"attention D={d} {dtype_name} ({route})"
        for q, k, v, dy, seed in calls:
            for rate in (0.1, 0.0):
                y, lse, grads = expect_launches(
                    counters, lambda: attention_step(attn_mod, q, k, v, dy, tau, rate, seed),
                    want, f"{what} B={q.shape[0]} rate {rate}")
                y2, lse2, grads2 = attention_step(attn_mod, q, k, v, dy, tau, rate, seed)
                same = (torch.equal(y, y2) and torch.equal(lse, lse2)
                        and all(torch.equal(a, c) for a, c in zip(grads, grads2)))
                e = attention_gates(torch, attn_mod, q, k, v, dy, tau, rate, seed, y, lse, grads)
                log(f"  {what} B={q.shape[0]} rate {rate}: errors as shares of their bounds " +
                    ", ".join(f"{n} {x:.3e}" for n, x in e.items()) +
                    f"; a second call of each bit-equal {same}")
                if max(e.values()) > 1.0 or not same:
                    raise AssertionError(f"{what}: {e}, repeat {same}")
                worst["y"] = max(worst["y"], e["y"])
                worst["grads"] = max(worst["grads"], e["dq"], e["dk"], e["dv"])
        rate = 0.1
        saved = [(q, k, v, dy, seed, *attn_mod.attention_fwd(q, k, v, tau, rate, seed))
                 for q, k, v, dy, seed in calls]
        err_y = max((y - attn_mod.attention_fwd_reference(q, k, v, tau, rate, seed,
                                                          kernel_scale=True)[0]).abs().max().item()
                    for q, k, v, dy, seed, y, lse in saved)
        err_g = max((a - w).abs().max().item() for q, k, v, dy, seed, y, lse in saved
                    for a, w in zip(attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, rate, seed),
                                    attn_mod.attention_bwd_reference(q, k, v, y, dy, lse, tau,
                                                                     rate, seed,
                                                                     kernel_scale=True)))
        lowp = dtype == torch.bfloat16
        lib = sdpa_flash if lowp and d <= 256 else sdpa
        t = attention_times(torch, attn_mod, saved, tau, rate, lib)
        log(f"  {what} per step (ms): " +
            ", ".join(f"{n} {v}" if v is None else f"{n} {v:.4f}" for n, v in t.items()))
        if d != ATTN_ROW_D[route]:    # beside the route's row
            extra[route].update({f"{n}_d{d}": t[f"{n}"]
                                 for n in ("fwd", "bwd", "lib_fwd", "lib_bwd")},
                                **{f"share_of_gate_d{d}": max(worst.values())})
            continue
        bn2d = sum(q.shape[0] for q, *_ in saved) * 2048 ** 2 * d
        n = sum(q.numel() for q, *_ in saved)
        nrows = sum(q.shape[0] * q.shape[1] for q, *_ in saved)
        el = 2.0 if lowp else 4.0
        fwd_bytes = 3 * el * n + 4.0 * n + 4.0 * nrows
        bwd_bytes = 3 * el * n + 2 * 4.0 * n + 4.0 * nrows + 3 * 4.0 * n
        passes, peak = (1, BF16_TC_FLOPS) if lowp else (3, TF32_TC_FLOPS)
        name = ATTN_ROUTE_ROWS[route]
        tag = "_bf16" if lowp else ""
        rows[f"{name}_fwd{tag}"] = row(
            err_y, t["fwd"], t["fwd_plain"], t["lib_fwd"], passes * 4.0 * bn2d, fwd_bytes,
            peak, bound_ms_ffma=bound(4.0 * bn2d, fwd_bytes)[0], head_dim=d,
            ms_b10=t["fwd_b10"], ms_b2=t["fwd_b2"], share_of_gate=worst["y"])
        rows[f"{name}_bwd{tag}"] = row(
            err_g, t["bwd"], t["bwd_plain"], t["lib_bwd"], passes * 10.0 * bn2d, bwd_bytes,
            peak, bound_ms_ffma=bound(10.0 * bn2d, bwd_bytes)[0], head_dim=d,
            ms_b10=t["bwd_b10"], ms_b2=t["bwd_b2"], share_of_gate=worst["grads"],
            ms_pair=t["fwd"] + t["bwd"],
            library_ms_pair=None if t["lib_fwd"] is None else t["lib_fwd"] + t["lib_bwd"])
    rows["attention_wide_tf32_bwd"].update(extra["wide_tf32"])
    rows["attention_wide_tc_bwd_bf16"].update(extra["wide_tc"])
    rows["attention_wide_group_bwd_bf16"].update(extra["wide_group"])
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dy = (torch.randn((2, 2048, 12), generator=g, device="cuda") for _ in range(4))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        tau = 12 ** 0.5
        y, lse, grads = expect_launches(
            counters, lambda: attention_step(attn_mod, q, k, v, dy, tau, 0.1, 5),
            {n: int(n.rsplit("_", 1)[0] == "tuned") for n in counters}, f"attention D=12 {dtype}")
        e = attention_gates(torch, attn_mod, q, k, v, dy, tau, 0.1, 5, y, lse, grads)
        log(f"  attention D=12 {dtype} ({'zero pad to 16, ' if dtype == torch.bfloat16 else ''}"
            f"tuned kernels): errors as shares of their bounds " +
            ", ".join(f"{n} {x:.3e}" for n, x in e.items()))
        if max(e.values()) > 1.0:
            raise AssertionError(f"attention D=12 {dtype}: {e}")
    return rows


def attention_digest(torch, attn_mod, seed: int) -> dict:
    """The attention kernels' output bits on inputs drawn from ``seed``, by
    the wrapper API every tree since the wide kernels has, so that two
    trees can be held bit for bit (run this file under each tree's root,
    see the module docstring): a sha256 of (y, lse, dq, dk, dv) of a
    training step at B = 10 and 2, N = 2048, rate 0.1, for the tuned f32
    and bf16 kernels at D = 64 and D = 12 (bf16: the zero pad), the f32
    wide kernels at D = 128 and the bf16 wide tensor-core kernels at D =
    128, 100 (the zero pad to 104) and 256; and of the bf16 backward alone
    at D = 64 (`bfloat16_d64_bwd`: dq, dk, dv from the plain forward's y
    and lse, so that kernel 5's bf16 bits are held across trees whose
    forwards sum in another order).  Then the f32 pair at D = 128 and the
    bf16 pair at D = 320, on whichever kernels the tree routes them to (the
    launch counters that moved are printed), and SDPA's memory-efficient
    backend beside each: their times per step (`attention_times`, rate
    0.1); and the bf16 forward and backward at D = 64 per call at B = 10
    and 2 beside flash (`bf16_forward_times`, `bf16_backward_times`)."""
    import hashlib
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    out = {}
    for dtype_name, d in (("float32", 64), ("bfloat16", 64), ("float32", 12), ("bfloat16", 12),
                          ("float32", 128), ("bfloat16", 128), ("bfloat16", 100),
                          ("bfloat16", 256), ("bfloat16", 320)):
        dtype = getattr(torch, dtype_name)
        calls = []
        for b, s in ((10, seed + 1), (2, seed + 2)):
            q, k, v, dy = (torch.randn((b, 2048, d), generator=g, device="cuda") for _ in range(4))
            calls.append((q.to(dtype), k.to(dtype), v.to(dtype), dy, s))
        tau = d ** 0.5
        key = f"{dtype_name}_d{d}"
        if (dtype_name, d) == ("bfloat16", 64):
            h = hashlib.sha256()
            for q, k, v, dy, s in calls:
                y, lse = attn_mod.attention_fwd_reference(q, k, v, tau, 0.1, s)
                for x in attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, 0.1, s):
                    h.update(x.contiguous().cpu().numpy().tobytes())
            out["bfloat16_d64_bwd"] = h.hexdigest()[:16]
            log(f"  attention bfloat16 D=64 backward alone (plain y, lse): sha256 "
                f"{out['bfloat16_d64_bwd']}")
            out["bf16_d64_fwd"] = bf16_forward_times(torch, attn_mod, calls, tau, 0.1)
            log("  attention bfloat16 D=64 forward per call (ms; lib_ is flash): " + ", ".join(
                f"{n} {v:.4f}" for n, v in out["bf16_d64_fwd"].items()))
            out["bf16_d64_bwd"] = bf16_backward_times(torch, attn_mod, calls, tau)
            log("  attention bfloat16 D=64 backward per call (ms; lib_ is flash): " + ", ".join(
                f"{n} {v:.4f}" for n, v in out["bf16_d64_bwd"].items()))
        if (dtype_name, d) != ("bfloat16", 320):
            h = hashlib.sha256()
            for q, k, v, dy, s in calls:
                y, lse, grads = attention_step(attn_mod, q, k, v, dy, tau, 0.1, s)
                for x in (y, lse, *grads):
                    h.update(x.contiguous().cpu().numpy().tobytes())
            out[key] = h.hexdigest()[:16]
            log(f"  attention {dtype_name} D={d}: sha256 {out[key]}")
        if (dtype_name, d) not in (("float32", 128), ("bfloat16", 320)):
            continue
        # every counter of the module, so that any tree's routes show
        names = [n for n in dir(attn_mod) if n.endswith("launches")]
        before = {n: getattr(attn_mod, n) for n in names}
        saved = [(q, k, v, dy, s, *attn_mod.attention_fwd(q, k, v, tau, 0.1, s))
                 for q, k, v, dy, s in calls]
        for q, k, v, dy, s, y, lse in saved:
            attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, 0.1, s)
        moved = {n: getattr(attn_mod, n) - c for n, c in before.items()
                 if getattr(attn_mod, n) != c}
        t = attention_times(torch, attn_mod, saved, tau, 0.1, sdpa, reps=10)
        tag = "f32_d128" if dtype_name == "float32" else "bf16_d320"
        # the device time of each kernel of the pair, per step
        per_kernel = {name[:60]: ms for name, ms in device_kernels(torch, lambda: [
            attention_step(attn_mod, q, k, v, dy, tau, 0.1, s) for q, k, v, dy, s in calls])}
        out[tag] = dict(t, counters=moved, device_ms=per_kernel)
        log(f"  attention {dtype_name} D={d} (counters {moved}) per step (ms): " +
            ", ".join(f"{n} {v}" if v is None else f"{n} {v:.4f}" for n, v in t.items()) +
            "; device ms per kernel: " + ", ".join(f"{n} {v:.4f}" for n, v in per_kernel.items()))
    return out


def check_kth_wide(torch, kth_mod):
    """The k-th distance on rows one block's shared memory does not hold:
    8 rows of 60000 f32 and of 120000 bf16 distances (k = 200), and the
    adversarial rows (`kth_rows`) at those widths: the wide variant's
    counter moves once per call and the tuned one's not, bit-equal to the
    plain version, two calls bit-equal.  Times: the kernel (CUDA events
    over five calls back to back), the plain version; no single PyTorch
    call gives the bisection's radius.  Bound: the rows read once, the
    radii written."""
    counters = {"wide": (kth_mod, "wide_launches"), "tuned": (kth_mod, "launches")}
    g = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for dtype, m, iters, tag in ((torch.float32, 60000, 32, ""),
                                 (torch.bfloat16, 120000, 16, "_bf16")):
        d = (torch.rand((8, m), generator=g, device="cuda") * 9.0 + 0.1).to(dtype)
        d[:, -4:] = kth_mod.SENTINEL
        cases = [(d, 200, "uniform")]
        for kind in KTH_KINDS:
            rows_k, k_k = kth_rows(kind, 3, m, seed=len(kind))
            cases.append((torch.from_numpy(rows_k).cuda().to(dtype), k_k, kind))
        for x, k, what in cases:
            got = expect_launches(counters, lambda: kth_mod.kth_smallest_per_row(x, k, iters),
                                  {"wide": 1, "tuned": 0}, f"kth wide {what} {dtype}")
            if not (torch.equal(got, kth_mod.kth_smallest_per_row_reference(x, k, iters))
                    and torch.equal(got, kth_mod.kth_smallest_per_row(x, k, iters))):
                raise AssertionError(f"kth wide {what} {dtype}: not bit-equal to plain or across "
                                     f"calls")
        log(f"  kth wide {dtype} m={m}: 8 uniform rows and {len(KTH_KINDS)} kinds of adversarial "
            f"rows bit-equal to plain, two calls bit-equal")
        ms = cuda_ms(lambda: kth_mod.kth_smallest_per_row(d, 200, iters), 10, per=5)
        plain = cuda_ms(lambda: kth_mod.kth_smallest_per_row_reference(d, 200, iters), 5)
        r = row(0.0, ms, plain, None, float(iters) * d.numel(),
                d.element_size() * d.numel() + 4.0 * d.shape[0])
        out.update({f"{key}{tag}": v for key, v in r.items()})
        log(f"  kth wide {dtype}: {ms:.4f} ms per call, plain {plain:.4f}")
    return out


def check_scatter_general(torch, knn_mod, scatter_mod, sx, qx):
    """The general scatter-add at C = 63 on a training step's kNN graphs
    (support B = 10 and query B = 2, N = 2048, K = 20), f32 and bf16 g, and
    at N = 32768 with C = 64 (one cloud's kNN graph of random points, K =
    20): the general counter moves once per call and the tuned one's not,
    bit-equal to the ordered emulation and across two calls (bf16 g: also to
    the f32 form on the upcast).  Times: the three f32 calls, kernel, plain
    version and `index_add_`; each call alone.  Bound: g and idx read, dx
    written."""
    counters = {"general": (scatter_mod, "general_launches"), "tuned": (scatter_mod, "launches")}
    g = torch.Generator(device="cuda").manual_seed(26)
    calls = []
    for x in (sx.reshape(-1, *sx.shape[2:]), qx):
        idx = knn_mod.knn(torch.from_numpy(np.ascontiguousarray(x)).cuda(), 20)
        calls.append((torch.randn((*idx.shape, 63), generator=g, device="cuda"), idx, 2048))
    pts = torch.rand((1, 32768, 9), generator=g, device="cuda")
    idx = knn_mod.knn(pts, 20)
    calls.append((torch.randn((*idx.shape, 64), generator=g, device="cuda"), idx, 32768))
    err = 0.0
    for gr, idx, n in calls:
        for gg in (gr, gr.to(torch.bfloat16)):
            got = expect_launches(counters, lambda: scatter_mod.scatter_add(gg, idx, n),
                                  {"general": 1, "tuned": 0},
                                  f"scatter general {tuple(gg.shape)} {gg.dtype} N={n}")
            same = torch.equal(got, scatter_mod.scatter_add(gg, idx, n))
            emulated = torch.equal(got, scatter_mod.scatter_add_ordered_reference(gg, idx, n))
            upcast = (gg.dtype == torch.float32
                      or torch.equal(got, scatter_mod.scatter_add(gg.float(), idx, n)))
            e = (got - scatter_mod.scatter_add_reference(gg, idx, n)).abs().max().item()
            log(f"  scatter general {tuple(gg.shape)} {gg.dtype} N={n}: bit-equal to the "
                f"ordered emulation {emulated}, across two calls {same}, to the f32 form on the "
                f"upcast {upcast}; max abs err against index_add_ {e:.3e}")
            if not (same and emulated and upcast):
                raise AssertionError("scatter general: not bit-equal")
            err = max(err, e)
    ms = cuda_ms(lambda: [scatter_mod.scatter_add(gr, idx, n) for gr, idx, n in calls], 5)
    plain = cuda_ms(lambda: [scatter_mod.scatter_add_reference(gr, idx, n)
                             for gr, idx, n in calls], 5)
    lib = cuda_ms(lambda: [index_add(torch, gr, idx, n) for gr, idx, n in calls], 5)
    per = {f"ms_b{gr.shape[0]}_c{gr.shape[-1]}_n{n}": cuda_ms(
        lambda gr=gr, idx=idx, n=n: scatter_mod.scatter_add(gr, idx, n), 5)
        for gr, idx, n in calls}
    log("  scatter general ms per call: " + ", ".join(f"{k[3:]} {v:.4f}" for k, v in per.items())
        + f"; the three {ms:.4f} (index_add_ {lib:.4f})")
    nbytes = sum(4.0 * (gr.numel() + idx.numel() + gr.shape[0] * n * gr.shape[-1])
                 for gr, idx, n in calls)
    return row(err, ms, plain, lib, sum(float(gr.numel()) for gr, _, _ in calls), nbytes, **per)


def check_f1(torch, mods, sx, qx) -> dict:
    """Every F1 kernel against its plain version at the F1 shapes (above);
    returns their rows."""
    log("[f1] shapes past the tuned kernels, each on its own kernel, against its plain version")
    rows = {"knn_general": check_knn_general(torch, mods["knn"]),
            "knn_packed": check_knn_packed(torch, mods["knn"], sx)}
    rows.update(check_attention_wide(torch, mods["attention"]))
    rows["kth_wide"] = check_kth_wide(torch, mods["kth"])
    rows["scatter_general"] = check_scatter_general(torch, mods["knn"], mods["scatter"], sx, qx)
    return rows


# ------------------------------------------------------------------ F2 --
# Shapes the archived TPU kernels 8-11 take and their tuned counterparts do
# not (fault F2): kernel 9 at C != 64, a K past the tuned tile, B * N not a
# multiple of 8 (B, N, K, C), and C = 64 at the flagship support shape,
# where the general kernel is held against the tuned one
FUSED_F2_SHAPES = [(10, 2048, 20, 32), (10, 2048, 20, 128), (2, 2048, 20, 63),
                   (2, 2048, 20, 256), (2, 2048, 64, 64), (1, 100, 20, 64)]
FUSED_F2_TIMED = (10, 2048, 20, 128)      # the general kernel's timed shape
GATHER_F2 = [(63, "float32"), (60, "bfloat16"), (63, "bfloat16")]   # C: 4- and 2-byte pieces
PROTO_F2_COLS = (16, 128)                 # kernel 10, groups of 8 columns
PROBE_F2_COLS = 12                        # kernel 11, a 32-column block


def fused_tuned_takes(name: str, b: int, n: int, k: int, c: int) -> bool:
    """Whether kernel 9's tuned tile takes pass ``name`` at (B, N, K, C), by
    `csrc/fused_edge.cu`'s rule: C = 64, B * N a multiple of 8, and its
    shared memory (`smem_floats`: W1 [and W1^T for bwd2, bwd3], the vector
    table, one or two tiles of 8 K rows) within the 227 KB a block may use
    (up to K = 103 for stats1, 51 for fwd and bwd1, 47 for bwd2 and bwd3)."""
    tile = (1 if name == "stats1" else 2) * 8 * k * 64
    floats = 64 * 64 * (2 if name in ("bwd2", "bwd3") else 1) + 14 * 64 + max(tile, 2 * 256 * 8)
    return c == 64 and (b * n) % 8 == 0 and 4 * floats <= 232448


def f2_block(torch, c: int, k: int, seed: int):
    """An EdgeConv (9 -> c, c) on the card with seeded weights and random
    BatchNorm affines and running statistics."""
    from r3dfsseg_tpu_torch.nn.dgcnn import EdgeConv
    torch.manual_seed(seed)
    block = EdgeConv(9, (c, c), k=k).cuda()
    with torch.no_grad():
        for layer in (block.layer0, block.layer1):
            layer.bn.weight.uniform_(0.5, 1.5)
            layer.bn.bias.normal_(0.0, 0.1)
            layer.bn.running_mean.normal_(0.0, 0.5)
            layer.bn.running_var.uniform_(0.5, 1.5)
    return block


def check_fused_general(torch, cfe, seed) -> dict:
    """Kernel 9's general kernel (`csrc/fused_edge_general.cu`) at
    FUSED_F2_SHAPES, f32 and bf16 e, each pass in train and eval, with the
    arguments the tail builds from an EdgeConv block's e_raw: the general
    counter moves once per call and the tuned kernel's not (but for the
    passes whose tile fits the K it is given, `fused_tuned_takes`: stats1
    at K = 64 runs the tuned kernel, as the dispatch asks), a second call
    is bit-equal, and each output is within the tuned kernel's tolerances
    of its plain version (stats1, fwd 1e-5 of the largest entry; backward
    1e-4; a bf16 d_e as `output_error` allows).  At the flagship support
    shape (10, 2048, 20, 64) the general kernel, forced by `general_only`,
    is held to the same tolerances against the tuned kernel.  Then each pass timed at FUSED_F2_TIMED, f32 and bf16
    (train arguments), beside its plain version and its bound, and at the
    flagship shape beside the tuned kernel.  Returns a row per pass."""
    counters = {f"fused_{pre}{p}": (cfe, f"{pre}{p}_launches")
                for pre in ("", "bf16_", "general_") for p in cfe.PASSES}
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    err = {p: 0.0 for p in cfe.PASSES}
    timed = {}
    for i, (b, n, k, c) in enumerate(FUSED_F2_SHAPES + [(10, 2048, 20, 64)]):
        vs_tuned = i == len(FUSED_F2_SHAPES)
        block = f2_block(torch, c, k, seed + i)
        x = torch.randn((b, n, 9), generator=g, device="cuda")
        _, _, e32, w1 = edge_operands(torch, block, x)
        dout = torch.randn((b, n, c), generator=g, device="cuda")
        worst = {}
        flips = 0
        for dtype in (torch.float32, torch.bfloat16):
            e = e32.to(dtype)
            for train in (True, False):
                args, _ = fused_pass_args(torch, cfe, block, e, w1, dout, train)
                for name, a in args.items():
                    what = f"fused_edge general {name} {(b, n, k, c)} {dtype} train={train}"
                    tuned = fused_tuned_takes(name, b, n, k, c) and not vs_tuned
                    want_moved = {f"fused_{name}": int(tuned),
                                  f"fused_bf16_{name}": int(tuned and dtype == torch.bfloat16),
                                  f"fused_general_{name}": int(not tuned)}
                    with cfe.general_only() if vs_tuned else contextlib.nullcontext():
                        got = _as_tuple(expect_launches(counters, lambda: getattr(cfe, name)(*a),
                                                        want_moved, what))
                        again = _as_tuple(getattr(cfe, name)(*a))
                    if not all(torch.equal(u, v) for u, v in zip(got, again)):
                        raise AssertionError(f"{what}: two calls differ")
                    want = _as_tuple(getattr(cfe, name)(*a) if vs_tuned
                                     else getattr(cfe, f"{name}_reference")(*a))
                    tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
                    for u, v in zip(got, want):
                        if u.dtype != v.dtype or u.shape != v.shape:
                            raise AssertionError(f"{what}: {u.dtype} {tuple(u.shape)}, want "
                                                 f"{v.dtype} {tuple(v.shape)}")
                        r, n_flip = output_error(u, v, tol, what)
                        flips += n_flip
                        err[name] = max(err[name], r * v.float().abs().max().item())
                        worst[name] = max(worst.get(name, 0.0), r)
                if train and ((b, n, k, c) == FUSED_F2_TIMED or vs_tuned):
                    timed[(dtype, vs_tuned)] = args
        log(f"  fused_edge general (B, N, K, C) = {(b, n, k, c)}, f32 and bf16 e, train and "
            f"eval: error / largest entry against "
            f"{'the tuned kernel' if vs_tuned else 'the plain version'} " +
            ", ".join(f"{n_} {v:.2e}" for n_, v in worst.items()) +
            f" (bf16 d_e entries one bf16 step apart: {flips}); repeats bit-equal; the general "
            f"counter moved, the tuned one not" +
            "".join(f" ({p_} took the tuned tile, which fits K = {k})" for p_ in cfe.PASSES
                    if fused_tuned_takes(p_, b, n, k, c) and not vs_tuned))
    rows = {}
    for name in cfe.PASSES:
        out = {}
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            a = timed[(dtype, False)][name]
            with cfe.general_only():
                ms = cuda_ms(lambda: getattr(cfe, name)(*a), 10)
            plain = cuda_ms(lambda: getattr(cfe, f"{name}_reference")(*a), 5)
            flops, nbytes = fused_pass_flops(name, a[0]), fused_pass_bytes(name, a[0])
            r = row(err[name], ms, plain, None, 3 * flops, nbytes, TF32_TC_FLOPS,
                    bound_ffma_ms=bound(flops, nbytes)[0])
            out.update({f"{key}{tag}": v for key, v in r.items()})
        a = timed[(torch.float32, True)][name]
        with cfe.general_only():
            out["ms_c64"] = cuda_ms(lambda: getattr(cfe, name)(*a), 10)
        out["tuned_ms_c64"] = cuda_ms(lambda: getattr(cfe, name)(*a), 10)
        out["shape"] = list(FUSED_F2_TIMED)
        rows[name] = out
        log(f"  fused_edge general {name} at {FUSED_F2_TIMED}: f32 {out['ms']:.3f} ms, bf16 "
            f"{out['ms_bf16']:.3f} (plain {out['plain_ms']:.3f} / {out['plain_ms_bf16']:.3f}, "
            f"bound {out['bound_ms']:.4f} / {out['bound_ms_bf16']:.4f}, FFMA "
            f"{out['bound_ffma_ms']:.4f}); at (10, 2048, 20, 64) {out['ms_c64']:.3f} against "
            f"the tuned kernel's {out['tuned_ms_c64']:.3f}")
    return rows


def check_gather_narrow(torch, gather_mod, sx) -> dict:
    """Kernel 8 on rows that are not a multiple of 16 bytes (GATHER_F2: C =
    63 f32 and 60 bf16 in 4-byte pieces, 63 bf16 in 2-byte ones) on the
    flagship support batch's kNN idx (the first EdgeConv block's, (10, 2048,
    20)): bit-equal to the plain version, the narrow counter moving once per
    call and the 16-byte one not, and timed."""
    from r3dfsseg_tpu_torch.ops import cuda_knn
    idx = cuda_knn.knn(sx, 20)
    g = torch.Generator(device="cuda").manual_seed(23)
    counters = {"gather_onehot": (gather_mod, "launches"),
                "gather_onehot_narrow": (gather_mod, "narrow_launches")}
    out = {}
    for c, dt in GATHER_F2:
        dtype = getattr(torch, dt)
        a = torch.randn((*sx.shape[:2], c), generator=g, device="cuda").to(dtype)
        got = expect_launches(counters, lambda: gather_mod.gather_onehot(a, idx),
                              {"gather_onehot": 0, "gather_onehot_narrow": 1},
                              f"gather C = {c} {dt}")
        if not torch.equal(got, gather_mod.gather_onehot_reference(a, idx)):
            raise AssertionError(f"gather C = {c} {dt}: kernel and plain differ")
        off = (torch.arange(a.shape[0], device="cuda") * a.shape[1])[:, None, None]
        flat = (idx.long() + off).reshape(-1)
        ms = cuda_ms(lambda: gather_mod.gather_onehot(a, idx), 10)
        plain = cuda_ms(lambda: gather_mod.gather_onehot_reference(a, idx), 10)
        lib = cuda_ms(lambda: a.reshape(-1, c).index_select(0, flat), 10)
        nbytes = a.element_size() * (idx.numel() * c + a.numel()) + 4.0 * idx.numel()
        out[f"C{c}_{dt}"] = row(0.0, ms, plain, lib, 0.0, nbytes)
        log(f"  gather narrow C = {c} {dt}: bit-equal; {ms:.3f} ms (plain {plain:.3f}, "
            f"index_select {lib:.3f}, bound {out[f'C{c}_{dt}']['bound_ms']:.4f})")
    first = out[f"C{GATHER_F2[0][0]}_{GATHER_F2[0][1]}"]
    return {**first, "cases": out}


def check_probe_f2(torch, proto_mod, cheby_mod, alpha: float = 0.99, iters: int = 50) -> dict:
    """Kernel 10 at PROTO_F2_COLS columns on the archive's problem (m =
    4396), one launch per group of 8 columns, within 1e-3 of max of its
    plain version (phase 6's gate at 3 columns); kernel 11 at PROBE_F2_COLS
    columns on the archive's input, one launch per call, within PROBE_TOL
    (3 steps on its S, 500 on it scaled by 1 / its row sums)."""
    s, _ = archive_cheby_problem(torch)
    m = s.shape[0]
    counters = {"proto_cheby": (proto_mod, "launches"),
                "matmul_only": (proto_mod, "matmul_only_launches")}
    rng = np.random.default_rng(29)
    out = {"proto_cheby": {}, "matmul_only": {}}
    for cols in PROTO_F2_COLS:
        b = np.zeros((m, cols), np.float32)
        b[np.arange(1000), rng.integers(0, cols, 1000)] = 1.0
        b = torch.from_numpy(b).cuda()
        got = expect_launches(counters, lambda: proto_mod.proto_cheby_solve(s, b, alpha, iters),
                              {"proto_cheby": -(-cols // 8), "matmul_only": 0},
                              f"proto_cheby {cols} columns")
        want = proto_mod.proto_cheby_solve_reference(s, b, alpha, iters)
        e = (got - want).abs().max().item()
        rel = e / want.abs().max().item()
        if not (np.isfinite(e) and rel <= 1e-3):
            raise AssertionError(f"proto_cheby {cols} columns: {rel} of max > 1e-3")
        ms = cuda_ms(lambda: proto_mod.proto_cheby_solve(s, b, alpha, iters), 5)
        plain = cuda_ms(lambda: proto_mod.proto_cheby_solve_reference(s, b, alpha, iters), 3)
        out["proto_cheby"][str(cols)] = row(e, ms, plain, None, iters * 2.0 * m * m * cols,
                                            2.0 * m * m + 8.0 * m * cols, peak=BF16_TC_FLOPS,
                                            max_rel_err=rel, launches_per_call=-(-cols // 8))
        log(f"  proto_cheby {cols} columns ({-(-cols // 8)} launches): {rel:.3e} of max "
            f"(tolerance 1e-3); {ms:.3f} ms per solve (plain {plain:.3f})")
    sp = archive_probe_input(torch)
    scaled = (sp.float() / sp.float().sum(1, keepdim=True)).to(torch.bfloat16)
    b = torch.ones((sp.shape[0], PROBE_F2_COLS), device="cuda")
    err = 0.0
    for steps, src in ((3, sp), (500, scaled)):
        got = expect_launches(counters, lambda: proto_mod.matmul_only(src, b, steps),
                              {"proto_cheby": 0, "matmul_only": 1},
                              f"matmul_only ncols={PROBE_F2_COLS}")
        want = proto_mod.matmul_only_reference(src, b, steps)
        e, scale = (got - want).abs().max().item(), want.abs().max().item()
        if got.shape != want.shape or not (np.isfinite(e) and e <= PROBE_TOL[steps] * scale):
            raise AssertionError(f"matmul_only ncols={PROBE_F2_COLS}, {steps} steps: {e} > "
                                 f"{PROBE_TOL[steps]} x {scale}")
        err = max(err, e)
        log(f"  matmul_only ncols={PROBE_F2_COLS}, {steps} steps: {e / scale:.3e} of max "
            f"(tolerance {PROBE_TOL[steps]})")
    ms = cuda_ms(lambda: proto_mod.matmul_only(sp, b, 500), 5)
    plain = cuda_ms(lambda: proto_mod.matmul_only_reference(sp, b, 500), 3)
    lib, lib_name = library_mm(torch, sp, b.to(torch.bfloat16))
    lib_ms = cuda_ms(lambda: [lib() for _ in range(500)], 3)
    mp = sp.shape[0]
    out["matmul_only"][str(PROBE_F2_COLS)] = row(
        err, ms, plain, lib_ms, 500 * 2.0 * mp * mp * PROBE_F2_COLS,
        2.0 * mp * mp + 8.0 * mp * PROBE_F2_COLS, peak=BF16_TC_FLOPS,
        us_per_matvec=ms / 500 * 1e3, library_us_per_matvec=lib_ms / 500 * 1e3, library=lib_name)
    log(f"  matmul_only ncols={PROBE_F2_COLS}: {ms / 500 * 1e3:.1f} us/matvec ({ms:.3f} ms per "
        f"500-step call; plain {plain:.3f}; {lib_name} {lib_ms / 500 * 1e3:.1f} us/matvec)")
    return out


def check_f2(torch, mods, sx, seed) -> dict:
    """Every F2 path against its plain version (above); returns their rows:
    one per pass of the general kernel 9, the narrow gather's, and the
    F2 rows of kernels 10 and 11."""
    log("[f2] shapes of kernels 8-11 past the tuned kernels, against their plain versions")
    general = check_fused_general(torch, mods["fused_edge"], seed)
    rows = {f"fused_edge_general_{p}": r for p, r in general.items()}
    rows["gather_onehot_narrow"] = check_gather_narrow(torch, mods["gather"], sx)
    rows.update({f"{k}_f2": v for k, v in check_probe_f2(torch, mods["proto_cheby"],
                                                         mods["cheby"]).items()})
    return rows


def index_add(torch, gr, idx, n: int = 2048):
    """One `index_add_` call computing the scatter-add: the library yardstick."""
    b, c = gr.shape[0], gr.shape[-1]
    off = (torch.arange(b, device="cuda") * n)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    return gr.new_zeros((b * n, c)).index_add_(0, flat, gr.reshape(-1, c))


# ----------------------------------------------------- fused EdgeConv --
def fused_edgeconv(block, x, train: bool):
    """One two-layer EdgeConv block of the port by the fused route: kNN ->
    a, b of the factored first layer, in the block's compute type as the
    layer computes them -> e_raw = gather(a, idx) + b (kernel 8, scatter-add
    backward; bf16 on the bf16 encoder) -> `edge_batch_stats` (train; eval
    takes the BatchNorms' running statistics) -> `fused_edge_tail` (kernel
    9, on e_raw's type).  The block's own `knn_impl` picks kernels ('auto')
    or plain versions ('xla').  Returns the pooled output and (m0, v0, m1,
    v1)."""
    from r3dfsseg_tpu_torch.ops import cuda_knn, fused_edge
    from r3dfsseg_tpu_torch.ops.knn import knn_indices

    if block.n_layers != 2:
        raise ValueError(f"the fused route takes two layers, not {block.n_layers}")
    impl = block.knn_impl
    xd = x.detach()
    idx = cuda_knn.knn(xd, block.k) if impl == "auto" else knn_indices(xd, block.k)
    l0, l1 = block.layer0, block.layer1
    a, b = l0.operands(x)
    e_raw = fused_edge.edge_gather(a, idx, impl) + b[:, :, None, :]
    w1 = l1.conv.weight.t()
    if train:
        stats = fused_edge.edge_batch_stats(e_raw, l0.bn.weight, l0.bn.bias, w1, impl)
    else:
        stats = (l0.bn.running_mean, l0.bn.running_var, l1.bn.running_mean, l1.bn.running_var)
    out = fused_edge.fused_edge_tail(e_raw, l0.bn.weight, l0.bn.bias, w1, l1.bn.weight,
                                     l1.bn.bias, *stats, train, impl)
    return out, stats


def unfused_edgeconv(block, x, train: bool):
    """The block's own forward.  Returns its output, the batch statistics
    of its two BatchNorms' inputs (mean and two-pass variance per channel,
    as `BatchNorm` computes them at groups = 1) and layer 1's output before
    the max over k."""
    seen = {}
    hooks = [block.layer0.bn.register_forward_pre_hook(
                 lambda m, args: seen.__setitem__("bn0", args[0].detach())),
             block.layer1.bn.register_forward_pre_hook(
                 lambda m, args: seen.__setitem__("bn1", args[0].detach())),
             block.layer1.register_forward_hook(
                 lambda m, args, out: seen.__setitem__("edges", out.detach()))]
    try:
        out = block(x, train)
    finally:
        for h in hooks:
            h.remove()
    stats = []
    for key in ("bn0", "bn1"):
        f = seen[key].float().reshape(-1, seen[key].shape[-1])
        m = f.mean(0)
        stats += [m, (f - m).square().mean(0)]
    return out, tuple(stats), seen["edges"]


def near_ties(torch, edges, rel: float = NEAR_TIE):
    """(exact, near): (B, N, C) masks of the (point, channel) pairs whose
    two largest values over k are equal, or within ``rel`` of the largest
    |value| of the tensor: there two roundings of the same product may
    route the max's gradient to different rows.  With one row per point
    (K = 1) there is no tie."""
    if edges.shape[2] < 2:
        none = torch.zeros(edges.amax(2).shape, dtype=torch.bool, device=edges.device)
        return none, none
    top = edges.topk(2, dim=2).values
    gap = top[:, :, 0] - top[:, :, 1]
    return gap == 0, gap <= rel * edges.abs().max()


def encoder_block_inputs(torch, model, x, train: bool):
    """The input of each EdgeConv block of the model's encoder, running the
    batch through the unfused blocks."""
    enc = model.features.encoder
    xs = [x]
    with torch.no_grad():
        for i in range(enc.n_edgeconv - 1):
            xs.append(getattr(enc, f"edgeconv{i}")(xs[-1], train))
    return [getattr(enc, f"edgeconv{i}") for i in range(enc.n_edgeconv)], xs


def edge_operands(torch, block, x):
    """What the block's fused route hands the kernels: the table a, the kNN
    idx, e_raw = a[idx] + b (in the block's compute type) and W1 (C_in,
    C_out)."""
    from r3dfsseg_tpu_torch.ops import cuda_knn
    from r3dfsseg_tpu_torch.ops.fast_gather import flat_take
    with torch.no_grad():
        idx = cuda_knn.knn(x, block.k)
        a, b = block.layer0.operands(x)
        e_raw = flat_take(a, idx) + b[:, :, None, :]
        return a, idx, e_raw, block.layer1.conv.weight.t().contiguous()


def check_gather(torch, gather_mod, operands):
    """Kernel 8 on the three support blocks' tables a (10, 2048, 64) and
    kNN idx: bit-equal to the plain version, f32 and on a bf16 copy."""
    tables = {"f32": [(a, idx) for a, idx, *_ in operands],
              "bf16": [(a.bfloat16(), idx) for a, idx, *_ in operands]}
    for kind, calls in tables.items():
        for a, idx in calls:
            got = gather_mod.gather_onehot(a, idx)
            if not torch.equal(got, gather_mod.gather_onehot_reference(a, idx)):
                raise AssertionError(f"gather {kind} {tuple(a.shape)}: kernel and plain differ")
        log(f"  gather {kind}: {len(calls)} tables {tuple(calls[0][0].shape)}, idx "
            f"{tuple(calls[0][1].shape)}: bit-equal")
    out = {}
    for kind, calls in tables.items():
        flats = []
        for a, idx in calls:
            off = (torch.arange(a.shape[0], device=a.device) * a.shape[1])[:, None, None]
            flats.append((a.reshape(-1, a.shape[-1]), (idx.long() + off).reshape(-1)))
        ms = cuda_ms(lambda: [gather_mod.gather_onehot(a, idx) for a, idx in calls], 10)
        plain = cuda_ms(lambda: [gather_mod.gather_onehot_reference(a, idx)
                                 for a, idx in calls], 10)
        lib = cuda_ms(lambda: [t.index_select(0, f) for t, f in flats], 10)
        nbytes = sum(a.element_size() * (idx.numel() * a.shape[-1] + a.numel())
                     + 4.0 * idx.numel() for a, idx in calls)
        out[kind] = row(0.0, ms, plain, lib, 0.0, nbytes)
    return {**out["f32"], **{f"{key}_bf16": v for key, v in out["bf16"].items()}}


FUSED_PRODUCTS = {"stats1": 1, "fwd": 1, "bwd1": 1, "bwd2": 3, "bwd3": 2}  # (C x C) per row


def fused_pass_args(torch, cfe, block, e, w1, dout, train: bool):
    """Each kernel-9 pass's arguments as `fused_edge_tail` builds them from
    the block's BatchNorms: batch statistics of e (train) or the running
    ones (eval); the backward's means from the plain sums (eval: zero).
    dout is zeroed on the (point, channel) pairs with a near-tie in the max
    (`near_ties`), where the kernel and cuBLAS may route the gradient to
    different rows; returns the arguments and the number zeroed."""
    from r3dfsseg_tpu_torch.ops import fused_edge
    l0, l1 = block.layer0, block.layer1
    g0, b0, g1, b1 = (t.detach() for t in (l0.bn.weight, l0.bn.bias, l1.bn.weight, l1.bn.bias))
    with torch.no_grad():
        if train:
            m0, v0, m1, v1 = fused_edge.edge_batch_stats(e, g0, b0, w1, "xla")
        else:
            m0, v0, m1, v1 = (l0.bn.running_mean, l0.bn.running_var, l1.bn.running_mean,
                              l1.bn.running_var)
        aff0, sh0, inv0 = fused_edge.bn_affines(g0, b0, m0, v0)
        aff1, sh1, inv1 = fused_edge.bn_affines(g1, b1, m1, v1)
        _, near = near_ties(torch, cfe.forward_chain(e, aff0, sh0, w1, aff1, sh1)[-1])
        dout = dout * ~near
        count = e.shape[0] * e.shape[1] * e.shape[2]
        zero = torch.zeros_like(m0)
        v1_args = (aff0, sh0, aff1, sh1, inv1, m1)
        r1, r2 = cfe.bwd1_reference(e, dout, *v1_args, w1)
        v2_args = v1_args + ((g1 * inv1,) + ((r1 / count, r2 / count) if train else (zero, zero))
                             + (inv0, m0))
        _, q1, q2 = cfe.bwd2_reference(e, dout, *v2_args, w1)
        v3_args = v2_args + ((g0 * inv0,) + ((q1 / count, q2 / count) if train else (zero, zero)))
    args = {"stats1": (e, aff0, sh0, w1), "fwd": (e, aff0, sh0, aff1, sh1, w1),
            "bwd1": (e, dout, *v1_args, w1), "bwd2": (e, dout, *v2_args, w1),
            "bwd3": (e, dout, *v3_args, w1)}
    if not train:
        del args["stats1"]                  # eval takes the running statistics
    return args, int(near.sum())


def fused_counts(cfe) -> dict:
    """Kernel 9's launch counters: per pass the tuned kernel's, of them its
    bf16 form's, and the general kernel's."""
    return {f"{pre}{p}": getattr(cfe, f"{pre}{p}_launches")
            for pre in ("", "bf16_", "general_") for p in cfe.PASSES}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


BF16_FLIP_SHARE = 1e-2  # entries of a bf16 d_e one bf16 step from the plain version's


def output_error(got, want, tol: float, what: str) -> tuple[float, int]:
    """(largest |got - want| / max |want|, entries flipped): fails past
    ``tol``.  A bf16 output (d_e on a bf16 e) is the rounding of an f32
    value within tol of the plain version's f32 value: where the two
    straddle a bf16 rounding edge they round one bf16 step apart, which
    may exceed tol, so such an entry counts as flipped and not in the
    error; at most BF16_FLIP_SHARE of the entries may flip, each by at
    most one step."""
    import torch
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    diff = (g - w).abs()
    flipped = 0
    if got.dtype == torch.bfloat16:
        off = diff > tol * scale
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        flipped = int(off.sum())
        if bool((diff[off] > step[off]).any()) or flipped > BF16_FLIP_SHARE * diff.numel():
            raise AssertionError(f"{what}: {flipped} bf16 entries past {tol} x {scale}, not all "
                                 f"one bf16 step from the plain version's")
        diff = diff.masked_fill(off, 0.0)
    e = diff.max().item()
    if not (np.isfinite(e) and e <= tol * scale):
        raise AssertionError(f"{what}: error {e} > {tol} x {scale}")
    return e / max(scale, 1e-30), flipped


def fused_pass_bytes(name: str, e) -> float:
    """Bytes a pass must move: e read once at its element size, dout
    (f32) for the backward passes, and the output (fwd f32, bwd3 at e's
    size; the sums are a few KB and not counted)."""
    c = e.shape[-1]
    rows, points = e.numel() / c, e.shape[0] * e.shape[1]
    return (e.element_size() * e.numel() + 4.0 * c * points * name.startswith("bwd")
            + (4.0 * c * points if name == "fwd" else 0.0)
            + (e.element_size() * c * rows if name == "bwd3" else 0.0))


def fused_pass_flops(name: str, e) -> float:
    c = e.shape[-1]
    return FUSED_PRODUCTS[name] * 2.0 * (e.numel() / c) * c * c


def check_fused_passes(torch, cfe, blocks, operands, seed):
    """Kernel 9's five passes on the three support blocks' e_raw (10, 2048,
    20, 64), in train and eval: stats1 and fwd within 1e-5 of each output's
    largest entry, each backward output within 1e-4 (f32 sums over 409,600
    edge rows in another order; a bf16 d_e as `output_error` allows).  The
    bound takes the products as three
    tf32 passes on the tensor cores, the peak of their type as for kernels
    1, 2 and 5 (the kernel runs them as FFMA, whose bound is printed
    beside).  On the bf16 encoder's e_raw (bf16
    operands) each pass runs the tuned kernel's bf16 form and is also bit
    for bit the f32 form on e's upcast (bwd3 after rounding to bf16).  Then
    each pass timed over the three blocks' train calls, beside its plain
    version and its bound (bytes at e's element size)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    bf16 = operands[0][2].dtype == torch.bfloat16
    kind = "bf16" if bf16 else "f32"
    err = {p: 0.0 for p in cfe.PASSES}
    rel = {p: 0.0 for p in cfe.PASSES}
    timed = []
    flips = 0
    for i, (blk, (_, _, e, w1)) in enumerate(zip(blocks, operands)):
        dout = torch.randn((*e.shape[:2], e.shape[-1]), generator=g, device="cuda")
        for train in (True, False):
            args, zeroed = fused_pass_args(torch, cfe, blk, e, w1, dout, train)
            worst = {}
            for name, a in args.items():
                before = fused_counts(cfe)
                got = _as_tuple(getattr(cfe, name)(*a))
                torch.cuda.synchronize()
                moved = {n: c - before[n] for n, c in fused_counts(cfe).items() if c != before[n]}
                if moved != ({name: 1, f"bf16_{name}": 1} if bf16 else {name: 1}):
                    raise AssertionError(f"fused_edge {kind} {name}: launches {moved}")
                want = _as_tuple(getattr(cfe, f"{name}_reference")(*a))
                if bf16:
                    up = _as_tuple(getattr(cfe, name)(a[0].float(), *a[1:]))
                    if not all(torch.equal(x, y.to(x.dtype)) for x, y in zip(got, up)):
                        raise AssertionError(f"fused_edge bf16 {name} block {i}: not the f32 "
                                             f"form's bits on e's upcast")
                tol = 1e-5 if name in ("stats1", "fwd") else 1e-4
                for x, y in zip(got, want):
                    r, n_flip = output_error(x, y, tol, f"fused_edge {kind} {name} block {i} "
                                                        f"train={train}")
                    flips += n_flip
                    err[name] = max(err[name], r * y.float().abs().max().item())
                    rel[name] = max(rel[name], r)
                    worst[name] = max(worst.get(name, 0.0), r)
            log(f"  fused_edge {kind} block {i} {'train' if train else 'eval'}: dout zeroed on "
                f"{zeroed} near-tie (point, channel) pairs; error / largest entry " +
                ", ".join(f"{n} {v:.2e}" for n, v in worst.items()) +
                ("; each pass bit-equal to the f32 form on e's upcast; d_e entries one bf16 "
                 f"step from the plain version's so far: {flips}" if bf16 else ""))
            if train:
                timed.append(args)
    passes = {}
    all_flops = all_bytes = 0.0
    for name in cfe.PASSES:
        kernel, plain = getattr(cfe, name), getattr(cfe, f"{name}_reference")
        ms = cuda_ms(lambda: [kernel(*a[name]) for a in timed], 10)
        plain_ms = cuda_ms(lambda: [plain(*a[name]) for a in timed], 10)
        flops = sum(fused_pass_flops(name, a[name][0]) for a in timed)
        nbytes = sum(fused_pass_bytes(name, a[name][0]) for a in timed)
        passes[name] = row(err[name], ms, plain_ms, None, 3 * flops, nbytes, TF32_TC_FLOPS,
                           max_rel_err=rel[name], bound_ffma_ms=bound(flops, nbytes)[0])
        all_flops, all_bytes = all_flops + flops, all_bytes + nbytes
    # the entry: the five passes' sums; its bound, the work of all five
    log(f"  fused_edge {kind} passes over the three blocks (train): " + ", ".join(
        f"{n} {p['ms']:.3f} ms (plain {p['plain_ms']:.3f}, bound {p['bound_ms']:.4f}, "
        f"FFMA {p['bound_ffma_ms']:.4f})" for n, p in passes.items()))
    return dict(row(max(err.values()), sum(p["ms"] for p in passes.values()),
                    sum(p["plain_ms"] for p in passes.values()), None, 3 * all_flops, all_bytes,
                    TF32_TC_FLOPS, bound_ffma_ms=bound(all_flops, all_bytes)[0]),
                passes=passes)


def fused_digest(torch, cfe, seed: int) -> dict:
    """Kernel 9's f32 form at the flagship support shape (10, 2048, 20, 64)
    on inputs drawn from ``seed``: a sha256 of each pass's output bits and
    its time (CUDA events), by the wrapper API every tree since the port
    began has, so that two trees' f32 kernels can be held bit for bit
    (run this file under each tree's root, see the module docstring)."""
    import hashlib
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    c = cfe.C

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device="cuda") * scale + shift

    e = randn(10, 2048, 20, c, scale=1.5, shift=0.5)
    dout = randn(10, 2048, c)
    w1 = randn(c, c, scale=c ** -0.5)
    pos = [randn(c, scale=0.2, shift=1.0).abs() for _ in range(6)]   # aff, inv, g*inv
    aff0, aff1, inv1, g1inv, inv0, g0inv = pos
    sh0, sh1, mu1, mr1, mr2, mu0, mq1, mq2 = (randn(c, scale=0.1) for _ in range(8))
    args = {"stats1": (e, aff0, sh0, w1), "fwd": (e, aff0, sh0, aff1, sh1, w1),
            "bwd1": (e, dout, aff0, sh0, aff1, sh1, inv1, mu1, w1),
            "bwd2": (e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0, w1),
            "bwd3": (e, dout, aff0, sh0, aff1, sh1, inv1, mu1, g1inv, mr1, mr2, inv0, mu0,
                     g0inv, mq1, mq2, w1)}
    out = {}
    for name, a in args.items():
        got = _as_tuple(getattr(cfe, name)(*a))
        h = hashlib.sha256()
        for t in got:
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[name] = dict(sha256=h.hexdigest()[:16],
                         ms=cuda_ms(lambda: getattr(cfe, name)(*a), 10))
        log(f"  fused_edge f32 {name}: sha256 {out[name]['sha256']}, {out[name]['ms']:.3f} ms")
    return out


def device_rows(prof, per: int) -> list:
    """[(kernel name, device ms, launches)] per ``per`` calls of a
    `torch.profiler` window, largest first: the device events without the
    annotations (`record_function` spans such as the optimizer's
    "Optimizer.step#Adam.step", which the profiler reports on the device
    too and whose span covers kernels counted on their own)."""
    rows = [(e.key, e.self_device_time_total / 1e3 / per, e.count // per)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def device_kernels(torch, fn, reps: int = 3):
    """`torch.profiler` over ``reps`` calls of fn(): [(kernel name, device
    ms per call)], largest first (the device's busy time, no host gaps)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(name, ms) for name, ms, _ in device_rows(prof, reps)]


def _close(a, b, rtol: float) -> float:
    """The largest |a - b| / (rtol * (|b| + max |b|)): at most 1 when a
    meets rtol with an atol of rtol times b's largest entry."""
    return ((a - b).abs() / (rtol * (b.abs() + b.abs().max()))).max().item()


# The fused route's gates against the block's own forward and backward
# (`fused_phase`).  On the float32 encoder the two compute the same chain in
# f32: outputs and m0, v0 at rtol 1e-5 (with an atol of 1e-5 of the largest
# entry), m1 and v1 at 1e-4 (v1 is the kernel's single-pass variance), the
# gradients within GRAD_TOL (relative L2), the cotangent zero where the max
# over k has its top two within NEAR_TIE of the largest |value|.
FUSED_F32_GATES = dict(out=1e-5, stats=(1e-5, 1e-5, 1e-4, 1e-4), grad=GRAD_TOL, near=NEAR_TIE)
# On the bf16 encoder both take the same bf16 e_raw = gather(a, idx) + b,
# so m0 and v0 agree as in f32.  Past it the bf16 block rounds h0 =
# leaky(BN0(e_raw)) and W1 to bf16 for its conv and l1 to bf16 after it,
# where the fused tail keeps all three in f32, as the archived tail does:
# each l1 differs by about 2^-8 of its size, which moves the outputs, m1
# and v1 by well under 1e-2 of their largest entry (bound BF16_ROUTE_RTOL,
# the JAX package's own bound on a bf16 layer's values,
# tests/test_backbone.py).  The block's bf16 backward rounds its cotangents
# to bf16 on the way (d_e too, as the fused tail does), and the train-mode
# BatchNorms cancel most of each sum, so its gradients sit a few 1e-2
# (relative L2) from the f32 tail's, most of all the first conv weight of
# block 0, whose 9 input channels sum the most rows: held to BF16_GRAD_TOL,
# the bound of the other bf16 gradient checks.  Two l1 rows within a bf16
# step of l1 of each other may take the max apart, so the cotangent is zero
# where the top two over k lie within 2^-9 of the largest |value|.
# `fused_phase` prints each measured value beside its bound.
BF16_ROUTE_RTOL = 2e-2
FUSED_BF16_GATES = dict(out=BF16_ROUTE_RTOL, stats=(1e-5, 1e-5, BF16_ROUTE_RTOL, BF16_ROUTE_RTOL),
                        grad=BF16_GRAD_TOL, near=2.0 ** -9)


def fused_phase(torch, blocks, xs, xq, kernels, seed, gates=FUSED_F32_GATES):
    """The fused route (`fused_edgeconv`) through all three EdgeConv blocks
    of the flagship encoder, float32 or bf16 (the blocks' own compute
    type), held against the blocks' own forward and backward with
    ``gates`` (FUSED_F32_GATES, FUSED_BF16_GATES).  Support batch (B = 10),
    train: outputs, m0 and v0 against the BatchNorms' batch statistics,
    m1 and v1, and the gradients of x and of the block's six parameters
    (relative L2 distance) under a random cotangent that is zero on the
    (point, channel) pairs with a near-tie in the max (`amax`'s backward
    splits a tie, the kernel routes it to the lowest k).  Query batch (B =
    2), eval: the outputs.  Each block launches kernel 8 once, and kernel
    9's tuned form (its bf16 form on the bf16 encoder) once per pass, and
    the general kernel no time; in train kernel 6 once (its bf16 form on
    the bf16 encoder).  Then both routes timed per block, forward (train)
    and forward plus backward, by CUDA events (host gaps included) and by
    the profiler (device busy time).  Returns the launch counts of the
    train run and of the eval run, the timings and the largest share of
    each gate measured."""
    from r3dfsseg_tpu_torch.ops import cuda_fused_edge as cfe
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16 = blocks[0].layer0.dtype == torch.bfloat16
    kind = "bf16" if bf16 else "f32"

    def grads(blk, x):
        return {"x": x.grad.clone(), **{n: p.grad.clone() for n, p in blk.named_parameters()}}

    want = []
    for blk, x in zip(blocks, xs):
        xu = x.clone().requires_grad_()
        blk.zero_grad(set_to_none=True)
        out, stats, edges = unfused_edgeconv(blk, xu, True)
        exact, near = near_ties(torch, edges, gates["near"])
        w = torch.randn(out.shape, generator=g, device="cuda") * ~near
        (out * w).sum().backward()
        want.append(dict(out=out.detach(), stats=stats, w=w, grads=grads(blk, xu),
                         ties=int(exact.sum()), near=int(near.sum())))
        del edges

    # the tuned kernel 9 (its bf16 form here on bf16 e_raw) once per pass a
    # block, the general kernel no time
    tuned = {f"fused_{p}": len(blocks) for p in cfe.PASSES}
    tuned.update({f"fused_{pre}{p}": len(blocks) if pre == "bf16_" and bf16 else 0
                  for pre in ("bf16_", "general_") for p in cfe.PASSES})

    # ---- the main path of this phase: the fused route, train, fwd + bwd
    zero_counts(kernels)
    got = []
    for blk, x, ref in zip(blocks, xs, want):
        xf = x.clone().requires_grad_()
        blk.zero_grad(set_to_none=True)
        out, stats = fused_edgeconv(blk, xf, True)
        (out * ref["w"]).sum().backward()
        got.append(dict(out=out.detach(), stats=stats, grads=grads(blk, xf)))
    torch.cuda.synchronize()
    launches = counts(kernels)
    want_train = {**tuned, "gather_onehot": len(blocks), "gather_onehot_narrow": 0,
                  "scatter_add": len(blocks), "scatter_add_bf16": len(blocks) if bf16 else 0}
    if any(launches[n] != c for n, c in want_train.items()):
        raise AssertionError(f"fused route {kind}, train: launches {launches}, want {want_train}")

    shares = dict(out=0.0, stats=0.0, grad=0.0, eval_out=0.0)
    for i, (ref, res) in enumerate(zip(want, got)):
        out_err = _close(res["out"], ref["out"], gates["out"])
        stat_err = [_close(a, b, tol) for a, b, tol in zip(res["stats"], ref["stats"],
                                                           gates["stats"])]
        dist = {n: ((res["grads"][n].float() - gr.float()).norm()
                    / gr.float().norm().clamp_min(1e-30)).item()
                for n, gr in ref["grads"].items()}
        worst = max(dist, key=dist.get)
        shares.update(out=max(shares["out"], out_err), stats=max(shares["stats"], *stat_err),
                      grad=max(shares["grad"], dist[worst] / gates["grad"]))
        log(f"  fused {kind} block {i} train (B = {ref['out'].shape[0]}): output at {out_err:.3f} "
            f"of its tolerance (rtol {gates['out']}); m0, v0, m1, v1 at " +
            ", ".join(f"{s:.3f}" for s in stat_err) +
            f" (rtol {gates['stats']}); gradients' largest relative L2 distance "
            f"{dist[worst]:.3e} ({worst}; bound {gates['grad']}); {ref['ties']} (point, channel) "
            f"pairs with a tied max over k, {ref['near']} within {gates['near']:.3g} of the "
            f"largest |value| (cotangent zero there)")
        if out_err > 1 or max(stat_err) > 1:
            raise AssertionError(f"fused {kind} block {i}: output {out_err}, statistics "
                                 f"{stat_err}")
        if dist[worst] > gates["grad"]:
            raise AssertionError(f"fused {kind} block {i}: gradient of {worst} at {dist[worst]}")

    zero_counts(kernels)
    for i, (blk, x) in enumerate(zip(blocks, xq)):
        with torch.no_grad():
            out_f = fused_edgeconv(blk, x, False)[0]
            out_u = blk(x, False)
        err = _close(out_f, out_u, gates["out"])
        shares["eval_out"] = max(shares["eval_out"], err)
        log(f"  fused {kind} block {i} eval (B = {x.shape[0]}): output at {err:.3f} of its "
            f"tolerance (rtol {gates['out']})")
        if err > 1:
            raise AssertionError(f"fused {kind} block {i} eval: output error {err}")
    torch.cuda.synchronize()
    launches_eval = counts(kernels)
    want_eval = {n: (c if n in ("fused_fwd", "fused_bf16_fwd") else 0) for n, c in tuned.items()}
    want_eval.update(gather_onehot=len(blocks), scatter_add=0)
    if any(launches_eval[n] != c for n, c in want_eval.items()):
        raise AssertionError(f"fused route {kind}, eval: launches {launches_eval}, "
                             f"want {want_eval}")

    times = []
    for i, (blk, x, ref) in enumerate(zip(blocks, xs, want)):
        xt = x.clone().requires_grad_()
        w = ref["w"]
        routes = {
            "fwd_fused": lambda: fused_edgeconv(blk, xt, True),
            "fwd_unfused": lambda: blk(xt, True),
            "fwd_bwd_fused": lambda: (fused_edgeconv(blk, xt, True)[0] * w).sum().backward(),
            "fwd_bwd_unfused": lambda: (blk(xt, True) * w).sum().backward()}
        t = {name: cuda_ms(fn, 10) for name, fn in routes.items()}
        busy = {name: device_kernels(torch, fn) for name, fn in routes.items()}
        t.update({f"busy_{name}": sum(ms for _, ms in b) for name, b in busy.items()})
        times.append(t)
        log(f"  fused {kind} block {i} (B = {x.shape[0]}, C_in = {x.shape[-1]}), ms by CUDA "
            f"events (device busy by the profiler): forward (train) fused {t['fwd_fused']:.3f} "
            f"({t['busy_fwd_fused']:.3f}) vs unfused {t['fwd_unfused']:.3f} "
            f"({t['busy_fwd_unfused']:.3f}); forward + backward fused {t['fwd_bwd_fused']:.3f} "
            f"({t['busy_fwd_bwd_fused']:.3f}) vs unfused {t['fwd_bwd_unfused']:.3f} "
            f"({t['busy_fwd_bwd_unfused']:.3f})")
        if i == 1:
            for name in ("fwd_bwd_fused", "fwd_bwd_unfused"):
                log(f"    {name} largest device times: " + "; ".join(
                    f"{ms:.3f} {k[:60]}" for k, ms in busy[name][:8]))
    return launches, launches_eval, times, shares


# ------------------------------------------------------------- probes --
def archive_cheby_problem(torch):
    """`scripts/archive/proto_cheby_pallas.py:main`'s problem: numpy
    default_rng(0), m = 4396, a = (a + a^T) / 2 uniform, S = a / sqrt(deg
    deg^T) rounded to bf16, b (4396, 3) with b[:200, 0] = 1."""
    m = 4396
    a = np.random.default_rng(0).random((m, m), dtype=np.float32)
    a = (a + a.T) * 0.5
    deg = a.sum(1)
    s = torch.from_numpy(a / np.sqrt(np.outer(deg, deg))).cuda().to(torch.bfloat16)
    b = torch.zeros((m, 3), device="cuda")
    b[:200, 0] = 1.0
    return s, b


def archive_probe_input(torch):
    """`scripts/archive/proto_cheby2.py:main`'s S: numpy default_rng(0), M =
    4480, uniform in [0, 1), rounded to bf16."""
    a = np.random.default_rng(0).random((4480, 4480), dtype=np.float32)
    return torch.from_numpy(a).cuda().to(torch.bfloat16)


def chain_ms(torch, fn, b, n: int = 10, reps: int = 3) -> float:
    """The archive's timing: ms per call over a chain of n calls, each fed
    the previous one's output; the best of ``reps`` chains (CUDA events)."""
    def chain():
        z = b
        for _ in range(n):
            z = fn(z)
    chain()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        chain()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def library_mm(torch, s, z):
    """One PyTorch call for kernel 11's matvec: bf16 S times bf16 z with f32
    output where this torch's `mm` takes `out_dtype`, else bf16 output.
    Returns (the call, its name)."""
    try:
        torch.mm(s[:8, :8], z[:8], out_dtype=torch.float32)
        return (lambda: torch.mm(s, z, out_dtype=torch.float32)), "torch.mm(out_dtype=float32)"
    except (TypeError, RuntimeError):
        return (lambda: torch.mm(s, z)), "torch.mm with bf16 output (no out_dtype in this torch)"


def step_sweep(torch, proto_mod, cheby_mod, s, b, alpha, iters, sizes=(1024, 2048, 3072, 4396)):
    """us per Chebyshev step of kernel 10 (as many rows of S kept on chip as
    fit, 16 rows per block, then none) and of kernel 7 on the leading (m,
    m) block of S, m from `sizes`: the difference of an `iters`-step and a
    2-step solve over iters - 2 steps (CUDA events), which takes out the
    launch and the set-up.  Shows what a step costs with S in registers and
    shared memory (all of it, at these sizes), with S partly and wholly read
    from L2, and with one launch per step."""
    out = {}
    for m in sizes:
        sm, bm = s[:m, :m].contiguous(), b[:m].contiguous()
        solves = {"kernel 10": proto_mod.proto_cheby_solve,
                  "kernel 10, 16 rows on chip": lambda *a: proto_mod.proto_cheby_solve(
                      *a, resident_rows=16),
                  "kernel 10, none on chip": lambda *a: proto_mod.proto_cheby_solve(
                      *a, resident_rows=0),
                  "kernel 7": cheby_mod.cheby_solve}
        out[m] = {name: (cuda_ms(lambda: f(sm, bm, alpha, iters), 20)
                         - cuda_ms(lambda: f(sm, bm, alpha, 2), 20)) / (iters - 2) * 1e3
                  for name, f in solves.items()}
        log(f"  m = {m} (S {2 * m * m / 1e6:.2f} MB): us per step " +
            ", ".join(f"{n} {v:.2f}" for n, v in out[m].items()))
    return out


def probe_phase(torch, proto_mod, cheby_mod, kernels, alpha: float = 0.99, iters: int = 50,
                probe_iters: int = 500):
    """The two archives' `main()` on the card.  The main path of this phase:
    kernel 10 on `archive_cheby_problem` (one solve), kernel 11 on the
    archive's input at 3 steps and on that S scaled by 1 / its row sums at
    500 steps (the archive's own input overflows f32 after about 12 steps),
    at PROBE_COLS columns of ones; counted, then checked: kernel 10 within
    1e-3 of max of its plain version (its distance from kernel 7's plain
    version, the archive's `_chebyshev_xla`, printed as the archive prints
    it), kernel 11 within PROBE_TOL of max of its plain version, and a
    second 500-step call at 128 columns bit for bit the first.  Then timed
    as the archives time them: kernel 10 and kernel 7 in ms per solve over a
    chain of 10, kernel 11 per 500-step call beside its plain version and
    500 single PyTorch matvecs, in us per matvec.  Returns the launch counts
    and the two kernels' probe rows."""
    s, b = archive_cheby_problem(torch)
    sp = archive_probe_input(torch)
    scaled = (sp.float() / sp.float().sum(1, keepdim=True)).to(torch.bfloat16)
    ones = {n: torch.ones((sp.shape[0], n), device="cuda") for n in PROBE_COLS}
    cases = [(n, steps, src) for n in ones for steps, src in ((3, sp), (probe_iters, scaled))]

    zero_counts(kernels)
    zp = proto_mod.proto_cheby_solve(s, b, alpha, iters)
    got = {(n, steps): proto_mod.matmul_only(src, ones[n], steps) for n, steps, src in cases}
    torch.cuda.synchronize()
    launches = counts(kernels)
    if launches["proto_cheby"] != 1 or launches["matmul_only"] != len(cases) or any(
            c for n, c in launches.items() if n not in ("proto_cheby", "matmul_only")):
        raise AssertionError(f"probe phase: launches {launches}")

    zx = cheby_mod.cheby_solve_reference(s, b, alpha, iters)
    rel_xla = ((zp - zx).abs().max() / (zx.abs().max() + 1e-30)).item()
    want = proto_mod.proto_cheby_solve_reference(s, b, alpha, iters)
    e10 = (zp - want).abs().max().item()
    rel10 = e10 / want.abs().max().item()
    log(f"  proto_cheby, the archive's problem (m = {s.shape[0]}, 3 columns, {iters} steps): "
        f"rel max err kernel 10 vs kernel 7's plain version (the archive's _chebyshev_xla): "
        f"{rel_xla:.3e}; vs its own plain version {rel10:.3e} of max (tolerance 1e-3)")
    if not (np.isfinite(e10) and rel10 <= 1e-3):
        raise AssertionError(f"proto_cheby on the archive's problem: {rel10} of max > 1e-3")
    t10 = chain_ms(torch, lambda z: proto_mod.proto_cheby_solve(s, z, alpha, iters), b)
    t7 = chain_ms(torch, lambda z: cheby_mod.cheby_solve(s, z, alpha, iters), b)
    for name, t in (("kernel 10", t10), ("kernel 7", t7)):
        log(f"  {name}: {t:.3f} ms/solve ({t / iters * 1e3:.1f} us/iter), chain of 10")
    proto_row = dict(max_abs_err=e10, max_rel_err=rel10, rel_err_vs_cheby_plain=rel_xla,
                     chain_ms=t10, us_per_step=t10 / iters * 1e3, cheby_chain_ms=t7,
                     step_us=step_sweep(torch, proto_mod, cheby_mod, s, b, alpha, iters))

    err = 0.0
    for (n, steps), x in got.items():
        src = sp if steps == 3 else scaled
        ref = proto_mod.matmul_only_reference(src, ones[n], steps)
        e, scale = (x - ref).abs().max().item(), ref.abs().max().item()
        tol = PROBE_TOL[steps]
        log(f"  matmul_only ncols={n:3d}, {steps} steps on the archive's S"
            f"{'' if steps == 3 else ' scaled by 1 / its row sums'}: max abs err {e:.3e}, "
            f"{e / scale:.3e} of max (tolerance {tol})")
        if not (np.isfinite(e) and e <= tol * scale):
            raise AssertionError(f"matmul_only ncols={n}, {steps} steps: {e} > {tol} x {scale}")
        if steps == probe_iters:
            err = max(err, e)
    again = proto_mod.matmul_only(scaled, ones[128], probe_iters)
    if not torch.equal(again, got[(128, probe_iters)]):
        raise AssertionError(f"matmul_only ncols=128, {probe_iters} steps: a second call differs")
    log(f"  matmul_only ncols=128, {probe_iters} steps: a second call bit-equal")
    cols = {}
    for n, b1 in ones.items():
        lib, lib_name = library_mm(torch, sp, b1.to(torch.bfloat16))
        ms = cuda_ms(lambda: proto_mod.matmul_only(sp, b1, probe_iters), 5)
        plain = cuda_ms(lambda: proto_mod.matmul_only_reference(sp, b1, probe_iters), 3)
        lib_ms = cuda_ms(lambda: [lib() for _ in range(probe_iters)], 3)
        m = sp.shape[0]
        cols[n] = row(0.0, ms, plain, lib_ms, probe_iters * 2.0 * m * m * n,
                      2.0 * m * m + 8.0 * m * n, peak=BF16_TC_FLOPS,
                      us_per_matvec=ms / probe_iters * 1e3,
                      library_us_per_matvec=lib_ms / probe_iters * 1e3, library=lib_name)
        log(f"  matmul_only ncols={n:3d}: {ms / probe_iters * 1e3:7.1f} us/matvec "
            f"({ms:.3f} ms per {probe_iters}-step call); plain {plain:.3f} ms; {lib_name} "
            f"{lib_ms / probe_iters * 1e3:7.1f} us/matvec; bound "
            f"{cols[n]['bound_ms']:.4f} ms ({cols[n]['bound_by']})")
    m = sp.shape[0]
    probe_row = row(err, sum(c["ms"] for c in cols.values()),
                    sum(c["plain_ms"] for c in cols.values()),
                    sum(c["library_ms"] for c in cols.values()),
                    sum(probe_iters * 2.0 * m * m * n for n in cols),
                    sum(2.0 * m * m + 8.0 * m * n for n in cols), peak=BF16_TC_FLOPS,
                    cols={str(n): c for n, c in cols.items()})
    return launches, proto_row, probe_row


PROBE_SWEEP_M = (2048, 3072, 4480, 6144, 8192)


def probe_sweep(torch, proto_mod, sizes=PROBE_SWEEP_M, cols=(8, 128), steps=(20, 220)):
    """Kernel 11's us per step against M, at `cols` columns of ones, on S
    uniform in [0, 2 / M) (row sums near 1, so acc stays finite): the
    difference of a 220-step and a 20-step call over 200 steps (CUDA
    events), which takes out the launch and the set-up, and S's bytes over
    that time.  S (2 M^2 bytes) would fit the 50 MB L2 up to M = 5000: a
    rate that holds across that size says S streams from device memory at
    every step; a rate that falls past it says L2 served S below."""
    g = torch.Generator(device="cuda").manual_seed(47)
    out = {}
    for m in sizes:
        s = (torch.rand((m, m), generator=g, device="cuda") * (2.0 / m)).to(torch.bfloat16)
        for n in cols:
            b = torch.ones((m, n), device="cuda")
            t0, t1 = (cuda_ms(lambda k=k: proto_mod.matmul_only(s, b, k), 5) for k in steps)
            us = (t1 - t0) / (steps[1] - steps[0]) * 1e3
            out[f"m{m}_c{n}"] = dict(us_per_step=us, s_tb_per_s=2.0 * m * m / us / 1e6)
            log(f"  matmul_only M = {m} (S {2 * m * m / 1e6:.2f} MB), {n} columns: "
                f"{us:.2f} us per step, S at {2.0 * m * m / us / 1e6:.3f} TB/s")
        del s
    return out


def probe_digest(torch, proto_mod, cheby_mod, alpha: float = 0.99, iters: int = 50,
                 probe_iters: int = 500) -> dict:
    """The Chebyshev probes' output bits and kernel 11's times, by the
    wrapper API every tree since kernel 11 took any column count has, so
    that two trees can be held bit for bit and timed in one call (run this
    file under each tree's root, see the module docstring): a sha256 of
    kernel 7's 50-step solve (`cuda_cheby.cheby_solve`) on
    `archive_cheby_problem`'s S at 3 columns (its b) and 8 (seeded normal),
    and of kernel 10's (`proto_cheby_solve`) at 3, 16 and 128 columns; then
    kernel 11's us per matvec at PROBE_DIGEST_COLS columns of ones on
    `archive_probe_input` (a 500-step call, CUDA events, the launches it
    took), its device time from the profiler and 500 `torch.mm` calls
    beside it, and `probe_sweep`."""
    import hashlib
    s, b3 = archive_cheby_problem(torch)
    m = s.shape[0]
    rng = np.random.default_rng(43)

    def normal(c):
        return torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32)).cuda()
    out = {}
    for name, fn, b in (("kernel7_c3", cheby_mod.cheby_solve, b3),
                        ("kernel7_c8", cheby_mod.cheby_solve, normal(8)),
                        ("kernel10_c3", proto_mod.proto_cheby_solve, b3),
                        ("kernel10_c16", proto_mod.proto_cheby_solve, normal(16)),
                        ("kernel10_c128", proto_mod.proto_cheby_solve, normal(128))):
        x = fn(s, b, alpha, iters)
        out[name] = hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
        log(f"  {name}: sha256 {out[name]}")
    sp = archive_probe_input(torch)
    mp = sp.shape[0]
    cols = {}
    for n in PROBE_DIGEST_COLS:
        ones = torch.ones((mp, n), device="cuda")

        def call():
            return proto_mod.matmul_only(sp, ones, probe_iters)
        before = proto_mod.matmul_only_launches
        call()
        torch.cuda.synchronize()
        launched = proto_mod.matmul_only_launches - before
        ms = cuda_ms(call, 5)
        dev = sum(v for k, v in device_kernels(torch, call, reps=2) if "matmul" in k)
        lib, lib_name = library_mm(torch, sp, ones.to(torch.bfloat16))
        lib_ms = cuda_ms(lambda: [lib() for _ in range(probe_iters)], 3)
        b_ms, by = bound(probe_iters * 2.0 * mp * mp * n, 2.0 * mp * mp + 8.0 * mp * n,
                         BF16_TC_FLOPS)
        cols[str(n)] = dict(launches_per_call=launched, ms=ms, device_ms=dev,
                            us_per_matvec=ms / probe_iters * 1e3,
                            device_us_per_matvec=dev / probe_iters * 1e3, library_ms=lib_ms,
                            library_us_per_matvec=lib_ms / probe_iters * 1e3, library=lib_name,
                            bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms)
        log(f"  matmul_only ncols={n:3d} ({launched} launch per call): "
            f"{ms / probe_iters * 1e3:7.2f} us/matvec (device {dev / probe_iters * 1e3:7.2f}; "
            f"{ms:.3f} ms per {probe_iters}-step call); {lib_name} "
            f"{lib_ms / probe_iters * 1e3:7.2f} us/matvec; bound {b_ms:.4f} ms ({by})")
    out["matmul_only"] = cols
    out["sweep"] = probe_sweep(torch, proto_mod)
    return out


# ------------------------------------------------------------ serving --
SERVE_KERNELS = ("knn", "attention_fwd", "fps", "kth")


def counts(kernels) -> dict:
    return {n: getattr(mod, attr) for n, (mod, attr) in kernels.items()}


def zero_counts(kernels) -> None:
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)


def serve(torch, cfg, episodes, kernels, seed, required=SERVE_KERNELS):
    """Serve every episode on the kernel path, then on the plain path with
    the same weights (under knn_impl 'pallas' its kNN is the packed mode's
    plain version); return latencies, predictions and launch counts.
    Every request must launch each kernel in ``required``, and FPS exactly
    twice (one cooperative launch per call: the ways and the background)."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.ops import cuda_knn
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
        if min(grew[n] for n in required) <= 0 or grew["fps"] != 2:
            raise AssertionError(f"request {i}: launches {grew}")
        preds.append(pred)
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    plain_knn = dgcnn.knn_indices
    if cfg.knn_impl == "pallas":         # the packed mode's plain path
        dgcnn.knn_indices = cuda_knn.knn_packed_reference
    try:
        plain.predict(*episodes[0][:3])
        plain_lat, plain_preds = [], []
        for ep in episodes:
            t0 = time.perf_counter()
            plain_preds.append(plain.predict(*ep[:3]))
            torch.cuda.synchronize()
            plain_lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        dgcnn.knn_indices = plain_knn
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

    def __init__(self, torch, knn_mod, dgcnn_mod, packed: bool = False):
        self.torch, self.knn_mod, self.dgcnn_mod = torch, knn_mod, dgcnn_mod
        self.packed = packed
        self.recorded, self.swapped = [], []

    def record(self):
        kernel = self.knn_mod.knn

        def knn(x, k, **kw):
            out = kernel(x, k, **kw)
            self.recorded.append(out.clone())
            return out
        self.knn_mod.knn = knn
        return kernel

    def replay(self):
        """Under ``packed`` (knn_impl 'pallas') the plain path's kNN is the
        packed mode's plain version: at most PACKED_MISMATCH of the rows
        may differ, each explained by the rounding of the distances
        (`packed_agreement`)."""
        saved = self.dgcnn_mod.knn_indices
        plain = self.knn_mod.knn_packed_reference if self.packed else saved
        queue = list(self.recorded)

        def knn_indices(x, k):
            want, rec = plain(x, k).long(), queue.pop(0).long()
            if self.packed:
                a = packed_agreement(self.torch, self.knn_mod, x, rec, want)
                self.swapped.append(int(round(a["mismatch"] * x.shape[0] * x.shape[1])))
                if a["unexplained"] or a["mismatch"] > PACKED_MISMATCH:
                    raise AssertionError(f"packed kNN kernel and plain differ beyond rounding: "
                                         f"{a}")
                return rec.to(self.torch.int32)
            rows = (want.sort(-1).values != rec.sort(-1).values).any(-1)
            self.swapped.append(int(rows.sum()))
            if bool(rows.any()):
                gap = knn_agreement(self.torch, x, rec, want)["gap"]
                if gap > NEAR_TIE:
                    raise AssertionError(f"kNN kernel and plain differ beyond a tie: {gap}")
            return rec.to(self.torch.int32)
        self.dgcnn_mod.knn_indices = knn_indices
        return saved


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


@contextlib.contextmanager
def plain_attention_as_kernels(attn_mod):
    """The plain attention versions with bf16 q scaled as the kernels scale
    it, q * bf16(1 / tau), where the model's plain path divides by
    bf16(tau) as the JAX package's XLA path does.  The two scalings agree
    where 1 / tau is a power of two; at D = 320 they part by enough to move
    a bf16-encoder step's gradients past BF16_ENC_CARD_GRAD_TOL, whichever
    kernels compute the attention (`train` logs both distances; PERF.md,
    section 6)."""
    names = ("attention_reference", "attention_fwd_reference", "attention_bwd_reference")
    saved = {n: getattr(attn_mod, n) for n in names}
    try:
        for n, f in saved.items():
            setattr(attn_mod, n, functools.partial(f, kernel_scale=True))
        yield
    finally:
        for n, f in saved.items():
            setattr(attn_mod, n, f)


def train(torch, cfg, episodes, kernels, seed, required, per_step=None, steps=TRAIN_STEPS,
          plain_kernel_scale=False):
    """One kernel-path and one plain-path step from the same weights and
    generator seed, on the same kNN graphs (`KnnReplay`), compared (with
    ``plain_kernel_scale`` the plain attention scales q as the kernels do:
    `plain_attention_as_kernels`); then
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
    from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_cheby, cuda_knn

    fast = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
    plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")

    def plain_scale():
        return (plain_attention_as_kernels(cuda_attention) if plain_kernel_scale
                else contextlib.nullcontext())
    plain = MPTILearner(plain_cfg, "cuda", torch.Generator().manual_seed(seed))
    for (n, a), b in zip(fast.model.state_dict().items(), plain.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"the two learners start from different weights at {n}")

    # ---- step 1 on both paths
    replay = KnnReplay(torch, cuda_knn, dgcnn, packed=cfg.knn_impl == "pallas")
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
        with plain_scale():
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
    bf16_enc = cfg.compute_dtype == "bfloat16"
    loss_rtol = BF16_ENC_LOSS_RTOL if bf16_enc else 1e-4
    for key in ("loss", "lp_loss", "contrast_loss"):
        a, b = m_fast[key].item(), m_plain[key].item()
        log(f"  step 1 {key}: kernels {a:.7f}, plain {b:.7f}, rel diff "
            f"{abs(a - b) / max(abs(b), 1e-30):.3e}")
        if not (np.isfinite(a) and abs(a - b) <= loss_rtol * abs(b)):
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
    if plain_kernel_scale:
        # beside it, ungated: the model's own plain path, whose q / bf16(tau)
        # parts from the kernels' q * bf16(1 / tau)
        own = MPTILearner(plain_cfg, "cuda", torch.Generator().manual_seed(seed))
        plain_knn = replay.replay()
        try:
            own.train(episodes[0])
        finally:
            dgcnn.knn_indices = plain_knn
        d = _rel_distances(g_fast, _grads(own.model), zero)
        tau = cfg.output_dim ** 0.5
        apart = abs(1.0 - cuda_attention.bf16_value(1 / tau) * cuda_attention.bf16_value(tau))
        log(f"  step 1 gradients, kernel path vs the plain path with q / bf16(tau) (scores "
            f"{apart:.2e} apart; not gated): largest relative L2 distance "
            f"{max(d.values()):.3e}, median {statistics.median(d.values()):.3e}")
    if cfg.graph_bf16:
        exact = MPTILearner(plain_cfg, "cuda", torch.Generator().manual_seed(seed))
        plain_knn, reference_solve = replay.replay(), cuda_cheby.cheby_solve_reference
        cuda_cheby.cheby_solve_reference = exact_solve(cuda_cheby)
        try:
            with plain_scale():
                exact.train(episodes[0])
        finally:
            dgcnn.knn_indices = plain_knn
            cuda_cheby.cheby_solve_reference = reference_solve
        g_exact = _grads(exact.model)
        for name, g in (("kernel", g_fast), ("plain", g_plain)):
            d = _rel_distances(g, g_exact, zero)
            log(f"  step 1 gradients, {name} path vs the exact-solve path: largest relative "
                f"L2 distance {max(d.values()):.3e}, median {statistics.median(d.values()):.3e}")
    tol = BF16_ENC_CARD_GRAD_TOL if bf16_enc else BF16_GRAD_TOL if cfg.graph_bf16 else GRAD_TOL
    if rel[worst] > tol:
        raise AssertionError(f"step 1 gradient of {worst}: relative distance {rel[worst]} > {tol}")
    if bf16_enc:
        glob = (sum(float((g_fast[n] - g_plain[n]).square().sum()) for n in rel)
                / sum(float(g_plain[n].square().sum()) for n in rel)) ** 0.5
        log(f"  step 1 gradients: relative L2 distance over all parameters {glob:.3e}")
        if glob > BF16_ENC_CARD_GLOBAL_TOL:
            raise AssertionError(f"step 1 gradients: relative distance {glob} over all "
                                 f"parameters > {BF16_ENC_CARD_GLOBAL_TOL}")
    # bf16 cotangents leave those zero-gradient biases bf16 noise
    if noise > (1e-2 if bf16_enc else 1e-5) * top:
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
    rows = device_rows(prof, steps)
    kernel_ms = sum(r[1] for r in rows)
    log(f"[profile] {steps} training steps: {wall / steps:.2f} ms per step (wall, profiled); "
        f"device busy {kernel_ms:.2f} ms per step ({kernel_ms / (wall / steps):.1%}); "
        f"largest device times per step:")
    for name, ms, n in rows[:top]:
        log(f"  {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    for what, key in (("attention kernels (2, 5)", "attn_"), ("kNN kernel (1)", "knn_kernel"),
                      ("FPS kernel (3)", "fps_kernel"), ("scatter-add kernel (6)", "scatter_add"),
                      ("Chebyshev kernel (7)", "cheby_kernel"),
                      ("general and packed kNN (1)", "knn_general"),
                      ("general scatter-add, its sum pass (6)", "sum_kernel")):
        mine = [r for r in rows if key in r[0]]
        log(f"[profile] {what}: {sum(r[1] for r in mine):.3f} ms per step")
        for name, ms, n in mine:
            log(f"  {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    fps_calls = sum(n for name, _, n in rows if "fps_kernel" in name)
    if fps_calls != 3:
        raise AssertionError(f"profile: {fps_calls} FPS kernels per step, not 3 (one per call)")
    # kernel 7: one cooperative launch per solve, the forward and the adjoint
    cheby_calls = sum(n for name, _, n in rows if "cheby_kernel" in name)
    if cheby_calls != (2 if learner.cfg.graph_bf16 else 0):
        raise AssertionError(f"profile: {cheby_calls} Chebyshev kernels per step")


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
    lowp = torch.bfloat16 if cfg.graph_bf16 else None
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
    split; return the kernel path's predictions, launch counts and peak
    memory."""
    graph = describe(cfg)
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
    log(f"[serve] {graph}: {len(lat)} requests; median latency "
        f"{statistics.median(lat):.2f} ms (kernels) vs {statistics.median(plain_lat):.2f} ms "
        f"(plain); peak memory {peak / 2**20:.1f} MiB; launches {launches}")
    stages = stage_breakdown(torch, model, cfg, episodes[0])
    log(f"[stages] {graph}, kernel path, device ms per request (median of 5): " +
        ", ".join(f"{n} {t:.3f}" for n, t in stages.items()) +
        f"; sum {sum(stages.values()):.3f}")
    return preds, launches, peak


def train_phase(torch, cfg, episodes, kernels, seed, required, per_step=None,
                steps=TRAIN_STEPS, plain_kernel_scale=False):
    """`train` with its log lines."""
    graph = describe(cfg)
    log(f"[train] {graph}: meta-training step, kernel path vs plain path, then "
        f"{steps} kernel-path steps")
    tr = train(torch, cfg, episodes, kernels, seed, required, per_step, steps, plain_kernel_scale)
    log(f"[train] {graph}: median step {tr['step_ms']:.2f} ms (host clock, "
        f"synchronised); device ms per step: " +
        ", ".join(f"{n} {t:.3f}" for n, t in tr["stages"].items()) +
        f"; peak memory {tr['peak'] / 2**20:.1f} MiB; launches over {steps} steps "
        f"{tr['launches']}")
    return tr


# ------------------------------------------------------------- parity --
FIXTURES = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", f)
                 for f in ("reference_parity.npz", "reference_parity_cfg2.npz"))
# the golden fixtures' gates, as tests/test_torch_reference_parity.py holds
# the plain path on the CPU (the JAX package's own tolerances)
FIXTURE_GATES = {"features": (2e-4, 1e-3), "logits": (2e-3, 2e-3), "lp_loss": (1e-4, 1e-4),
                 "contrast_loss": (5e-4, 5e-4)}
FIXTURE_SOLVERS = {"solve": {}, "cheby150": dict(lp_solver="cheby", lp_cg_iters=150,
                                                  lp_adjoint_iters=0)}
# (phase key, label, the modes, the gradient gate) of the flagship checkpoint runs
PARITY_RUNS = (("topk_solve", "topk + solve, float32 graph",
                dict(affinity_impl="topk", lp_solver="solve"), GRAD_TOL),
               ("topk_cg", "topk + cg, float32 graph",
                dict(affinity_impl="topk", lp_solver="cg"), GRAD_TOL),
               ("topk_cheby_bf16", "topk + cheby, bf16 graph (kernel 7 on bf16(S))",
                dict(affinity_impl="topk", lp_solver="cheby", graph_dtype="bfloat16"),
                BF16_GRAD_TOL))
PARITY_KERNELS = ("knn", "attention_fwd", "fps", "attention_bwd", "scatter_add")


def expect_parity_launches(launched: dict, bf16_graph: bool, what: str) -> None:
    """Kernels 1, 2, 3, 5 and 6 launched, kernel 4 not (the top-k select
    takes no radius), kernel 7 on the bf16 graph only."""
    missing = [n for n in PARITY_KERNELS if launched[n] <= 0]
    if missing or launched["kth"] or bool(launched["cheby"]) != bf16_graph:
        raise AssertionError(f"{what}: launches {launched}")


def fixture_config(meta):
    """A golden fixture's model, as tests/test_reference_parity.py:48-61
    builds it, with every kernel on (the `*_impl` defaults)."""
    from r3dfsseg_tpu_torch.config import R3DConfig
    return R3DConfig(
        n_way=meta["n_way"], k_shot=meta["k_shot"], n_queries=1, pc_npts=meta["pc_npts"],
        dgcnn_k=meta["dgcnn_k"], edgeconv_widths=tuple(tuple(w) for w in meta["edgeconv_widths"]),
        dgcnn_mlp_widths=tuple(meta["dgcnn_mlp_widths"]), base_widths=tuple(meta["base_widths"]),
        output_dim=meta["output_dim"], n_subprototypes=meta["n_subprototypes"],
        k_connect=meta["k_connect"], sigma=meta["sigma"], proj_dim=128, attn_dropout=0.0,
        use_attention=meta.get("use_attention", True), lp_solver="solve",
        affinity_impl="topk", compute_dtype="float32", contrast_fps_k=4)


@contextlib.contextmanager
def knn_near_ties(torch, knn_mod, swapped: list):
    """Hold each kNN kernel call against the plain version on the same x:
    a row whose neighbour set differs must be a rounding-level tie (gap <=
    NEAR_TIE of xx_i + xx_j); the count of such rows per call goes to
    ``swapped``.  The kernel's lists are kept."""
    from r3dfsseg_tpu_torch.ops.knn import knn_indices
    kernel = knn_mod.knn

    def knn(x, k, **kw):
        got = kernel(x, k, **kw)
        want = knn_indices(x.float(), k).long()
        rows = (got.long().sort(-1).values != want.sort(-1).values).any(-1)
        swapped.append(int(rows.sum()))
        if swapped[-1]:
            gap = knn_agreement(torch, x.float(), got.long(), want)["gap"]
            if gap > NEAR_TIE:
                raise AssertionError(f"fixture replay: kNN kernel and plain differ beyond a "
                                     f"tie: {gap}")
        return got
    knn_mod.knn = knn
    try:
        yield
    finally:
        knn_mod.knn = kernel


def _gate(what: str, got: np.ndarray, want: np.ndarray, atol: float, rtol: float) -> float:
    """The largest share of the allclose bound atol + rtol |want| that
    |got - want| takes; raises past 1."""
    share = float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())
    if not share <= 1.0:
        raise AssertionError(f"{what}: {share:.3f} of the tolerance (atol {atol}, rtol {rtol})")
    return share


def fixture_replay(torch, kernels) -> dict:
    """Replay the golden fixtures' four episodes (f0, f1; g0, g1 without
    attention) on the card with the kernels on, the original model's
    weights loaded by the port's key map, under the CPU test's gates:
    eval features, the MDNS flags (exact), the logits in eval without and
    with MDNS and in training, lp_loss, the contrast loss and every
    parameter's gradient of lp_loss + 0.1 contrast_loss (rtol 5e-3, atol
    max(5e-3 x the leaf's scale, 1e-5 x the largest gradient)), each with
    the dense solve and with Chebyshev-150.  Returns the largest share of
    each gate, the launches and the kNN rows kept at a near-tie."""
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.models.mpti import mdns_keep_mask
    from r3dfsseg_tpu_torch.ops import cuda_knn
    from r3dfsseg_tpu_torch.utils.torch_convert import key_map

    shares = {k: 0.0 for k in ("features", "logits", "lp_loss", "contrast_loss", "gradients")}
    swapped: list = []
    zero_counts(kernels)
    for path in FIXTURES:
        data = np.load(path)
        meta = json.loads(bytes(data["meta"]).decode())
        sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
        for name in meta["fixtures"]:
            g = lambda f: data[f"{name}/ep/{f}"]  # noqa: E731
            ep = Episode(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()[None] for a in (
                g("support_x").transpose(0, 1, 3, 2), g("support_y").astype(np.int64),
                g("query_x").transpose(0, 2, 1), g("query_y").astype(np.int64),
                g("gt_support_y").astype(np.int64), g("gt_query_y").astype(np.int64),
                g("support_flag").astype(np.int64))))
            for solver, kw in FIXTURE_SOLVERS.items():
                learner = MPTILearner(fixture_config(meta).replace(**kw), "cuda")
                learner.load_torch_state(sd)
                model = learner.model
                with knn_near_ties(torch, cuda_knn, swapped), torch.no_grad():
                    sf, _ = model.extract_features(ep)
                    _, flags = mdns_keep_mask(sf[0], ep.support_y[0] > 0,
                                              ep.support_x[0, ..., :3], model.cfg.mdns_scales)
                    outs = {mode: model(ep, train=mode == "train", eval_mdns=mode == "eval_mdns")
                            for mode in ("eval_plain", "eval_mdns", "train")}
                what = f"fixture {name} ({solver})"
                shares["features"] = max(shares["features"], _gate(
                    f"{what} features", sf[0].cpu().numpy(),
                    data[f"{name}/support_feat_eval"].transpose(0, 1, 3, 2),
                    *FIXTURE_GATES["features"]))
                if not np.array_equal(flags.cpu().numpy(), data[f"{name}/eval_mdns/clean_flag"]):
                    raise AssertionError(f"{what}: MDNS flags {flags.cpu().numpy()}")
                for mode, out in outs.items():
                    checks = [("logits", out.query_logits[0].cpu().numpy(),
                               data[f"{name}/{mode}/logits"].transpose(0, 2, 1)),
                              ("lp_loss", out.lp_loss.item(), data[f"{name}/{mode}/lp_loss"])]
                    if mode == "train":
                        checks.append(("contrast_loss", out.contrast_loss.item(),
                                       data[f"{name}/train/contrast_loss"]))
                    for key, got, want in checks:
                        shares[key] = max(shares[key], _gate(
                            f"{what} {mode} {key}", np.asarray(got), np.asarray(want),
                            *FIXTURE_GATES[key]))
                # the training loss's gradients, each leaf at its own scale
                with knn_near_ties(torch, cuda_knn, swapped):
                    out = model(ep, train=True)
                    (out.lp_loss + 0.1 * out.contrast_loss).backward()
                prefix = f"{name}/train_grads/"
                to_torch = {port: key for key, (port, _) in key_map(model).items()}
                params = dict(model.named_parameters())
                want = {n: np.asarray(data[prefix + to_torch[n]]).reshape(tuple(p.shape))
                        if prefix + to_torch[n] in data.files else np.zeros(tuple(p.shape))
                        for n, p in params.items()}
                gmax = max(float(np.abs(w).max()) for w in want.values())
                for n, p in params.items():
                    got = np.zeros(tuple(p.shape)) if p.grad is None else p.grad.cpu().numpy()
                    scale = max(float(np.abs(want[n]).max()), 1e-12)
                    shares["gradients"] = max(shares["gradients"], _gate(
                        f"{what} gradient of {n}", got, want[n],
                        max(5e-3 * scale, 1e-5 * gmax), 5e-3))
    launched = counts(kernels)
    expect_parity_launches(launched, False, "fixture replay")
    log(f"[parity] golden fixtures f0, f1, g0, g1 on the card, kernels on, solve and "
        f"Chebyshev-150: every gate held; largest share of each: " +
        ", ".join(f"{k} {v:.3f}" for k, v in shares.items()) +
        f"; MDNS flags equal; kNN rows kept at a near-tie {sum(swapped)} in {len(swapped)} "
        f"calls; launches {launched}")
    return dict(shares=shares, launches=launched, knn_near_tie_rows=sum(swapped))


def parity_graph_times(torch, model, cfg, episode) -> dict:
    """Device ms (CUDA events, median of 5) of the top-k select, the dense
    solve and CG-50 with their f32 products, and kernel 7 on bf16(S), on a
    served flagship episode's graph, with the graph's shape."""
    from r3dfsseg_tpu_torch.models import mpti
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.ops import lp

    sx, sy, qx = (torch.as_tensor(a).cuda() for a in episode[:3])
    with torch.inference_mode():
        sf, qf = model.extract_features(Episode(sx[None], sy[None], qx[None], None))
        sf, qf = sf[0], qf[0].reshape(-1, sf.shape[-1])
        fg = sy > 0
        keep, _ = mpti.mdns_keep_mask(sf, fg, sx[..., :3], cfg.mdns_scales)
        protos, pvalid, labels, _ = mpti.episode_graph_nodes(sf, fg & (keep[..., None] > 0.5),
                                                             fg, cfg)
        node = torch.cat([protos, qf])
        valid = torch.cat([pvalid, torch.ones(len(qf), dtype=torch.bool, device=qf.device)])
        b = torch.cat([labels, torch.zeros((len(qf), cfg.n_classes), device=qf.device)])
        _, sel = lp.graph_distances(node, valid)
        a = lp.local_constrained_affinity(node, cfg.k_connect, cfg.sigma, valid=valid,
                                          impl="topk")
        times = {"topk_select": cuda_ms(lambda: lp.exact_topk_select(sel, cfg.k_connect), 5),
                 "dense_solve": cuda_ms(lambda: lp.label_propagate(
                     a, b, cfg.lp_alpha, solver="solve"), 5),
                 "cg": cuda_ms(lambda: lp.label_propagate(
                     a, b, cfg.lp_alpha, solver="cg", cg_iters=cfg.lp_cg_iters), 5),
                 "cheby_bf16": cuda_ms(lambda: lp.label_propagate(
                     a, b, cfg.lp_alpha, solver="cheby", cg_iters=cfg.lp_cg_iters,
                     matvec_dtype=torch.bfloat16), 5)}
        z = {s: lp.label_propagate(a, b, cfg.lp_alpha, solver=s, cg_iters=cfg.lp_cg_iters)
             for s in ("solve", "cg")}
    rel = ((z["cg"] - z["solve"]).abs().max() / z["solve"].abs().max()).item()
    return dict(times, nodes=len(node), valid=int(valid.sum()), cg_vs_solve=rel)


def parity_runs(torch, episodes, kernels, seed) -> dict:
    """The seeded flagship model written as a `checkpoint.tar` by
    `save_reference_checkpoint`, served by `FewShotPredictor.from_checkpoint`
    (2 requests) and trained one step in each of PARITY_RUNS, on the kernel
    path and on the plain path (`*_impl="xla"`) from the same file, on the
    same kNN graphs in training (`KnnReplay`): labels >= 99% per request,
    step-1 losses rtol 1e-4, each gradient within the mode's relative L2
    gate; then a second kernel-path step, timed.  The kernel path's
    requests and steps must launch kernels 1, 2, 3, 5 and 6, not kernel 4,
    and kernel 7 only on the bf16 graph (`expect_parity_launches`)."""
    import tempfile

    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.ops import cuda_knn
    from r3dfsseg_tpu_torch.serve import FewShotPredictor
    from r3dfsseg_tpu_torch.utils.torch_convert import save_reference_checkpoint

    cfg0 = R3DConfig()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.tar")
        save_reference_checkpoint(path, MPTILearner(cfg0, "cuda",
                                                    torch.Generator().manual_seed(seed)).model)
        log(f"[parity] the seeded flagship model as {os.path.basename(path)}: "
            f"{os.path.getsize(path) / 2**20:.2f} MiB")
        for key, label, kw, grad_tol in PARITY_RUNS:
            cfg = cfg0.replace(**kw)
            plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")
            fast = FewShotPredictor.from_checkpoint(tmp, cfg, device="cuda")
            plain = FewShotPredictor.from_checkpoint(path, plain_cfg, device="cuda")
            fast.predict(*episodes[0][:3])                 # warm-up: first allocations
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(kernels)
            lat, agree = [], []
            for ep in episodes[:2]:
                t0 = time.perf_counter()
                pred = fast(*ep[:3])
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                launched = counts(kernels)
                agree.append(float((pred == plain(*ep[:3])).mean()))
                if counts(kernels) != launched:
                    raise AssertionError(f"{label}: the plain path launched a kernel")
            serve_peak = torch.cuda.max_memory_allocated()
            if min(agree) < 0.99:
                raise AssertionError(f"{label}: kernel and plain paths agree on {agree}")

            torch.cuda.reset_peak_memory_stats()
            replay = KnnReplay(torch, cuda_knn, dgcnn)
            kernel_knn = replay.record()
            try:
                t0 = time.perf_counter()
                m_fast = fast._learner.train(episodes[0])
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
            finally:
                cuda_knn.knn = kernel_knn
            step_peak = torch.cuda.max_memory_allocated()
            launched = counts(kernels)
            plain_knn = replay.replay()
            try:
                m_plain = plain._learner.train(episodes[0])
            finally:
                dgcnn.knn_indices = plain_knn
            torch.cuda.synchronize()
            if counts(kernels) != launched:
                raise AssertionError(f"{label}: the plain training path launched a kernel")
            losses = {}
            for name in ("loss", "lp_loss", "contrast_loss"):
                a, b = m_fast[name].item(), m_plain[name].item()
                losses[name] = abs(a - b) / max(abs(b), 1e-30)
                if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
                    raise AssertionError(f"{label}: step 1 {name}: kernel path {a} vs plain {b}")
            g_fast, g_plain = _grads(fast._learner.model), _grads(plain._learner.model)
            if set(g_fast) != set(g_plain):
                raise AssertionError(f"{label}: the paths have gradients for other parameters")
            zero = {n for n in g_plain if n.endswith(".conv.bias")}   # feed train-mode BNs
            top = max(g.abs().max().item() for g in g_plain.values())
            noise = max(max(g_fast[n].abs().max().item(), g_plain[n].abs().max().item())
                        for n in zero)
            rel = _rel_distances(g_fast, g_plain, zero)
            worst = max(rel, key=rel.get)
            if rel[worst] > grad_tol or noise > 1e-5 * top:
                raise AssertionError(f"{label}: step 1 gradient of {worst}: {rel[worst]} > "
                                     f"{grad_tol}, zero-gradient biases at {noise / top}")
            t0 = time.perf_counter()                       # a second, steady step
            m2 = fast._learner.train(episodes[1])
            torch.cuda.synchronize()
            step2_ms = (time.perf_counter() - t0) * 1e3
            if not all(np.isfinite(v.item()) for v in m2.values()):
                raise AssertionError(f"{label}: step 2 metrics {m2}")
            launched = counts(kernels)
            expect_parity_launches(launched, cfg.graph_bf16, label)
            out[key] = dict(
                request_ms=lat, step_ms=step_ms, step2_ms=step2_ms, agreement=agree, serve_peak=serve_peak,
                step_peak=step_peak, launches=launched, loss_rel=losses, grad_worst=rel[worst],
                grad_median=statistics.median(rel.values()), knn_swapped=replay.swapped)
            log(f"[parity] {label}, from checkpoint.tar: requests {', '.join(f'{t:.2f}' for t in lat)} "
                f"ms, labels agree with the plain path on {', '.join(f'{x:.4f}' for x in agree)}; "
                f"step 1 {step_ms:.2f} ms, step 2 {step2_ms:.2f} ms, losses within {max(losses.values()):.2e} (rtol), "
                f"gradients: largest relative L2 {rel[worst]:.3e} ({worst}), median "
                f"{out[key]['grad_median']:.3e} (gate {grad_tol}); peak memory request "
                f"{serve_peak / 2**20:.1f} MiB, step {step_peak / 2**20:.1f} MiB; kNN rows "
                f"at a near-tie {replay.swapped}; launches {launched}")
        times = parity_graph_times(torch, fast._learner.model, cfg0, episodes[0])
    log(f"[parity] device ms on a served flagship graph ({times['nodes']} nodes, "
        f"{times['valid']} valid, k_connect {cfg0.k_connect}): top-k select "
        f"{times['topk_select']:.3f}, dense solve {times['dense_solve']:.3f}, CG-"
        f"{cfg0.lp_cg_iters} {times['cg']:.3f}, Chebyshev-{cfg0.lp_cg_iters} on bf16(S) "
        f"(kernel 7) {times['cheby_bf16']:.3f}; CG vs the dense solve {times['cg_vs_solve']:.2e} "
        f"of max |z|")
    return dict(runs=out, graph_ms=times)


def parity_phase(torch, episodes, kernels, seed) -> dict:
    """Phase 7: `fixture_replay`, then `parity_runs`."""
    return dict(fixtures=fixture_replay(torch, kernels),
                **parity_runs(torch, episodes, kernels, seed))


# ---------------------------------------------------------------- CLIs --
CLI_ITERS = 24          # training episodes of the CLI phase
CLI_EVAL_INTERVAL = 12  # its validation interval
CLI_EPISODE_TEST = 2    # cached episodes per class pair (15 pairs of fold 0's test classes)
CLI_WORKERS = 4         # loader threads
CLI_LOADER_EPISODES = 16  # episodes of the loader-alone rate
CLI_TRAIN_KERNELS = ("knn", "attention_fwd", "fps", "kth", "attention_bwd", "scatter_add")
CLI_EVAL_KERNELS = ("knn", "attention_fwd", "fps", "kth")


def pin_and_copy_ms(torch, episodes, busy: bool) -> dict:
    """Host ms per episode of `loader.to_device`'s two parts, its fields
    copied into pinned memory and the non-blocking copies submitted, on an
    idle card or with about 60 ms of matmuls queued before each episode
    (as a training step keeps the card busy when the loop fetches the next
    batch)."""
    a = torch.rand(8192, 8192, device="cuda")
    c = torch.empty_like(a)
    pin, submit = [], []
    for ep in episodes:
        torch.cuda.synchronize()
        if busy:
            for _ in range(4):
                torch.mm(a, a, out=c)
        t = time.perf_counter()
        pinned = [torch.as_tensor(x).pin_memory() for x in ep if x is not None]
        t1 = time.perf_counter()
        for x in pinned:
            x.to("cuda", non_blocking=True)
        submit.append(time.perf_counter() - t1)
        pin.append(t1 - t)
    torch.cuda.synchronize()
    return {"pin_ms": 1e3 * statistics.median(pin), "submit_ms": 1e3 * statistics.median(submit)}


def cli_phase(torch, kernels, seed) -> dict:
    """Phase 4f: the port's two CLIs end to end at full flagship width on a
    synthetic dataset (see the module docstring); returns their launch
    counts and figures."""
    import tempfile

    from r3dfsseg_tpu_torch import eval_noise, mpti_train_noise, native
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.data.episodes import NoisyEpisodeSampler
    from r3dfsseg_tpu_torch.data.loader import EpisodeLoader, to_device
    from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.utils.torch_convert import load_checkpoint_blob, torch_state_of

    with tempfile.TemporaryDirectory(prefix="r3d_cli_") as tmp:
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(os.path.join(tmp, "blocks"), n_scans=40, pts_per_scan=4096,
                                    seed=seed)
        if native.assemble_scan() is None:
            raise AssertionError("the native episode assembly did not build")
        cfg = R3DConfig(clean_data_path=ds, n_iters=CLI_ITERS, eval_interval=CLI_EVAL_INTERVAL,
                        n_episode_test=CLI_EPISODE_TEST, n_workers=CLI_WORKERS,
                        save_path=tmp, log_dir=os.path.join(tmp, "run"))
        log(f"[cli] {describe(cfg)}: {cfg.n_way}-way {cfg.k_shot}-shot, {cfg.pc_npts} points, "
            f"{CLI_ITERS} training episodes, validation every {CLI_EVAL_INTERVAL} on "
            f"{CLI_EPISODE_TEST} episodes a class pair, {CLI_WORKERS} loader threads")
        zero_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        st = mpti_train_noise.train(cfg, device="cuda")
        train_s = time.perf_counter() - t
        train_launches = counts(kernels)
        train_peak = torch.cuda.max_memory_allocated()

        ckpt = os.path.join(cfg.log_dir, "checkpoint.tar")
        if not os.path.exists(ckpt):
            raise AssertionError(f"training wrote no {ckpt} (best validation IoU "
                                 f"{st['best_iou']})")
        blob = load_checkpoint_blob(ckpt)
        sd, encoder_only = torch_state_of(blob)
        if encoder_only or not blob["optimizer_state_dict"]:
            raise AssertionError(f"{ckpt}: not a full checkpoint with its Adam state")
        MPTILearner(cfg, "cuda").load_torch_state(sd)
        losses = np.asarray(st["losses"])
        if len(losses) != CLI_ITERS or not np.isfinite(losses).all():
            raise AssertionError(f"training losses: {losses}")

        # the first training episodes, drawn from the samplers for the seed:
        # worker 0 after the learner-init draw, then workers seeded
        # seed + 1000 + w, taken in turn
        kw = dict(mode="train", num_point=cfg.pc_npts, k_shot=cfg.k_shot,
                  noise_ratio=list(cfg.train_noise_ratio), noise_type="train")
        workers = [NoisyEpisodeSampler(ds, cfg.dataset, seed=cfg.seed, **kw)]
        workers[0].sample()
        workers += [NoisyEpisodeSampler(ds, cfg.dataset, seed=cfg.seed + 1000 + w, **kw)
                    for w in range(CLI_WORKERS - 1)]
        first = [workers[i % CLI_WORKERS].sample() for i in range(mpti_train_noise.DIGEST_EPISODES)]
        want = mpti_train_noise.episodes_sha256(first)
        if st["episodes_sha256"] != want:
            raise AssertionError(f"the first training episodes' sha256 {st['episodes_sha256']} "
                                 f"!= the samplers' {want}")

        ecfg = cfg.replace(phase="mptinoise_eval", noise_ratio=0.4, noise_type="ood",
                           model_checkpoint_path=cfg.log_dir)
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        miou = eval_noise.evaluate(ecfg, device="cuda")
        eval_s = time.perf_counter() - t
        eval_launches = counts(kernels)
        eval_peak = torch.cuda.max_memory_allocated()
        if not 0.0 <= miou <= 1.0:
            raise AssertionError(f"mean IoU {miou}")
        text = open(os.path.join(cfg.log_dir, "log_mptinoise_eval.txt")).read()
        found = re.findall(r"eval throughput: ([0-9.]+) episodes/s", text)
        if not found or "mdns_precision" not in text:
            raise AssertionError("the eval log has no throughput or MDNS line")
        eval_eps = float(found[-1])

        # the same loop on one loader thread (half the episodes, no
        # validation), to hold its wait per step against the threads' above
        one = mpti_train_noise.train(
            cfg.replace(n_workers=1, n_iters=CLI_ITERS // 2, eval_interval=CLI_ITERS,
                        log_dir=os.path.join(tmp, "one_thread")), device="cuda")

        # the loader alone, with no step to share the host with: episodes/s
        # of CLI_WORKERS threads and of one, and the pinned copy to the card
        samplers = mpti_train_noise.train_samplers(cfg)
        rates = {}
        for n_workers in (CLI_WORKERS, 1):
            t = time.perf_counter()
            eps = list(EpisodeLoader(None, num_batches=CLI_LOADER_EPISODES,
                                     worker_fns=[w.sample for w in samplers[:n_workers]]))
            rates[n_workers] = len(eps) / (time.perf_counter() - t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for ep in eps:
            to_device(ep, "cuda")
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t) / len(eps) * 1e3
        pin_copy = {"idle": pin_and_copy_ms(torch, eps, busy=False),
                    "busy": pin_and_copy_ms(torch, eps, busy=True)}
        phase_s = time.perf_counter() - t0

    for what, launched, required, absent in (
            ("train", train_launches, CLI_TRAIN_KERNELS, ()),
            ("evaluate", eval_launches, CLI_EVAL_KERNELS, ("attention_bwd", "scatter_add"))):
        if min(launched[n] for n in required) <= 0 or any(launched[n] for n in absent) or any(
                launched[n] for n in launched if n not in required):
            raise AssertionError(f"cli {what}: launches {launched}")
    figures = dict(train_episodes_per_s=st["episodes_per_s"], step_ms_median=st["step_ms_median"],
                   loader_wait_ms_median=st["loader_wait_ms_median"],
                   loader_wait_ms_mean=st["loader_wait_ms_mean"],
                   loader_queue_ms_median=st["loader_queue_ms_median"], train_s=train_s,
                   validation_s=st["eval_s"], train_peak_mib=train_peak / 2**20,
                   eval_episodes_per_s=eval_eps, eval_s=eval_s, eval_peak_mib=eval_peak / 2**20,
                   best_valid_iou=st["best_iou"], test_miou=miou, phase_s=phase_s,
                   episodes_sha256=st["episodes_sha256"],
                   loader_alone_episodes_per_s={str(k): v for k, v in rates.items()},
                   pinned_copy_ms=copy_ms, pin_copy_ms=pin_copy,
                   one_thread={k: one[k] for k in ("episodes_per_s", "step_ms_median",
                                                   "loader_wait_ms_median",
                                                   "loader_queue_ms_median")})
    log(f"[cli] train: {CLI_ITERS} episodes in {train_s:.2f} s (validation {st['eval_s']:.2f} s): "
        f"{st['episodes_per_s']:.2f} episodes/s without validation; median step "
        f"{st['step_ms_median']:.2f} ms (host clock); loader wait per step median "
        f"{st['loader_wait_ms_median']:.3f} ms, mean {st['loader_wait_ms_mean']:.3f} ms (on the "
        f"loader's queue: median {st['loader_queue_ms_median']:.3f} ms); peak "
        f"memory {train_peak / 2**20:.1f} MiB; losses {losses.min():.4f}-{losses.max():.4f}; "
        f"best validation IoU {st['best_iou']:.4f}; launches {train_launches}")
    log(f"[cli] first {mpti_train_noise.DIGEST_EPISODES} training episodes' sha256 "
        f"{st['episodes_sha256']} (equal to the samplers')")
    log(f"[cli] evaluate (ood 0.4, MDNS): mean IoU {miou:.4f}; {eval_eps:.2f} episodes/s (the "
        f"CLI's line); {eval_s:.2f} s with the test set's build; peak memory "
        f"{eval_peak / 2**20:.1f} MiB; launches {eval_launches}")
    log(f"[cli] train on one loader thread ({CLI_ITERS // 2} episodes, no validation): "
        f"{one['episodes_per_s']:.2f} episodes/s; median step {one['step_ms_median']:.2f} ms; "
        f"wait per step median {one['loader_wait_ms_median']:.3f} ms (on the loader's queue "
        f"{one['loader_queue_ms_median']:.3f} ms)")
    log(f"[cli] the loader alone (no step running): {rates[CLI_WORKERS]:.1f} episodes/s on "
        f"{CLI_WORKERS} threads, {rates[1]:.1f} on one; an episode's pinned copy to the card "
        f"{copy_ms:.3f} ms with a synchronise; median host ms of its two parts, copying into "
        f"pinned memory and submitting the copies: idle card {pin_copy['idle']['pin_ms']:.3f} + "
        f"{pin_copy['idle']['submit_ms']:.3f}, busy card {pin_copy['busy']['pin_ms']:.3f} + "
        f"{pin_copy['busy']['submit_ms']:.3f}; phase {phase_s:.1f} s")
    return dict(train=train_launches, eval=eval_launches, figures=figures)


# --------------------------------------------------------- pretraining --
PRETRAIN_STEPS = 20     # steps of the pretraining run (phase 4g)
PRETRAIN_BATCH = 16     # clouds a step, the JAX pretraining's default
PRETRAIN_TIMED = 5      # timed steps after it, host clock
# each pretraining step's launches: kNN and the scatter-add once per
# EdgeConv block, the f32 wide attention pair once (dg_atten_dim 128)
PRETRAIN_PER_STEP = {"knn": 3, "attention_wide_tf32_fwd": 1, "attention_wide_tf32_bwd": 1,
                     "scatter_add": 3}
RESUME_LOSSES = ("loss", "lp_loss", "contrast_loss")
RESUME_REPEATS = 4      # default-mode steps from the .tar again, for the spread


def watch_encoder_install(mpti_train_noise, torch_convert) -> dict:
    """Wrap the meta-training CLI's `make_learner` so that the learner it
    builds is kept (``learner``) and its feature extractor is exported the
    moment a pretrained trunk is installed into it (``init``); calling
    ``restore`` undoes the wrap."""
    seen = {}
    real = mpti_train_noise.make_learner

    def make_learner(cfg, device=None):
        learner = real(cfg, device)
        install = learner.load_encoder_state

        def load_encoder_state(state):
            install(state)
            # a copy: on the CPU the export's tensors are the live parameters
            seen["init"] = {k: v.clone() for k, v in
                            torch_convert.export_feature_extractor(learner.model.features).items()}
        learner.load_encoder_state = load_encoder_state
        seen["learner"] = learner
        return learner

    mpti_train_noise.make_learner = make_learner
    seen["restore"] = lambda: setattr(mpti_train_noise, "make_learner", real)
    return seen


def pretrain_step_check(torch, cfg, model, batch, kernels, seed) -> dict:
    """One pretraining step on the kernel path and one on the plain path
    (knn_impl and attn_impl "xla") from ``model``'s weights on the same
    batch and generator seed, on the same kNN graphs (`KnnReplay`): losses
    rtol 1e-4; each gradient within a relative L2 distance of GRAD_TOL,
    times sqrt(D / 64) for the attention's maps as phase 4c gates the wide
    pair; the segmenter's second conv bias, whose exact gradient is 0
    (it feeds a train-mode BatchNorm), below 1e-5 of the largest gradient
    entry; the kernel step launches PRETRAIN_PER_STEP and nothing else, the
    plain step nothing.  ``model`` takes the kernel path's step."""
    from r3dfsseg_tpu_torch import pretrain as pre
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.ops import cuda_knn

    plain = pre.seg_model(cfg.replace(knn_impl="xla", attn_impl="xla"),
                          model.seg_out.out_features).cuda()
    plain.load_state_dict(model.state_dict())
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
            for m in (model, plain)]
    x, y = batch
    replay = KnnReplay(torch, cuda_knn, dgcnn)
    zero_counts(kernels)
    kernel_knn = replay.record()
    try:
        loss_k, acc_k = pre.pretrain_step(model, opts[0], x, y, torch.Generator().manual_seed(seed))
    finally:
        cuda_knn.knn = kernel_knn
    torch.cuda.synchronize()
    launched = counts(kernels)
    plain_knn = replay.replay()
    try:
        loss_p, acc_p = pre.pretrain_step(plain, opts[1], x, y, torch.Generator().manual_seed(seed))
    finally:
        dgcnn.knn_indices = plain_knn
    torch.cuda.synchronize()
    if counts(kernels) != launched:
        raise AssertionError(f"the plain pretraining step launched a kernel: {counts(kernels)}")
    want = {n: PRETRAIN_PER_STEP.get(n, 0) for n in kernels}
    if launched != want:
        raise AssertionError(f"pretraining step 1: launches {launched}, want {want}")
    a, b = loss_k.item(), loss_p.item()
    rel_loss = abs(a - b) / abs(b)
    if not (np.isfinite(a) and rel_loss <= 1e-4):
        raise AssertionError(f"pretraining step 1 loss: kernel path {a} vs plain path {b}")
    g_k, g_p = _grads(model), _grads(plain)
    zero = {"seg1.conv.bias"}
    top = max(g.abs().max().item() for g in g_p.values())
    noise = max(max(g_k[n].abs().max().item(), g_p[n].abs().max().item()) for n in zero)
    rel = _rel_distances(g_k, g_p, zero)
    d = model.att_learner.q_map.out_features
    tol = {n: GRAD_TOL * max((d / 64) ** 0.5, 1.0) if n.startswith("att_learner.") else GRAD_TOL
           for n in rel}
    worst = max(rel, key=lambda n: rel[n] / tol[n])
    log(f"  step 1 kNN rows where the plain path took the kernel path's near-tie choice, per "
        f"call: {replay.swapped}")
    log(f"  step 1 loss: kernels {a:.7f}, plain {b:.7f}, rel diff {rel_loss:.3e}; accuracy "
        f"{acc_k.item():.4f} / {acc_p.item():.4f}")
    log(f"  step 1 gradients: {len(rel)} parameters, largest relative L2 distance "
        f"{rel[worst]:.3e} ({worst}, limit {tol[worst]:.2e}); median "
        f"{statistics.median(rel.values()):.3e}; the zero-gradient bias at "
        f"{noise / top:.3e} of the largest entry")
    if rel[worst] > tol[worst] or noise > 1e-5 * top:
        raise AssertionError(f"pretraining step 1 gradients: {worst} {rel[worst]} > "
                             f"{tol[worst]}, or the zero-gradient bias at {noise / top}")
    return dict(loss_rel_diff=rel_loss, grad_rel_max=rel[worst], grad_rel_max_param=worst,
                grad_rel_median=statistics.median(rel.values()), knn_swapped=replay.swapped,
                optimizer=opts[0])


def pretrain_attention_times(torch, attn_mod, seed) -> dict:
    """The f32 wide pair at a pretraining step's shape, (16, 2048, 128),
    rate 0.1: CUDA events around the forward and the backward (kernels and
    plain versions) and SDPA's memory-efficient backend.  (Its device time
    is the profiled step's.)"""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dy = (torch.randn(PRETRAIN_BATCH, 2048, 128, device="cuda", generator=g)
                   for _ in range(4))
    tau, rate = 128 ** 0.5, 0.1
    y, lse = attn_mod.attention_fwd(q, k, v, tau, rate, seed)
    return attention_times(torch, attn_mod, [(q, k, v, dy, seed, y, lse)], tau, rate, sdpa,
                           reps=5)


def pretrain_phase(torch, kernels, episodes, seed) -> dict:
    """Phase 4g: encoder pretraining at full width (see the module
    docstring); returns the pretraining run's launch counts and figures."""
    import tempfile

    from r3dfsseg_tpu_torch import mpti_train_noise, pretrain as pre
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.nn.dgcnn import init_linear_weights
    from r3dfsseg_tpu_torch.ops import cuda_attention
    from r3dfsseg_tpu_torch.serve import FewShotPredictor
    from r3dfsseg_tpu_torch.utils import checkpoint, torch_convert

    with tempfile.TemporaryDirectory(prefix="r3d_pretrain_") as tmp:
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(os.path.join(tmp, "blocks"), n_scans=40, pts_per_scan=4096,
                                    seed=seed)
        cfg = R3DConfig(clean_data_path=ds, n_iters=PRETRAIN_STEPS, save_path=tmp,
                        log_dir=os.path.join(tmp, "pretrain"), seed=seed)
        log(f"[pretrain] {describe(cfg)}: {PRETRAIN_BATCH} clouds of {cfg.pc_npts} points a "
            f"step, attention {cfg.dg_atten_dim} wide (f32), dropout 0.3 and 0.1, "
            f"{PRETRAIN_STEPS} steps")
        # ---- the pretraining run: the main path of this phase
        zero_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = pre.pretrain(cfg, batch_size=PRETRAIN_BATCH, device="cuda")
        run_s = time.perf_counter() - t
        launches = counts(kernels)
        run_peak = torch.cuda.max_memory_allocated()
        want = {n: PRETRAIN_PER_STEP.get(n, 0) * PRETRAIN_STEPS for n in kernels}
        if launches != want:
            raise AssertionError(f"pretraining run: launches {launches}, want {want}")
        text = open(os.path.join(cfg.log_dir, "log_pretrain.txt")).read()
        losses = [float(v) for v in re.findall(r"\[Pretrain\] Iter \d+ \| loss ([-0-9.naif]+)",
                                               text)]
        accs = [float(v) for v in re.findall(r"\| acc ([-0-9.naif]+)", text)]
        found = re.findall(r"== throughput: ([0-9.]+) clouds/s", text)
        if len(losses) != PRETRAIN_STEPS // 10 or not np.isfinite(losses).all() or not found:
            raise AssertionError(f"pretraining log: losses {losses}, throughput {found}")
        run_clouds_s = float(found[-1])
        blob = torch.load(out, map_location="cpu", weights_only=True)
        if set(blob) != {"params"} or "att_learner.q_map.weight" not in blob["params"]:
            raise AssertionError(f"{out}: not the original pretraining schema")

        # ---- one step against the plain path, then timed steps and a profile
        classes, scans = pre.pretrain_scans(cfg)
        stream = pre.batch_stream(cfg, PRETRAIN_BATCH, classes, scans)
        next(stream)
        batch = tuple(torch.from_numpy(a).cuda() for a in next(stream))
        model = pre.seg_model(cfg, len(classes) + 1)
        init_linear_weights(model, torch.Generator().manual_seed(seed))
        model.cuda()
        check = pretrain_step_check(torch, cfg, model, batch, kernels, seed)
        opt = check.pop("optimizer")
        gen = torch.Generator().manual_seed(seed + 1)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(PRETRAIN_TIMED):
            before = counts(kernels)
            t = time.perf_counter()
            loss, _ = pre.pretrain_step(model, opt, *batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            grew = {n: c - before[n] for n, c in counts(kernels).items()}
            if grew != {n: PRETRAIN_PER_STEP.get(n, 0) for n in kernels} or \
                    not np.isfinite(loss.item()):
                raise AssertionError(f"timed pretraining step: launches {grew}, loss {loss}")
        step_peak = torch.cuda.max_memory_allocated()
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                pre.pretrain_step(model, opt, *batch, gen)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / 2
        rows = device_rows(prof, 2)
        busy = sum(r[1] for r in rows)
        wide = {part: sum(r[1] for r in rows if f"attn_wide_tf32_{part}" in r[0])
                for part in ("fwd", "bwd", "delta")}
        by_kernel = {key: sum(r[1] for r in rows if key in r[0])
                     for key in ("knn_kernel", "scatter_add")}
        log(f"[pretrain] profiled step: {wall:.2f} ms (wall, profiled); device busy {busy:.2f} "
            f"ms ({busy / wall:.1%}); the wide pair {sum(wide.values()):.3f} ms (forward "
            f"{wide['fwd']:.3f}, backward {wide['bwd']:.3f} + Delta {wide['delta']:.3f}); kNN "
            f"{by_kernel['knn_kernel']:.3f}, scatter-add {by_kernel['scatter_add']:.3f}; "
            f"largest device times per step:")
        for name, ms, n in rows[:10]:
            log(f"  {ms:8.3f} ms  x{n:<4d} {name[:90]}")
        attn = pretrain_attention_times(torch, cuda_attention, seed)

        # ---- finetune from the .tar, then meta-train from it
        ft = cfg.replace(phase="finetune", pretrain_checkpoint_path=out, n_iters=2,
                         log_dir=os.path.join(tmp, "finetune"))
        pre.pretrain(ft, batch_size=PRETRAIN_BATCH, device="cuda")
        if "finetune: loaded encoder" not in open(os.path.join(ft.log_dir,
                                                               "log_finetune.txt")).read():
            raise AssertionError("finetune did not load the encoder")
        mt = R3DConfig(clean_data_path=ds, n_iters=4, eval_interval=4, n_episode_test=1,
                       n_workers=2, pretrain_checkpoint_path=out, save_path=tmp,
                       log_dir=os.path.join(tmp, "metatrain"), seed=seed)
        seen = watch_encoder_install(mpti_train_noise, torch_convert)
        try:
            st = mpti_train_noise.train(mt, device="cuda")
        finally:
            seen.pop("restore")()
        text = open(os.path.join(mt.log_dir, "log_mptitrain.txt")).read()
        if "Load encoder module" not in text or not np.isfinite(st["losses"]).all():
            raise AssertionError(f"meta-training from the pretrained encoder: {st['losses']}")
        # the trunk of the learner that the run trained: the artifact's as it
        # was installed, and moved by the run's 4 steps
        if "init" not in seen:
            raise AssertionError("meta-training installed no pretrained trunk")
        end = torch_convert.export_feature_extractor(seen["learner"].model.features)
        trunk = {k: v for k, v in blob["params"].items()
                 if not k.startswith("att_learner.") and not k.endswith("num_batches_tracked")}
        if not trunk or any(not torch.equal(seen["init"]["encoder." + k], v)
                            for k, v in trunk.items()):
            raise AssertionError("the meta-training encoder is not the artifact's at init")
        if all(torch.equal(end["encoder." + k], v) for k, v in trunk.items()):
            raise AssertionError("meta-training did not move the pretrained trunk")

        # ---- the .msgpack path: the seeded flagship learner after 2 steps
        fcfg = R3DConfig()
        learner = MPTILearner(fcfg, "cuda", torch.Generator().manual_seed(seed))
        for ep in episodes[:2]:
            learner.train(ep)
        paths = {"msgpack": os.path.join(tmp, "msgpack", "checkpoint.msgpack"),
                 "tar": os.path.join(tmp, "tar", "checkpoint.tar")}
        checkpoint.save_checkpoint(paths["msgpack"], learner, iteration=2)
        os.makedirs(os.path.dirname(paths["tar"]))
        torch_convert.save_reference_checkpoint(paths["tar"], learner.model, iteration=2,
                                                optimizer=learner.optimizer)
        sizes = {k: os.path.getsize(p) for k, p in paths.items()}
        served, resumers = {}, {}
        for key, path in paths.items():
            p = FewShotPredictor.from_checkpoint(os.path.dirname(path), fcfg, device="cuda")
            served[key] = [p.predict(*ep[:3]) for ep in episodes[:2]]
            resumers[key] = MPTILearner(fcfg, "cuda", torch.Generator().manual_seed(seed + 2))
            checkpoint.restore(path, resumers[key])
        if any(not np.array_equal(a, b) for a, b in zip(served["msgpack"], served["tar"])):
            raise AssertionError("the .msgpack and the .tar serve different labels")
        # the two resumed states bit for bit: weights, statistics, Adam, StepLR
        a, b = resumers["msgpack"], resumers["tar"]
        sa, sb = a.model.state_dict(), b.model.state_dict()
        pb = dict(b.model.named_parameters())
        same = all(torch.equal(sa[k], sb[k]) for k in sb) and all(
            all(torch.equal(a.optimizer.state[p][m], b.optimizer.state[pb[n]][m])
                for m in ("step", "exp_avg", "exp_avg_sq"))
            for n, p in a.model.named_parameters()) and \
            a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
        if not same:
            raise AssertionError("the states resumed from the .msgpack and the .tar differ")
        # one step from each state.  The card's step is not bit-reproducible
        # (PERF.md section 7): the steps whose losses are held bit-equal run
        # under torch.use_deterministic_algorithms; the default mode's steps,
        # from each file and RESUME_REPEATS more from the .tar, are recorded
        def resumed_step(path):
            r = MPTILearner(fcfg, "cuda", torch.Generator().manual_seed(seed + 2))
            checkpoint.restore(path, r)
            return {k: v.item() for k, v in r.train(episodes[2]).items() if k in RESUME_LOSSES}

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                det = [resumed_step(paths[k]) for k in ("msgpack", "tar", "tar")]
        finally:
            torch.use_deterministic_algorithms(False)
        det_warned = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        if det[0] != det[1] or det[2] != det[1]:
            raise AssertionError(f"deterministic steps resumed from the .msgpack {det[0]}, the "
                                 f".tar {det[1]} and the .tar again {det[2]} differ")
        default = [resumed_step(paths[k]) for k in ("msgpack", "tar")] + \
            [resumed_step(paths["tar"]) for _ in range(RESUME_REPEATS)]

        def rel(x, y):
            return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for k in RESUME_LOSSES)
        loss_diff = rel(default[0], default[1])
        repeat_diffs = [rel(r, default[1]) for r in default[2:]]
        phase_s = time.perf_counter() - t0

    step_ms = statistics.median(times)
    figures = dict(run_s=run_s, run_clouds_per_s=run_clouds_s, losses=losses, accuracies=accs,
                   run_peak_mib=run_peak / 2**20, step_ms_median=step_ms, step_ms=times,
                   clouds_per_s_steady=PRETRAIN_BATCH / step_ms * 1e3,
                   step_peak_mib=step_peak / 2**20, profiled_step_ms=wall, device_busy_ms=busy,
                   device_busy_share=busy / wall, wide_pair_device_ms=wide,
                   knn_device_ms=by_kernel["knn_kernel"],
                   scatter_add_device_ms=by_kernel["scatter_add"], attention_b16=attn,
                   metatrain_losses=st["losses"], checkpoint_bytes=sizes,
                   resume_deterministic_losses=det[1], resume_deterministic_warned=det_warned,
                   resume_loss_rel_diff=loss_diff, resume_repeat_rel_diffs=repeat_diffs,
                   phase_s=phase_s, **check)
    log(f"[pretrain] run: {PRETRAIN_STEPS} steps in {run_s:.2f} s with the first; "
        f"{run_clouds_s:.1f} clouds/s from the end of the first step (the CLI's line); "
        f"losses {losses}, accuracies {accs}; peak memory {run_peak / 2**20:.1f} MiB; "
        f"launches {launches}")
    log(f"[pretrain] timed steps (host clock, synchronised): median {step_ms:.2f} ms "
        f"({PRETRAIN_BATCH / step_ms * 1e3:.1f} clouds/s), {['%.2f' % t for t in times]}; "
        f"peak memory of a step {step_peak / 2**20:.1f} MiB")
    log(f"[pretrain] the f32 wide pair at (16, 2048, 128), rate 0.1, CUDA events: forward "
        f"{attn['fwd']:.3f} ms (plain {attn['fwd_plain']:.3f}, SDPA {attn['lib_fwd']:.3f}); "
        f"backward {attn['bwd']:.3f} ms (plain {attn['bwd_plain']:.3f}, SDPA "
        f"{attn['lib_bwd']:.3f})")
    log(f"[pretrain] finetune 2 steps and meta-training 4 episodes from the .tar: losses "
        f"{['%.4f' % v for v in st['losses']]}; the .msgpack ({sizes['msgpack']} bytes) and the "
        f".tar ({sizes['tar']}) serve equal labels on 2 requests and resume to bit-equal states "
        f"whose next steps give bit-equal losses under deterministic algorithms ({det[1]}; "
        f"warned: {det_warned or 'nothing'}); in the default mode the .msgpack's step is "
        f"{loss_diff:.2e} off the .tar's, {RESUME_REPEATS} repeats from the .tar "
        f"{['%.2e' % d for d in repeat_diffs]}; phase {phase_s:.1f} s")
    return dict(launches=launches, figures=figures)


# ----------------------------------------------------------- baselines --
# phase 4h: (name, eval phase, train phase) of ProtoNet_Contrast and the transformer
BASELINES = (("proto", "protoeval", "prototrain"),
             ("transformer", "transformereval", "transformertrain"))
BASELINE_SERVE_KERNELS = ("knn", "attention_fwd")
BASELINE_TRAIN_KERNELS = ("knn", "attention_fwd", "attention_bwd", "scatter_add")
BASELINE_CLI_ITERS = 8  # training episodes of each baseline's CLI run (the CLI's 40000, cut)
BASELINE_GATES = {"logits": 2e-3, "loss": 1e-4, "contrast_loss": 5e-4, "binary_loss": 5e-4,
                  "clean_proto_loss": 5e-3}   # the JAX package's golden-fixture tolerances
GRAD_FLOOR = 1e-5   # a gradient's norm floor in the relative gate, of the largest entry


def baseline_learner(torch, cfg, seed, plain: bool = False):
    """The learner of ``cfg.phase`` (ProtoNet_Contrast or the transformer)
    on the card, weights and dropout from a generator seeded ``seed``; with
    ``plain`` on the plain kNN, attention and FPS."""
    from r3dfsseg_tpu_torch.learners import ProtoLearner, TransformerLearner
    if plain:
        cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla")
    gen = torch.Generator().manual_seed(seed)
    if cfg.phase in ("protoeval", "prototrain"):
        return ProtoLearner(cfg, "cuda", gen, with_contrast=True)
    return TransformerLearner(cfg, "cuda", gen)


def expect_baseline_launches(what: str, grew: dict, required, fps: int = 0) -> None:
    """Every kernel in ``required`` launched, FPS exactly ``fps`` times, and
    no other counter moved (kernel 4, kernel 7, kernels 8-11, every bf16,
    wide and general form)."""
    moved = {n: c for n, c in grew.items() if c}
    if (any(grew[n] <= 0 for n in required) or grew["fps"] != fps
            or set(moved) - set(required) - ({"fps"} if fps else set())):
        raise AssertionError(f"{what}: launches {moved}")


def _diff(after: dict, before: dict) -> dict:
    return {n: c - before[n] for n, c in after.items()}


def _total(moves: list) -> dict:
    return {n: sum(m[n] for m in moves) for n in moves[0]}


def baseline_serve(torch, cfg, episodes, kernels, seed) -> dict:
    """``episodes`` served (MDNS on) by `FewShotPredictor` on the kernel
    path and on the plain path with equal weights: each request launches
    kNN and the attention forward and nothing else, labels agree on >= 99%
    of each request's points; host-clock latency and peak memory."""
    from r3dfsseg_tpu_torch.serve import FewShotPredictor
    fast = FewShotPredictor(cfg, baseline_learner(torch, cfg, seed))
    plain_learner = baseline_learner(torch, cfg, seed, plain=True)
    plain_learner.model.load_state_dict(fast._learner.model.state_dict())
    plain = FewShotPredictor(plain_learner.cfg, plain_learner)
    fast.predict(*episodes[0][:3])               # warm-up: first allocations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, preds, moves = [], [], []
    for i, ep in enumerate(episodes):
        before = counts(kernels)
        t0 = time.perf_counter()
        preds.append(fast.predict(*ep[:3]))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        moves.append(_diff(counts(kernels), before))
        expect_baseline_launches(f"{cfg.phase} request {i}", moves[-1], BASELINE_SERVE_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    before = counts(kernels)
    plain.predict(*episodes[0][:3])
    plain_lat, agree = [], []
    q, n = cfg.n_way * cfg.n_queries, cfg.pc_npts
    for i, (ep, a) in enumerate(zip(episodes, preds)):
        t0 = time.perf_counter()
        b = plain.predict(*ep[:3])
        torch.cuda.synchronize()
        plain_lat.append((time.perf_counter() - t0) * 1e3)
        if a.shape != (q, n) or a.dtype != np.int32 or a.min() < 0 or a.max() > cfg.n_way:
            raise AssertionError(f"{cfg.phase} request {i}: labels {a.shape} {a.dtype}")
        agree.append(float((a == b).mean()))
        if agree[-1] < 0.99:
            raise AssertionError(f"{cfg.phase} request {i}: kernel and plain paths agree on "
                                 f"{agree[-1]}")
    if counts(kernels) != before:
        raise AssertionError(f"{cfg.phase}: the plain path launched a kernel")
    return dict(lat=lat, plain_lat=plain_lat, agree=agree, moves=moves, peak=peak)


def baseline_train(torch, cfg, episodes, kernels, seed) -> dict:
    """Step 1 on the kernel and the plain path from the same weights and
    generator on the same kNN graphs (`KnnReplay`): each loss within rtol
    1e-4, each gradient within a relative L2 distance of GRAD_TOL (its
    norm floored at GRAD_FLOOR of the largest entry; the biases with an
    exact zero gradient, the BaseLearner's conv biases before a train-mode
    BatchNorm and the transformer's key biases, below GRAD_FLOOR of it; the
    stopped class tokens have none); then TRAIN_STEPS kernel-path steps,
    each launching kNN, the attention pair and the scatter-add, FPS once on
    ProtoNet_Contrast (WayContrast's prototypes) and never on the
    transformer, and nothing else; a profiled step's device time."""
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.ops import cuda_knn
    fast = baseline_learner(torch, cfg, seed)
    plain = baseline_learner(torch, cfg, seed, plain=True)
    for (n, a), b in zip(fast.model.state_dict().items(), plain.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"the two learners start from different weights at {n}")
    fps = 1 if cfg.phase == "prototrain" else 0
    replay = KnnReplay(torch, cuda_knn, dgcnn)
    before = counts(kernels)
    kernel_knn = replay.record()
    try:
        m_fast = fast.train(episodes[0])
    finally:
        cuda_knn.knn = kernel_knn
    torch.cuda.synchronize()
    first = counts(kernels)
    expect_baseline_launches(f"{cfg.phase} step 1", _diff(first, before),
                             BASELINE_TRAIN_KERNELS, fps)
    plain_knn = replay.replay()
    try:
        m_plain = plain.train(episodes[0])
    finally:
        dgcnn.knn_indices = plain_knn
    torch.cuda.synchronize()
    if counts(kernels) != first:
        raise AssertionError(f"{cfg.phase}: the plain training path launched a kernel")
    for key in sorted(m_fast):
        if key == "accuracy":
            continue
        a, b = m_fast[key].item(), m_plain[key].item()
        log(f"  step 1 {key}: kernels {a:.7f}, plain {b:.7f}, rel diff "
            f"{abs(a - b) / max(abs(b), 1e-30):.3e}")
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"{cfg.phase} step 1 {key}: kernel path {a} vs plain path {b}")
    g_fast, g_plain = _grads(fast.model), _grads(plain.model)
    if set(g_fast) != set(g_plain):
        raise AssertionError("the two paths produced gradients for different parameters")
    top = max(g.abs().max().item() for g in g_plain.values())
    zero = {n for n in g_plain if n.endswith("self_attn.key.bias")
            or (n.startswith("features.base_learner.") and n.endswith(".conv.bias"))}
    noise = max(max(g_fast[n].abs().max().item(), g_plain[n].abs().max().item())
                for n in zero)
    rel = {n: ((g_fast[n] - g_plain[n]).norm().item()
               / max(g_plain[n].norm().item(), GRAD_FLOOR * top))
           for n in g_plain if n not in zero}
    worst = max(rel, key=rel.get)
    log(f"  step 1 gradients: {len(rel)} parameters, largest relative L2 distance "
        f"{rel[worst]:.3e} ({worst}), median {statistics.median(rel.values()):.3e}; "
        f"{len(zero)} exact-zero biases at {noise / top:.3e} of the largest entry; kNN rows "
        f"kept at a near-tie per call {replay.swapped}")
    if rel[worst] > GRAD_TOL or noise > GRAD_FLOOR * top:
        raise AssertionError(f"{cfg.phase} step 1 gradients: {worst} {rel[worst]}, "
                             f"zero-gradient noise {noise / top}")

    torch.cuda.reset_peak_memory_stats()
    times, moves = [], []
    for i in range(TRAIN_STEPS):
        before = counts(kernels)
        t0 = time.perf_counter()
        m = fast.train(episodes[(i + 1) % len(episodes)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        moves.append(_diff(counts(kernels), before))
        expect_baseline_launches(f"{cfg.phase} step {i + 2}", moves[-1],
                                 BASELINE_TRAIN_KERNELS, fps)
        vals = {k: v.item() for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{cfg.phase} step {i + 2}: metrics {vals}")
    peak = torch.cuda.max_memory_allocated()
    busy = device_kernels(torch, lambda: fast.train(episodes[0]), reps=1)
    return dict(times=times, moves=moves, peak=peak, busy_ms=sum(ms for _, ms in busy),
                top=busy[:6], learner=fast, metrics=vals)


def _fixture_episode(torch, data, prefix):
    """A golden fixture's episode on the card, channels last, batched."""
    from r3dfsseg_tpu_torch.models.episode import Episode
    g = lambda f: data[f"{prefix}/{f}"]  # noqa: E731
    return Episode(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()[None] for a in (
        g("support_x").transpose(0, 1, 3, 2), g("support_y").astype(np.int64),
        g("query_x").transpose(0, 2, 1), g("query_y").astype(np.int64),
        g("gt_support_y").astype(np.int64), g("gt_query_y").astype(np.int64),
        g("support_flag").astype(np.int64))))


def baseline_golden(torch, kernels) -> dict:
    """The baselines' golden fixtures with every kernel on, the original
    models' weights through the port's key map: plain ProtoNet's
    `proto/{cosine,euclidean}/{eval,train}` (`reference_parity.npz`, f0),
    ProtoNet_Contrast's `pc/{eval,train,train_clean}` and the transformer's
    `pt/{eval,train}` (`reference_parity_extra.npz`) at BASELINE_GATES; a
    kNN row that differs from the plain version only at a near-tie."""
    from r3dfsseg_tpu_torch.learners import ProtoLearner, TransformerLearner
    from r3dfsseg_tpu_torch.ops import cuda_knn

    shares = dict.fromkeys(BASELINE_GATES, 0.0)
    diffs = dict.fromkeys(BASELINE_GATES, 0.0)      # largest |got - want|
    swapped: list = []
    before = counts(kernels)

    def check(out, data, key, fields):
        pairs = [("logits", out.query_logits[0].cpu().numpy(),
                  data[f"{key}/logits"].transpose(0, 2, 1))]
        pairs += [(f, np.asarray(getattr(out, f).item()), np.asarray(data[f"{key}/{f}"]))
                  for f in fields]
        for f, got, want in pairs:
            tol = BASELINE_GATES[f]
            shares[f] = max(shares[f], _gate(f"{key} {f}", got, want, tol, tol))
            diffs[f] = max(diffs[f], float(np.abs(got - want).max()))

    data = np.load(FIXTURES[0])
    cfg = fixture_config(json.loads(bytes(data["meta"]).decode()))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/") and "proj." not in k}
    ep = _fixture_episode(torch, data, "f0/ep")
    for dist in ("cosine", "euclidean"):
        learner = ProtoLearner(cfg.replace(dist_method=dist), "cuda")
        learner.load_torch_state(sd)
        for mode in ("eval", "train"):
            with knn_near_ties(torch, cuda_knn, swapped), torch.no_grad():
                out = learner.model(ep, train=mode == "train")
            check(out, data, f"proto/{dist}/{mode}", ("loss",))
    data = np.load(os.path.join(os.path.dirname(FIXTURES[0]), "reference_parity_extra.npz"))
    cfg = fixture_config(json.loads(bytes(data["meta"]).decode()))
    eps = {name: _fixture_episode(torch, data, name) for name in ("ep", "ep_clean")}
    learner = ProtoLearner(cfg, "cuda", with_contrast=True)
    learner.load_torch_state({k[6:]: data[k] for k in data.files if k.startswith("pc_sd/")})
    for name, key in (("ep", "eval"), ("ep", "train"), ("ep_clean", "train_clean")):
        with knn_near_ties(torch, cuda_knn, swapped), torch.no_grad():
            out = learner.model(eps[name], train=key != "eval", eval_mdns=key == "eval")
        check(out, data, f"pc/{key}", ("loss",) if key == "eval" else ("loss", "contrast_loss"))
    learner = TransformerLearner(cfg, "cuda", d_model=128, n_head=8, n_layers=3, d_feed=128,
                                 dropout=0.0)
    learner.load_torch_state({k[6:]: data[k] for k in data.files if k.startswith("pt_sd/")})
    for mode in ("eval", "train"):
        with knn_near_ties(torch, cuda_knn, swapped), torch.no_grad():
            out = learner.model(eps["ep"], train=mode == "train")
        check(out, data, f"pt/{mode}", ("loss",) if mode == "eval"
              else ("loss", "binary_loss", "clean_proto_loss"))
    launched = _diff(counts(kernels), before)
    # FPS once in each of ProtoNet_Contrast's two training replays
    expect_baseline_launches("golden fixtures", launched, BASELINE_SERVE_KERNELS, fps=2)
    log(f"[baselines] golden fixtures proto/*, pc/*, pt/* with the kernels on: every gate "
        f"held; largest share of each (largest |difference|): " +
        ", ".join(f"{k} {v:.2e} ({diffs[k]:.2e})" for k, v in shares.items()) +
        f"; kNN rows kept at a near-tie {sum(swapped)} in {len(swapped)} calls; launches " +
        str({n: c for n, c in launched.items() if c}))
    return dict(shares=shares, max_abs_diff=diffs, knn_near_tie_rows=sum(swapped))


def baseline_checkpoints(torch, learner, episodes, tmp) -> None:
    """``learner`` written as a `.msgpack` (`save_checkpoint`) and a `.tar`
    (`save_reference_checkpoint`): `FewShotPredictor.from_checkpoint` on
    each serves equal labels, from equal weights."""
    from r3dfsseg_tpu_torch.serve import FewShotPredictor
    from r3dfsseg_tpu_torch.utils.checkpoint import save_checkpoint
    from r3dfsseg_tpu_torch.utils.torch_convert import save_reference_checkpoint
    cfg = learner.cfg
    paths = [os.path.join(tmp, f"{cfg.phase}.msgpack"), os.path.join(tmp, f"{cfg.phase}.tar")]
    save_checkpoint(paths[0], learner, iteration=TRAIN_STEPS + 1)
    save_reference_checkpoint(paths[1], learner.model, iteration=TRAIN_STEPS + 1)
    a, b = (FewShotPredictor.from_checkpoint(p, cfg, device="cuda") for p in paths)
    for (k, x), y in zip(a._learner.model.state_dict().items(),
                         b._learner.model.state_dict().values()):
        if not torch.equal(x, y):
            raise AssertionError(f"{cfg.phase}: .msgpack and .tar load different {k}")
    for i, ep in enumerate(episodes[:2]):
        if not np.array_equal(a.predict(*ep[:3]), b.predict(*ep[:3])):
            raise AssertionError(f"{cfg.phase} request {i}: .msgpack and .tar labels differ")


def baseline_cli(torch, kernels, ds, tmp, train_phase, eval_phase) -> dict:
    """The meta-training CLI with ``train_phase`` for BASELINE_CLI_ITERS
    episodes (one validation), then the meta-test CLI with ``eval_phase``
    (ood noise 0.4, MDNS on) from the `.tar` it wrote; launches gated as
    the learners' steps and requests, episodes/s from their logs."""
    from r3dfsseg_tpu_torch import eval_noise, mpti_train_noise
    from r3dfsseg_tpu_torch.config import R3DConfig
    cfg = R3DConfig(phase=train_phase, clean_data_path=ds, n_iters=BASELINE_CLI_ITERS,
                    eval_interval=BASELINE_CLI_ITERS, n_episode_test=1, n_workers=CLI_WORKERS,
                    save_path=tmp, log_dir=os.path.join(tmp, train_phase))
    before = counts(kernels)
    t = time.perf_counter()
    st = mpti_train_noise.train(cfg, device="cuda")
    train_s = time.perf_counter() - t
    expect_baseline_launches(f"cli {train_phase}", _diff(counts(kernels), before),
                             BASELINE_TRAIN_KERNELS, fps=BASELINE_CLI_ITERS
                             if train_phase == "prototrain" else 0)
    losses = np.asarray(st["losses"])
    if len(losses) != BASELINE_CLI_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"cli {train_phase}: losses {losses}")
    ecfg = cfg.replace(phase=eval_phase, noise_ratio=0.4, noise_type="ood",
                       model_checkpoint_path=os.path.join(
                           cfg.log_dir, f"checkpoint_{BASELINE_CLI_ITERS}.tar"))
    before = counts(kernels)
    miou = eval_noise.evaluate(ecfg, device="cuda")
    expect_baseline_launches(f"cli {eval_phase}", _diff(counts(kernels), before),
                             BASELINE_SERVE_KERNELS)
    text = open(os.path.join(cfg.log_dir, f"log_{eval_phase}.txt")).read()
    found = re.findall(r"eval throughput: ([0-9.]+) episodes/s", text)
    if not 0.0 <= miou <= 1.0 or not found:
        raise AssertionError(f"cli {eval_phase}: mean IoU {miou}, throughput line {found}")
    return dict(train_episodes_per_s=st["episodes_per_s"], train_step_ms=st["step_ms_median"],
                train_s=train_s, eval_episodes_per_s=float(found[-1]), test_miou=miou,
                losses=[float(x) for x in losses])


def baselines_phase(torch, kernels, episodes, seed) -> dict:
    """Phase 4h: ProtoNet_Contrast and the transformer at flagship width
    (module docstring).  Returns each baseline's main-path launches (its
    served requests and kernel-path training steps) and its figures."""
    import tempfile

    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    launches, figures = {}, {}
    golden = baseline_golden(torch, kernels)
    with tempfile.TemporaryDirectory(prefix="r3d_baselines_") as tmp:
        ds = make_synthetic_dataset(os.path.join(tmp, "blocks"), n_scans=40,
                                    pts_per_scan=4096, seed=seed)
        for name, eval_phase, train_phase in BASELINES:
            cfg = R3DConfig(phase=eval_phase)
            log(f"[baselines] {name} ({eval_phase} / {train_phase}): {describe(cfg)}, "
                f"{cfg.n_way}-way {cfg.k_shot}-shot, {cfg.pc_npts} points" +
                (f", d_model {cfg.d_model}, {cfg.n_head} heads, {cfg.n_layers} layers, d_feed "
                 f"{cfg.d_feed}" if name == "transformer" else ", MDNS on"))
            sv = baseline_serve(torch, cfg, episodes, kernels, seed)
            tr = baseline_train(torch, cfg.replace(phase=train_phase), episodes, kernels, seed)
            baseline_checkpoints(torch, tr["learner"], episodes, tmp)
            cli = baseline_cli(torch, kernels, ds, tmp, train_phase, eval_phase)
            launches[name] = _total(sv["moves"] + tr["moves"])
            per_req = {n: c for n, c in sv["moves"][0].items() if c}
            per_step = {n: c for n, c in tr["moves"][0].items() if c}
            figures[name] = dict(
                request_ms_median=statistics.median(sv["lat"]),
                plain_request_ms_median=statistics.median(sv["plain_lat"]),
                agreement=sv["agree"], serve_peak_mib=sv["peak"] / 2**20,
                step_ms_median=statistics.median(tr["times"]), step_ms=tr["times"],
                step_device_busy_ms=tr["busy_ms"], train_peak_mib=tr["peak"] / 2**20,
                per_request=per_req, per_step=per_step, cli=cli)
            log(f"[baselines] {name}: {len(sv['lat'])} requests, median latency "
                f"{statistics.median(sv['lat']):.2f} ms (kernels) vs "
                f"{statistics.median(sv['plain_lat']):.2f} ms (plain), agreement "
                f"{min(sv['agree']):.4f} at least; launches per request {per_req}; peak "
                f"{sv['peak'] / 2**20:.1f} MiB")
            log(f"[baselines] {name}: {TRAIN_STEPS} steps, median {figures[name]['step_ms_median']:.2f} "
                f"ms (host clock), device busy {tr['busy_ms']:.2f} ms in a profiled step; "
                f"launches per step {per_step}; peak {tr['peak'] / 2**20:.1f} MiB; largest "
                f"device times " + ", ".join(f"{ms:.3f} {k[:40]}" for k, ms in tr["top"]))
            log(f"[baselines] {name}: .msgpack and .tar served equal labels; CLI "
                f"{train_phase} {cli['train_episodes_per_s']:.2f} episodes/s (median step "
                f"{cli['train_step_ms']:.2f} ms), {eval_phase} {cli['eval_episodes_per_s']:.2f} "
                f"episodes/s, mean IoU {cli['test_miou']:.4f}")
            del tr["learner"]
    figures["golden"] = golden
    figures["phase_s"] = time.perf_counter() - t0
    log(f"[baselines] phase {figures['phase_s']:.1f} s")
    return dict(launches=launches, figures=figures)


# phase 4i: whole-scene serving (`FewShotPredictor.predict_scene`)
SCENE_EXTENT = (8.0, 8.0, 3.0)   # metres of the synthetic scene's box
# (name, points, graph dtype, the path `serve.scene_lp_path` must name at R3D_SCENE_LP=auto)
SCENES = (("dense", 16384, "float32", "dense"),
          ("dense_bf16", 16384, "bfloat16", "dense"),
          ("blocked", 32768, "float32", "blocked-stored"),
          ("split", 65536, "float32", "blocked-split"))
SCENE_KERNELS = ("knn", "attention_fwd", "fps", "kth", "cheby")   # kernels 1, 2, 3, 4, 7
SCENE_BLOCKED_GATE = 0.99   # dense vs blocked labels, the JAX package's (tests/test_serve.py:154)
SCENE_PLAIN_GATE = 0.99     # dense scene, kernel path vs plain path (the serving phases' gate)
SCENE_STREAM_TOL = (1e-5, 1e-6)   # stored vs rematerialised Z: rtol, atol (test_lp_blocked.py:79)
# split store vs f32 stored (tests/test_lp_blocked.py:126-129): argmax equal on
# valid rows, and entries within SCENE_SPLIT_ATOL of max |Z|, each share above
SCENE_SPLIT_GATE, SCENE_SPLIT_ATOL = 0.995, 2e-2
SCENE_STREAM_POINTS = 8192
SCENE_CALLS = 3             # calls a checked scene: the first's kernel inputs kept, the later timed
SCENE_REPEAT_GATE = 0.999   # a later call's labels against the first's


def synthetic_scene(rng: np.random.Generator, p: int):
    """(xyz, rgb) of p points uniform over SCENE_EXTENT metres, colours in [0, 1]."""
    xyz = (rng.uniform(size=(p, 3)) * np.asarray(SCENE_EXTENT)).astype(np.float32)
    return xyz, rng.uniform(size=(p, 3)).astype(np.float32)


@contextlib.contextmanager
def scene_stages(torch, predictor):
    """CUDA events around the scene program's stages: the encoder's calls
    (forward hooks), the dense affinity (`lp.local_constrained_affinity`)
    and solve (`lp.label_propagate`), the blocked or sparse graph's whole
    call and its Chebyshev solve (`cuda_cheby.chebyshev`).  Yields a dict
    of stage -> [(start, end)]."""
    from r3dfsseg_tpu_torch.ops import cuda_cheby, lp, lp_blocked

    spans = {name: [] for name in ("encode", "affinity", "label_propagate", "scene_lp",
                                   "chebyshev")}
    patched = [(lp, "local_constrained_affinity", "affinity"),
               (lp, "label_propagate", "label_propagate"),
               (lp_blocked, "blocked_label_propagate", "scene_lp"),
               (lp_blocked, "sparse_label_propagate", "scene_lp"),
               (cuda_cheby, "chebyshev", "chebyshev")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]

    def timed(fn, stage):
        def run(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[stage].append((start, end))
            return out
        return run

    def pre(_module, _args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans["encode"].append([ev, None])

    def post(_module, _args, _out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans["encode"][-1][1] = ev

    features = predictor._learner.model.features
    hooks = [features.register_forward_pre_hook(pre), features.register_forward_hook(post)]
    for mod, name, stage in patched:
        setattr(mod, name, timed(getattr(mod, name), stage))
    try:
        yield spans
    finally:
        for h in hooks:
            h.remove()
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def stage_ms(spans) -> dict:
    """Device ms of each stage from `scene_stages`' events (synchronised):
    encode, graph build and solve.  On the dense graph the build is the
    affinity and the solve `label_propagate` (S and the Chebyshev steps); on
    the blocked graph the solve is the Chebyshev steps and the build the
    rest of its call."""
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    if spans["scene_lp"]:
        return dict(encode_ms=ms["encode"], build_ms=ms["scene_lp"] - ms["chebyshev"],
                    solve_ms=ms["chebyshev"])
    return dict(encode_ms=ms["encode"], build_ms=ms["affinity"], solve_ms=ms["label_propagate"])


@contextlib.contextmanager
def capture_calls(torch, targets):
    """Keeps the calls of module functions made while the block runs:
    targets maps a label to (module, attribute, keep), keep(args) choosing
    the calls kept.  Yields label -> [(args, kwargs, out)], tensors
    cloned; the function runs as before, so its launch count is
    unchanged."""
    calls = {label: [] for label in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets.values()]

    def grab(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def kept(fn, label, keep):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if keep(a):
                calls[label].append((tuple(grab(x) for x in a), kw, grab(out)))
            return out
        return run

    for label, (mod, name, keep) in targets.items():
        setattr(mod, name, kept(getattr(mod, name), label, keep))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def scene_kernel_targets(n_blocks: int) -> dict:
    """`capture_calls` targets of a scene's kernels on the scene's own
    shapes: kNN and the attention forward on the batch of n_blocks blocks
    (not the support's), and every k-th distance and Chebyshev solve (the
    scene graph's)."""
    from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_cheby, cuda_kth, cuda_knn

    def blocks(a):
        return a[0].shape[0] == n_blocks

    return {"knn": (cuda_knn, "knn", blocks), "attention_fwd": (cuda_attention, "attention", blocks),
            "kth": (cuda_kth, "kth_smallest_per_row", lambda a: True),
            "cheby": (cuda_cheby, "cheby_solve", lambda a: True)}


def check_scene_kernels(torch, what: str, calls: dict) -> dict:
    """Each kernel call that a scene's main path made (`capture_calls`)
    against its plain version on the same inputs: kNN's lists by
    `knn_agreement` (mismatch <= 1e-3 of rows, every differing neighbour a
    tie within NEAR_TIE), the attention forward within rtol 1e-4 / atol
    1e-5, kernel 4 bit-equal, kernel 7 within SPLIT_TOL of
    `cheby_solve_split_reference` and within CHEBY_TOL of the f32-product
    `cheby_solve_reference`, both of max |x| (check_cheby's gates).
    Returns each kernel's worst error."""
    from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_cheby, cuda_kth, cuda_knn

    out = {}
    with torch.inference_mode():
        for (x, k, *rest), kw, got in calls["knn"]:
            a = knn_agreement(torch, x.float(), got.long(), cuda_knn.knn_reference(x, k).long())
            log(f"  [scene] {what}: knn {tuple(x.shape)} k={k}: row mismatch {a['mismatch']:.3e}, "
                f"worst differing neighbour {a['gap']:.3e} of xx_i + xx_j (gate {NEAR_TIE})")
            if a["mismatch"] > 1e-3 or a["gap"] > NEAR_TIE:
                raise AssertionError(f"[scene] {what}: knn {tuple(x.shape)}: {a}")
            out["knn_mismatch"] = max(out.get("knn_mismatch", 0.0), a["mismatch"])
        for (q, k, v, *rest), kw, got in calls["attention_fwd"]:
            want = cuda_attention.attention_reference(q, k, v, *rest, **kw)
            err = (got - want).abs().max().item()
            log(f"  [scene] {what}: attention {tuple(q.shape)}: max abs err {err:.3e}")
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            out["attention_err"] = max(out.get("attention_err", 0.0), err)
        for (d, k, iters), kw, got in calls["kth"]:
            want = cuda_kth.kth_smallest_per_row_reference(d, k, iters)
            log(f"  [scene] {what}: kth {d.dtype} {tuple(d.shape)} k={k} iters={iters}: "
                f"bit-equal to plain {torch.equal(got, want)}")
            if not torch.equal(got, want):
                raise AssertionError(f"[scene] {what}: kth differs from plain by up to "
                                     f"{(got - want).abs().max().item()}")
            out["kth_err"] = 0.0
        for (s, b, alpha, iters), kw, got in calls["cheby"]:
            # the tolerance of the shortest solve in SPLIT_TOL that is no shorter
            split_tol = SPLIT_TOL[min([s for s in SPLIT_TOL if s >= iters] or [max(SPLIT_TOL)])]
            for name, ref, tol in (("split", cuda_cheby.cheby_solve_split_reference, split_tol),
                                   ("f32", cuda_cheby.cheby_solve_reference, CHEBY_TOL)):
                want = ref(s, b, alpha, iters)
                e, scale = (got - want).abs().max().item(), want.abs().max().item()
                log(f"  [scene] {what}: cheby bf16 S {tuple(s.shape)}, b {tuple(b.shape)}, "
                    f"{iters} steps: kernel vs {name} plain {e:.3e}, {e / scale:.3e} of max |x| "
                    f"(tolerance {tol})")
                if not (np.isfinite(e) and e <= tol * scale):
                    raise AssertionError(f"[scene] {what}: cheby vs {name} plain {e} > "
                                         f"{tol} x {scale}")
                out[f"cheby_{name}_rel_err"] = e / scale
    return out


def scene_request(torch, predictor, support, scene, kernels, impl: str, what: str,
                  check: bool = False) -> dict:
    """SCENE_CALLS `predict_scene` calls (one if not ``check``) under
    R3D_SCENE_LP=impl, each with its launches counted from zero, host ms,
    stage device ms and peak memory.  The first call's launches are the
    ones returned; with ``check`` its kernels' inputs are kept and each
    call held against its plain version (`check_scene_kernels`), and the
    later calls' labels must equal the first's."""
    from r3dfsseg_tpu_torch.serve import scene_lp_path

    c = predictor.cfg
    p = len(scene[0])
    nodes = c.n_classes * c.n_subprototypes + p
    targets = scene_kernel_targets(-(-p // c.pc_npts)) if check else {}
    timed = []
    os.environ["R3D_SCENE_LP"] = impl
    try:
        path = scene_lp_path(nodes, c)
        for i in range(SCENE_CALLS if check else 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with scene_stages(torch, predictor) as spans, \
                    capture_calls(torch, targets if i == 0 else {}) as calls:
                zero_counts(kernels)
                t0 = time.perf_counter()
                labels = predictor.predict_scene(*support, *scene)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
                launched = counts(kernels)
            timed.append(dict(host_ms=host_ms, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                              launched=launched, labels=labels, **stage_ms(spans)))
            if i == 0 and check:
                checked = check_scene_kernels(torch, what, calls)
                del calls
    finally:
        del os.environ["R3D_SCENE_LP"]
    labels, launched = timed[0]["labels"], timed[0]["launched"]
    if labels.shape != (p,) or labels.dtype != np.int32 or \
            labels.min() < 0 or labels.max() > c.n_way:
        raise AssertionError(f"[scene] {what}: labels {labels.shape} {labels.dtype} in "
                             f"[{labels.min()}, {labels.max()}]")
    repeat = min((float((t["labels"] == labels).mean()) for t in timed[1:]), default=1.0)
    if any(t["launched"] != launched for t in timed[1:]) or repeat < SCENE_REPEAT_GATE:
        raise AssertionError(f"[scene] {what}: later calls launched "
                             f"{[t['launched'] for t in timed[1:]]} against {launched}, their "
                             f"labels equal the first's on {repeat} of points")
    # figures from the calls after the first (its kernels' inputs were
    # copied on the card), or from the only call
    later = timed[1:] or timed
    out = dict(points=p, nodes=nodes, path=path, labels=labels, launched=launched,
               classes=np.bincount(labels, minlength=c.n_classes).tolist(),
               calls=len(later), checked=checked if check else None, repeat_agreement=repeat,
               **{key: [t[key] for t in later]
                  for key in ("host_ms", "encode_ms", "build_ms", "solve_ms", "peak_mib")})

    def span(key, fmt):
        lo, hi = min(out[key]), max(out[key])
        return f"{lo:{fmt}}" if len(out[key]) == 1 else f"{lo:{fmt}}-{hi:{fmt}}"

    log(f"[scene] {what}: {p} points, {nodes} nodes, path {path}; launches "
        + ", ".join(f"{n} {launched[n]}" for n in SCENE_KERNELS)
        + f"; {out['calls']} timed call(s): host {span('host_ms', '.1f')} ms, device encode "
        f"{span('encode_ms', '.2f')} ms, graph build {span('build_ms', '.2f')}, solve "
        f"{span('solve_ms', '.2f')}; peak {span('peak_mib', '.1f')} MiB; labels per class "
        f"{out['classes']}")
    return out


def expect_scene_launches(what: str, path: str, launched: dict, bf16_graph: bool) -> None:
    """Kernels 1-3 on every path, kernel 4 on the dense graph only and
    kernel 7 on the dense bf16 graph only; nothing else of the kernels'
    families but their tuned forms."""
    want = {"knn": True, "attention_fwd": True, "fps": True, "kth": path == "dense",
            "cheby": path == "dense" and bf16_graph}
    bad = {n: launched[n] for n, on in want.items() if (launched[n] > 0) != on}
    others = {n: c for n, c in launched.items() if c and n not in want}
    if bad or others:
        raise AssertionError(f"[scene] {what} ({path}): launches {bad} against {want}; other "
                             f"kernels launched: {others}")


def scene_phase(torch, kernels, episodes, seed) -> dict:
    """Phase 4i: whole-scene serving at flagship width on seeded weights
    (module docstring).  Returns each scene's main-path launches
    (`scene_<name>`) and the figures."""
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.ops import lp_blocked
    from r3dfsseg_tpu_torch.serve import FewShotPredictor, scene_blocks

    t0 = time.perf_counter()
    cfg = R3DConfig()
    rng = np.random.default_rng(seed + 404)
    support = tuple(episodes[0][:2])
    preds = {gd: FewShotPredictor(cfg.replace(graph_dtype=gd),
                                  MPTILearner(cfg.replace(graph_dtype=gd), "cuda",
                                              torch.Generator().manual_seed(seed)))
             for gd in ("float32", "bfloat16")}
    log(f"[scene] {describe(cfg)}, {cfg.n_way}-way {cfg.k_shot}-shot support, blocks of "
        f"{cfg.pc_npts} points, scenes uniform over {SCENE_EXTENT} m, MDNS on")

    # the blocked graph's modes on one scene's nodes (the call is also the
    # warm-up): stored against rematerialised, split-stored against stored
    small = synthetic_scene(rng, SCENE_STREAM_POINTS)
    scene_request(torch, preds["float32"], support, small, kernels, "auto", "warm-up")
    blocks, pad_mask, _ = scene_blocks(*small, cfg.pc_npts)
    node_feat, node_valid, y0, _ = preds["float32"].scene_nodes(blocks, pad_mask, *support)
    kw = dict(k=cfg.k_connect, sigma=cfg.sigma, alpha=cfg.lp_alpha, valid=node_valid,
              iters=cfg.lp_cg_iters)
    with torch.inference_mode():
        z_store = lp_blocked.blocked_label_propagate(node_feat, y0, store_graph=True, **kw)
        z_stream = lp_blocked.blocked_label_propagate(node_feat, y0, store_graph=False, **kw)
        z_split = lp_blocked.blocked_label_propagate(node_feat, y0, split_store=True, **kw)
    rtol, atol = SCENE_STREAM_TOL
    diff = (z_store - z_stream).abs()
    excess = float((diff - rtol * z_stream.abs()).max())
    stream = dict(nodes=int(node_feat.shape[0]), max_abs_diff=float(diff.max()),
                  max_rel_diff=float((diff / z_stream.abs().clamp_min(1e-30)).max()),
                  max_excess_over_tol=excess)
    log(f"[scene] stored vs rematerialised blocked graph, {stream['nodes']} nodes: Z max abs "
        f"diff {stream['max_abs_diff']:.3e}, max rel {stream['max_rel_diff']:.3e} (tolerance "
        f"rtol {rtol}, atol {atol})")
    if not excess <= atol:
        raise AssertionError(f"[scene] stored vs rematerialised Z: {stream}")
    gap, scale = (z_split - z_store).abs(), z_store.abs().max()
    split = dict(nodes=stream["nodes"], max_abs_diff=float(gap.max()),
                 max_abs_diff_of_max_z=float(gap.max() / scale),
                 close=float((gap <= SCENE_SPLIT_ATOL * scale).float().mean()),
                 agreement=float((z_split.argmax(-1) == z_store.argmax(-1))[node_valid]
                                 .float().mean()))
    log(f"[scene] split-stored vs stored f32 blocked graph, {split['nodes']} nodes: Z max abs "
        f"diff {split['max_abs_diff']:.3e} ({split['max_abs_diff_of_max_z']:.3e} of max |Z|), "
        f"{split['close']:.5f} of entries within {SCENE_SPLIT_ATOL} of max |Z|; argmax equal on "
        f"{split['agreement']:.5f} of valid nodes (gates {SCENE_SPLIT_GATE})")
    if not min(split["agreement"], split["close"]) > SCENE_SPLIT_GATE:
        raise AssertionError(f"[scene] split-stored vs stored Z: {split}")
    del node_feat, node_valid, y0, z_store, z_stream, z_split, diff, gap

    points, runs = {}, {}
    for name, p, gd, path in SCENES:
        if p not in points:
            points[p] = synthetic_scene(rng, p)
        r = scene_request(torch, preds[gd], support, points[p], kernels, "auto", name,
                          check=True)
        if r["path"] != path:
            raise AssertionError(f"[scene] {name}: path {r['path']}, want {path}")
        expect_scene_launches(name, path, r["launched"], gd == "bfloat16")
        runs[name] = r

    # the dense scene again, blocked, and on the plain path at both graph
    # dtypes (the f32 graph against the bf16 one is printed, not gated:
    # the bf16 graph's selection and S round, so it is another graph)
    dense, dense_points = runs["dense"], points[SCENES[0][1]]
    blk = scene_request(torch, preds["float32"], support, dense_points, kernels, "blocked",
                        "dense scene, R3D_SCENE_LP=blocked")
    expect_scene_launches("dense scene, blocked", blk["path"], blk["launched"], False)
    plain = {}
    for gd, name in (("float32", "dense"), ("bfloat16", "dense_bf16")):
        plain_cfg = cfg.replace(knn_impl="xla", fps_impl="xla", attn_impl="xla", graph_dtype=gd)
        pred = FewShotPredictor(plain_cfg, MPTILearner(plain_cfg, "cuda"))
        pred._learner.model.load_state_dict(preds[gd]._learner.model.state_dict())
        pl = scene_request(torch, pred, support, dense_points, kernels, "auto",
                           f"{name} scene, plain path")
        if any(pl["launched"].values()):
            raise AssertionError(f"[scene] the plain path launched a kernel: {pl['launched']}")
        plain[name] = pl
    agree = dict(blocked=float((blk["labels"] == dense["labels"]).mean()),
                 plain=float((plain["dense"]["labels"] == dense["labels"]).mean()),
                 plain_bf16=float((plain["dense_bf16"]["labels"]
                                   == runs["dense_bf16"]["labels"]).mean()),
                 bf16_graph=float((runs["dense_bf16"]["labels"] == dense["labels"]).mean()))
    log(f"[scene] dense scene: the blocked graph agrees on {agree['blocked']:.5f} of points "
        f"(gate {SCENE_BLOCKED_GATE}), the plain path on {agree['plain']:.5f} (gate "
        f"{SCENE_PLAIN_GATE}); on the bf16 graph the plain path on {agree['plain_bf16']:.5f} "
        f"(gate {SCENE_PLAIN_GATE}); the bf16 graph against the f32 one on "
        f"{agree['bf16_graph']:.5f}")
    if agree["blocked"] < SCENE_BLOCKED_GATE or \
            min(agree["plain"], agree["plain_bf16"]) < SCENE_PLAIN_GATE:
        raise AssertionError(f"[scene] agreement {agree}")

    keep = ("points", "nodes", "path", "calls", "host_ms", "encode_ms", "build_ms", "solve_ms",
            "peak_mib", "classes", "checked", "repeat_agreement")
    figures = {name: {k: runs[name][k] for k in keep} for name, *_ in SCENES}
    figures.update(dense_blocked={k: blk[k] for k in keep},
                   **{f"{name}_plain": {k: pl[k] for k in keep} for name, pl in plain.items()},
                   agreement=agree, stored_vs_stream=stream, split_vs_stored=split,
                   phase_s=time.perf_counter() - t0)
    log(f"[scene] phase {figures['phase_s']:.1f} s")
    return dict(launches={f"scene_{name}": runs[name]["launched"] for name, *_ in SCENES},
                figures=figures)


# ------------------------------------------------- data parallelism --
# phase 4j: the episode and scene-batch data parallelism of `parallel/`
DP_E = 2               # episodes of the flagship DP step
DP_CLI_ITERS = 8       # training episodes of the CLI at --mesh 1 and without
DP_TIMED = 5           # timed steps after the first, host clock
# W = 2 against the unsharded step: the loss and the BN running statistics
# at tests/test_torch_parallel.py (d)'s 1e-5 (each statistic against its
# buffer's largest entry).  The gradients at flagship width: the CPU tests'
# 1e-5 per parameter holds at their tiny widths, not here.  A shard's other
# summation orders (batch-sized GEMMs and key splits, partial BN sums, the
# gradient's all-reduce) move the early layers' gradients as far as one
# ulp on the first layer's weights does (`one_ulp`; PERF.md section 6: up to
# 4e-4 and 1.4e-3 against 9e-4 and 1.8e-3, 2e-4 to 6e-4 over all
# parameters), while the losses agree within 5e-7.  So the relative L2
# over all parameters is held to GRAD_TOL, the card's gate for
# rounding-level differences of the flagship step, and each parameter's
# to 10 GRAD_TOL: a missing or unscaled reduction moves a gradient by O(1).
# Each BN statistic against its own entry (the CPU tests' measure) read
# 1.64e-3 here, on entries whose (1 - momentum) batch means cancel to near
# 0: printed, not gated.  The witness holds the rest (`dp_witness`): the
# W = 2 step against its ranks' rows run alone and averaged by hand, at
# the CPU tests' (d) gates, each statistic against its own entry
DP_GATES = dict(loss=1e-5, grad_all=GRAD_TOL, grad=10 * GRAD_TOL, buffers=1e-5)
DP_WITNESS_GATES = dict(loss=1e-5, grad_all=1e-5, grad=1e-5, buffers=1e-5, buffers_elem=1e-5)
DP_PRETRAIN_CLASSES = 7
DP_STEP = {"knn": 6, "attention_fwd": 2, "attention_bwd": 2, "fps": 3 * DP_E, "kth": DP_E,
           "scatter_add": 6}   # launches of the flagship DP step (E = 2), f32 graph
DP_ATTN = (("float32", 64), ("bfloat16", 64), ("float32", 128), ("bfloat16", 128),
           ("bfloat16", 320))  # one family each: tuned f32, wgmma bf16, wide tf32, wide tc, group
DP_ATTN_B, DP_ATTN_ROWS = 4, 2  # the whole batch and a shard's rows, N = 2048


def stacked(episodes, e: int):
    """The first ``e`` flagship episodes as one batch (numpy `Episode`)."""
    from r3dfsseg_tpu_torch.models.episode import Episode
    return Episode(*(np.stack(f) for f in zip(*episodes[:e])))


def dp_state(torch, learner) -> dict:
    """A learner's parameters, buffers and Adam state (CPU copies)."""
    opt = learner.optimizer
    return dict(params={n: p.detach().cpu().clone() for n, p in learner.model.named_parameters()},
                buffers={n: b.cpu().clone() for n, b in learner.model.named_buffers()},
                adam={n: {k: v.cpu().clone() for k, v in opt.state[p].items()}
                      for n, p in learner.model.named_parameters() if p in opt.state})


def same_state(a: dict, b: dict) -> bool:
    import torch
    return all(a[part].keys() == b[part].keys() for part in a) and \
        all(torch.equal(x, b["params"][n]) for n, x in a["params"].items()) and \
        all(torch.equal(x, b["buffers"][n]) for n, x in a["buffers"].items()) and \
        all(all(torch.equal(v, b["adam"][n][k]) for k, v in st.items())
            for n, st in a["adam"].items())


def check_attention_offsets(torch, attn_mod, seed) -> dict:
    """Phase 4j (2): each attention family (DP_ATTN), forward and backward
    at rate 0.1 on B = DP_ATTN_B clouds of N = 2048: the kernels on rows
    [b0, b0 + DP_ATTN_ROWS) with offset b0 (a data-parallel rank's call)
    bit-equal to those rows of the whole batch's call (y, lse, dq, dk, dv),
    for b0 = 0 and DP_ATTN_ROWS, and the mask's words from
    `r3d_dropout_mask` at b0 bit-equal to the plain version's and to the
    whole batch's rows.  A launch's key splits grow as B shrinks, up to 4
    (`csrc/attention.cuh:splits`); at these batches every family is at 4
    for the whole batch and for a shard, so both run one tiling (the
    grouped bf16 pair takes 2 at B = 8, 4 at B = 4)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 53)
    n, s = 2048, seed + 5
    words = attn_mod.dropout_words(DP_ATTN_B, n, s, "cuda")
    out = {}
    for b0 in range(0, DP_ATTN_B, DP_ATTN_ROWS):
        part = attn_mod.dropout_words(DP_ATTN_ROWS, n, s, "cuda", b0)
        plain = attn_mod.dropout_words_reference(DP_ATTN_ROWS, n, s, "cuda", b0)
        if not (torch.equal(part, words[b0:b0 + DP_ATTN_ROWS])
                and torch.equal(part.to(torch.int64) & 0xFFFFFFFF, plain)):
            raise AssertionError(f"dropout words at offset {b0}: not the whole batch's rows")
    del words, part, plain
    for dtype_name, d in DP_ATTN:
        dtype = getattr(torch, dtype_name)
        q, k, v, dy = (torch.randn((DP_ATTN_B, n, d), generator=g, device="cuda")
                       for _ in range(4))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        tau = d ** 0.5
        y, lse = attn_mod.attention_fwd(q, k, v, tau, 0.1, s)
        whole = (y, lse, *attn_mod.attention_bwd(q, k, v, y, dy, lse, tau, 0.1, s))
        for b0 in range(0, DP_ATTN_B, DP_ATTN_ROWS):
            sl = slice(b0, b0 + DP_ATTN_ROWS)
            yr, lr = attn_mod.attention_fwd(q[sl], k[sl], v[sl], tau, 0.1, s, b0)
            rows = (yr, lr, *attn_mod.attention_bwd(q[sl], k[sl], v[sl], yr, dy[sl], lr, tau,
                                                    0.1, s, b0))
            bad = [name for name, a, w in zip(("y", "lse", "dq", "dk", "dv"), rows, whole)
                   if not torch.equal(a, w[sl])]
            if bad:
                raise AssertionError(f"attention {dtype_name} D={d}: rows [{b0}, "
                                     f"{b0 + DP_ATTN_ROWS}) at offset {b0} differ from the "
                                     f"whole batch's rows in {bad}")
        out[f"{dtype_name}_d{d}"] = "bit-equal"
    log(f"  [4j] attention at an offset: {', '.join(out)} forward and backward (rate 0.1, B "
        f"{DP_ATTN_B}, rows of {DP_ATTN_ROWS} at b0 = 0 and {DP_ATTN_ROWS}) bit-equal to the "
        f"whole batch's rows; the mask's words at each offset equal the plain version's")
    return out


@contextlib.contextmanager
def knn_rows(torch, knn_mod, recorded, mesh):
    """A data-parallel rank on the unsharded step's kNN graphs (why:
    `KnnReplay`): each call launches the kNN kernel on the rank's clouds;
    where a row's neighbours differ from the same row of the whole batch's
    recorded call, the difference must be a rounding-level tie (gap <=
    NEAR_TIE), and the recorded row is taken.  Yields the rows taken, per
    call."""
    kernel, queue, swapped = knn_mod.knn, list(recorded), []

    def knn(x, k, **kw):
        got = kernel(x, k, **kw)
        whole = queue.pop(0)
        per = whole.shape[0] // mesh.size
        want = whole[mesh.rank * per:(mesh.rank + 1) * per].to(got.device)
        rows = (got.long().sort(-1).values != want.long().sort(-1).values).any(-1)
        swapped.append(int(rows.sum()))
        if bool(rows.any()):
            gap = knn_agreement(torch, x.float(), got.long(), want.long())["gap"]
            if gap > NEAR_TIE:
                raise AssertionError(f"rank {mesh.rank}: kNN rows differ from the whole "
                                     f"batch's beyond a tie: {gap}")
        return want.to(got.dtype)
    knn_mod.knn = knn
    try:
        yield swapped
    finally:
        knn_mod.knn = kernel


def dp_timed(torch, step, reps: int = DP_TIMED) -> dict:
    """Host-clock ms of ``reps`` calls of step() (a synchronise each), and
    the device's busy ms per call over 3 profiled calls (kernel time)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    busy = sum(ms for _, ms in device_kernels(torch, step))
    return dict(host_ms=times, host_ms_median=statistics.median(times), device_busy_ms=busy)


def pretrain_batch(episodes, rng):
    """A pretraining batch of 16 flagship clouds (the support clouds of the
    first episodes) with labels in [0, DP_PRETRAIN_CLASSES)."""
    x = np.concatenate([e[0].reshape(-1, *e[0].shape[-2:]) for e in episodes])[:16]
    y = rng.integers(0, DP_PRETRAIN_CLASSES, size=x.shape[:2]).astype(np.int64)
    return x, y


def parallel_rank(payload: dict, device=None) -> dict:
    """Phase 4j (3)'s rank body, which `parallel.launch` runs in each of
    two processes sharing the card over gloo: the flagship DP step (E =
    DP_E) and a DP pretraining step (batch 16, 8 a rank) from the seeded
    weights, on the unsharded steps' kNN graphs (`knn_rows`), then timed
    steps of each.  Returns rank 0's metrics, gradients, BN buffers,
    launches and times."""
    import torch

    from r3dfsseg_tpu_torch import pin_f32_matmul, pretrain as pre
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.nn.dgcnn import init_linear_weights
    from r3dfsseg_tpu_torch.ops import cuda_knn
    from r3dfsseg_tpu_torch.parallel import make_mesh, replicate
    from r3dfsseg_tpu_torch.parallel.mesh import shard_rows

    pin_f32_matmul()
    mesh = make_mesh(device=device)
    kernels, seed = all_counters(), payload["seed"]
    learner = MPTILearner(payload["cfg"], mesh.device, torch.Generator().manual_seed(seed))
    learner.attach_mesh(mesh)
    batch = payload["batch"]
    zero_counts(kernels)
    # deterministic, as the witness (`dp_witness`) runs the ranks' rows
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with knn_rows(torch, cuda_knn, payload["knn"], mesh) as swapped:
            m = learner.train(batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    out = dict(launches=counts(kernels), metrics={k: v.item() for k, v in m.items()},
               grads={n: p.grad.cpu() for n, p in learner.model.named_parameters()
                      if p.grad is not None},
               buffers={n: b.cpu() for n, b in learner.model.named_buffers()},
               swapped=swapped, staged_all_gather=mesh.staged_all_gather,
               backend=torch.distributed.get_backend(mesh.group))
    out["timed"] = dp_timed(torch, lambda: learner.train(batch))
    del learner

    model = pre.seg_model(payload["cfg"], DP_PRETRAIN_CLASSES)
    init_linear_weights(model, torch.Generator().manual_seed(seed))
    model.to(mesh.device)
    gen = torch.Generator().manual_seed(seed)
    replicate([*model.parameters(), *model.buffers()], mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    x, y = (shard_rows(torch.from_numpy(a), mesh).to(mesh.device)
            for a in payload["pretrain_batch"])
    offset = mesh.rank * x.shape[0]
    zero_counts(kernels)
    with knn_rows(torch, cuda_knn, payload["pretrain_knn"], mesh) as swapped:
        loss, acc = pre.pretrain_step(model, opt, x, y, gen, mesh, offset)
    torch.cuda.synchronize()
    out["pretrain"] = dict(
        launches=counts(kernels), loss=loss.item(), acc=acc.item(), swapped=swapped,
        grads={n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
        buffers={n: b.cpu() for n, b in model.named_buffers()},
        timed=dp_timed(torch, lambda: pre.pretrain_step(model, opt, x, y, gen, mesh, offset)))
    return out


def dp_witness(torch, cfg, batch, seed, recorded_knn, w: int) -> dict:
    """The W-rank DP step without a collective, in this process: each
    rank's rows run alone on a fresh seeded learner, at their `Shard`
    offset and on the whole batch's kNN rows (`knn_rows`), under
    deterministic algorithms; the ranks' losses, gradients (None as zero,
    as `all_reduce_grads_` counts it) and BN running statistics are then
    averaged by hand as the DP step's all-reduces average them.  The W = 2
    step must equal this: its only differences from the unsharded step
    are then those of the shapes a rank computes at."""
    from r3dfsseg_tpu_torch.data.loader import to_device
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.models.episode import Episode
    from r3dfsseg_tpu_torch.ops import cuda_knn
    from r3dfsseg_tpu_torch.parallel import Mesh, Shard, shard_episode

    ranks = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for r in range(w):
            mesh = Mesh(None, r, w, torch.device("cuda"))
            learner = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
            rows, offset = shard_episode(Episode(*batch), mesh)
            with knn_rows(torch, cuda_knn, recorded_knn, mesh):
                out = learner.model(to_device(rows, "cuda"), train=True,
                                    generator=learner.generator,
                                    shard=Shard(offset, batch.support_x.shape[0]))
            loss, _ = learner.objective(out)
            loss.backward()
            torch.cuda.synchronize()
            ranks.append(dict(loss=loss.detach(),
                              grads=dict(learner.model.named_parameters()),
                              buffers=dict(learner.model.named_buffers())))
    finally:
        torch.use_deterministic_algorithms(False)
    grads = {}
    for n in ranks[0]["grads"]:
        got = [k["grads"][n].grad for k in ranks]
        if any(g is not None for g in got):
            grads[n] = (sum(torch.zeros_like(k["grads"][n]) if g is None else g
                            for k, g in zip(ranks, got)) / w).cpu()
    return dict(loss=(sum(k["loss"] for k in ranks) / w).item(), grads=grads,
                buffers={n: (sum(k["buffers"][n] for k in ranks) / w).cpu()
                         for n in ranks[0]["buffers"]})


def one_ulp(torch, w) -> None:
    """Every entry of ``w`` moved up by one ulp: a rounding-level change
    of the step, to show how far such a change moves its gradients."""
    with torch.no_grad():
        w.copy_(torch.nextafter(w, torch.full_like(w, float("inf"))))


def dp_compare(what: str, got: dict, want: dict, gates: dict = DP_GATES) -> dict:
    """Loss, each gradient (relative L2; the biases that feed a train-mode
    BatchNorm, whose exact gradient is 0, below 1e-5 of the largest entry;
    the relative L2 over all parameters printed beside) and the BN running
    statistics (each buffer's largest difference over its largest entry,
    and each entry's difference over itself: gated where ``gates`` has
    "buffers_elem") of ``got`` against ``want``; ``gates`` None only
    prints them."""
    import torch
    got, want = ({k: {n: x.cpu() for n, x in v.items()} if k in ("grads", "buffers") else v
                  for k, v in d.items()} for d in (got, want))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    zero = {n for n in want["grads"] if n.endswith(".conv.bias")}
    top = max(g.abs().max().item() for g in want["grads"].values())
    noise = max((max(got["grads"][n].abs().max().item(), want["grads"][n].abs().max().item())
                 for n in zero), default=0.0)
    rel = _rel_distances(got["grads"], want["grads"], zero)
    worst = max(rel, key=rel.get)
    names = sorted(rel)
    flat = [torch.cat([g[n].flatten() for n in names]) for g in (got["grads"], want["grads"])]
    stats = [n for n in want["buffers"] if n.endswith(("running_mean", "running_var"))]
    buf = max(((got["buffers"][n] - want["buffers"][n]).abs().max()
               / want["buffers"][n].abs().max().clamp_min(1e-30)).item() for n in stats)
    elem = {}
    for n in stats:
        d = (got["buffers"][n] - want["buffers"][n]).abs()
        elem[n] = torch.where(d == 0, 0.0, d / want["buffers"][n].abs()).max().item()
    elem_worst = max(elem, key=elem.get)
    r = dict(loss_rel_diff=loss_rel, grad_rel_max=rel[worst], grad_rel_max_param=worst,
             grad_rel_median=statistics.median(rel.values()),
             grad_rel_all=((flat[0] - flat[1]).norm() / flat[1].norm()).item(),
             zero_grad_noise=noise / top, buffer_rel_max=buf,
             buffer_rel_elem=elem[elem_worst], buffer_rel_elem_name=elem_worst)
    log(f"  [4j] {what}: loss rel diff {loss_rel:.3e}; gradients: largest relative L2 "
        f"{rel[worst]:.3e} ({worst}), median {r['grad_rel_median']:.3e}, over all parameters "
        f"{r['grad_rel_all']:.3e}, the zero-gradient biases at {noise / top:.3e} of the "
        f"largest entry; BN running statistics: largest difference {buf:.3e} of its buffer's "
        f"largest entry, {elem[elem_worst]:.3e} of its own entry ({elem_worst})"
        + (f" (gates {gates})" if gates else ""))
    if gates is None:
        return r
    if not (loss_rel <= gates["loss"] and rel[worst] <= gates["grad"]
            and r["grad_rel_all"] <= gates["grad_all"] and noise <= 1e-5 * top
            and buf <= gates["buffers"]
            and elem[elem_worst] <= gates.get("buffers_elem", float("inf"))
            and set(got["grads"]) == set(want["grads"])):
        raise AssertionError(f"[4j] {what}: {r}")
    return r


def parallel_phase(torch, kernels, episodes, seed) -> dict:
    """Phase 4j: data parallelism (`parallel/`) at flagship width (module
    docstring).  Returns the main-path launches (`parallel_w1`: the W = 1
    DP step; `parallel_pretrain_w1`; `parallel_w2` and
    `parallel_pretrain_w2`: rank 0 of the two ranks) and the figures."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from r3dfsseg_tpu_torch import mpti_train_noise, pretrain as pre
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.nn import dgcnn
    from r3dfsseg_tpu_torch.nn.dgcnn import init_linear_weights
    from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_knn
    from r3dfsseg_tpu_torch.parallel import launch, make_mesh, replicate

    t0 = time.perf_counter()
    cfg = R3DConfig(episode_batch=DP_E, seed=seed)
    batch = stacked(episodes, DP_E)
    rng = np.random.default_rng(seed + 77)
    pbatch = pretrain_batch(episodes, rng)
    px, py = (torch.from_numpy(a).cuda() for a in pbatch)
    log(f"[4j] {describe(cfg)}: the DP training step at E = {DP_E} (attention dropout "
        f"{cfg.attn_dropout}), a DP pretraining step at batch 16")
    figures, launched = {}, {}

    def seg(seed_):
        m = pre.seg_model(cfg, DP_PRETRAIN_CLASSES)
        init_linear_weights(m, torch.Generator().manual_seed(seed_))
        m.cuda()
        return m, torch.optim.Adam(m.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)

    # ---- (1) world size 1 under NCCL: bit-equal to the unwrapped learner
    with tempfile.TemporaryDirectory(prefix="r3d_dp_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0, timeout=timedelta(seconds=120))
        try:
            mesh = make_mesh(1, "cuda")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    plain = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
                    m_plain = plain.train(batch)
                    dp = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
                    dp.attach_mesh(mesh)
                    # the main path of this phase: the W = 1 DP step
                    zero_counts(kernels)
                    m_dp = dp.train(batch)
                    torch.cuda.synchronize()
                    launched["parallel_w1"] = counts(kernels)
                    same = {k: m_dp[k].item() == m_plain[k].item() for k in m_plain}
                    if not (all(same.values()) and same_state(dp_state(torch, dp),
                                                              dp_state(torch, plain))):
                        raise AssertionError(f"[4j] W = 1: the DP step is not bit-equal to the "
                                             f"unwrapped learner's: metrics {same}")
                    del plain
                    # pretraining at batch 16, W = 1
                    pm, popt = seg(seed)
                    qm, qopt = seg(seed)
                    replicate([*qm.parameters(), *qm.buffers()], mesh)
                    a = pre.pretrain_step(pm, popt, px, py, torch.Generator().manual_seed(seed))
                    zero_counts(kernels)
                    b = pre.pretrain_step(qm, qopt, px, py, torch.Generator().manual_seed(seed),
                                          mesh, 0)
                    torch.cuda.synchronize()
                    launched["parallel_pretrain_w1"] = counts(kernels)
                    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and all(
                            torch.equal(u, w) for u, w in zip(pm.state_dict().values(),
                                                             qm.state_dict().values()))):
                        raise AssertionError("[4j] W = 1: the DP pretraining step is not "
                                             "bit-equal to the plain one")
                    # synchronised BatchNorm on the one rank (its sums all-reduced,
                    # then divided) gives the step's gradients bit for bit
                    sm, _ = seg(seed)
                    logits = sm(px, train=True, generator=torch.Generator().manual_seed(seed),
                                sync=mesh.group)
                    (-torch.log_softmax(logits, -1).gather(-1, py.long()[..., None])
                     .mean()).backward()
                    gp = _grads(pm)
                    if not all(torch.equal(g, gp[n]) for n, g in _grads(sm).items()):
                        raise AssertionError("[4j] W = 1: synchronised BatchNorm moves the "
                                             "pretraining step's gradients")
                    del pm, qm, popt, qopt, sm, gp
                    # the training CLI at --mesh 1 against no --mesh
                    ds = make_synthetic_dataset(os.path.join(tmp, "blocks"), n_scans=40,
                                                pts_per_scan=4096, seed=seed)
                    runs = {}
                    for tag, shape in (("mesh1", (1,)), ("none", None)):
                        runs[tag] = mpti_train_noise.train(cfg.replace(
                            clean_data_path=ds, n_iters=DP_CLI_ITERS, n_episode_test=1,
                            eval_interval=10 * DP_CLI_ITERS, n_workers=2, mesh_shape=shape,
                            save_path=tmp, log_dir=os.path.join(tmp, tag)), device="cuda")
                    if runs["mesh1"]["losses"] != runs["none"]["losses"] or \
                            runs["mesh1"]["episodes_sha256"] != runs["none"]["episodes_sha256"]:
                        raise AssertionError(f"[4j] the training CLI at --mesh 1 and without: "
                                             f"{runs['mesh1']['losses']} vs "
                                             f"{runs['none']['losses']}")
            finally:
                torch.use_deterministic_algorithms(False)
            figures["w1_warned"] = sorted({str(w.message).split("\n")[0][:160] for w in caught})
            figures["w1_dp"] = dp_timed(torch, lambda: dp.train(batch))
            del dp
        finally:
            dist.destroy_process_group()
    if launched["parallel_w1"] != {n: DP_STEP.get(n, 0) for n in kernels}:
        raise AssertionError(f"[4j] the W = 1 DP step: launches {launched['parallel_w1']}, "
                             f"want {DP_STEP}")
    if launched["parallel_pretrain_w1"] != {n: PRETRAIN_PER_STEP.get(n, 0) for n in kernels}:
        raise AssertionError(f"[4j] the W = 1 DP pretraining step: launches "
                             f"{launched['parallel_pretrain_w1']}")
    log(f"  [4j] W = 1 under NCCL: the DP step (E = {DP_E}) bit-equal to the unwrapped "
        f"learner's (metrics, parameters, BN buffers, Adam state), the DP pretraining step at "
        f"batch 16 bit-equal to the plain one (and with synchronised BatchNorm on the one "
        f"rank), the training CLI at --mesh 1 bit-equal to no "
        f"--mesh ({len(runs['none']['losses'])} losses and the episode digest), under "
        f"deterministic algorithms (warned: {figures['w1_warned'] or 'nothing'}); launches "
        f"{launched['parallel_w1']}")

    # ---- (2) each attention family at a batch offset
    figures["attention_offsets"] = check_attention_offsets(torch, cuda_attention, seed)

    # ---- (3) world size 2 on the one card: two processes on cuda:0 over gloo
    replay = KnnReplay(torch, cuda_knn, dgcnn)
    unsharded = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
    kernel_knn = replay.record()
    try:
        m = unsharded.train(batch)
    finally:
        cuda_knn.knn = kernel_knn
    torch.cuda.synchronize()
    want = dict(loss=m["loss"].item(),
                grads={n: g.cpu() for n, g in _grads(unsharded.model).items()},
                buffers={n: b.cpu() for n, b in unsharded.model.named_buffers()})
    step_knn = [r.cpu() for r in replay.recorded]
    witness = dp_witness(torch, cfg, batch, seed, step_knn, 2)
    # beside it, ungated, on the same graphs: the same step again, and the
    # step with the first EdgeConv layer's weights moved by one ulp
    for tag, moved in (("twice", False), ("ulp", True)):
        again = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(seed))
        if moved:
            one_ulp(torch, again.model.features.encoder.edgeconv0.layer0.conv.weight)
        with knn_rows(torch, cuda_knn, step_knn, make_mesh(device="cuda")):
            m = again.train(batch)
        figures[f"step_{tag}"] = dp_compare(
            f"the unsharded step {'again' if tag == 'twice' else 'with one ulp moved'} "
            f"(not gated)", dict(loss=m["loss"].item(), grads=_grads(again.model),
                                 buffers=dict(again.model.named_buffers())), want, None)
        del again
    figures["w1_unwrapped"] = dp_timed(torch, lambda: unsharded.train(batch))
    del unsharded
    pm, popt = seg(seed)
    replay = KnnReplay(torch, cuda_knn, dgcnn)
    kernel_knn = replay.record()
    try:
        loss, _ = pre.pretrain_step(pm, popt, px, py, torch.Generator().manual_seed(seed))
    finally:
        cuda_knn.knn = kernel_knn
    torch.cuda.synchronize()
    pwant = dict(loss=loss.item(), grads={n: g.cpu() for n, g in _grads(pm).items()},
                 buffers={n: b.cpu() for n, b in pm.named_buffers()})
    pknn = [r.cpu() for r in replay.recorded]
    qm, qopt = seg(seed)
    one_ulp(torch, qm.encoder.edgeconv0.layer0.conv.weight)
    with knn_rows(torch, cuda_knn, pknn, make_mesh(device="cuda")):
        loss, _ = pre.pretrain_step(qm, qopt, px, py, torch.Generator().manual_seed(seed))
    figures["pretrain_ulp"] = dp_compare(
        "the W = 1 pretraining step with one ulp moved (not gated)",
        dict(loss=loss.item(), grads=_grads(qm), buffers=dict(qm.named_buffers())), pwant, None)
    del qm, qopt
    figures["pretrain_w1"] = dp_timed(torch, lambda: pre.pretrain_step(
        pm, popt, px, py, torch.Generator().manual_seed(seed)))
    del pm, popt
    payload = dict(cfg=cfg, seed=seed, batch=tuple(batch), knn=step_knn,
                   pretrain_batch=pbatch, pretrain_knn=pknn)
    t = time.perf_counter()
    two = launch(parallel_rank, 2, payload, device="cuda:0", timeout_s=600)
    figures["w2_launch_s"] = time.perf_counter() - t
    launched["parallel_w2"], launched["parallel_pretrain_w2"] = (two["launches"],
                                                                 two["pretrain"]["launches"])
    log(f"  [4j] W = 2, two processes on cuda:0 over {two['backend']} (all-gathers staged "
        f"through host copies: {two['staged_all_gather']}); kNN rows of the rank that took the "
        f"whole batch's tie choice, per call: step {two['swapped']}, pretraining "
        f"{two['pretrain']['swapped']}")
    figures["w2_step"] = dp_compare("the W = 2 DP step against the unsharded step",
                                    dict(two, loss=two["metrics"]["loss"]), want)
    figures["w2_witness"] = dp_compare(
        "the W = 2 DP step against its ranks' rows run alone in this process and averaged "
        "by hand", dict(two, loss=two["metrics"]["loss"]), witness, DP_WITNESS_GATES)
    figures["witness_step"] = dp_compare(
        "the ranks' rows run alone and averaged against the unsharded step (not gated)",
        witness, want, None)
    figures["w2_pretrain"] = dp_compare("the W = 2 DP pretraining step against W = 1",
                                        two["pretrain"], pwant)
    # rank 0 runs one episode: every kNN, attention and scatter-add call on
    # its clouds, one episode's FPS and k-th distance
    rank_step = dict(DP_STEP, fps=3, kth=1)
    if two["launches"] != {n: rank_step.get(n, 0) for n in kernels} or \
            two["pretrain"]["launches"] != {n: PRETRAIN_PER_STEP.get(n, 0) for n in kernels}:
        raise AssertionError(f"[4j] rank 0: launches {two['launches']} (want {rank_step}), "
                             f"pretraining {two['pretrain']['launches']}")
    figures["w2"], figures["pretrain_w2"] = two["timed"], two["pretrain"]["timed"]
    figures["phase_s"] = time.perf_counter() - t0
    log(f"  [4j] step times, host clock median (device busy a step): W = 1 unwrapped "
        f"{figures['w1_unwrapped']['host_ms_median']:.2f} ms "
        f"({figures['w1_unwrapped']['device_busy_ms']:.2f}), W = 1 DP "
        f"{figures['w1_dp']['host_ms_median']:.2f} ({figures['w1_dp']['device_busy_ms']:.2f}), "
        f"W = 2 rank 0 {figures['w2']['host_ms_median']:.2f} "
        f"({figures['w2']['device_busy_ms']:.2f}; two processes sharing the card, not a "
        f"scaling figure); pretraining W = 1 {figures['pretrain_w1']['host_ms_median']:.2f} "
        f"({figures['pretrain_w1']['device_busy_ms']:.2f}), W = 2 rank 0 "
        f"{figures['pretrain_w2']['host_ms_median']:.2f} "
        f"({figures['pretrain_w2']['device_busy_ms']:.2f}); the two ranks' launch "
        f"{figures['w2_launch_s']:.1f} s; phase {figures['phase_s']:.1f} s")
    return dict(launches=launched, figures=figures)


def all_counters() -> dict:
    """Every kernel counter, by the name of its row: (module, attribute).
    The bf16 forms' counters count their calls apart, within their
    kernel's."""
    from r3dfsseg_tpu_torch.ops import (cuda_attention, cuda_cheby, cuda_fps, cuda_fused_edge,
                                        cuda_gather, cuda_knn, cuda_kth, cuda_proto_cheby,
                                        cuda_scatter)
    return {"knn_general": (cuda_knn, "general_launches"),
            "knn_packed": (cuda_knn, "packed_launches"),
            "attention_wide_tf32_fwd": (cuda_attention, "wide_tf32_launches"),
            "attention_wide_tf32_bwd": (cuda_attention, "wide_tf32_bwd_launches"),
            "attention_wide_tc_fwd_bf16": (cuda_attention, "wide_tc_bf16_launches"),
            "attention_wide_tc_bwd_bf16": (cuda_attention, "wide_tc_bwd_bf16_launches"),
            "attention_wide_group_fwd_bf16": (cuda_attention, "wide_group_bf16_launches"),
            "attention_wide_group_bwd_bf16": (cuda_attention, "wide_group_bwd_bf16_launches"),
            "kth_wide": (cuda_kth, "wide_launches"),
            "scatter_general": (cuda_scatter, "general_launches"),
            "knn": (cuda_knn, "launches"), "attention_fwd": (cuda_attention, "launches"),
            "attention_bwd": (cuda_attention, "bwd_launches"), "fps": (cuda_fps, "launches"),
            "knn_bf16": (cuda_knn, "bf16_launches"),
            "attention_fwd_bf16": (cuda_attention, "bf16_launches"),
            "attention_bwd_bf16": (cuda_attention, "bwd_bf16_launches"),
            "scatter_add_bf16": (cuda_scatter, "bf16_launches"),
            "kth": (cuda_kth, "launches"), "scatter_add": (cuda_scatter, "launches"),
            "cheby": (cuda_cheby, "launches"), "gather_onehot": (cuda_gather, "launches"),
            **{f"fused_{pre}{p}": (cuda_fused_edge, f"{pre}{p}_launches")
               for pre in ("", "bf16_", "general_") for p in cuda_fused_edge.PASSES},
            "gather_onehot_narrow": (cuda_gather, "narrow_launches"),
            "proto_cheby": (cuda_proto_cheby, "launches"),
            "matmul_only": (cuda_proto_cheby, "matmul_only_launches")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--only", choices=["knn,fps", "cheby,scatter", "kth", "bf16", "f1", "f2",
                                       "fused", "attn", "probe", "parity", "cli", "pretrain",
                                       "baselines", "scene", "parallel"],
                    help="build, then only the kNN and FPS (or the Chebyshev and scatter-add, "
                         "the k-th distance, the bf16 forms of kernels 1, 2, 5 and 6, the "
                         "F1 kernels: general kNN, packed kNN, wide attention, wide-row k-th "
                         "distance, general scatter-add; the F2 paths: general kernel 9, the "
                         "narrow gather, kernels 10 and 11 past 8 columns; kernel 9's f32 "
                         "passes' output digests; or the attention kernels' output digests and "
                         "the f32 D = 128 and bf16 D = 320 pairs' times and the bf16 D = 64 "
                         "forward's beside flash; or kernels 7 and "
                         "10's digests and kernel 11's times) kernel checks, and "
                         "print their rows "
                         "(to time them beside another tree's kernels); parity: phase 4e "
                         "alone (the golden fixtures and the flagship checkpoint in the "
                         "exact top-k modes); cli: phase 4f alone (the training and "
                         "evaluation CLIs on a synthetic dataset); pretrain: phase 4g alone "
                         "(encoder pretraining at full width, finetune and meta-training "
                         "from it, the .msgpack checkpoints); baselines: phase 4h alone "
                         "(ProtoNet_Contrast and the transformer); scene: phase 4i alone "
                         "(whole-scene serving on the dense and blocked graphs); parallel: "
                         "phase 4j alone (data parallelism)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from r3dfsseg_tpu_torch import pin_f32_matmul
    from r3dfsseg_tpu_torch.config import R3DConfig
    from r3dfsseg_tpu_torch.kernels import build
    from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
    from r3dfsseg_tpu_torch.ops import (cuda_attention, cuda_cheby, cuda_fps, cuda_fused_edge,
                                        cuda_gather, cuda_knn, cuda_kth, cuda_proto_cheby,
                                        cuda_scatter)
    pin_f32_matmul()

    # ---- 1. build
    t0 = time.perf_counter()
    lib = build.library_path()
    build.library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line.lower()) and \
                "(C7519)" not in line:   # counted below, one line for all
            log("  " + line.strip())
    notes = ptxas_notes(build.build_log)
    if notes["counts"]:
        log(f"  [ptxas] C7519 notes (\"{notes['first']} ...\"): " + ", ".join(
            f"{name} {c}" for name, c in notes["counts"].items()))
    for line in ptxas_report(build.build_log):
        log("  [ptxas] " + line)
    if not hasattr(cuda_attention, "wide_tf32_launches"):
        log("  [ptxas] a tree without the 3xTF32 wide attention kernels: spill check not run")
    elif build.build_log:
        tc = ptxas_report(build.build_log, ("attn_wide_tc", "attn_group", "attn_wide_tf32"))
        missing = [f"wide_tc {k} T={t}" for k in ("fwd", "dkdv", "dq") for t in (2, 4)
                   if not any(x.startswith(f"attn_wide_tc_{k}_bf16_kernelILi{t}E") for x in tc)]
        missing += [f"group {k} S={s}" for k, c in (("fwd", 2), ("dkdv", 1), ("dq", 1))
                    for s in (2, 4)
                    if not any(x.startswith(f"attn_group_{k}_bf16_kernelILi{c}ELi{s}E")
                               for x in tc)]
        missing += [f"wide_tf32 {k} S={s}" for k, ss in (("fwd", (2, 4)), ("bwd", (2,)))
                    for s in ss
                    if not any(x.startswith(f"attn_wide_tf32_{k}_kernelILi{s}E") for x in tc)]
        spills = [x for x in tc
                  if "spill" in x and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        if missing or spills:
            raise AssertionError(f"the wide and grouped tensor-core attention kernels: no ptxas "
                                 f"report for {missing}, spills {spills}")
        log(f"  [ptxas] the wide and grouped tensor-core attention kernels (bf16 and 3xTF32): "
            f"{len(tc) // 2} entries, no spill")
    else:
        log("  [ptxas] cached build: spill check not run")
    if not hasattr(cuda_attention, "fwd_bf16_plan"):
        log("  [ptxas] a tree without the wgmma bf16 forward: its spill check not run")
    elif build.build_log:
        fw = ptxas_report(build.build_log, ("attn_fwd_bf16_wgmma_kernel",))
        missing = [f"C={c} dropout={dr}" for c in (1, 2, 4) for dr in (0, 1)
                   if not any(x.startswith(f"attn_fwd_bf16_wgmma_kernelILi{c}ELb{dr}E")
                              for x in fw)]
        spills = [x for x in fw
                  if "spill" in x and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        if missing or spills:
            raise AssertionError(f"kernel 2's bf16 form (attn_fwd_bf16_wgmma_kernel): no ptxas "
                                 f"report for {missing}, spills {spills}")
        log(f"  [ptxas] kernel 2's bf16 form (attn_fwd_bf16_wgmma_kernel): {len(fw) // 2} "
            f"entries, no spill")
    if not hasattr(cuda_attention, "bwd_bf16_plan"):
        log("  [ptxas] a tree without the wgmma bf16 backward: its spill check not run")
    elif build.build_log:
        bw = ptxas_report(build.build_log, ("attn_bwd_dkdv_bf16_wgmma_kernel",
                                            "attn_bwd_dq_bf16_wgmma_kernel"))
        missing = [f"dK/dV dropout={dr}" for dr in (0, 1)
                   if not any(x.startswith(f"attn_bwd_dkdv_bf16_wgmma_kernelILb{dr}E")
                              for x in bw)]
        missing += [] if any(x.startswith("attn_bwd_dq_bf16_wgmma_kernel") for x in bw) \
            else ["dQ"]
        spills = [x for x in bw
                  if "spill" in x and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        if missing or spills:
            raise AssertionError(f"kernel 5's bf16 form (attn_bwd_*_bf16_wgmma_kernel): no "
                                 f"ptxas report for {missing}, spills {spills}")
        used = [re.match(r"attn_bwd_(\w+?)_bf16_wgmma_kernel(?:ILb(\d)E)?\S*: Used (\d+) "
                         r"registers", x) for x in bw]
        regs = ", ".join(f"{m[1]}{f'<{m[2]}>' if m[2] else ''} {m[3]}" for m in used if m)
        log(f"  [ptxas] kernel 5's bf16 form (attn_bwd_*_bf16_wgmma_kernel): {len(bw) // 2} "
            f"entries, no spill; registers (<dropout>) {regs}")
    if not hasattr(cuda_proto_cheby, "probe_plan"):
        log("  [ptxas] a tree without kernel 11's split of S: its spill check not run")
    elif build.build_log:
        mp = ptxas_report(build.build_log, ("matmul_probe_kernel",))
        missing = [f"NT={nt} vec={v}" for nt in (1, 2, 4) for v in (0, 1)
                   if not any(x.startswith(f"matmul_probe_kernelILi{nt}ELb{v}E") for x in mp)]
        spills = [x for x in mp
                  if "spill" in x and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        if missing or spills:
            raise AssertionError(f"kernel 11 (matmul_probe_kernel): no ptxas report for "
                                 f"{missing}, spills {spills}")
        log(f"  [ptxas] kernel 11 (matmul_probe_kernel): {len(mp) // 2} entries, no spill")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    # ---- 2. kernels against their plain versions
    cfg = R3DConfig()
    rng = np.random.default_rng(args.seed)
    episodes = [make_episode(cfg, rng) for _ in range(max(args.requests, 3))]
    log("[kernels] flagship shapes, kernel vs plain PyTorch on the card")
    cfg16 = cfg.replace(graph_dtype="bfloat16")
    if args.only == "cheby,scatter":
        _, s16, b16, _, _ = flagship_graph(torch, cfg16, episodes[0], args.seed)
        rows = {"cheby": check_cheby(torch, cuda_cheby, s16, b16, cfg.lp_alpha, cfg.lp_cg_iters),
                "scatter_add": check_scatter(torch, cuda_knn, cuda_scatter, episodes[0][0],
                                             episodes[0][2])}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "kth":
        rows = {"kth": check_kth(torch, cuda_kth)}
        check_kth_rows(torch, cuda_kth)
        sel, _, _, _, _ = flagship_graph(torch, cfg16, episodes[0], args.seed)
        rows["kth"].update(check_kth_bf16(torch, cuda_kth, sel))
        r = rows["kth"]
        log(f"  kth: f32 {r['ms']:.4f} ms (device {r['device_ms']:.4f}), bf16 "
            f"{r['ms_bf16']:.4f} (device {r['device_ms_bf16']:.4f})")
        log(smi)
        log(json.dumps(rows))
        return 0
    f1_mods = {"knn": cuda_knn, "attention": cuda_attention, "kth": cuda_kth,
               "scatter": cuda_scatter}
    f2_mods = {"fused_edge": cuda_fused_edge, "gather": cuda_gather,
               "proto_cheby": cuda_proto_cheby, "cheby": cuda_cheby}
    support = torch.from_numpy(episodes[0][0].reshape(-1, cfg.pc_npts, cfg.pc_in_dim)).cuda()
    if args.only == "attn":
        rows = {"attention": attention_digest(torch, cuda_attention, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "probe":
        rows = {"probe": probe_digest(torch, cuda_proto_cheby, cuda_cheby)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "fused":
        rows = {"fused_edge": fused_digest(torch, cuda_fused_edge, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "f2":
        rows = check_f2(torch, f2_mods, support, args.seed)
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "f1":
        rows = check_f1(torch, f1_mods, episodes[0][0], episodes[0][2])
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "bf16":
        rows = {}
        rows["attention_fwd_bf16"], rows["attention_bwd_bf16"] = check_attention_bf16(
            torch, cuda_attention)
        rows["scatter_add_bf16"] = check_scatter_bf16(torch, cuda_knn, cuda_scatter,
                                                      episodes[0][0], episodes[0][2])
        rows["knn_bf16"] = check_knn_bf16(torch, cuda_knn)
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "cli":
        counters = {"knn": (cuda_knn, "launches"), "attention_fwd": (cuda_attention, "launches"),
                    "attention_bwd": (cuda_attention, "bwd_launches"),
                    "fps": (cuda_fps, "launches"), "kth": (cuda_kth, "launches"),
                    "scatter_add": (cuda_scatter, "launches"), "cheby": (cuda_cheby, "launches")}
        rows = {"cli": cli_phase(torch, counters, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "pretrain":
        rows = {"pretrain": pretrain_phase(torch, all_counters(), episodes, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "baselines":
        rows = {"baselines": baselines_phase(torch, all_counters(), episodes, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "scene":
        rows = {"scene": scene_phase(torch, all_counters(), episodes, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "parallel":
        rows = {"parallel": parallel_phase(torch, all_counters(), episodes, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    if args.only == "parity":
        counters = {"knn": (cuda_knn, "launches"), "attention_fwd": (cuda_attention, "launches"),
                    "attention_bwd": (cuda_attention, "bwd_launches"),
                    "fps": (cuda_fps, "launches"), "kth": (cuda_kth, "launches"),
                    "scatter_add": (cuda_scatter, "launches"), "cheby": (cuda_cheby, "launches")}
        rows = {"parity": parity_phase(torch, episodes, counters, args.seed)}
        log(smi)
        log(json.dumps(rows))
        return 0
    rows = {"knn": check_knn(torch, cuda_knn, episodes[0][0])}
    if args.only:
        rows["fps"] = check_fps(torch, cuda_fps)
        log(smi)
        log(json.dumps(rows))
        return 0
    attn_eval = check_attention(torch, cuda_attention)
    check_dropout_mask(torch, cuda_attention)
    rows["attention_fwd"], rows["attention_bwd"] = check_attention_train(torch, cuda_attention)
    rows["attention_fwd"].update(ms_eval=attn_eval[1], plain_ms_eval=attn_eval[2],
                                 library_ms_eval=attn_eval[3], max_abs_err_eval=attn_eval[0],
                                 **attn_eval[4])
    rows["attention_fwd_bf16"], rows["attention_bwd_bf16"] = check_attention_bf16(
        torch, cuda_attention)
    rows["fps"] = check_fps(torch, cuda_fps)
    rows["kth"] = check_kth(torch, cuda_kth)
    check_kth_rows(torch, cuda_kth)
    rows["scatter_add"] = check_scatter(torch, cuda_knn, cuda_scatter, episodes[0][0],
                                        episodes[0][2])
    rows["scatter_add_bf16"] = check_scatter_bf16(torch, cuda_knn, cuda_scatter, episodes[0][0],
                                                  episodes[0][2])
    rows["knn_bf16"] = check_knn_bf16(torch, cuda_knn)
    model = MPTILearner(cfg, "cuda", torch.Generator().manual_seed(args.seed)).model
    query = torch.from_numpy(episodes[0][2]).cuda()
    blocks, xs = encoder_block_inputs(torch, model, support, True)
    _, xq = encoder_block_inputs(torch, model, query, False)
    operands = [edge_operands(torch, blk, x) for blk, x in zip(blocks, xs)]
    rows["gather_onehot"] = check_gather(torch, cuda_gather, operands)
    rows["fused_edge"] = check_fused_passes(torch, cuda_fused_edge, blocks, operands, args.seed)
    del operands
    # the bf16 encoder's blocks: bf16 a, b and e_raw (kernel 9's bf16 form)
    model16 = MPTILearner(cfg.replace(compute_dtype="bfloat16"), "cuda",
                          torch.Generator().manual_seed(args.seed)).model
    blocks16, xs16 = encoder_block_inputs(torch, model16, support, True)
    _, xq16 = encoder_block_inputs(torch, model16, query, False)
    operands = [edge_operands(torch, blk, x) for blk, x in zip(blocks16, xs16)]
    fused16 = check_fused_passes(torch, cuda_fused_edge, blocks16, operands, args.seed)
    rows.update({f"fused_edge_bf16_{p}": r for p, r in fused16.pop("passes").items()})
    rows["fused_edge"]["bf16"] = fused16
    del operands
    sel, s16, b16, node, valid = flagship_graph(torch, cfg16, episodes[0], args.seed)
    rows["kth"].update(check_kth_bf16(torch, cuda_kth, sel))
    rows["cheby"] = check_cheby(torch, cuda_cheby, s16, b16, cfg.lp_alpha, cfg.lp_cg_iters)
    rows["proto_cheby"] = check_proto_cheby(torch, cuda_proto_cheby, cuda_cheby, s16, b16,
                                            cfg.lp_alpha, cfg.lp_cg_iters)
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
    log(f"  kth: device {r['device_ms']:.4f} ms; bf16: {r['ms_bf16']:.3f} ms kernel (device "
        f"{r['device_ms_bf16']:.4f}), {r['plain_ms_bf16']:.3f} plain, library "
        f"{r['library_ms_bf16']:.3f}, bound {r['bound_ms_bf16']:.4f} ({r['bound_by_bf16']})")
    r = rows["gather_onehot"]
    log(f"  gather_onehot bf16: {r['ms_bf16']:.3f} ms kernel, {r['plain_ms_bf16']:.3f} plain, "
        f"library {r['library_ms_bf16']:.3f}, bound {r['bound_ms_bf16']:.4f} "
        f"({r['bound_by_bf16']})")
    log(f"  cheby: bound with S read from device memory at every step "
        f"{rows['cheby']['bound_ms_hbm']:.4f} ms")

    # ---- 2b. the F1 kernels: shapes past the tuned kernels, and the packed kNN
    f1_kernels = ("knn_general", "knn_packed", "attention_wide_tf32_fwd",
                  "attention_wide_tf32_bwd", "attention_wide_tc_fwd_bf16",
                  "attention_wide_tc_bwd_bf16", "attention_wide_group_fwd_bf16",
                  "attention_wide_group_bwd_bf16", "kth_wide", "scatter_general")
    f1_counters = {n: c for n, c in all_counters().items() if n in f1_kernels}
    zero_counts(f1_counters)
    rows.update(check_f1(torch, f1_mods, episodes[0][0], episodes[0][2]))
    f1_checks = counts(f1_counters)

    # ---- 2c. F2: kernels 8-11 at the shapes their TPU kernels take past the tuned ones
    f2_counters = {**{f"fused_general_{p}": (cuda_fused_edge, f"general_{p}_launches")
                      for p in cuda_fused_edge.PASSES},
                   "gather_onehot_narrow": (cuda_gather, "narrow_launches")}
    zero_counts(f2_counters)
    rows.update(check_f2(torch, f2_mods, support, args.seed))
    f2_checks = counts(f2_counters)
    rows["proto_cheby"]["f2"] = rows.pop("proto_cheby_f2")
    matmul_f2 = rows.pop("matmul_only_f2")      # joins phase 6's row

    kernels = all_counters()
    f32_kernels = ("knn", "attention_fwd", "attention_bwd", "fps", "kth", "scatter_add")
    bf16_forms = ("knn_bf16", "attention_fwd_bf16", "attention_bwd_bf16", "scatter_add_bf16")
    # the bf16 encoder's step: kernels 1, 2 (bf16), 3, 4 (bf16), 5 (bf16), 6 (bf16), 7
    enc_kernels = ("knn", "attention_fwd_bf16", "attention_bwd_bf16", "fps", "kth",
                   "scatter_add_bf16", "cheby")
    fused_passes = tuple(f"fused_{p}" for p in cuda_fused_edge.PASSES)
    fused_kernels = ("gather_onehot", "gather_onehot_narrow") + tuple(
        f"fused_{pre}{p}" for pre in ("", "bf16_", "general_") for p in cuda_fused_edge.PASSES)
    probe_kernels = ("proto_cheby", "matmul_only")

    # ---- 3. serving, float32 graph then bf16 graph
    preds, serve_launches, _ = serve_phase(torch, cfg, episodes, kernels, args.seed,
                                           SERVE_KERNELS)
    preds16, serve_launches16, peak16 = serve_phase(torch, cfg16, episodes, kernels, args.seed,
                                            SERVE_KERNELS + ("cheby",))
    for i, (a, b) in enumerate(zip(preds16, preds)):
        agree = float((a == b).mean())
        log(f"  request {i}: bf16 graph agrees with the float32 graph on {agree:.4f}")
        if agree < 0.98:
            raise AssertionError(f"request {i}: bf16 and float32 graphs agree on {agree}")

    # ---- 4. training, float32 graph then bf16 graph
    # FPS: one cooperative launch per call, three calls per step (the ways,
    # the background, WayContrast's)
    tr = train_phase(torch, cfg, episodes, kernels, args.seed, f32_kernels, per_step={"fps": 3})
    tr16 = train_phase(torch, cfg16, episodes, kernels, args.seed, f32_kernels + ("cheby",),
                       per_step={"cheby": 2, "kth": 1, "fps": 3})
    log(f"[train] peak memory: float32 graph {tr['peak'] / 2**20:.1f} MiB, bf16 graph "
        f"{tr16['peak'] / 2**20:.1f} MiB")
    phases = {"serve_f32": serve_launches, "serve_bf16": serve_launches16,
              "train_f32": tr["launches"], "train_bf16": tr16["launches"]}
    for phase, launched in phases.items():
        if any(launched[n] for n in bf16_forms):
            raise AssertionError(f"{phase}: the float32 encoder launched a bf16 form: {launched}")

    # ---- 4b. the bf16 encoder (compute_dtype="bfloat16"; graph 'auto': the bf16 graph)
    cfg_enc = cfg.replace(compute_dtype="bfloat16")
    preds_enc, serve_launches_enc, peak_enc = serve_phase(
        torch, cfg_enc, episodes, kernels, args.seed,
        SERVE_KERNELS + ("cheby", "attention_fwd_bf16"))
    for i, (a, b16, b32) in enumerate(zip(preds_enc, preds16, preds)):
        log(f"  request {i}: the bf16 encoder agrees with the float32 encoder (same weights) "
            f"on {float((a == b16).mean()):.4f} of points on the bf16 graph, "
            f"{float((a == b32).mean()):.4f} against the float32 encoder's float32 graph")
    # 'hybrid' (and 'stats', 'relaxed') feed bf16 block outputs to the kNN
    _, serve_launches_hybrid, _ = serve_phase(
        torch, cfg_enc.replace(bn_mode="hybrid"), episodes[:2], kernels, args.seed,
        SERVE_KERNELS + ("cheby", "attention_fwd_bf16", "knn_bf16"))
    tr_enc = train_phase(torch, cfg_enc, episodes, kernels, args.seed, enc_kernels,
                         per_step={"cheby": 2, "kth": 1, "fps": 3})
    log(f"[bf16 encoder] peak memory: a request {peak_enc / 2**20:.1f} MiB (float32 encoder, "
        f"bf16 graph: {peak16 / 2**20:.1f}); a training step {tr_enc['peak'] / 2**20:.1f} MiB "
        f"(float32 encoder, bf16 graph: {tr16['peak'] / 2**20:.1f})")
    phases.update(serve_bf16enc=serve_launches_enc, serve_hybrid=serve_launches_hybrid,
                  train_bf16enc=tr_enc["launches"])
    for phase, launched in phases.items():
        if any(launched[n] for n in f1_kernels):
            raise AssertionError(f"{phase}: a flagship path launched an F1 kernel: {launched}")

    # ---- 4c. configurations past the tuned kernels' shapes (F1): dgcnn_k 40
    # (the general kNN), a 128-wide attention head (the wide kernels: the
    # 3xTF32 pair in f32, the bf16 tensor-core pair on the bf16 encoder), an
    # odd first EdgeConv width (the general scatter-add), float32 and bf16 encoders;
    # the tuned kNN, attention and scatter-add launch no time there; then
    # the bf16 encoder with a 320-wide head (the grouped tensor-core pair),
    # against a plain path that scales q as the kernels do
    # (`plain_attention_as_kernels`)
    cfg_f1 = cfg.replace(dgcnn_k=40, output_dim=128, edgeconv_widths=((63, 64), (64, 64),
                                                                      (64, 64)))
    not_tuned = {"knn": 0, "attention_fwd": 0, "attention_bwd": 0}   # the 64-wide blocks
    # 2 and 3 keep the tuned scatter-add
    _, serve_launches_f1, _ = serve_phase(torch, cfg_f1, episodes[:2], kernels, args.seed,
                                          ("knn_general", "attention_wide_tf32_fwd", "fps",
                                           "kth"))
    tr_f1 = train_phase(torch, cfg_f1, episodes, kernels, args.seed,
                        ("knn_general", "attention_wide_tf32_fwd", "attention_wide_tf32_bwd",
                         "fps", "kth", "scatter_general"), per_step={"fps": 3, **not_tuned},
                        steps=1)
    not_bf16 = {"attention_fwd_bf16": 0, "attention_bwd_bf16": 0}
    tr_f1_enc = train_phase(
        torch, cfg_f1.replace(compute_dtype="bfloat16"), episodes, kernels, args.seed,
        ("knn_general", "attention_wide_tc_fwd_bf16", "attention_wide_tc_bwd_bf16", "fps", "kth",
         "scatter_general", "cheby"),
        per_step={"fps": 3, "cheby": 2, "attention_wide_group_fwd_bf16": 0,
                  "attention_wide_group_bwd_bf16": 0, **not_bf16, **not_tuned}, steps=1)
    tr_f1_320 = train_phase(
        torch, cfg_f1.replace(compute_dtype="bfloat16", output_dim=320), episodes, kernels,
        args.seed, ("knn_general", "attention_wide_group_fwd_bf16",
                    "attention_wide_group_bwd_bf16", "fps", "kth", "scatter_general", "cheby"),
        per_step={"fps": 3, "cheby": 2, "attention_wide_group_fwd_bf16": 2,
                  "attention_wide_group_bwd_bf16": 2, "attention_wide_tc_fwd_bf16": 0,
                  "attention_wide_tc_bwd_bf16": 0, **not_bf16, **not_tuned}, steps=1,
        plain_kernel_scale=True)

    # ---- 4d. knn_impl "pallas": the packed-key kNN at full flagship width
    cfg_p = cfg.replace(knn_impl="pallas", fps_impl="pallas", attn_impl="pallas")
    preds_p, serve_launches_p, _ = serve_phase(torch, cfg_p, episodes[:2], kernels, args.seed,
                                               ("knn_packed", "attention_fwd", "fps", "kth"))
    for i, (a, b) in enumerate(zip(preds_p, preds)):
        log(f"  request {i}: knn_impl 'pallas' agrees with the exact kNN path (same weights) "
            f"on {float((a == b).mean()):.4f} of points")
    tr_p = train_phase(torch, cfg_p, episodes, kernels, args.seed,
                       ("knn_packed",) + f32_kernels[1:], per_step={"fps": 3, "knn": 0},
                       steps=1)
    # ---- 4e. the reference-faithful modes: the golden fixtures with the
    # kernels on, then the seeded flagship model served and trained from a
    # checkpoint.tar in the exact top-k modes
    parity = parity_phase(torch, episodes, kernels, args.seed)
    phases.update(parity_fixtures=parity["fixtures"]["launches"],
                  **{f"parity_{key}": r["launches"] for key, r in parity["runs"].items()})
    # ---- 4f. the training and evaluation CLIs on a synthetic dataset
    cli = cli_phase(torch, kernels, args.seed)
    phases.update(cli_train=cli["train"], cli_eval=cli["eval"])
    # ---- 4g. encoder pretraining at full width, finetune and meta-training
    # from its checkpoint, and the .msgpack checkpoints
    pre = pretrain_phase(torch, kernels, episodes, args.seed)
    phases["pretrain"] = pre["launches"]
    log("[pretrain] figures " + json.dumps(pre["figures"]))
    # ---- 4h. the baselines: ProtoNet_Contrast and the transformer served,
    # trained, replayed on their golden fixtures, checkpointed, and run
    # through both CLIs
    base = baselines_phase(torch, kernels, episodes, args.seed)
    phases.update(baselines_proto=base["launches"]["proto"],
                  baselines_transformer=base["launches"]["transformer"])
    log("[baselines] figures " + json.dumps(base["figures"]))
    # ---- 4i. whole-scene serving: the dense graph (f32 and bf16), the
    # blocked graph stored in f32 and split-stored in bf16
    scene = scene_phase(torch, kernels, episodes, args.seed)
    phases.update(scene["launches"])
    log("[scene] figures " + json.dumps(scene["figures"]))
    # ---- 4j. data parallelism: W = 1 under NCCL bit-equal to the unwrapped
    # learner, each attention family at a batch offset, W = 2 on the card
    par = parallel_phase(torch, kernels, episodes, args.seed)
    phases.update(par["launches"])
    log("[4j] figures " + json.dumps(par["figures"]))
    for name in ("attention_fwd", "attention_bwd"):
        rows[name]["batch_offsets"] = par["figures"]["attention_offsets"]
    attn16, dev16 = pre["figures"]["attention_b16"], pre["figures"]["wide_pair_device_ms"]
    rows["attention_wide_tf32_fwd"]["pretrain_b16"] = dict(
        ms=attn16["fwd"], step_device_ms=dev16["fwd"], plain_ms=attn16["fwd_plain"],
        library_ms=attn16["lib_fwd"])
    rows["attention_wide_tf32_bwd"]["pretrain_b16"] = dict(
        ms=attn16["bwd"], step_device_ms=dev16["bwd"] + dev16["delta"],
        plain_ms=attn16["bwd_plain"], library_ms=attn16["lib_bwd"])
    phases.update(f1_checks={**{n: 0 for n in kernels}, **f1_checks},
                  serve_f1=serve_launches_f1, train_f1=tr_f1["launches"],
                  train_f1_bf16enc=tr_f1_enc["launches"],
                  train_f1_320_bf16enc=tr_f1_320["launches"], serve_pallas=serve_launches_p,
                  train_pallas=tr_p["launches"])
    for phase, launched in phases.items():
        if any(launched[n] for n in fused_kernels + probe_kernels):
            raise AssertionError(f"{phase}: kernels 8, 9, 10 or 11 were launched: {launched}")

    phases["f2_checks"] = {**{n: 0 for n in kernels}, **f2_checks}

    # ---- 5. the fused EdgeConv route, all three blocks, float32 then bf16 encoder
    log("[fused] the three EdgeConv blocks by the fused route (kernels 8, 9) vs the module")
    fused_launches, fused_eval, block_ms, fused_shares = fused_phase(
        torch, blocks, xs, xq, kernels, args.seed)
    log("[fused] the bf16 encoder's blocks (bf16 e_raw: kernel 8 and kernel 9 in their bf16 "
        "forms, kernel 6's bf16 form) vs the bf16 module")
    fused_launches16, fused_eval16, block_ms16, fused_shares16 = fused_phase(
        torch, blocks16, xs16, xq16, kernels, args.seed, FUSED_BF16_GATES)
    phases.update(fused_train=fused_launches, fused_eval=fused_eval,
                  fused_train_bf16=fused_launches16, fused_eval_bf16=fused_eval16)
    log(f"[fused] launches: train {fused_launches}; eval {fused_eval}; bf16 encoder train "
        f"{fused_launches16}; eval {fused_eval16}")
    log(f"[fused] largest share of each gate, f32 route {fused_shares}; bf16 route "
        f"{fused_shares16}")
    if any(c[n] for c in (fused_launches, fused_eval, fused_launches16, fused_eval16)
           for n in probe_kernels):
        raise AssertionError("the fused route launched kernel 10 or 11")

    # ---- 6. the archived Chebyshev probes (kernels 10, 11)
    log("[probe] the archived Chebyshev probes' main() on the card (kernels 10, 11)")
    probe_launches, proto_probe, rows["matmul_only"] = probe_phase(
        torch, cuda_proto_cheby, cuda_cheby, kernels)
    rows["matmul_only"]["f2"] = matmul_f2
    phases["probe"] = probe_launches
    rows["proto_cheby"]["probe"] = proto_probe
    log(f"[probe] launches {probe_launches}")

    sources = {"knn": ("knn.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27"),
               "attention_fwd": ("attention_fwd.cu", "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_bwd": ("attention_bwd.cu", "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "attention_fwd_bf16": ("attention_fwd_bf16.cu",
                                      "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_bwd_bf16": ("attention_bwd_bf16.cu",
                                      "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "knn_bf16": ("knn.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27"),
               "scatter_add_bf16": ("scatter_add.cu", "r3dfsseg_tpu/ops/fast_gather.py:40"),
               "fps": ("fps.cu", "r3dfsseg_tpu/ops/pallas_fps.py:46"),
               "kth": ("kth.cu", "r3dfsseg_tpu/ops/pallas_kth.py:33"),
               "scatter_add": ("scatter_add.cu", "r3dfsseg_tpu/ops/fast_gather.py:40"),
               "cheby": ("proto_cheby.cu", "r3dfsseg_tpu/ops/pallas_cheby.py:42"),
               "gather_onehot": ("gather.cu", "r3dfsseg_tpu/ops/fast_gather.py:89"),
               "fused_edge": ("fused_edge.cu", "scripts/archive/fused_edge.py:213"),
               **{f"fused_edge_bf16_{p}": ("fused_edge.cu", "scripts/archive/fused_edge.py:213")
                  for p in cuda_fused_edge.PASSES},
               **{f"fused_edge_general_{p}": ("fused_edge_general.cu",
                                              "scripts/archive/fused_edge.py:213")
                  for p in cuda_fused_edge.PASSES},
               "gather_onehot_narrow": ("gather.cu", "r3dfsseg_tpu/ops/fast_gather.py:89"),
               "proto_cheby": ("proto_cheby.cu", "scripts/archive/proto_cheby_pallas.py:22"),
               "matmul_only": ("matmul_probe.cu", "scripts/archive/proto_cheby2.py:36"),
               "knn_general": ("knn_general.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27"),
               "knn_packed": ("knn_general.cu", "r3dfsseg_tpu/ops/pallas_knn.py:27"),
               "attention_wide_tf32_fwd": ("attention_wide.cu",
                                           "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_wide_tf32_bwd": ("attention_wide.cu",
                                           "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "attention_wide_tc_fwd_bf16": ("attention_wide_bf16.cu",
                                              "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_wide_tc_bwd_bf16": ("attention_wide_bf16.cu",
                                              "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "attention_wide_group_fwd_bf16": ("attention_group_bf16.cu",
                                                 "r3dfsseg_tpu/ops/pallas_attention.py:54"),
               "attention_wide_group_bwd_bf16": ("attention_group_bf16.cu",
                                                 "r3dfsseg_tpu/ops/pallas_attention.py:78"),
               "kth_wide": ("kth.cu", "r3dfsseg_tpu/ops/pallas_kth.py:33"),
               "scatter_general": ("scatter_general.cu", "r3dfsseg_tpu/ops/fast_gather.py:40")}
    # each entry's counters, and the phase whose count is its "launches":
    # the float32 graph's training run; cheby's the bf16 graph's, which
    # alone launches it; the bf16 forms of kernels 2, 5 and 6 the bf16
    # encoder's training run, kernel 1's bf16 input its 'hybrid' serving
    # run (the default 'fastvar' feeds kNN f32); kernels 8 and 9 the fused
    # route's; kernels 10 and 11 the probe phase's; the general kNN, the
    # f32 wide (3xTF32) attention and general scatter-add the F1 configuration's
    # training run (the wide tensor-core bf16 attention its bf16
    # encoder's, the grouped pair the bf16 encoder's at output_dim 320),
    # the packed kNN the 'pallas' training run, and the wide-row k-th
    # distance, which no configuration of these sizes reaches (rows past
    # 57.7k nodes), the F1 checks' (the counters zeroed before them);
    # kernel 9's bf16 form the bf16
    # encoder's fused route, and the general kernel 9 and the narrow gather
    # the F2 checks' (no configuration reaches them)
    members = {name: (name,) for name in sources}
    members["fused_edge"] = fused_passes
    members.update({f"fused_edge_{pre}{p}": (f"fused_{pre}{p}",) for pre in ("bf16_", "general_")
                    for p in cuda_fused_edge.PASSES})
    main_phase = {name: "train_f32" for name in sources}
    main_phase.update(cheby="train_bf16", gather_onehot="fused_train", fused_edge="fused_train",
                      proto_cheby="probe", matmul_only="probe",
                      attention_fwd_bf16="train_bf16enc", attention_bwd_bf16="train_bf16enc",
                      scatter_add_bf16="train_bf16enc", knn_bf16="serve_hybrid",
                      gather_onehot_narrow="f2_checks",
                      **{f"fused_edge_bf16_{p}": "fused_train_bf16"
                         for p in cuda_fused_edge.PASSES},
                      **{f"fused_edge_general_{p}": "f2_checks" for p in cuda_fused_edge.PASSES},
                      knn_general="train_f1", attention_wide_tf32_fwd="pretrain",
                      attention_wide_tf32_bwd="pretrain", scatter_general="train_f1",
                      attention_wide_tc_fwd_bf16="train_f1_bf16enc",
                      attention_wide_tc_bwd_bf16="train_f1_bf16enc",
                      attention_wide_group_fwd_bf16="train_f1_320_bf16enc",
                      attention_wide_group_bwd_bf16="train_f1_320_bf16enc",
                      knn_packed="train_pallas",
                      kth_wide="f1_checks")
    for p in cuda_fused_edge.PASSES:
        rows["fused_edge"]["passes"][p].update(
            {f"launches_{ph}": c[f"fused_{p}"] for ph, c in phases.items()},
            launches=fused_launches[f"fused_{p}"])
    rows["fused_edge"]["block_ms"] = block_ms
    rows["fused_edge"]["bf16"].update(block_ms=block_ms16, gate_shares=fused_shares16)
    rows["fused_edge"]["gate_shares"] = fused_shares
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"r3dfsseg_tpu_torch/csrc/{src}",
         "replaces": rep,
         "launches": sum(phases[main_phase[name]][m] for m in members[name]),
         **{f"launches_{ph}": sum(c[m] for m in members[name]) for ph, c in phases.items()},
         **rows[name]}
        for name, (src, rep) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
