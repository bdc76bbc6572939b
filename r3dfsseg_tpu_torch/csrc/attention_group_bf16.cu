// Single-head attention forward and backward on bf16 q, k, v at head widths
// D > 256, D % 8 == 0 (r3d_attn_group_fwd_bf16, r3d_attn_group_bwd_bf16):
// the bf16 encoder's attention past attention_wide_bf16.cu's four channel
// tiles, on the same bf16 tensor-core tiles, with no upper limit on D.  The
// wrapper zero-pads an unaligned D to a multiple of 8 (exact).
//
// Replaces the TPU kernels r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (:54, via _fwd_impl :160) and _attn_bwd_kernel (:78, via
// _bwd_impl :190), their lowp branch at D > 256 (`--output_dim` or
// `dg_atten_dim` above 256 on the bf16 encoder).  The function and its
// roundings are attention_wide_bf16.cu's: the same Philox mask, q *
// bf16(1 / tau) rounded to bf16, bf16 mma.sync.m16n8k16 products with f32
// sums; forward in two passes (each row's max m and sum l over all keys,
// then P = exp(s - m) * (1 / l) times the mask, rounded to bf16 before P V),
// lse = m + log l and y in f32; backward with P = exp(s - lse), dY, Pd and
// dS rounded to bf16 before their products, Delta = rowsum(bf16(dY) * Y),
// dK from the unscaled q, dQ and dK times the f32 1 / tau.
//
// The design: channel groups.  A warp's 16 x D f32 accumulator would take
// D / 2 registers a lane, and attention_wide_bf16.cu's four-tile kernels
// already hold 198-255, so the outputs' channels (y; dQ, dK, dV) are cut into G groups
// of at most 4 tiles of 64 (ceil(tiles / G) tiles each, the last group cut
// at D: D = 320 is 3 + 2 tiles, 512 is 4 + 4), one group per block along
// the grid's z axis.  A group's accumulator is then that file's T = 4 one.
// The contractions over all of D (S = q k^T; dPd = dY v^T) are summed in
// chunks of C channel tiles streamed through the two-stage cp.async ring,
// the block's own rows with them, so no operand is ever staged at the full
// D: a step of the ring is one chunk of one column tile, and a warp's
// score pass (32 columns at most, S >= 2 splits) sums its k-steps over
// the chunks in channel order, then meets the softmax and the group's
// product.  Every group runs the same k-steps in the same order with the
// same code, so its m, l and P are the other groups' bit for bit and the
// groups' slices of y and of the gradients are what one block would write;
// group 0 alone writes lse.  The group's tile of the output product's
// operand (V; K in dQ; dY or q in dK/dV) is staged once per column tile,
// with the tile's second chunk, into one buffer that the tile's last chunk
// reads (so D must span at least two chunks, which D > 256 does).
// Shared memory (C = 2 in the forward, 1 in the backward): two stages and
// the group tile come to 72-81 KB, so two blocks of 4 warps fit an SM.
// The dK/dV kernel sums dV and dK in two sweeps over the queries, one
// accumulator at a time, as attention_wide_bf16.cu does.  No float atomics
// and a fixed order of sums: a call repeats bit for bit.
//
// What bounds it on the H100: the products, 4 B N^2 D operations forward
// and 10 B N^2 D backward on 989 TFLOP/s of bf16 tensor cores (0.0651 ms
// and 0.163 ms at a training step's two calls, B = 10 + 2, N = 2048, D =
// 320).  The groups repeat S (and dPd): in (N x N x D) products a cloud
// takes 2 G + 1 in the forward (2 S per group, then P V over its slice) and
// 5 G + 3 in the backward (dK/dV: S, dV; S, dPd, dK; dQ: S, dPd, dQ), where
// attention_wide_bf16.cu's one-group kernels take 3 and 8 and the bound
// counts 2 and 5: at D = 320 (G = 2) 5 and 13 products.
#include <algorithm>
#include <cmath>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace r3d_attn;

constexpr int kGroupTiles = 4;               // channel tiles of an output group, at most
constexpr int kGroupW = kDP * kGroupTiles;   // its channels
constexpr int kFwdChunk = 2;                 // channel tiles of a forward chunk
constexpr int kBwdChunk = 1;                 // of a backward chunk

// q * scale rounded to bf16, 8 entries a thread-step (the forward's scaled
// q; the backward's comes from attn_bwd_prep_bf16_kernel).
__global__ void attn_scale_bf16_kernel(const uint4* __restrict__ q, uint4* __restrict__ qs,
                                       size_t count, float scale) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint4 w = q[e];
    qs[e] = make_uint4(r3d::pack_bf16(r3d::bf16_lo(w.x) * scale, r3d::bf16_hi(w.x) * scale),
                       r3d::pack_bf16(r3d::bf16_lo(w.y) * scale, r3d::bf16_hi(w.y) * scale),
                       r3d::pack_bf16(r3d::bf16_lo(w.z) * scale, r3d::bf16_hi(w.z) * scale),
                       r3d::pack_bf16(r3d::bf16_lo(w.w) * scale, r3d::bf16_hi(w.w) * scale));
  }
}

// A block's place: its cloud, its group's first channel c0 and width w,
// and the chunks of C tiles that span d.
template <int C>
struct Place {
  int b, c0, w, chunks;
  size_t base;
  __device__ Place(int n, int d, int gw)
      : b(blockIdx.y), c0(blockIdx.z * gw), w(min(gw, d - static_cast<int>(blockIdx.z) * gw)),
        chunks((d + kDP * C - 1) / (kDP * C)), base(static_cast<size_t>(blockIdx.y) * n * d) {}
  // the first channel of chunk h
  __device__ int ch(int h) const { return h * kDP * C; }
};

// ---- forward ------------------------------------------------------------
// A stage: a K chunk of a key tile, then the block's rows of the scaled q
// chunk; after the two stages, the group's V tile (merge_stats' slots in
// pass 1, when no V tile is staged).
__host__ __device__ constexpr size_t fwd_stage(int c, int s) {
  return (kChunk + 16 * kWarps / s) * kDP * c;
}
constexpr size_t fwd_smem(int c, int s) {
  return sizeof(uint16_t) * (2 * fwd_stage(c, s) + kChunk * kGroupW);
}

template <int C, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_group_fwd_bf16_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v, float* __restrict__ y,
                           float* __restrict__ lse, int n, int d, int gw, r3d::Dropout drop) {
  static_assert(S >= 2, "a warp's keys of a tile are one pass of at most 32");
  constexpr int kRows = 16 * kWarps / S;  // queries of a block
  constexpr int kCols = kChunk / S;       // keys of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kKc = kChunk * kDP * C;   // bf16 entries of a staged K chunk
  constexpr int kStage = static_cast<int>(fwd_stage(C, S));
  extern __shared__ __align__(16) float smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vt = ring + 2 * kStage;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = 16 * (warp / S);  // the warp's first row in the block's q chunk
  const int row0 = blockIdx.x * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first key of the warp
  const Place<C> at(n, d, gw);
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step i: chunk i % chunks of key tile i / chunks; pass 2 also stages the
  // tile's V slice with its second chunk, when every warp is done with the
  // previous tile's
  auto stage = [&](int i, bool with_v) {
    const int c = i / at.chunks, h = i % at.chunks;
    uint16_t* st = ring + (i & 1) * kStage;
    stage_cols_bf16<C>(k + at.base + at.ch(h), c * kChunk, n, d, d - at.ch(h), st);
    stage_cols_bf16<C, kRows>(qs + at.base + at.ch(h), blockIdx.x * kRows, n, d, d - at.ch(h),
                              st + kKc);
    if (with_v && h == 1) stage_cols_bf16<kGroupTiles>(v + at.base + at.c0, c * kChunk, n, d,
                                                       at.w, vt);
  };
  // acc += the scores of step i's chunk
  auto scores = [&](float (&acc)[NT][4], int i) {
    const uint16_t* st = ring + (i & 1) * kStage;
    const int h = i % at.chunks;
    product_along_channels_wide<C, NT>(acc, st + kKc, r0, st, cb, min(kDP * C, d - at.ch(h)));
  };

  // 1. the row statistics
  stage(0, false);
  r3d::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[NT][4];
  zero(s);
  for (int i = 0; i < steps; ++i) {
    r3d::cp_async_wait_all();
    __syncthreads();  // step i has arrived; every warp is done with step i - 1
    if (i + 1 < steps) stage(i + 1, false);
    r3d::cp_async_commit();
    scores(s, i);
    if (i % at.chunks == at.chunks - 1) {
      mask_ragged_keys<NT>(s, i / at.chunks * kChunk + cb, n, t);
      row_stats<NT>(s, m, l);
      zero(s);
    }
  }
  merge_stats<S>(reinterpret_cast<float*>(vt), m, l, warp);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};

  // 2. O = P V over the group's channels, with the normalised P
  __syncthreads();  // every warp is done with pass 1's ring and the slots
  stage(0, true);
  r3d::cp_async_commit();
  float o[8 * kGroupTiles][4];
  zero(o);
  for (int i = 0; i < steps; ++i) {
    r3d::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < steps) stage(i + 1, true);
    r3d::cp_async_commit();
    scores(s, i);
    if (i % at.chunks == at.chunks - 1) {
      const int key0 = i / at.chunks * kChunk + cb;
      mask_ragged_keys<NT>(s, key0, n, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_fast((s[j][e] - m[e >> 1]) * kLog2e) * inv[e >> 1];  // 0 on masked keys
        if constexpr (kDropout) {
          const float4 f = row_mask(drop, at.b, row0 + g, key0 + 8 * j + 2 * t);
          s[j][0] *= f.x;
          s[j][1] *= f.y;
          s[j][2] *= f.z;
          s[j][3] *= f.w;
        }
      }
      product_along_rows_bf16<NT, kGroupTiles>(o, s, vt, cb, at.w);
      zero(s);
    }
  }
  finish_sums<S>(smem, o, m, l, y + at.c0, blockIdx.z == 0 ? lse : nullptr, at.base, at.b, n,
                 at.w, d, row0, warp, g, t);
}

// ---- backward -----------------------------------------------------------
// dK/dV: a stage holds the block's rows of the K and V chunks, then the
// scaled q and bf16 dY chunks of a query tile; after the two stages, the
// group's tile of bf16 dY (sweep 1) or q (sweep 2), then the query tile's
// lse and Delta.
__host__ __device__ constexpr size_t dkdv_stage(int c, int s) {
  return 2 * (16 * kWarps / s + kChunk) * kDP * c;
}
constexpr size_t dkdv_smem(int c, int s) {
  return sizeof(uint16_t) * (2 * dkdv_stage(c, s) + kChunk * kGroupW) +
         2 * sizeof(float) * kChunk;
}
// dQ: a stage holds the K and V chunks of a key tile, then the block's rows
// of the scaled q and bf16 dY chunks; after the two stages, the group's K
// tile.
__host__ __device__ constexpr size_t dq_stage(int c, int s) {
  return 2 * (kChunk + 16 * kWarps / s) * kDP * c;
}
constexpr size_t dq_smem(int c, int s) {
  return sizeof(uint16_t) * (2 * dq_stage(c, s) + kChunk * kGroupW);
}

// (a) dV, then dK, of the group's channels of a warp's 16 keys.  Score
// tiles are (key, query).
template <int C, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_group_dkdv_bf16_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ q,
                            const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                            const uint16_t* __restrict__ dyb, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dk,
                            float* __restrict__ dv, int n, int d, int gw, float scale,
                            r3d::Dropout drop) {
  static_assert(S >= 2, "a warp's queries of a tile are one pass of at most 32");
  constexpr int kRows = 16 * kWarps / S;  // keys of a block
  constexpr int kCols = kChunk / S;       // queries of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kRc = kRows * kDP * C;    // bf16 entries of the block's rows of a chunk
  constexpr int kQc = kChunk * kDP * C;   // of a query tile's chunk
  constexpr int kStage = static_cast<int>(dkdv_stage(C, S));
  extern __shared__ __align__(16) float smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* gt = ring + 2 * kStage;
  float* stats = reinterpret_cast<float*>(gt + kChunk * kGroupW);  // lse, then Delta
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = 16 * (warp / S);
  const int key0 = blockIdx.x * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first query of the warp
  const Place<C> at(n, d, gw);
  const float* lse_b = lse + static_cast<size_t>(at.b) * n;
  const float* delta_b = delta + static_cast<size_t>(at.b) * n;
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step i: chunk i % chunks of the block's keys and of query tile i /
  // chunks (K and the scaled q; sweep 2 also V and dY), and with the
  // second chunk the tile's group slice of dY (sweep 1) or q (sweep 2),
  // its lse and Delta (zeros past n, whose terms then vanish)
  auto stage = [&](int i, bool sweep2) {
    const int c = i / at.chunks, h = i % at.chunks;
    const int ch = at.ch(h);
    uint16_t* st = ring + (i & 1) * kStage;
    stage_cols_bf16<C, kRows>(k + at.base + ch, blockIdx.x * kRows, n, d, d - ch, st);
    stage_cols_bf16<C>(qs + at.base + ch, c * kChunk, n, d, d - ch, st + 2 * kRc);
    if (sweep2) {
      stage_cols_bf16<C, kRows>(v + at.base + ch, blockIdx.x * kRows, n, d, d - ch, st + kRc);
      stage_cols_bf16<C>(dyb + at.base + ch, c * kChunk, n, d, d - ch, st + 2 * kRc + kQc);
    }
    if (h != 1) return;
    stage_cols_bf16<kGroupTiles>((sweep2 ? q : dyb) + at.base + at.c0, c * kChunk, n, d, at.w,
                                 gt);
    static_assert(kThreads == 2 * kChunk, "one thread per lse and Delta entry");
    const int e = threadIdx.x;
    const float* src = e < kChunk ? lse_b : delta_b;
    const int row = c * kChunk + (e & (kChunk - 1));
    r3d::cp_async4(stats + e, row < n ? src + row : src, row < n);
  };
  auto width = [&](int i) { return min(kDP * C, d - at.ch(i % at.chunks)); };
  float acc[8 * kGroupTiles][4];
  float s[NT][4], dp[NT][4];

  // 1. dV = Pd^T dY
  stage(0, false);
  r3d::cp_async_commit();
  zero(acc);
  zero(s);
  for (int i = 0; i < steps; ++i) {
    const uint16_t* st = ring + (i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < steps) stage(i + 1, false);
    r3d::cp_async_commit();
    product_along_channels_wide<C, NT>(s, st, r0, st + 2 * kRc, cb, width(i));  // S^T
    if (i % at.chunks != at.chunks - 1) continue;
    const int c = i / at.chunks;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(stats + cb + 8 * j + 2 * t);
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = col_mask(drop, at.b, key0, c * kChunk + cb + 8 * j);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e) * fs[e];  // Pd^T
    }
    product_along_rows_bf16<NT, kGroupTiles>(acc, s, gt, cb, at.w);  // dV += Pd^T dY
    zero(s);
  }
  store_rows<S>(smem, acc, dv + at.c0, at.base, key0, n, at.w, d, 1.f, warp, g, t);

  // 2. dK = dS^T q / tau
  __syncthreads();  // every warp is done with the ring and the merge's slots
  stage(0, true);
  r3d::cp_async_commit();
  zero(acc);
  zero(dp);
  for (int i = 0; i < steps; ++i) {
    const uint16_t* st = ring + (i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < steps) stage(i + 1, true);
    r3d::cp_async_commit();
    product_along_channels_wide<C, NT>(s, st, r0, st + 2 * kRc, cb, width(i));  // S^T
    product_along_channels_wide<C, NT>(dp, st + kRc, r0, st + 2 * kRc + kQc, cb,
                                       width(i));  // dPd^T
    if (i % at.chunks != at.chunks - 1) continue;
    const int c = i / at.chunks;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(stats + cb + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(stats + kChunk + cb + 8 * j + 2 * t);
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = col_mask(drop, at.b, key0, c * kChunk + cb + 8 * j);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e);
        dp[j][e] = pe * (dp[j][e] * fs[e] - ((e & 1) ? dl.y : dl.x));  // dS^T
      }
    }
    product_along_rows_bf16<NT, kGroupTiles>(acc, dp, gt, cb, at.w);  // dK += dS^T q
    zero(s);
    zero(dp);
  }
  store_rows<S>(smem, acc, dk + at.c0, at.base, key0, n, at.w, d, scale, warp, g, t);
}

// (b) dQ of the group's channels of a warp's 16 queries.  Score tiles are
// (query, key).
template <int C, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_group_dq_bf16_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v, const uint16_t* __restrict__ dyb,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int n, int d, int gw, float scale,
                          r3d::Dropout drop) {
  static_assert(S >= 2, "a warp's keys of a tile are one pass of at most 32");
  constexpr int kRows = 16 * kWarps / S;  // queries of a block
  constexpr int kCols = kChunk / S;       // keys of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kKc = kChunk * kDP * C;   // bf16 entries of a key tile's chunk
  constexpr int kRc = kRows * kDP * C;    // of the block's rows of a chunk
  constexpr int kStage = static_cast<int>(dq_stage(C, S));
  extern __shared__ __align__(16) float smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* kg = ring + 2 * kStage;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = 16 * (warp / S);
  const int row0 = blockIdx.x * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first key of the warp
  const Place<C> at(n, d, gw);
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step i: chunk i % chunks of key tile i / chunks (K, V) and of the
  // block's rows (scaled q, dY), and with the second chunk the tile's group
  // slice of K
  auto stage = [&](int i) {
    const int c = i / at.chunks, h = i % at.chunks;
    const int ch = at.ch(h);
    uint16_t* st = ring + (i & 1) * kStage;
    stage_cols_bf16<C>(k + at.base + ch, c * kChunk, n, d, d - ch, st);
    stage_cols_bf16<C>(v + at.base + ch, c * kChunk, n, d, d - ch, st + kKc);
    stage_cols_bf16<C, kRows>(qs + at.base + ch, blockIdx.x * kRows, n, d, d - ch, st + 2 * kKc);
    stage_cols_bf16<C, kRows>(dyb + at.base + ch, blockIdx.x * kRows, n, d, d - ch,
                              st + 2 * kKc + kRc);
    if (h == 1) stage_cols_bf16<kGroupTiles>(k + at.base + at.c0, c * kChunk, n, d, at.w, kg);
  };

  stage(0);
  r3d::cp_async_commit();
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lq[r] = row < n ? lse[static_cast<size_t>(at.b) * n + row] : 0.f;
    dl[r] = row < n ? delta[static_cast<size_t>(at.b) * n + row] : 0.f;
  }
  float acc[8 * kGroupTiles][4];
  float s[NT][4], dp[NT][4];
  zero(acc);
  zero(s);
  zero(dp);
  for (int i = 0; i < steps; ++i) {
    const uint16_t* st = ring + (i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < steps) stage(i + 1);
    r3d::cp_async_commit();
    const int w = min(kDP * C, d - at.ch(i % at.chunks));
    product_along_channels_wide<C, NT>(s, st + 2 * kKc, r0, st, cb, w);           // S
    product_along_channels_wide<C, NT>(dp, st + 2 * kKc + kRc, r0, st + kKc, cb, w);  // dPd
    if (i % at.chunks != at.chunks - 1) continue;
    const int j0 = i / at.chunks * kChunk + cb;
    const bool ragged = j0 + kCols > n;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = row_mask(drop, at.b, row0 + g, j0 + 8 * j + 2 * t);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_fast((s[j][e] - lq[e >> 1]) * kLog2e);
        // a key past n has zero K and V, but exp(0 - lse) may overflow
        if (ragged && j0 + 8 * j + 2 * t + (e & 1) >= n) pe = 0.f;
        s[j][e] = pe * (dp[j][e] * fs[e] - dl[e >> 1]);  // dS
      }
    }
    product_along_rows_bf16<NT, kGroupTiles>(acc, s, kg, cb, at.w);  // dQ += dS K
    zero(s);
    zero(dp);
  }
  store_rows<S>(smem, acc, dq + at.c0, at.base, row0, n, at.w, d, scale, warp, g, t);
}

static_assert(fwd_smem(kFwdChunk, 2) <= r3d::kSmemLimit &&
                  dkdv_smem(kBwdChunk, 2) <= r3d::kSmemLimit &&
                  dq_smem(kBwdChunk, 2) <= r3d::kSmemLimit,
              "every launch fits one block's shared memory");
static_assert(fwd_smem(kFwdChunk, 4) >= sizeof(float) * 4 * 8 * kGroupTiles * kThreads &&
                  dkdv_smem(kBwdChunk, 4) >= sizeof(float) * 4 * 8 * kGroupTiles * kThreads &&
                  dq_smem(kBwdChunk, 4) >= sizeof(float) * 4 * 8 * kGroupTiles * kThreads,
              "store_rows' lane slots fit the shared memory");

// The launch shape: G groups of ceil(tiles / G) channel tiles (gw
// channels), and S key or query splits, the smallest of 2 and 4 that
// starts four blocks an SM over the groups' blocks (attention.cuh
// `splits`; S >= 2 keeps a warp's columns of a tile to one pass of 32).
struct Plan {
  int groups, gw, s;
};

Plan plan(int b, int n, int d) {
  const int tiles = (d + kDP - 1) / kDP;
  const int groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  const int blocks = static_cast<int>(std::min(1LL * b * groups, 1LL << 24));
  return {groups, kDP * ((tiles + groups - 1) / groups), std::max(2, splits(blocks, n))};
}

// f(S, kDropout) with S (2 or 4) and the dropout flag as compile-time
// constants.
template <typename F>
cudaError_t dispatch(int s, bool dropout, F&& f) {
  auto with_s = [&](auto sc) {
    return dropout ? f(sc, std::true_type{}) : f(sc, std::false_type{});
  };
  return s == 2 ? with_s(std::integral_constant<int, 2>{})
                : with_s(std::integral_constant<int, 4>{});
}

dim3 grid_of(int b, int n, int s, int groups) {
  return dim3((n + 16 * kWarps / s - 1) / (16 * kWarps / s), b, groups);
}

// The prep pass of the forward: qs = bf16(q * scale).
cudaError_t scale_q(const uint16_t* q, uint16_t* qs, size_t entries, float scale,
                    cudaStream_t st) {
  const size_t count = entries / 8;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  attn_scale_bf16_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const uint4*>(q),
                                                  reinterpret_cast<uint4*>(qs), count, scale);
  return cudaGetLastError();
}

bool takes(int b, int n, int d) {
  return b >= 1 && b <= 65535 && n >= 1 && d > 4 * kDP && d % 8 == 0 &&
         (d + kDP - 1) / kDP <= kGroupTiles * 65535;
}

}  // namespace

// The forward: q, k, v (B, N, D) bf16 contiguous, D > 256, D % 8 == 0 ->
// y (B, N, D) f32 and, when lse is not null, lse (B, N) f32.  Scratch from
// the wrapper: qs (B, N, D) bf16.  scale = bf16(1 / tau); the dropout
// arguments as r3d_attn_fwd's.
R3D_EXPORT int r3d_attn_group_fwd_bf16(const void* q, const void* k, const void* v, void* y,
                                       void* lse, void* qs, int b, int n, int d, float scale,
                                       int dropout, unsigned seed_lo, unsigned seed_hi,
                                       unsigned threshold, float keep_scale, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto qsp = static_cast<uint16_t*>(qs);
  cudaError_t err = scale_q(static_cast<const uint16_t*>(q), qsp,
                            static_cast<size_t>(b) * n * d, scale, st);
  if (err != cudaSuccess) return err;
  const Plan p = plan(b, n, d);
  return dispatch(p.s, dropout != 0, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    return r3d_launch(attn_group_fwd_bf16_kernel<kFwdChunk, S, decltype(dc)::value>,
                      grid_of(b, n, S, p.groups), dim3(kThreads), fwd_smem(kFwdChunk, S), st,
                      static_cast<const uint16_t*>(qsp), static_cast<const uint16_t*>(k),
                      static_cast<const uint16_t*>(v), static_cast<float*>(y),
                      static_cast<float*>(lse), n, d, p.gw, drop);
  });
}

// The backward, with r3d_attn_wide_tc_bwd_bf16's arguments: q, k, v as the
// forward's; y, dy (B, N, D) f32, lse (B, N) f32 -> dq, dk, dv (B, N, D)
// f32.  Scratch from the wrapper: delta (B, N) f32, qs and dyb (B, N, D)
// bf16.  scale = 1 / tau (f32), qscale = bf16(1 / tau), the forward's.
R3D_EXPORT int r3d_attn_group_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* y, const void* dy, const void* lse,
                                       void* delta, void* qs, void* dyb, void* dq, void* dk,
                                       void* dv, int b, int n, int d, float scale, float qscale,
                                       int dropout, unsigned seed_lo, unsigned seed_hi,
                                       unsigned threshold, float keep_scale, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const uint16_t*>(q);
  auto kp = static_cast<const uint16_t*>(k);
  auto vp = static_cast<const uint16_t*>(v);
  auto lp = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  auto qsp = static_cast<uint16_t*>(qs);
  auto dybp = static_cast<uint16_t*>(dyb);
  const int rows = b * n;
  attn_bwd_prep_bf16_kernel<><<<(rows * 32 + 255) / 256, 256, 0, st>>>(
      qp, static_cast<const float*>(dy), static_cast<const float*>(y), dl, qsp, dybp, rows, d,
      qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale};
  const Plan p = plan(b, n, d);
  err = dispatch(p.s, dropout != 0, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    return r3d_launch(attn_group_dkdv_bf16_kernel<kBwdChunk, S, decltype(dc)::value>,
                      grid_of(b, n, S, p.groups), dim3(kThreads), dkdv_smem(kBwdChunk, S), st,
                      static_cast<const uint16_t*>(qsp), qp, kp, vp,
                      static_cast<const uint16_t*>(dybp), lp, static_cast<const float*>(dl),
                      static_cast<float*>(dk), static_cast<float*>(dv), n, d, p.gw, scale, drop);
  });
  if (err != cudaSuccess) return err;
  return dispatch(p.s, dropout != 0, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    return r3d_launch(attn_group_dq_bf16_kernel<kBwdChunk, S, decltype(dc)::value>,
                      grid_of(b, n, S, p.groups), dim3(kThreads), dq_smem(kBwdChunk, S), st,
                      static_cast<const uint16_t*>(qsp), kp, vp,
                      static_cast<const uint16_t*>(dybp), lp, static_cast<const float*>(dl),
                      static_cast<float*>(dq), n, d, p.gw, scale, drop);
  });
}
