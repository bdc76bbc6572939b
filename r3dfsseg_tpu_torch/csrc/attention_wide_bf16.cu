// Single-head attention forward and backward on bf16 q, k, v at head widths
// 64 < D <= 256, D % 8 == 0 (r3d_attn_wide_tc_fwd_bf16,
// r3d_attn_wide_tc_bwd_bf16): the bf16 encoder's attention past the tuned
// kernels' 64 channels, on bf16 tensor-core tiles.  The wrapper zero-pads
// an unaligned D to a multiple of 8 (exact); f32 q, k, v at D > 64 run
// attention_wide.cu, bf16 at D > 256 attention_group_bf16.cu.
//
// Replaces the TPU kernels r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (:54, via _fwd_impl :160) and _attn_bwd_kernel (:78, via
// _bwd_impl :190), their lowp branch at D > 64 (the pretraining network's
// 128-wide head, r3dfsseg_tpu/config.py:60; `--output_dim` above 64 on the
// bf16 encoder).  The function and its roundings are the tuned bf16 forms'
// (attention_fwd_bf16.cu:r3d_attn_fwd_bf16,
// attention_bwd_bf16.cu:r3d_attn_bwd_bf16): the same Philox mask, q *
// bf16(1 / tau) rounded to bf16, bf16 products with f32 sums
// (mma.sync.m16n8k16 here, wgmma in the tuned pair); forward in two passes
// (each row's max m and sum l over all keys, then P = exp(s - m) * (1 / l)
// times the mask, rounded to bf16 before P V: the TPU kernel rounds the
// normalised P), lse = m + log l and y in f32; backward with P = exp(s -
// lse) recomputed from the forward's lse, dY, Pd and dS rounded to bf16
// before their products, Delta = rowsum(bf16(dY) * Y), dK from the
// unscaled q, dQ and dK times the f32 1 / tau.
//
// The design is the f32 tuned kernels' in bf16, widened: 4 warps a block,
// a warp owns 16 rows (queries; keys in dK/dV), 64-row tiles of the column
// operands stream through a two-stage cp.async ring, fragments by ldmatrix
// from XOR-swizzled tiles, S splits of the columns by B x N (attention.cuh
// `splits`), merged in split order.  What changes with the width:
//   - a staged row is T channel tiles of 64 (T = 2 for D <= 128, T = 4 up
//     to 256: one kernel per T, the runtime d stops the k-steps and output
//     tiles at d, so any D that is a multiple of 8 runs unpadded past it);
//   - a warp's own rows are not held in registers as the tuned kernels hold
//     them (16 x 256 bf16 is 64 registers a lane, on top of a 16 x D f32
//     accumulator of up to 128): the block's rows are staged once in shared
//     memory and read as A fragments by ldmatrix at each k-step;
//   - a warp takes the columns of a tile in passes of at most 32 (as the
//     tuned backward does), so scores stay at 16 registers;
//   - the dK/dV kernel sums dV and dK in two sweeps over the queries, each
//     with one 16 x D accumulator: sweep 1 recomputes S and sums Pd^T dY,
//     sweep 2 recomputes S and dPd and sums dS^T q.  That costs one S
//     product more than summing both at once: 5 (N x N x D) products per
//     cloud in dK/dV and 3 in dQ, 8 against the bound's 5 (the tuned bf16
//     backward takes 7); summing both at once would hold two accumulators,
//     256 registers a lane at D = 256.
// No float atomics and a fixed order of sums: a call repeats bit for bit.
//
// What bounds it on the H100: the products, 4 B N^2 D operations forward
// and 10 B N^2 D backward on 989 TFLOP/s of bf16 tensor cores, 0.0261 ms
// and 0.0651 ms at a training step's two calls (B = 10 + 2, N = 2048, D =
// 128); the bytes (q, k, v bf16, y, dy, dq, dk, dv f32) are below.  The
// design keeps every product on the tensor cores and every (N x N) tile in
// registers; as for the tuned bf16 forms, mma.sync issued by 4-8 warps an
// SM, each product behind its ldmatrix and the softmax between the
// products, sets the pace, not the tensor cores (PERF.md, section 6).
#include <cmath>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace r3d_attn;

constexpr int kPass = 32;  // columns of a warp's pass over a tile (register budget)

// x <- bf16(x * mul) for the `count` entries (a multiple of 8 kThreads) of
// a staged bf16 tile: the forward's q * bf16(1 / tau), rounded as
// load_rows_bf16 and the backward's pre-pass round it (zeros stay zeros).
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, float mul) {
  return r3d::pack_bf16(r3d::bf16_lo(w) * mul, r3d::bf16_hi(w) * mul);
}

__device__ __forceinline__ void scale_tile_bf16(uint16_t* tile, int count, float mul) {
  for (int e = 8 * threadIdx.x; e < count; e += 8 * kThreads) {
    const uint4 w = *reinterpret_cast<const uint4*>(tile + e);
    *reinterpret_cast<uint4*>(tile + e) = make_uint4(scaled_pair(w.x, mul), scaled_pair(w.y, mul),
                                                     scaled_pair(w.z, mul), scaled_pair(w.w, mul));
  }
}

// ---- forward ------------------------------------------------------------
// Shared memory: the ring (pass 1: two stages of a K tile; pass 2: two
// stages of a K and a V tile), the block's rows of q * scale, and the slots
// of merge_stats.
constexpr size_t fwd_smem(int t, int s) {
  return sizeof(uint16_t) * (4 * kChunk + 16 * kWarps / s) * kDP * t +
         sizeof(float) * 4 * kThreads;
}

template <int T, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_tc_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v, float* __restrict__ y,
                             float* __restrict__ lse, int n, int d, float scale,
                             r3d::Dropout drop) {
  constexpr int kTile = kChunk * kDP * T;  // bf16 entries of a staged K or V tile
  constexpr int kRows = 16 * kWarps / S;   // queries of a block
  constexpr int kCols = kChunk / S;        // keys of a tile per warp
  constexpr int kW = kCols < kPass ? kCols : kPass;
  constexpr int NT = kW / 8;
  extern __shared__ __align__(16) float smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* qt = ring + 4 * kTile;
  float* slots = reinterpret_cast<float*>(qt + kRows * kDP * T);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int b = blockIdx.y;
  const int r0 = 16 * (warp / S);  // the warp's first row in the block's q tile
  const int row0 = blockIdx.x * kRows + r0;
  const int col0 = (warp % S) * kCols;
  const size_t base = static_cast<size_t>(b) * n * d;
  const int tiles = (n + kChunk - 1) / kChunk;

  stage_tile_bf16<T, kRows>(q + base, blockIdx.x * kRows, n, d, qt);
  r3d::cp_async_commit();
  r3d::cp_async_wait_all();
  __syncthreads();
  scale_tile_bf16(qt, kRows * kDP * T, scale);  // published by the first barrier below
  stage_tile_bf16<T>(k + base, 0, n, d, ring);
  r3d::cp_async_commit();

  // 1. the row statistics
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int c = 0; c < tiles; ++c) {
    const uint16_t* kt = ring + (c & 1) * kTile;
    r3d::cp_async_wait_all();
    __syncthreads();  // tile c has arrived; every warp is done with tile c - 1
    if (c + 1 < tiles)
      stage_tile_bf16<T>(k + base, (c + 1) * kChunk, n, d, ring + ((c + 1) & 1) * kTile);
    r3d::cp_async_commit();
#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;  // tile-relative first key of the pass
      float s[NT][4];
      zero(s);
      product_along_channels_wide<T, NT>(s, qt, r0, kt, cb, d);
      mask_ragged_keys<NT>(s, c * kChunk + cb, n, t);
      row_stats<NT>(s, m, l);
    }
  }
  merge_stats<S>(slots, m, l, warp);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};

  // 2. O = P V with the normalised P
  __syncthreads();  // every warp is done with pass 1's ring
  stage_tile_bf16<T>(k + base, 0, n, d, ring);
  stage_tile_bf16<T>(v + base, 0, n, d, ring + kTile);
  r3d::cp_async_commit();
  float o[8 * T][4];
  zero(o);
  for (int c = 0; c < tiles; ++c) {
    const uint16_t* kt = ring + (c & 1) * 2 * kTile;
    r3d::cp_async_wait_all();
    __syncthreads();  // tile c has arrived; every warp is done with tile c - 1
    if (c + 1 < tiles) {
      uint16_t* next = ring + ((c + 1) & 1) * 2 * kTile;
      stage_tile_bf16<T>(k + base, (c + 1) * kChunk, n, d, next);
      stage_tile_bf16<T>(v + base, (c + 1) * kChunk, n, d, next + kTile);
    }
    r3d::cp_async_commit();
#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;
      const int key0 = c * kChunk + cb;
      float s[NT][4];
      zero(s);
      product_along_channels_wide<T, NT>(s, qt, r0, kt, cb, d);
      mask_ragged_keys<NT>(s, key0, n, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_fast((s[j][e] - m[e >> 1]) * kLog2e) * inv[e >> 1];  // 0 on masked keys
        if constexpr (kDropout) {
          const float4 f = row_mask(drop, b, row0 + g, key0 + 8 * j + 2 * t);
          s[j][0] *= f.x;
          s[j][1] *= f.y;
          s[j][2] *= f.z;
          s[j][3] *= f.w;
        }
      }
      product_along_rows_bf16<NT, T>(o, s, kt + kTile, cb, d);
    }
  }

  finish_sums<S>(smem, o, m, l, y, lse, base, b, n, d, d, row0, warp, g, t);
}

// ---- backward -----------------------------------------------------------
// dK/dV: a stage holds the scaled q, q and bf16 dY tiles, then lse and
// Delta of kChunk queries; after the two stages, the block's rows of K and
// of V.
__host__ __device__ constexpr size_t stage_bytes(int t) {
  return 3 * sizeof(uint16_t) * kChunk * kDP * t + 2 * sizeof(float) * kChunk;
}
constexpr size_t dkdv_smem(int t, int s) {
  return 2 * stage_bytes(t) + 2 * sizeof(uint16_t) * (16 * kWarps / s) * kDP * t;
}
// dQ: as the forward's pass 2, K and V tiles, then the block's rows of the
// scaled q and of bf16 dY
constexpr size_t dq_smem(int t, int s) {
  return sizeof(uint16_t) * (4 * kChunk + 2 * 16 * kWarps / s) * kDP * t;
}

// Issue the copy of the query tile at i0: the scaled q, q (sweep 2 only),
// bf16 dY, lse and Delta (zeros past n, whose terms then vanish: dY = 0 and
// Delta = 0 there).
template <int T>
__device__ __forceinline__ void stage_queries(const uint16_t* qs, const uint16_t* q,
                                              const uint16_t* dyb, const float* lse,
                                              const float* delta, int i0, int n, int d,
                                              bool with_q, char* dst) {
  constexpr int kTile = kChunk * kDP * T;
  uint16_t* tiles = reinterpret_cast<uint16_t*>(dst);
  stage_tile_bf16<T>(qs, i0, n, d, tiles);
  if (with_q) stage_tile_bf16<T>(q, i0, n, d, tiles + kTile);
  stage_tile_bf16<T>(dyb, i0, n, d, tiles + 2 * kTile);
  static_assert(kThreads == 2 * kChunk, "one thread per lse and Delta entry");
  float* stats = reinterpret_cast<float*>(tiles + 3 * kTile);
  const int e = threadIdx.x;
  const float* src = e < kChunk ? lse : delta;
  const int i = i0 + (e & (kChunk - 1));
  r3d::cp_async4(stats + e, i < n ? src + i : src, i < n);
}

// (a) dV, then dK, of a warp's 16 keys.  Score tiles are (key, query).
template <int T, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_tc_dkdv_bf16_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ q,
                              const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                              const uint16_t* __restrict__ dyb, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int n, int d, float scale,
                              r3d::Dropout drop) {
  constexpr int kTile = kChunk * kDP * T;
  constexpr int kRows = 16 * kWarps / S;  // keys of a block
  constexpr int kCols = kChunk / S;       // queries of a tile per warp
  constexpr int kW = kCols < kPass ? kCols : kPass;
  constexpr int NT = kW / 8;
  constexpr size_t kStage = stage_bytes(T);
  extern __shared__ __align__(16) float smem[];
  char* ring = reinterpret_cast<char*>(smem);
  uint16_t* kr = reinterpret_cast<uint16_t*>(ring + 2 * kStage);
  uint16_t* vr = kr + kRows * kDP * T;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int b = blockIdx.y;
  const int r0 = 16 * (warp / S);
  const int key0 = blockIdx.x * kRows + r0;
  const int col0 = (warp % S) * kCols;
  const size_t base = static_cast<size_t>(b) * n * d;
  const float* lse_b = lse + static_cast<size_t>(b) * n;
  const float* delta_b = delta + static_cast<size_t>(b) * n;
  const int tiles = (n + kChunk - 1) / kChunk;

  stage_tile_bf16<T, kRows>(k + base, blockIdx.x * kRows, n, d, kr);
  stage_tile_bf16<T, kRows>(v + base, blockIdx.x * kRows, n, d, vr);
  stage_queries<T>(qs + base, q + base, dyb + base, lse_b, delta_b, 0, n, d, false, ring);
  r3d::cp_async_commit();
  float acc[8 * T][4];

  // 1. dV = Pd^T dY
  zero(acc);
  for (int c = 0; c < tiles; ++c) {
    const uint16_t* qst = reinterpret_cast<const uint16_t*>(ring + (c & 1) * kStage);
    const uint16_t* dyt = qst + 2 * kTile;
    const float* lse_s = reinterpret_cast<const float*>(qst + 3 * kTile);
    r3d::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < tiles)
      stage_queries<T>(qs + base, q + base, dyb + base, lse_b, delta_b, (c + 1) * kChunk, n, d,
                       false, ring + ((c + 1) & 1) * kStage);
    r3d::cp_async_commit();
#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;  // tile-relative first query of the pass
      float s[NT][4];
      zero(s);
      product_along_channels_wide<T, NT>(s, kr, r0, qst, cb, d);  // S^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + cb + 8 * j + 2 * t);
        float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kDropout) f = col_mask(drop, b, key0, c * kChunk + cb + 8 * j);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e) * fs[e];  // Pd^T
      }
      product_along_rows_bf16<NT, T>(acc, s, dyt, cb, d);  // dV += Pd^T dY
    }
  }
  store_rows<S>(smem, acc, dv, base, key0, n, d, d, 1.f, warp, g, t);

  // 2. dK = dS^T q / tau
  __syncthreads();  // every warp is done with the ring and the merge's slots
  stage_queries<T>(qs + base, q + base, dyb + base, lse_b, delta_b, 0, n, d, true, ring);
  r3d::cp_async_commit();
  zero(acc);
  for (int c = 0; c < tiles; ++c) {
    const uint16_t* qst = reinterpret_cast<const uint16_t*>(ring + (c & 1) * kStage);
    const uint16_t* qt = qst + kTile;
    const uint16_t* dyt = qst + 2 * kTile;
    const float* lse_s = reinterpret_cast<const float*>(qst + 3 * kTile);
    const float* dl_s = lse_s + kChunk;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < tiles)
      stage_queries<T>(qs + base, q + base, dyb + base, lse_b, delta_b, (c + 1) * kChunk, n, d,
                       true, ring + ((c + 1) & 1) * kStage);
    r3d::cp_async_commit();
#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      product_along_channels_wide<T, NT>(s, kr, r0, qst, cb, d);   // S^T
      product_along_channels_wide<T, NT>(dp, vr, r0, dyt, cb, d);  // dPd^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + cb + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + cb + 8 * j + 2 * t);
        float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kDropout) f = col_mask(drop, b, key0, c * kChunk + cb + 8 * j);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e);
          dp[j][e] = pe * (dp[j][e] * fs[e] - ((e & 1) ? dl.y : dl.x));  // dS^T
        }
      }
      product_along_rows_bf16<NT, T>(acc, dp, qt, cb, d);  // dK += dS^T q
    }
  }
  store_rows<S>(smem, acc, dk, base, key0, n, d, d, scale, warp, g, t);
}

// (b) dQ of a warp's 16 queries.  Score tiles are (query, key).
template <int T, int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_tc_dq_bf16_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v, const uint16_t* __restrict__ dyb,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int n, int d, float scale,
                            r3d::Dropout drop) {
  constexpr int kTile = kChunk * kDP * T;
  constexpr int kRows = 16 * kWarps / S;  // queries of a block
  constexpr int kCols = kChunk / S;       // keys of a tile per warp
  constexpr int kW = kCols < kPass ? kCols : kPass;
  constexpr int NT = kW / 8;
  extern __shared__ __align__(16) float smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* qr = ring + 4 * kTile;
  uint16_t* dyr = qr + kRows * kDP * T;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int b = blockIdx.y;
  const int r0 = 16 * (warp / S);
  const int row0 = blockIdx.x * kRows + r0;
  const int col0 = (warp % S) * kCols;
  const size_t base = static_cast<size_t>(b) * n * d;
  const int tiles = (n + kChunk - 1) / kChunk;

  stage_tile_bf16<T, kRows>(qs + base, blockIdx.x * kRows, n, d, qr);
  stage_tile_bf16<T, kRows>(dyb + base, blockIdx.x * kRows, n, d, dyr);
  stage_tile_bf16<T>(k + base, 0, n, d, ring);
  stage_tile_bf16<T>(v + base, 0, n, d, ring + kTile);
  r3d::cp_async_commit();
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lq[r] = row < n ? lse[static_cast<size_t>(b) * n + row] : 0.f;
    dl[r] = row < n ? delta[static_cast<size_t>(b) * n + row] : 0.f;
  }
  float acc[8 * T][4];
  zero(acc);

  for (int c = 0; c < tiles; ++c) {
    const uint16_t* kt = ring + (c & 1) * 2 * kTile;
    const uint16_t* vt = kt + kTile;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < tiles) {
      uint16_t* next = ring + ((c + 1) & 1) * 2 * kTile;
      stage_tile_bf16<T>(k + base, (c + 1) * kChunk, n, d, next);
      stage_tile_bf16<T>(v + base, (c + 1) * kChunk, n, d, next + kTile);
    }
    r3d::cp_async_commit();
#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;  // tile-relative first key of the pass
      const int j0 = c * kChunk + cb;
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      product_along_channels_wide<T, NT>(s, qr, r0, kt, cb, d);    // S
      product_along_channels_wide<T, NT>(dp, dyr, r0, vt, cb, d);  // dPd
      const bool ragged = j0 + kW > n;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kDropout) f = row_mask(drop, b, row0 + g, j0 + 8 * j + 2 * t);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2_fast((s[j][e] - lq[e >> 1]) * kLog2e);
          // a key past n has zero K and V, but exp(0 - lse) may overflow
          if (ragged && j0 + 8 * j + 2 * t + (e & 1) >= n) pe = 0.f;
          s[j][e] = pe * (dp[j][e] * fs[e] - dl[e >> 1]);  // dS
        }
      }
      product_along_rows_bf16<NT, T>(acc, s, kt, cb, d);  // dQ += dS K
    }
  }
  store_rows<S>(smem, acc, dq, base, row0, n, d, d, scale, warp, g, t);
}

// f(S, kDropout) with S (1, 2 or 4) and the dropout flag as compile-time
// constants.
template <typename F>
cudaError_t dispatch(int s, bool dropout, F&& f) {
  auto with_s = [&](auto sc) {
    return dropout ? f(sc, std::true_type{}) : f(sc, std::false_type{});
  };
  switch (s) {
    case 1:
      return with_s(std::integral_constant<int, 1>{});
    case 2:
      return with_s(std::integral_constant<int, 2>{});
    default:
      return with_s(std::integral_constant<int, 4>{});
  }
}

template <int T>
cudaError_t fwd(const uint16_t* q, const uint16_t* k, const uint16_t* v, float* y, float* lse,
                int b, int n, int d, float scale, bool dropout, r3d::Dropout drop,
                cudaStream_t st) {
  return dispatch(splits(b, n), dropout, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    const dim3 grid((n + 16 * kWarps / S - 1) / (16 * kWarps / S), b);
    return r3d_launch(attn_wide_tc_fwd_bf16_kernel<T, S, decltype(dc)::value>, grid,
                      dim3(kThreads), fwd_smem(T, S), st, q, k, v, y, lse, n, d, scale, drop);
  });
}

struct Bwd {
  const uint16_t *q, *k, *v;
  const float *y, *dy, *lse;
  float* delta;
  uint16_t *qs, *dyb;
  float *dq, *dk, *dv;
};

template <int T>
cudaError_t bwd(const Bwd& a, int b, int n, int d, float scale, bool dropout, r3d::Dropout drop,
                cudaStream_t st) {
  // the dK/dV kernel's stages and rows at T = 4 fit one block's shared
  // memory only from S = 2
  int s = splits(b, n);
  while (s < 4 && dkdv_smem(T, s) > r3d::kSmemLimit) s *= 2;
  cudaError_t err = dispatch(s, dropout, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    const dim3 grid((n + 16 * kWarps / S - 1) / (16 * kWarps / S), b);
    return r3d_launch(attn_wide_tc_dkdv_bf16_kernel<T, S, decltype(dc)::value>, grid,
                      dim3(kThreads), dkdv_smem(T, S), st, a.qs, a.q, a.k, a.v, a.dyb, a.lse,
                      a.delta, a.dk, a.dv, n, d, scale, drop);
  });
  if (err != cudaSuccess) return err;
  return dispatch(splits(b, n), dropout, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    const dim3 grid((n + 16 * kWarps / S - 1) / (16 * kWarps / S), b);
    return r3d_launch(attn_wide_tc_dq_bf16_kernel<T, S, decltype(dc)::value>, grid,
                      dim3(kThreads), dq_smem(T, S), st, a.qs, a.k, a.v, a.dyb, a.lse, a.delta,
                      a.dq, n, d, scale, drop);
  });
}

static_assert(fwd_smem(4, 1) <= r3d::kSmemLimit && dq_smem(4, 1) <= r3d::kSmemLimit &&
                  dkdv_smem(4, 2) <= r3d::kSmemLimit,
              "every launch fits one block's shared memory");

bool takes(int b, int n, int d) {
  return b >= 1 && b <= 65535 && n >= 1 && d > kDP && d <= 4 * kDP && d % 8 == 0;
}

}  // namespace

// The forward: q, k, v (B, N, D) bf16 contiguous, 64 < D <= 256, D % 8 ==
// 0 -> y (B, N, D) f32 and, when lse is not null, lse (B, N) f32.  scale =
// bf16(1 / tau); the dropout arguments as r3d_attn_fwd's.
R3D_EXPORT int r3d_attn_wide_tc_fwd_bf16(const void* q, const void* k, const void* v, void* y,
                                         void* lse, int b, int n, int d, float scale,
                                         int dropout, unsigned seed_lo, unsigned seed_hi,
                                         unsigned threshold, float keep_scale,
                                         unsigned b0, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const uint16_t*>(q);
  auto kp = static_cast<const uint16_t*>(k);
  auto vp = static_cast<const uint16_t*>(v);
  auto yp = static_cast<float*>(y);
  auto lp = static_cast<float*>(lse);
  return d <= 2 * kDP ? fwd<2>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st)
                      : fwd<4>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
}

// The backward: q, k, v as the
// forward's; y, dy (B, N, D) f32, lse (B, N) f32 -> dq, dk, dv (B, N, D)
// f32.  Scratch from the wrapper: delta (B, N) f32, qs and dyb (B, N, D)
// bf16.  scale = 1 / tau (f32), qscale = bf16(1 / tau), the forward's.
R3D_EXPORT int r3d_attn_wide_tc_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* y, const void* dy, const void* lse,
                                         void* delta, void* qs, void* dyb, void* dq, void* dk,
                                         void* dv, int b, int n, int d, float scale,
                                         float qscale, int dropout, unsigned seed_lo,
                                         unsigned seed_hi, unsigned threshold, float keep_scale,
                                         unsigned b0, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const Bwd a{static_cast<const uint16_t*>(q),  static_cast<const uint16_t*>(k),
              static_cast<const uint16_t*>(v),  static_cast<const float*>(y),
              static_cast<const float*>(dy),    static_cast<const float*>(lse),
              static_cast<float*>(delta),       static_cast<uint16_t*>(qs),
              static_cast<uint16_t*>(dyb),      static_cast<float*>(dq),
              static_cast<float*>(dk),          static_cast<float*>(dv)};
  const int rows = b * n;
  attn_bwd_prep_bf16_kernel<><<<(rows * 32 + 255) / 256, 256, 0, st>>>(a.q, a.dy, a.y, a.delta,
                                                                       a.qs, a.dyb, rows, d,
                                                                       qscale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  return d <= 2 * kDP ? bwd<2>(a, b, n, d, scale, dropout != 0, drop, st)
                      : bwd<4>(a, b, n, d, scale, dropout != 0, drop, st);
}
