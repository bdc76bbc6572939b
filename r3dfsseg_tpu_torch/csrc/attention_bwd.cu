// Single-head attention backward: dq, dk, dv of y = (P * M) v with
// P = softmax(q k^T * scale) and the dropout mask M (philox.cuh; M = 1
// without dropout), for f32 q, k, v at D <= 64 (r3d_attn_bwd; bf16 ones
// run attention_bwd_bf16.cu).
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_bwd_kernel (via _bwd_impl).  Same algebra
// (pallas_attention.py:15-19), with Pd = P * M:
//     dV = Pd^T dY,   dPd = dY V^T,   dS = P * (dPd * M - Delta),
//     dQ = dS K * scale,   dK = dS^T Q * scale,
// where Delta_i = rowsum(dP * P)_i = rowsum(dY * Y)_i (with dropout too:
// sum_j dPd_ij M_ij P_ij = dY_i . sum_j Pd_ij V_j = dY_i . Y_i).
//
// What bounds it on the H100: five (N x N x D) products per cloud, 10 B
// N^2 D operations (32.2 GFLOP per training step at B = 10 + 2, N =
// 2048, D = 64), each run as 3 tf32 tensor-core passes (3xTF32,
// common.cuh) against 495 TFLOP/s: 0.195 ms; measured, it is bound by
// latency as the forward is (attention_fwd.cu).  The TPU kernel keeps a (256, N) tile
// of P in VMEM and sums dk/dv across a sequential grid into revisited
// output blocks (:126-134); Hopper's blocks run in no order, so that carry
// does not exist here.  Instead, with no float atomics, so that the result
// repeats bit for bit:
//   0. a pre-pass computes Delta, one warp per row;
//   a. a warp owns 16 keys and loops over 64-query tiles of Q and dY
//      (cp.async ring, attention.cuh), recomputing the scores and P =
//      exp(s - lse) from the forward's row log-sum-exp, and sums dK and dV
//      in registers;
//   b. a warp owns 16 queries and loops over 64-key tiles of K and V, the
//      same recomputation, and sums dQ in registers.
// The scores take the forward's fragments, channel order and term order
// (in (a) with the operands' roles swapped, kBLoFirst), so P is the
// forward's P to the rounding of exp(s - lse).  The pair recomputes two of
// the five products (S and dPd) once more than the minimum: 7 products per
// cloud against the bound's 5.  With S > 1 splits (small B) the warps of
// a row group split each tile's columns and sum their partials in split
// order at the end.
//
// Layout: q, k, v, y, dy (B, N, D) f32 contiguous, D <= 64, D % 4 == 0;
// lse, delta (B, N) f32 -> dq, dk, dv (B, N, D) f32.
#include <cmath>

#include "attention.cuh"

namespace {

using namespace r3d_attn;

constexpr int kPass = 32;  // columns of a warp's pass over a tile (register budget)

// dK/dV: a stage holds the Q tile, the dY tile, lse and Delta of 64 queries
constexpr int kStageKV = 2 * kTileF + 2 * kChunk;
constexpr size_t kSmemKV = sizeof(float) * (2 * kStageKV + 2 * kTileF);
// dQ: as the forward, K and V tiles
constexpr size_t kSmemQ = sizeof(float) * 6 * kTileF;

__global__ void attn_bwd_delta_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                                      float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = dy + static_cast<size_t>(row) * d;
  const float* c = y + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int ch = lane; ch < d; ch += 32) s = fmaf(a[ch], c[ch], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// Issue the copy of the query tile at i0: Q, dY, lse and Delta (zeros past
// n, whose terms then vanish: dY = 0 and Delta = 0 there).
__device__ __forceinline__ void stage_queries(const float* q, const float* dy, const float* lse,
                                              const float* delta, int i0, int n, int d,
                                              float* dst) {
  stage_tile(q, i0, n, d, dst);
  stage_tile(dy, i0, n, d, dst + kTileF);
  static_assert(kThreads == 2 * kChunk, "one thread per lse and Delta entry");
  const int e = threadIdx.x;
  const float* src = e < kChunk ? lse : delta;
  const int i = i0 + (e & (kChunk - 1));
  r3d::cp_async4(dst + 2 * kTileF + e, i < n ? src + i : src, i < n);
}

// (a) dK, dV of a warp's 16 keys.  Score tiles are (key, query).
template <int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dy,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int d, float scale,
                     r3d::Dropout drop) {
  constexpr int kCols = kChunk / S;               // queries of a tile per warp
  constexpr int kW = kCols < kPass ? kCols : kPass;
  constexpr int NT = kW / 8;
  extern __shared__ __align__(16) float smem[];
  float* lo = smem + 2 * kStageKV;                 // Q lo, dY lo
  const int warp = threadIdx.x >> 5;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  const int b = blockIdx.y;
  const int key0 = blockIdx.x * (16 * kWarps / S) + 16 * (warp / S);
  const int col0 = (warp % S) * kCols;
  const size_t base = static_cast<size_t>(b) * n * d;
  const float* lse_b = lse + static_cast<size_t>(b) * n;
  const float* delta_b = delta + static_cast<size_t>(b) * n;
  const int tiles = (n + kChunk - 1) / kChunk;

  stage_queries(q + base, dy + base, lse_b, delta_b, 0, n, d, smem);
  r3d::cp_async_commit();
  float4 kr[4][2], vr[4][2];
  load_rows(k + base, key0, n, d, 1.f, kr);
  load_rows(v + base, key0, n, d, 1.f, vr);
  float gk[8][4], gv[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[nn][e] = gv[nn][e] = 0.f;

  for (int c = 0; c < tiles; ++c) {
    float* qh = smem + (c & 1) * kStageKV;
    float* dyh = qh + kTileF;
    const float* lse_s = qh + 2 * kTileF;
    const float* dl_s = lse_s + kChunk;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < tiles)
      stage_queries(q + base, dy + base, lse_b, delta_b, (c + 1) * kChunk, n, d,
                    smem + ((c + 1) & 1) * kStageKV);
    r3d::cp_async_commit();
    split_tiles(qh, lo, kTileF, scale);         // Q * scale, as the forward
    split_tiles(dyh, lo + kTileF, kTileF, 1.f);
    __syncthreads();

#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;  // tile-relative first query of the pass
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      product_along_channels<NT, true>(s, kr, qh, lo, cb, d, ln);               // S^T
      product_along_channels<NT, true>(dp, vr, dyh, lo + kTileF, cb, d, ln);    // dPd^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + cb + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + cb + 8 * j + 2 * t);
        float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kDropout) f = col_mask(drop, b, key0, c * kChunk + cb + 8 * j);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? ls.y : ls.x;
          const float dlq = (e & 1) ? dl.y : dl.x;
          const float pe = exp2_fast((s[j][e] - lq) * kLog2e);
          s[j][e] = pe * fs[e];                       // Pd^T
          dp[j][e] = pe * (dp[j][e] * fs[e] - dlq);   // dS^T
        }
      }
      product_along_rows<NT>(gv, s, dyh, lo + kTileF, cb, d, ln);   // dV += Pd^T dY
      product_along_rows<NT>(gk, dp, qh, lo, cb, d, ln);            // dK += dS^T (Q * scale)
    }
  }

  if constexpr (S > 1) {
    constexpr int kSlot = 64;
    __syncthreads();
    float* mine = lane_slot(smem, warp, kSlot);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[4 * nn + e] = gk[nn][e];
        mine[32 + 4 * nn + e] = gv[nn][e];
      }
    __syncthreads();
    if (warp % S != 0) return;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[nn][e] = gv[nn][e] = 0.f;
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(smem, warp + sp, kSlot);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gk[nn][e] += other[4 * nn + e];
          gv[nn][e] += other[32 + 4 * nn + e];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + g + 8 * r;
    if (row >= n) continue;
    const size_t off = base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int ch = 8 * nn + 2 * t;
      if (ch >= d) continue;
      *reinterpret_cast<float2*>(dk + off + ch) = make_float2(gk[nn][2 * r], gk[nn][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + ch) = make_float2(gv[nn][2 * r], gv[nn][2 * r + 1]);
    }
  }
}

// (b) dQ of a warp's 16 queries.  Score tiles are (query, key).
template <int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dy,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int n, int d, float scale, r3d::Dropout drop) {
  constexpr int kCols = kChunk / S;  // keys of a tile per warp
  constexpr int kW = kCols < kPass ? kCols : kPass;
  constexpr int NT = kW / 8;
  extern __shared__ __align__(16) float smem[];
  float* lo = smem + 4 * kTileF;
  const int warp = threadIdx.x >> 5;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * (16 * kWarps / S) + 16 * (warp / S);
  const int col0 = (warp % S) * kCols;
  const size_t base = static_cast<size_t>(b) * n * d;
  const int tiles = (n + kChunk - 1) / kChunk;

  stage_tile(k + base, 0, n, d, smem);
  stage_tile(v + base, 0, n, d, smem + kTileF);
  r3d::cp_async_commit();
  float4 qr[4][2], dyr[4][2];
  load_rows(q + base, row0, n, d, scale, qr);
  load_rows(dy + base, row0, n, d, 1.f, dyr);
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lq[r] = row < n ? lse[static_cast<size_t>(b) * n + row] : 0.f;
    dl[r] = row < n ? delta[static_cast<size_t>(b) * n + row] : 0.f;
  }
  float gq[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[nn][e] = 0.f;

  for (int c = 0; c < tiles; ++c) {
    float* kh = smem + (c & 1) * 2 * kTileF;
    float* vh = kh + kTileF;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < tiles) {
      float* next = smem + ((c + 1) & 1) * 2 * kTileF;
      stage_tile(k + base, (c + 1) * kChunk, n, d, next);
      stage_tile(v + base, (c + 1) * kChunk, n, d, next + kTileF);
    }
    r3d::cp_async_commit();
    split_tiles(kh, lo, 2 * kTileF, 1.f);
    __syncthreads();

#pragma unroll 1
    for (int p = 0; p < kCols / kW; ++p) {
      const int cb = col0 + p * kW;  // tile-relative first key of the pass
      const int j0 = c * kChunk + cb;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      product_along_channels<NT, false>(s, qr, kh, lo, cb, d, ln);             // S
      product_along_channels<NT, false>(dp, dyr, vh, lo + kTileF, cb, d, ln);  // dPd
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
      product_along_rows<NT>(gq, s, kh, lo, cb, d, ln);  // dQ += dS K
    }
  }

  if constexpr (S > 1) {
    constexpr int kSlot = 32;
    __syncthreads();
    float* mine = lane_slot(smem, warp, kSlot);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * nn + e] = gq[nn][e];
    __syncthreads();
    if (warp % S != 0) return;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) gq[nn][e] = 0.f;
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(smem, warp + sp, kSlot);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) gq[nn][e] += other[4 * nn + e];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* out = dq + base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int ch = 8 * nn + 2 * t;
      if (ch < d)
        *reinterpret_cast<float2*>(out + ch) =
            make_float2(gq[nn][2 * r] * scale, gq[nn][2 * r + 1] * scale);
    }
  }
}

template <int S, bool kDropout>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dy,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int b, int n, int d, float scale, r3d::Dropout drop, cudaStream_t st) {
  const int rows = 16 * kWarps / S;
  const dim3 grid((n + rows - 1) / rows, b);
  const cudaError_t err = r3d_launch(attn_bwd_dkdv_kernel<S, kDropout>, grid, dim3(kThreads),
                                     kSmemKV, st, q, k, v, dy, lse, delta, dk, dv, n, d, scale,
                                     drop);
  if (err != cudaSuccess) return err;
  return r3d_launch(attn_bwd_dq_kernel<S, kDropout>, grid, dim3(kThreads), kSmemQ, st, q, k, v,
                    dy, lse, delta, dq, n, d, scale, drop);
}

template <int S>
cudaError_t launch_bwd_s(bool dropout, const float* q, const float* k, const float* v,
                         const float* dy, const float* lse, const float* delta, float* dq,
                         float* dk, float* dv, int b, int n, int d, float scale,
                         r3d::Dropout drop, cudaStream_t st) {
  return dropout ? launch_bwd<S, true>(q, k, v, dy, lse, delta, dq, dk, dv, b, n, d, scale, drop, st)
                 : launch_bwd<S, false>(q, k, v, dy, lse, delta, dq, dk, dv, b, n, d, scale, drop,
                                        st);
}

}  // namespace

// delta is (B, N) f32 scratch the wrapper allocates.
R3D_EXPORT int r3d_attn_bwd(const void* q, const void* k, const void* v, const void* y,
                            const void* dy, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int b, int n, int d, float scale, int dropout,
                            unsigned seed_lo, unsigned seed_hi, unsigned threshold,
                            float keep_scale, unsigned b0, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  attn_bwd_delta_kernel<<<(rows * 32 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<float*>(delta),
      rows, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  auto args = [&](auto launch) {
    return launch(dropout != 0, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dy),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), b, n,
                  d, scale, drop, st);
  };
  switch (splits(b, n)) {
    case 1:
      return args(launch_bwd_s<1>);
    case 2:
      return args(launch_bwd_s<2>);
    default:
      return args(launch_bwd_s<4>);
  }
}
