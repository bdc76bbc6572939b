// Single-head attention backward: dq, dk, dv of y = (P * M) v with
// P = softmax(q k^T * scale) and the dropout mask M (philox.cuh; M = 1
// without dropout).
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_bwd_kernel (via _bwd_impl).  Same algebra
// (pallas_attention.py:15-19), with Pd = P * M:
//     dV = Pd^T dY,   dPd = dY V^T,   dS = P * (dPd * M - Delta),
//     dQ = dS K * scale,   dK = dS^T Q * scale,
// where Delta_i = rowsum(dP * P)_i = rowsum(dY * Y)_i (with dropout too:
// sum_j dPd_ij M_ij P_ij = dY_i . sum_j Pd_ij V_j = dY_i . Y_i).
//
// What bounds it on the H100: five (N x N x D) products per cloud, 10 x B x
// N^2 x D operations (32.2 GFLOP per training step at B = 10 + 2, N = 2048,
// D = 64), run as FP32 FFMA on CUDA cores like the forward (no TF32).  The
// TPU kernel keeps a (256, N) tile of P in VMEM and sums dk/dv across a
// sequential grid into revisited output blocks (:126-134); Hopper's blocks
// run in no order, so that carry does not exist here.  Instead, with no
// float atomics, so the result is deterministic:
//   0. a pre-pass computes Delta, one warp per row;
//   a. a block owns a 64-key tile and loops over the 64-query tiles,
//      recomputing the scores and P = exp(s - lse) from the forward's row
//      log-sum-exp, and sums dK and dV in registers;
//   b. a block owns a 64-query tile and loops over the key tiles, the same
//      recomputation, and sums dQ in registers.
// Every product is a 64 x 64 tile with a 4 x 4 register sub-tile per
// thread (two float4 shared loads per 16 FFMAs), as in attention_fwd.cu.
// The scores are summed over channels in the forward's order with the same
// fmaf chain, so P is the forward's P to the rounding of exp(s - lse).
// The pair recomputes two of the five products (S and dPd) once more than
// the minimum: 7 products per cloud against the bound's 5.
//
// Layout: q, k, v, y, dy (B, N, D) f32 contiguous, D <= 64, D % 4 == 0;
// lse, delta (B, N) f32 -> dq, dk, dv (B, N, D) f32.
#include <cmath>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStride = kTile + 1;

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

// Stage rows [row0, row0 + kTile) of a (N, D) matrix into shared memory,
// channel-major (dst[ch * kTile + r], for float4 loads along rows) and, if
// dst_r is given, row-major (dst_r[r * d + ch], for float4 loads along
// channels).  Rows past n are zero.  The channel-major copy walks rows
// fastest, as attention_fwd.cu does, so its shared stores do not collide;
// the row-major copy walks channels fastest and reads coalesced.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, float mul, int row0,
                                           int n, int d, float* dst_c, float* dst_r) {
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e % kTile;
    const int ch = e / kTile;
    dst_c[ch * kTile + r] =
        (row0 + r < n) ? src[static_cast<size_t>(row0 + r) * d + ch] * mul : 0.f;
  }
  if (dst_r == nullptr) return;
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    dst_r[e] = (row0 + r < n) ? src[static_cast<size_t>(row0) * d + e] * mul : 0.f;
  }
}

// acc[i][j] = sum_ch a_c[ch][r0 + i] * b_c[ch][c0 + j], channel ascending.
__device__ __forceinline__ void tile_dot(const float* a_c, const float* b_c, int d, int r0,
                                         int c0, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int ch = 0; ch < d; ++ch) {
    const float4 a = *reinterpret_cast<const float4*>(a_c + ch * kTile + r0);
    const float4 b = *reinterpret_cast<const float4*>(b_c + ch * kTile + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_x m_s[r0 + i][x] * b_r[x][c0 + j] over x < kTile.
__device__ __forceinline__ void tile_accumulate(const float* m_s, const float* b_r, int d,
                                                int r0, int c0, float (&acc)[4][4]) {
  for (int x = 0; x < kTile; ++x) {
    const float4 b = *reinterpret_cast<const float4*>(b_r + x * d + c0);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = m_s[(r0 + i) * kStride + x];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
}

// (a) dK, dV of one key tile.  Score tiles are (key, query): thread rows
// r0.. are keys, columns c0.. are queries.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dy,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int d, float scale,
                     r3d::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_c = reinterpret_cast<float*>(smem);  // d * kTile, this key tile
  float* v_c = k_c + d * kTile;                 // d * kTile
  float* q_c = v_c + d * kTile;                 // d * kTile, the query tile, scaled
  float* q_r = q_c + d * kTile;                 // kTile * d, the same, row-major
  float* dy_c = q_r + kTile * d;                // d * kTile
  float* dy_r = dy_c + d * kTile;               // kTile * d
  float* pd_s = dy_r + kTile * d;               // kTile * kStride: Pd (key, query)
  float* ds_s = pd_s + kTile * kStride;         // kTile * kStride: dS (key, query)
  float* lse_s = ds_s + kTile * kStride;        // kTile
  float* dl_s = lse_s + kTile;                  // kTile

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int key0 = blockIdx.x * kTile;
  const int r0 = (t / 16) * 4;
  const int c0 = (t % 16) * 4;
  const size_t base = static_cast<size_t>(b) * n * d;

  stage_tile(k + base, 1.f, key0, n, d, k_c, nullptr);
  stage_tile(v + base, 1.f, key0, n, d, v_c, nullptr);
  float gk[4][4], gv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int i0 = 0; i0 < n; i0 += kTile) {
    __syncthreads();  // the previous query tile is fully consumed
    stage_tile(q + base, scale, i0, n, d, q_c, q_r);
    stage_tile(dy + base, 1.f, i0, n, d, dy_c, dy_r);
    if (t < kTile) {
      const bool ok = i0 + t < n;
      lse_s[t] = ok ? lse[static_cast<size_t>(b) * n + i0 + t] : INFINITY;
      dl_s[t] = ok ? delta[static_cast<size_t>(b) * n + i0 + t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(k_c, q_c, d, r0, c0, s);    // s[key][query], the forward's fmaf chain
    tile_dot(v_c, dy_c, d, r0, c0, dp);  // dPd[key][query]
    float mk[4][4];                      // mask factor [key][query]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = drop.factors(b, i0 + c0 + j, key0 + r0);
      mk[0][j] = f.x;
      mk[1][j] = f.y;
      mk[2][j] = f.z;
      mk[3][j] = f.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool key_ok = key0 + r0 + i < n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = key_ok ? expf(s[i][j] - lse_s[c0 + j]) : 0.f;
        pd_s[(r0 + i) * kStride + c0 + j] = p * mk[i][j];
        ds_s[(r0 + i) * kStride + c0 + j] = p * (dp[i][j] * mk[i][j] - dl_s[c0 + j]);
      }
    }
    __syncthreads();
    if (c0 < d) {
      tile_accumulate(pd_s, dy_r, d, r0, c0, gv);  // dV += Pd^T dY
      tile_accumulate(ds_s, q_r, d, r0, c0, gk);   // dK += dS^T (Q * scale)
    }
  }

  if (c0 < d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (key0 + r0 + i >= n) continue;
      const size_t off = base + static_cast<size_t>(key0 + r0 + i) * d + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[off + j] = gk[i][j];
        dv[off + j] = gv[i][j];
      }
    }
  }
}

// (b) dQ of one query tile.  Score tiles are (query, key).
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dy,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int n, int d, float scale, r3d::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_c = reinterpret_cast<float*>(smem);  // d * kTile, this query tile, scaled
  float* dy_c = q_c + d * kTile;                // d * kTile
  float* k_c = dy_c + d * kTile;                // d * kTile, the key tile
  float* k_r = k_c + d * kTile;                 // kTile * d, the same, row-major
  float* v_c = k_r + kTile * d;                 // d * kTile
  float* ds_s = v_c + d * kTile;                // kTile * kStride: dS (query, key)
  float* lse_s = ds_s + kTile * kStride;        // kTile
  float* dl_s = lse_s + kTile;                  // kTile

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int r0 = (t / 16) * 4;
  const int c0 = (t % 16) * 4;
  const size_t base = static_cast<size_t>(b) * n * d;

  stage_tile(q + base, scale, row0, n, d, q_c, nullptr);
  stage_tile(dy + base, 1.f, row0, n, d, dy_c, nullptr);
  if (t < kTile) {
    const bool ok = row0 + t < n;
    lse_s[t] = ok ? lse[static_cast<size_t>(b) * n + row0 + t] : INFINITY;
    dl_s[t] = ok ? delta[static_cast<size_t>(b) * n + row0 + t] : 0.f;
  }
  float gq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gq[i][j] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kTile) {
    __syncthreads();  // the previous key tile is fully consumed
    stage_tile(k + base, 1.f, j0, n, d, k_c, k_r);
    stage_tile(v + base, 1.f, j0, n, d, v_c, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(q_c, k_c, d, r0, c0, s);    // s[query][key], the forward's fmaf chain
    tile_dot(dy_c, v_c, d, r0, c0, dp);  // dPd[query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = drop.factors(b, row0 + r0 + i, j0 + c0);
      const float mk[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (j0 + c0 + j < n) ? expf(s[i][j] - lse_s[r0 + i]) : 0.f;
        ds_s[(r0 + i) * kStride + c0 + j] = p * (dp[i][j] * mk[j] - dl_s[r0 + i]);
      }
    }
    __syncthreads();
    if (c0 < d) tile_accumulate(ds_s, k_r, d, r0, c0, gq);  // dQ += dS K
  }

  if (c0 < d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + r0 + i >= n) continue;
      float* out = dq + base + static_cast<size_t>(row0 + r0 + i) * d + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = gq[i][j] * scale;
    }
  }
}

template <bool kDropout>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dy,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int b, int n, int d, float scale, r3d::Dropout drop, cudaStream_t st) {
  const dim3 grid((n + kTile - 1) / kTile, b);
  const size_t smem_kv =
      sizeof(float) * (6 * static_cast<size_t>(d) * kTile + 2 * kTile * kStride + 2 * kTile);
  const size_t smem_q =
      sizeof(float) * (5 * static_cast<size_t>(d) * kTile + kTile * kStride + 2 * kTile);
  cudaError_t err = r3d_set_smem(attn_bwd_dkdv_kernel<kDropout>, smem_kv);
  if (err != cudaSuccess) return err;
  err = r3d_set_smem(attn_bwd_dq_kernel<kDropout>, smem_q);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<kDropout><<<grid, kThreads, smem_kv, st>>>(q, k, v, dy, lse, delta, dk, dv,
                                                                   n, d, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<kDropout><<<grid, kThreads, smem_q, st>>>(q, k, v, dy, lse, delta, dq, n, d,
                                                               scale, drop);
  return cudaGetLastError();
}

}  // namespace

// delta is (B, N) f32 scratch the wrapper allocates.
R3D_EXPORT int r3d_attn_bwd(const void* q, const void* k, const void* v, const void* y,
                            const void* dy, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int b, int n, int d, float scale, int dropout,
                            unsigned seed_lo, unsigned seed_hi, unsigned threshold,
                            float keep_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  attn_bwd_delta_kernel<<<(rows * 32 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<float*>(delta),
      rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale};
  auto args = [&](auto launch) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dy),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), b, n,
                  d, scale, drop, st);
  };
  return dropout ? args(launch_bwd<true>) : args(launch_bwd<false>);
}
