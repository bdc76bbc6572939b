// Single-head attention forward, softmax(q k^T * scale) v, eval mode.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (via _fwd_impl) with train=False.  Dropout and the
// backward (_attn_bwd_kernel) belong to training and are not here.
//
// Layout: q, k, v (B, N, D) f32 contiguous, D <= 64 and D % 4 == 0 ->
// y (B, N, D) f32.  Grid: (ceil(N / kTile), B), kThreads threads.  A block
// owns kTile query rows; K and V stream through shared memory in tiles of
// kTile keys, flash-style, so the (N, N) score matrix never exists.  Per
// key tile:
//   1. scores S = (q * scale) k^T, a kTile x kTile tile with a 4 x 4
//      register sub-tile per thread (two float4 shared loads per 16 FFMAs,
//      where one query per thread would pay a load per FFMA);
//   2. online softmax in f32: per row the running max m and sum l, the
//      tile's probabilities exp(s - m_new) and the factor exp(m - m_new)
//      that rescales what was accumulated before;
//   3. O = O * factor + P V, O held as a 4 x 4 register sub-tile of
//      (rows x channels) per thread.
// Plain FFMA and expf throughout, no TF32.  Like the TPU kernel, q is
// multiplied by scale = 1 / tau.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStride = kTile + 1;

__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ y, int n, int d,
                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // d * kTile, channel-major, scaled
  float* k_s = q_s + d * kTile;                  // d * kTile, channel-major
  float* v_s = k_s + d * kTile;                  // kTile * d, row-major
  float* p_s = v_s + kTile * d;                  // kTile * kStride: scores, then probabilities
  float* m_s = p_s + kTile * kStride;            // kTile running row max
  float* l_s = m_s + kTile;                      // kTile running row sum
  float* f_s = l_s + kTile;                      // kTile rescale factor of this tile
  float* tmax_s = f_s + kTile;                   // kThreads partial tile maxima
  float* psum_s = tmax_s + kThreads;             // kThreads partial tile sums

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int r0 = (t / 16) * 4;  // this thread's 4 rows
  const int c0 = (t % 16) * 4;  // and 4 keys (scores) or 4 channels (output)
  const int srow = t / 4;       // softmax: 4 threads per row,
  const int scol = (t % 4) * 16;  // 16 columns each
  const size_t base = static_cast<size_t>(b) * n * d;

  for (int e = t; e < kTile * d; e += kThreads) {
    const int r = e % kTile;
    const int ch = e / kTile;
    q_s[ch * kTile + r] =
        (row0 + r < n) ? q[base + static_cast<size_t>(row0 + r) * d + ch] * scale : 0.f;
  }
  if (t < kTile) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int nk = min(kTile, n - j0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = t; e < kTile * d; e += kThreads) {
      const int j = e % kTile;
      const int ch = e / kTile;
      k_s[ch * kTile + j] = (j < nk) ? k[base + static_cast<size_t>(j0 + j) * d + ch] : 0.f;
      v_s[e] = (e / d < nk) ? v[base + static_cast<size_t>(j0) * d + e] : 0.f;
    }
    __syncthreads();

    // 1. scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < d; ++ch) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + ch * kTile + r0);
      const float4 bk = *reinterpret_cast<const float4*>(k_s + ch * kTile + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(r0 + i) * kStride + c0 + j] = (c0 + j < nk) ? s[i][j] : -INFINITY;
    __syncthreads();

    // 2. online softmax
    float* sr = p_s + srow * kStride + scol;
    float tmax = -INFINITY;
    for (int j = 0; j < 16; ++j) tmax = fmaxf(tmax, sr[j]);
    tmax_s[t] = tmax;
    __syncthreads();
    const float m_new = fmaxf(m_s[srow], fmaxf(fmaxf(tmax_s[4 * srow], tmax_s[4 * srow + 1]),
                                              fmaxf(tmax_s[4 * srow + 2], tmax_s[4 * srow + 3])));
    float part = 0.f;
    for (int j = 0; j < 16; ++j) {
      const float pj = expf(sr[j] - m_new);  // 0 on masked columns
      sr[j] = pj;
      part += pj;
    }
    psum_s[t] = part;
    __syncthreads();
    if (t < kTile) {
      const float m_old = m_s[t];
      const float mn = fmaxf(m_old, fmaxf(fmaxf(tmax_s[4 * t], tmax_s[4 * t + 1]),
                                          fmaxf(tmax_s[4 * t + 2], tmax_s[4 * t + 3])));
      const float f = expf(m_old - mn);  // 0 on the first tile (m_old = -inf)
      l_s[t] = l_s[t] * f +
               ((psum_s[4 * t] + psum_s[4 * t + 1]) + (psum_s[4 * t + 2] + psum_s[4 * t + 3]));
      m_s[t] = mn;
      f_s[t] = f;
    }
    __syncthreads();

    // 3. O = O * f + P V
    if (c0 < d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = f_s[r0 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= f;
      }
      for (int jj = 0; jj < nk; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + jj * d + c0);
        const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = p_s[(r0 + i) * kStride + jj];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pi, vj[j], acc[i][j]);
        }
      }
    }
  }

  __syncthreads();
  if (c0 < d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + r0 + i >= n) continue;
      const float inv = 1.f / l_s[r0 + i];
      float* yr = y + base + static_cast<size_t>(row0 + r0 + i) * d + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) yr[j] = acc[i][j] * inv;
    }
  }
}

}  // namespace

R3D_EXPORT int r3d_attn_fwd(const void* q, const void* k, const void* v, void* y, int b, int n,
                            int d, float scale, void* stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(d) * kTile + kTile * kStride +
                                       3 * kTile + 2 * kThreads);
  cudaError_t err = r3d_set_smem(attn_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTile - 1) / kTile, b);
  attn_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(y), n, d, scale);
  return cudaGetLastError();
}
