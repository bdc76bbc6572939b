// Single-head attention forward, softmax(q k^T * scale) [dropout] v, for
// f32 q, k, v (r3d_attn_fwd).  The bf16 form (r3d_attn_fwd_bf16, the bf16
// encoder's) is attention_fwd_bf16.cu.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (via _fwd_impl), in eval mode and in training with
// dropout on the attention map.  The backward is attention_bwd.cu.
//
// Layout: q, k, v (B, N, D) f32 contiguous, D <= 64 and D % 4 == 0 ->
// y (B, N, D) f32.  Grid: (ceil(N / rows), B) blocks of 4 warps; a warp
// owns 16 query rows and K, V stream through shared memory in 64-key tiles
// (attention.cuh), flash-style, so the (N, N) score matrix never exists.
// With S > 1 splits (small B, see `splits`) the block's S warps of a row
// group each take 64 / S keys of every tile and their (max, sum, output)
// are merged at the end.  Per key tile and warp:
//   1. scores S = (q * scale) k^T, 3xTF32 mma.sync (common.cuh);
//   2. online softmax in f32 registers: the row max across the quad by
//      shuffles, P = exp(s - m_new), the factor exp(m - m_new) that
//      rescales what was summed before; the row sum stays per lane until
//      the end;
//   3. O = O * factor + P V, P the A operand straight from the
//      accumulator registers.
// Like the TPU kernel, q is multiplied by scale = 1 / tau.
//
// What bounds it on the H100: 2 products of B x N^2 x D multiply-adds, 4
// B N^2 D operations (12.9 GFLOP at B = 10 + 2, N = 2048, D = 64), each
// run as 3 tf32 tensor-core passes against 495 TFLOP/s: 0.078 ms; the
// bytes (q, k, v, y) are far below.  Measured, the kernel takes several
// times that: at 8 warps per SM (255 registers each), the stream of
// mma.sync, operand splits and fragment loads is bound by latency, not by
// the tensor cores (PERF.md, sections 6 and 7).
//
// Training (kDropout): the row max m and the row sum l come from the
// undropped scores, so the normaliser is the softmax's own; only the
// accumulator takes exp(s - m) * mask, the mask of philox.cuh drawn once
// per element (`row_mask`).  lse = m + log l per row, (B, N) f32, is
// written whenever the wrapper passes a buffer for it; the backward
// recomputes P = exp(s - lse) from it.
#include <cmath>

#include "attention.cuh"

namespace {

using namespace r3d_attn;

// ring: 2 stages x (K tile, V tile), then the lo halves of the current one
constexpr size_t kSmem = sizeof(float) * 6 * kTileF;

template <int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ y, float* __restrict__ lse,
                int n, int d, float scale, r3d::Dropout drop) {
  constexpr int kCols = kChunk / S;  // keys of a tile per warp
  constexpr int NT = kCols / 8;
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
  float4 qr[4][2];
  load_rows(q + base, row0, n, d, scale, qr);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;

  for (int c = 0; c < tiles; ++c) {
    float* kh = smem + (c & 1) * 2 * kTileF;
    r3d::cp_async_wait_all();
    __syncthreads();  // tile c has arrived; every warp is done with tile c - 1
    if (c + 1 < tiles) {
      float* next = smem + ((c + 1) & 1) * 2 * kTileF;
      stage_tile(k + base, (c + 1) * kChunk, n, d, next);
      stage_tile(v + base, (c + 1) * kChunk, n, d, next + kTileF);
    }
    r3d::cp_async_commit();
    split_tiles(kh, lo, 2 * kTileF, 1.f);
    __syncthreads();

    // 1. scores
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    product_along_channels<NT, false>(s, qr, kh, lo, col0, d, ln);
    const int key0 = c * kChunk + col0;
    mask_ragged_keys<NT>(s, key0, n, t);

    // 2. online softmax
    online_softmax<kDropout>(s, m, l, o, drop, b, row0 + g, key0, t);

    // 3. O += P V
    product_along_rows<NT>(o, s, kh + kTileF, lo + kTileF, col0, d, ln);
  }

  finish_rows<S>(smem, o, m, l, y, lse, base, b, n, d, d, row0, warp, g, t);
}

// The mask's raw words, (B, N, N) uint32: word (b, i, j) as the kernels
// above and attention_bwd.cu draw it.  Only for checking the bits against
// the plain version; nothing on the model's path calls it.
__global__ void dropout_words_kernel(uint32_t* __restrict__ out, int n, r3d::Dropout drop) {
  const int j4 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j4 >= n) return;
  const uint4 w = drop.words(b, i, j4 >> 2);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t* row = out + (static_cast<size_t>(b) * n + i) * n;
  for (int e = 0; e < 4 && j4 + e < n; ++e) row[j4 + e] = ws[e];
}

template <int S>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* y, float* lse,
                       int b, int n, int d, float scale, bool dropout, r3d::Dropout drop,
                       cudaStream_t st) {
  const dim3 grid((n + 16 * kWarps / S - 1) / (16 * kWarps / S), b);
  return dropout ? r3d_launch(attn_fwd_kernel<S, true>, grid, dim3(kThreads), kSmem, st, q, k,
                              v, y, lse, n, d, scale, drop)
                 : r3d_launch(attn_fwd_kernel<S, false>, grid, dim3(kThreads), kSmem, st, q, k,
                              v, y, lse, n, d, scale, drop);
}

}  // namespace

// lse may be null (eval); otherwise it receives the (B, N) row
// log-sum-exp.  dropout != 0 selects the kernel with the mask.
R3D_EXPORT int r3d_attn_fwd(const void* q, const void* k, const void* v, void* y, void* lse,
                            int b, int n, int d, float scale, int dropout,
                            unsigned seed_lo, unsigned seed_hi, unsigned threshold,
                            float keep_scale, void* stream) {
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto yp = static_cast<float*>(y);
  auto lp = static_cast<float*>(lse);
  switch (splits(b, n)) {
    case 1:
      return launch_fwd<1>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
    case 2:
      return launch_fwd<2>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
    default:
      return launch_fwd<4>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
  }
}

R3D_EXPORT int r3d_dropout_mask(void* out, int b, int n, unsigned seed_lo, unsigned seed_hi,
                                void* stream) {
  const r3d::Dropout drop{seed_lo, seed_hi, 0u, 1.f};
  dim3 grid(((n + 3) / 4 + 127) / 128, n, b);
  dropout_words_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, drop);
  return cudaGetLastError();
}
