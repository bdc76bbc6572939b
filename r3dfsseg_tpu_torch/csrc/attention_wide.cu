// Single-head attention forward and backward on f32 q, k, v at any head
// width D > 64: the shapes the tuned f32 kernels do not take (the wrapper
// zero-pads an unaligned D <= 64 to attention_fwd.cu and attention_bwd.cu;
// bf16 q, k, v past 64 run attention_wide_bf16.cu and
// attention_group_bf16.cu).
//
// Replaces the TPU kernels r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel and _attn_bwd_kernel there (the pretraining network's
// SelfAttention is 128 wide, r3dfsseg_tpu/config.py:60).  The function is
// the tuned kernels' (ops/cuda_attention.py's plain versions): the same
// Philox mask (philox.cuh), q multiplied by scale = 1 / tau, dK from the
// unscaled q, f32 sums throughout.
//
// What bounds it on the H100: the products, 4 B N^2 D operations forward
// and 10 backward, here FFMA in f32 against 67 TFLOP/s.  This kernel is
// simple, not fast.  Each block of 256 threads owns 64 rows (queries; keys
// in dK/dV) and each thread a 4 x 4 patch of a 64 x 64 score tile; q, k, dY
// and v stream through shared memory in 32-channel chunks, transposed so
// that a thread reads its four rows and four columns as two float4.  The
// outputs are summed in registers, 128 channels per pass (D > 128 takes
// more passes, each recomputing the scores).
//   forward: pass 1 over the keys takes each row's max m and sum l (online,
//     the scores' own softmax normaliser) and writes lse = m + log l; each
//     output pass recomputes the scores, P = exp(s - m) / l and the mask,
//     and sums P V;
//   backward: a pre-pass writes Delta = rowsum(dY * Y);
//     the dQ kernel (a block per 64 queries) and the dK/dV kernel (a block
//     per 64 keys) each recompute S and dPd = dY V^T per tile, P = exp(s -
//     lse), Pd = P * M, dS = P * (dPd * M - Delta), and sum dQ = dS K *
//     scale, or dV = Pd^T dY and dK = dS^T q * scale.
// No float atomics and a fixed order of sums: a call repeats bit for bit.
#include <cmath>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRows = 64;       // rows (and columns) of a score tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 patch each
constexpr int kDC = 32;         // channels of a staged chunk
constexpr int kLd = kRows + 4;  // floats per staged channel (rows transposed)
constexpr int kOut = 128;       // output channels per pass
constexpr int kOutLd = kOut + 4;
constexpr int kPLd = kRows + 1;  // floats per row of a transposed P or dS tile
constexpr int kChunkF = kDC * kLd;
constexpr int kPF = kRows * kPLd;
constexpr int kOutF = kRows * kOutLd;

// Rows [r0, r0 + 64), channels [c0, c0 + 32) of an (n, d) matrix, times
// mul when kScaled (q), into dst[channel][row] (kLd floats a channel);
// zeros past n and d.
template <bool kScaled>
__device__ __forceinline__ void stage_chunk(const float* src, int r0, int n, int d, int c0,
                                            float mul, float* dst) {
  for (int e = threadIdx.x; e < kRows * kDC; e += kThreads) {
    const int r = e / kDC, cc = e % kDC;
    const bool ok = r0 + r < n && c0 + cc < d;
    const float* x = src + static_cast<size_t>(r0 + r) * d + c0 + cc;
    dst[cc * kLd + r] = ok ? (kScaled ? *x * mul : *x) : 0.f;
  }
}

// Rows [r0, r0 + 64), channels [o0, o0 + 128) into dst[row][channel]
// (kOutLd floats a row); zeros past n and d.
__device__ __forceinline__ void stage_out(const float* src, int r0, int n, int d, int o0,
                                          float* dst) {
  for (int e = threadIdx.x; e < kRows * kOut; e += kThreads) {
    const int r = e / kOut, cc = e % kOut;
    const bool ok = r0 + r < n && o0 + cc < d;
    dst[r * kOutLd + cc] = ok ? src[static_cast<size_t>(r0 + r) * d + o0 + cc] : 0.f;
  }
}

// acc[r][j] += sum over the chunk's w channels of a[4 ty + r] b[4 tx + j].
__device__ __forceinline__ void patch(float (&acc)[4][4], const float* a, const float* b, int w,
                                      int ty, int tx) {
  for (int cc = 0; cc < w; ++cc) {
    const float4 av = *reinterpret_cast<const float4*>(a + cc * kLd + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + cc * kLd + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(ar[r], br[j], acc[r][j]);
  }
}

// acc[r][j] += sum over the 64 tile columns i of p[i][4 ty + r] o[i][cols]
// with cols 4 tx + j (j < 4) and 64 + 4 tx + j - 4 (j >= 4).
__device__ __forceinline__ void out_patch(float (&acc)[4][8], const float* p, const float* o,
                                          int ty, int tx) {
  for (int i = 0; i < kRows; ++i) {
    float pr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) pr[r] = p[i * kPLd + 4 * ty + r];
    const float4 o0 = *reinterpret_cast<const float4*>(o + i * kOutLd + 4 * tx);
    const float4 o1 = *reinterpret_cast<const float4*>(o + i * kOutLd + 64 + 4 * tx);
    const float oc[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(pr[r], oc[j], acc[r][j]);
  }
}

// Write a thread's patch of an output pass: rows r0 + 4 ty + r, channels
// o0 + its 8 columns, times mul.
__device__ __forceinline__ void write_out(const float (&acc)[4][8], float* dst, int r0, int n,
                                          int d, int o0, float mul, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = o0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (ch < d) dst[static_cast<size_t>(row) * d + ch] = acc[r][j] * mul;
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[r][j] = 0.f;
}

__device__ __forceinline__ void zero(float (&a)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[r][j] = 0.f;
}

// The mask factors of four consecutive keys 4 j4 .. 4 j4 + 3 on query i.
__device__ __forceinline__ void factors(const r3d::Dropout& drop, int b, int i, int j4,
                                        float (&f)[4]) {
  const uint4 w = drop.words(b, i, j4);
  f[0] = drop.factor(w.x);
  f[1] = drop.factor(w.y);
  f[2] = drop.factor(w.z);
  f[3] = drop.factor(w.w);
}

// Scores of the block's queries [i0, i0 + 64) against keys [j0, j0 + 64):
// s[r][j] for query 4 ty + r, key 4 tx + j.
__device__ __forceinline__ void scores(float (&s)[4][4], const float* q, const float* k, int i0,
                                       int j0, int n, int d, float qscale, float* qt, float* kt,
                                       int ty, int tx) {
  zero(s);
  for (int c0 = 0; c0 < d; c0 += kDC) {
    __syncthreads();
    stage_chunk<true>(q, i0, n, d, c0, qscale, qt);
    stage_chunk<false>(k, j0, n, d, c0, 1.f, kt);
    __syncthreads();
    patch(s, qt, kt, min(kDC, d - c0), ty, tx);
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_wide_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ y, float* __restrict__ lse,
                     int n, int d, float qscale, r3d::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + kChunkF;
  float* pt = kt + kChunkF;  // P transposed: [key][query]
  float* vs = pt + kPF;      // V: [key][channel]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(b) * n * d;
  q += base;
  k += base;
  v += base;
  y += base;

  // pass 1: each row's max and sum
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kRows) {
    float s[4][4];
    scores(s, q, k, i0, j0, n, d, qscale, qt, kt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j0 + 4 * tx + j < n) mt = fmaxf(mt, s[r][j]);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[r], mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j0 + 4 * tx + j < n) ps += expf(s[r][j] - mn);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * expf(m[r] - mn) + ps;
      m[r] = mn;
    }
  }
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + 4 * ty + r;
      if (row < n) lse[static_cast<size_t>(b) * n + row] = m[r] + logf(l[r]);
    }
  }

  // output passes: P V over 128 channels each
  for (int o0 = 0; o0 < d; o0 += kOut) {
    float acc[4][8];
    zero(acc);
    for (int j0 = 0; j0 < n; j0 += kRows) {
      float s[4][4];
      scores(s, q, k, i0, j0, n, d, qscale, qt, kt, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if (kDropout) factors(drop, b, i0 + 4 * ty + r, j0 / 4 + tx, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = j0 + 4 * tx + j < n ? expf(s[r][j] - m[r]) / l[r] : 0.f;
          if (kDropout) p *= f[j];
          pt[(4 * tx + j) * kPLd + 4 * ty + r] = p;
        }
      }
      stage_out(v, j0, n, d, o0, vs);
      __syncthreads();
      out_patch(acc, pt, vs, ty, tx);
      // the next scores() syncs before any thread stages again
    }
    write_out(acc, y, i0, n, d, o0, 1.f, ty, tx);
  }
}

// Delta = rowsum(dY * Y): one warp per row.
__global__ void attn_wide_delta_kernel(const float* __restrict__ dy, const float* __restrict__ y,
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

// S and dPd of the tile of queries [i0, i0 + 64) and keys [j0, j0 + 64):
// kKeyRows false: s[r][j] for query 4 ty + r and key 4 tx + j (the dQ
// kernel); true: for key 4 ty + r and query 4 tx + j (dK/dV).  Channels in
// the same order as the forward's scores.
template <bool kKeyRows>
__device__ __forceinline__ void bwd_scores(float (&s)[4][4], float (&dp)[4][4], const float* q,
                                           const float* k, const float* v, const float* dy,
                                           int i0, int j0, int n, int d, float qscale,
                                           float* stage, int ty, int tx) {
  float* qt = stage;
  float* kt = qt + kChunkF;
  float* dyt = kt + kChunkF;
  float* vt = dyt + kChunkF;
  zero(s);
  zero(dp);
  for (int c0 = 0; c0 < d; c0 += kDC) {
    __syncthreads();
    stage_chunk<true>(q, i0, n, d, c0, qscale, qt);
    stage_chunk<false>(k, j0, n, d, c0, 1.f, kt);
    stage_chunk<false>(dy, i0, n, d, c0, 1.f, dyt);
    stage_chunk<false>(v, j0, n, d, c0, 1.f, vt);
    __syncthreads();
    const int w = min(kDC, d - c0);
    if (kKeyRows) {
      patch(s, kt, qt, w, ty, tx);
      patch(dp, vt, dyt, w, ty, tx);
    } else {
      patch(s, qt, kt, w, ty, tx);
      patch(dp, dyt, vt, w, ty, tx);
    }
  }
}

// dQ = dS K * scale for 64 queries a block.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dy,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int n, int d, float scale, float qscale,
                    r3d::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;            // four chunks; dS transposed ([key][query]) after them
  float* ks = smem + 4 * kChunkF;  // K: [key][channel]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(b) * n * d;
  q += base;
  k += base;
  v += base;
  dy += base;
  dq += base;
  float lr[4], dr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + 4 * ty + r;
    lr[r] = row < n ? lse[static_cast<size_t>(b) * n + row] : 0.f;
    dr[r] = row < n ? delta[static_cast<size_t>(b) * n + row] : 0.f;
  }
  for (int o0 = 0; o0 < d; o0 += kOut) {
    float acc[4][8];
    zero(acc);
    for (int j0 = 0; j0 < n; j0 += kRows) {
      float s[4][4], dp[4][4];
      bwd_scores<false>(s, dp, q, k, v, dy, i0, j0, n, d, qscale, stage, ty, tx);
      __syncthreads();  // every thread is done with the chunks that dS overwrites
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if (kDropout) factors(drop, b, i0 + 4 * ty + r, j0 / 4 + tx, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = j0 + 4 * tx + j < n ? expf(s[r][j] - lr[r]) : 0.f;
          const float ds = p * (dp[r][j] * f[j] - dr[r]);
          stage[(4 * tx + j) * kPLd + 4 * ty + r] = ds;
        }
      }
      stage_out(k, j0, n, d, o0, ks);
      __syncthreads();
      out_patch(acc, stage, ks, ty, tx);
    }
    write_out(acc, dq, i0, n, d, o0, scale, ty, tx);
  }
}

// dV = Pd^T dY and dK = dS^T q * scale for 64 keys a block.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_wide_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dy,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int n, int d, float scale,
                      float qscale, r3d::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;              // four chunks; Pd and dS transposed ([query][key]) after them
  float* pdt = smem;
  float* dst = smem + kPF;
  float* dys = smem + 4 * kChunkF;  // dY: [query][channel]
  float* qs = dys + kOutF;          // q unscaled: [query][channel]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(b) * n * d;
  q += base;
  k += base;
  v += base;
  dy += base;
  dk += base;
  dv += base;
  for (int o0 = 0; o0 < d; o0 += kOut) {
    float acc_k[4][8], acc_v[4][8];
    zero(acc_k);
    zero(acc_v);
    for (int i0 = 0; i0 < n; i0 += kRows) {
      float s[4][4], dp[4][4];
      bwd_scores<true>(s, dp, q, k, v, dy, i0, j0, n, d, qscale, stage, ty, tx);
      __syncthreads();  // every thread is done with the chunks that Pd and dS overwrite
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // query i0 + 4 tx + j
        const int i = i0 + 4 * tx + j;
        const bool live = i < n;
        const float lq = live ? lse[static_cast<size_t>(b) * n + i] : 0.f;
        const float dq_ = live ? delta[static_cast<size_t>(b) * n + i] : 0.f;
        float f[4] = {1.f, 1.f, 1.f, 1.f};  // keys j0 + 4 ty .. + 3
        if (kDropout) factors(drop, b, i, j0 / 4 + ty, f);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = live ? expf(s[r][j] - lq) : 0.f;
          const float pd = p * f[r];
          const float ds = p * (dp[r][j] * f[r] - dq_);
          pdt[(4 * tx + j) * kPLd + 4 * ty + r] = pd;
          dst[(4 * tx + j) * kPLd + 4 * ty + r] = ds;
        }
      }
      stage_out(dy, i0, n, d, o0, dys);
      stage_out(q, i0, n, d, o0, qs);
      __syncthreads();
      out_patch(acc_v, pdt, dys, ty, tx);
      out_patch(acc_k, dst, qs, ty, tx);
    }
    write_out(acc_v, dv, j0, n, d, o0, 1.f, ty, tx);
    write_out(acc_k, dk, j0, n, d, o0, scale, ty, tx);
  }
}

constexpr size_t kFwdSmem = sizeof(float) * (2 * kChunkF + kPF + kOutF);
constexpr size_t kDqSmem = sizeof(float) * (4 * kChunkF + kOutF);
constexpr size_t kDkdvSmem = sizeof(float) * (4 * kChunkF + 2 * kOutF);
static_assert(kPF <= 4 * kChunkF && 2 * kPF <= 4 * kChunkF, "dS and Pd fit where the chunks were");

int fwd(const void* q, const void* k, const void* v, void* y, void* lse, int b, int n, int d,
        float qscale, int dropout, r3d::Dropout drop, cudaStream_t st) {
  if (b < 1 || b > 65535 || n < 1 || d < 1) return cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, b);
  auto args = [&](auto kernel) {
    return r3d_launch(kernel, grid, dim3(kThreads), kFwdSmem, st, static_cast<const float*>(q),
                      static_cast<const float*>(k), static_cast<const float*>(v),
                      static_cast<float*>(y), static_cast<float*>(lse), n, d, qscale, drop);
  };
  return dropout ? args(attn_wide_fwd_kernel<true>) : args(attn_wide_fwd_kernel<false>);
}

int bwd(const void* q, const void* k, const void* v, const void* y, const void* dy,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int n, int d,
        float scale, float qscale, int dropout, r3d::Dropout drop, cudaStream_t st) {
  if (b < 1 || b > 65535 || n < 1 || d < 1) return cudaErrorInvalidValue;
  const int rows = b * n;
  attn_wide_delta_kernel<<<(rows * 32 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<float*>(delta),
      rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, b);
  const auto qp = static_cast<const float*>(q);
  const auto kp = static_cast<const float*>(k);
  const auto vp = static_cast<const float*>(v);
  const auto dyp = static_cast<const float*>(dy);
  const auto lp = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  auto launch = [&](auto dq_kernel, auto dkdv_kernel) {
    cudaError_t e = r3d_launch(dq_kernel, grid, dim3(kThreads), kDqSmem, st, qp, kp, vp, dyp, lp,
                               dl, static_cast<float*>(dq), n, d, scale, qscale, drop);
    if (e != cudaSuccess) return e;
    return r3d_launch(dkdv_kernel, grid, dim3(kThreads), kDkdvSmem, st, qp, kp, vp, dyp, lp, dl,
                      static_cast<float*>(dk), static_cast<float*>(dv), n, d, scale, qscale,
                      drop);
  };
  return dropout ? launch(attn_wide_dq_kernel<true>, attn_wide_dkdv_kernel<true>)
                 : launch(attn_wide_dq_kernel<false>, attn_wide_dkdv_kernel<false>);
}

}  // namespace

// The forward: q, k, v (B, N, D) f32 contiguous, any D -> y (B, N, D) f32
// and, when lse is not null, lse (B, N) f32.  qscale = 1 / tau.  The
// dropout arguments as r3d_attn_fwd's.
R3D_EXPORT int r3d_attn_wide_fwd(const void* q, const void* k, const void* v, void* y, void* lse,
                                 int b, int n, int d, float qscale, int dropout,
                                 unsigned seed_lo, unsigned seed_hi, unsigned threshold,
                                 float keep_scale, void* stream) {
  return fwd(q, k, v, y, lse, b, n, d, qscale, dropout,
             r3d::Dropout{seed_lo, seed_hi, threshold, keep_scale},
             static_cast<cudaStream_t>(stream));
}

// The backward: q, k, v as the forward's; y, dy (B, N, D) f32, lse (B, N)
// f32; delta (B, N) f32 scratch -> dq, dk, dv (B, N, D) f32.  scale = 1 /
// tau, qscale the forward's.
R3D_EXPORT int r3d_attn_wide_bwd(const void* q, const void* k, const void* v, const void* y,
                                 const void* dy, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int b, int n, int d, float scale,
                                 float qscale, int dropout, unsigned seed_lo, unsigned seed_hi,
                                 unsigned threshold, float keep_scale, void* stream) {
  return bwd(q, k, v, y, dy, lse, delta, dq, dk, dv, b, n, d, scale, qscale, dropout,
             r3d::Dropout{seed_lo, seed_hi, threshold, keep_scale},
             static_cast<cudaStream_t>(stream));
}
