// Chebyshev solve of (I - alpha S) x = b on a bf16 S with f32 iterates.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_cheby.py:_cheby_kernel (via
// cheby_solve_pallas).  Same recurrence (Saad, alg. 12.1, spectral bounds
// [1 - alpha, 1 + alpha]): r = b, d = r / theta, x = d, then for each step
//   r <- r - (d - alpha * S d);  d <- c1 * d + c2 * r;  x <- x + d
// with the per-step scalars (c1, c2) computed once on the host, in double,
// by ops/cuda_cheby.py:coefficients and shared with the plain version.  The
// TPU kernel splits d into a bf16 hi + lo pair because the MXU takes bf16
// operands; here each product of a bf16 entry of S (upcast exactly) with an
// f32 entry of d is one f32 FMA, so no split is needed and the kernel
// computes what the plain f32 product of the upcast S computes, in another
// summation order.  The r/d/x updates use round-to-nearest intrinsics (no
// contraction) in the plain version's operation order.
//
// What bounds it on the H100: each step reads all of S (4396^2 bf16 =
// 38.65 MB at the flagship graph; the 50 MB L2 can hold it across steps)
// and does 2 * ncols flops per entry.  Design: one launch per step, because
// step t + 1 needs all of d from step t and blocks of one launch are not
// all co-resident (no grid-wide barrier); d is double-buffered, read from
// one buffer and written to the other.  A block stages d (ncols x M f32,
// column-major) in shared memory once; each warp owns kRowsPerWarp rows and
// reads their entries of S with 8-byte loads (4 bf16 per lane, so a warp
// reads 256 contiguous bytes of each row per step), sharing each d load
// across its rows; row sums are reduced with warp shuffles.  Where M, the
// row stride or the base is not a multiple of 4 entries, lanes take 2-byte
// loads instead.
//
// Layout: s (M, lds) bf16 row-major, b and x (M, ncols) f32 row-major,
// scratch (2 * ncols * ldd + M * ncols) f32 with ldd = M rounded up to 4:
// the two d buffers, then r.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxCols = 8;

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

// V consecutive bf16 entries starting at p, upcast exactly to f32.
template <int V>
__device__ __forceinline__ void load_s(const unsigned short* p, float* out);

template <>
__device__ __forceinline__ void load_s<4>(const unsigned short* p, float* out) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  out[0] = bf16_bits_to_float(u.x & 0xffffu);
  out[1] = __uint_as_float(u.x & 0xffff0000u);
  out[2] = bf16_bits_to_float(u.y & 0xffffu);
  out[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <>
__device__ __forceinline__ void load_s<1>(const unsigned short* p, float* out) {
  out[0] = bf16_bits_to_float(__ldg(p));
}

template <int V>
__device__ __forceinline__ void load_d(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

// r = b, d = b / theta (column-major into d), x = d.
__global__ void cheby_init_kernel(const float* __restrict__ b, float* __restrict__ x,
                                  float* __restrict__ r, float* __restrict__ d, int m,
                                  int c, int ldd, float theta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * c) return;
  const int row = i / c;
  const int col = i - row * c;
  const float v = b[i];
  const float dv = __fdiv_rn(v, theta);
  r[i] = v;
  x[i] = dv;
  d[col * ldd + row] = dv;
}

// One Chebyshev step for kRowsPerBlock rows.
template <int C, int V>
__global__ void __launch_bounds__(kThreads)
cheby_step_kernel(const unsigned short* __restrict__ s, int lds, int m,
                  const float* __restrict__ d_in, float* __restrict__ d_out, int ldd,
                  float* __restrict__ r, float* __restrict__ x, float alpha, float c1,
                  float c2) {
  extern __shared__ __align__(16) float d_s[];  // C x ldd
  const int n4 = C * ldd / 4;
  for (int k = threadIdx.x; k < n4; k += kThreads) {
    reinterpret_cast<float4*>(d_s)[k] = reinterpret_cast<const float4*>(d_in)[k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  if (row0 >= m) return;  // no barrier follows

  const unsigned short* srow[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    srow[q] = s + static_cast<size_t>(min(row0 + q, m - 1)) * lds;  // ragged tail: a repeat
  }
  float acc[kRowsPerWarp][C];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int col = 0; col < C; ++col) acc[q][col] = 0.f;
  }

#pragma unroll 2
  for (int j = lane * V; j < m; j += 32 * V) {
    float sv[kRowsPerWarp][V];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) load_s<V>(srow[q] + j, sv[q]);
#pragma unroll
    for (int col = 0; col < C; ++col) {
      float dv[V];
      load_d<V>(d_s + col * ldd + j, dv);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][col] = fmaf(sv[q][e], dv[e], acc[q][col]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int col = 0; col < C; ++col) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[q][col] += __shfl_xor_sync(0xffffffffu, acc[q][col], off);
      }
    }
  }

  // lane l updates entry (row0 + l / C, l % C)
  if (lane >= kRowsPerWarp * C) return;
  const int q = lane / C;
  const int col = lane - q * C;
  const int row = row0 + q;
  if (row >= m) return;
  float sd = 0.f;
#pragma unroll
  for (int qq = 0; qq < kRowsPerWarp; ++qq) {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      if (qq == q && cc == col) sd = acc[qq][cc];
    }
  }
  const int i = row * C + col;
  const float dv = d_s[col * ldd + row];
  const float md = __fsub_rn(dv, __fmul_rn(alpha, sd));  // (I - alpha S) d
  const float rv = __fsub_rn(r[i], md);
  const float dn = __fadd_rn(__fmul_rn(c1, dv), __fmul_rn(c2, rv));
  r[i] = rv;
  x[i] = __fadd_rn(x[i], dn);
  d_out[col * ldd + row] = dn;
}

template <int C, int V>
cudaError_t run_steps(const unsigned short* s, int lds, int m, float* d0, float* d1, int ldd,
                      float* r, float* x, int iters, float alpha, const float* coef,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * C * static_cast<size_t>(ldd);
  cudaError_t err = r3d_set_smem(cheby_step_kernel<C, V>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int t = 0; t + 1 < iters; ++t) {
    const float* d_in = (t % 2 == 0) ? d0 : d1;
    float* d_out = (t % 2 == 0) ? d1 : d0;
    cheby_step_kernel<C, V><<<grid, kThreads, smem, stream>>>(
        s, lds, m, d_in, d_out, ldd, r, x, alpha, coef[2 * t], coef[2 * t + 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int C>
cudaError_t run_steps_aligned(const unsigned short* s, int lds, int m, float* d0, float* d1,
                              int ldd, float* r, float* x, int iters, float alpha,
                              const float* coef, cudaStream_t stream) {
  const bool vec =
      m % 4 == 0 && lds % 4 == 0 && reinterpret_cast<std::uintptr_t>(s) % 8 == 0;
  return vec ? run_steps<C, 4>(s, lds, m, d0, d1, ldd, r, x, iters, alpha, coef, stream)
             : run_steps<C, 1>(s, lds, m, d0, d1, ldd, r, x, iters, alpha, coef, stream);
}

}  // namespace

// coef: 2 * (iters - 1) host floats, (c1, c2) per step.  One call is one
// solve: an init launch and iters - 1 step launches on `stream`.
R3D_EXPORT int r3d_cheby(const void* s, int lds, const void* b, void* x, void* scratch, int m,
                         int c, int iters, float alpha, float theta, const float* coef,
                         void* stream) {
  if (c < 1 || c > kMaxCols || m < 1 || iters < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldd = (m + 3) / 4 * 4;
  float* d0 = static_cast<float*>(scratch);
  float* d1 = d0 + static_cast<size_t>(c) * ldd;
  float* r = d1 + static_cast<size_t>(c) * ldd;
  float* xf = static_cast<float*>(x);
  const int n = m * c;
  cheby_init_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(b), xf, r, d0,
                                                      m, c, ldd, theta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* sp = static_cast<const unsigned short*>(s);
  switch (c) {
    case 1: return run_steps_aligned<1>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 2: return run_steps_aligned<2>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 3: return run_steps_aligned<3>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 4: return run_steps_aligned<4>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 5: return run_steps_aligned<5>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 6: return run_steps_aligned<6>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    case 7: return run_steps_aligned<7>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
    default: return run_steps_aligned<8>(sp, lds, m, d0, d1, ldd, r, xf, iters, alpha, coef, st);
  }
}
