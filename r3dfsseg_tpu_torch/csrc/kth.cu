// Per-row k-th smallest distance by fixed-count bisection.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_kth.py:_kth_kernel (via
// kth_smallest_per_row_pallas).  Same rule: bracket [0, max(row max
// finite, 1e-6)], where finite means d < 0.5 * 1e30 (the affinity's
// self/invalid sentinel); then `iters` steps of mid = 0.5 * (lo + hi),
// count(d <= mid) >= k ? hi = mid : lo = mid; the result is hi.  Counts are
// integers and the mid-point is computed with round-to-nearest intrinsics
// (no contraction), so the result equals the plain version bit for bit.
//
// Layout: d (R, M) f32 or bf16 contiguous -> out (R,) f32.  One block per
// row: the row is staged once in shared memory as f32 (M = 4396 -> 17.6 KB;
// a bf16 row is upcast exactly while it is staged, as the TPU kernel
// upcasts its tile, so the bf16 variant reads half the bytes from device
// memory and runs the same f32 bisection) and every step re-reads it from
// there instead of from device memory.  The bound is the shared-memory
// sweep, iters x M compares per row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(unsigned short bf16_bits) {
  return __uint_as_float(static_cast<unsigned int>(bf16_bits) << 16);
}

template <typename T>  // float, or unsigned short holding bf16 bits
__global__ void __launch_bounds__(kThreads)
kth_kernel(const T* __restrict__ d, float* __restrict__ out, int m, int k, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* row_s = reinterpret_cast<float*>(smem);          // m
  float* red_f = row_s + m;                                // kThreads
  int* red_i = reinterpret_cast<int*>(red_f + kThreads);   // kThreads

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const T* dr = d + static_cast<size_t>(r) * m;

  float mx = 0.f;
  for (int j = t; j < m; j += kThreads) {
    const float v = upcast(dr[j]);
    row_s[j] = v;
    if (v < 0.5f * kBig) mx = fmaxf(mx, v);
  }
  red_f[t] = mx;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red_f[t] = fmaxf(red_f[t], red_f[t + s]);
    __syncthreads();
  }
  float hi = fmaxf(red_f[0], 1e-6f);
  float lo = 0.f;

  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
    for (int j = t; j < m; j += kThreads) cnt += row_s[j] <= mid;
    red_i[t] = cnt;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) red_i[t] += red_i[t + s];
      __syncthreads();
    }
    const bool ge = red_i[0] >= k;
    __syncthreads();  // every thread has read the count before it is overwritten
    if (ge) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  if (t == 0) out[r] = hi;
}

template <typename T>
cudaError_t launch(const void* d, void* out, int rows, int m, int k, int iters, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(m) + 2 * kThreads);
  cudaError_t err = r3d_set_smem(kth_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  kth_kernel<T><<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<float*>(out), m, k, iters);
  return cudaGetLastError();
}

}  // namespace

R3D_EXPORT int r3d_kth(const void* d, void* out, int rows, int m, int k, int iters,
                       void* stream) {
  return launch<float>(d, out, rows, m, k, iters, stream);
}

R3D_EXPORT int r3d_kth_bf16(const void* d, void* out, int rows, int m, int k, int iters,
                            void* stream) {
  return launch<unsigned short>(d, out, rows, m, k, iters, stream);
}
