// Row gather: out[b, i, k, :] = x[b, idx[b, i, k], :].
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/fast_gather.py:_gather_kernel
// (via gather_onehot_pallas), which builds a (TM, N) one-hot tile per step
// and lets the matrix unit compute onehot @ table, only to put the gather
// on the TPU's MXU.  Each output row is one table row, so on Hopper the
// same function is a row copy: bit-exact for any element type, with no
// products at all.
//
// What bounds it on the H100: bytes.  The output is written once (105 MB at
// B = 10, N = NQ = 2048, K = 20, C = 64 f32), the table is read once from
// device memory (5 MB; later reads of a row hit L2) and idx once (1.6 MB).
// One thread copies one 16-byte chunk of a row, and neighbouring lanes take
// neighbouring chunks, so a warp reads whole 128-byte lines of two rows
// (f32, C = 64) and writes 512 contiguous bytes.  The copy moves raw bytes
// (uint4), so f32 and bf16 tables share the kernel.  A row that is not a
// multiple of 16 bytes (any C: the TPU kernel takes any) is copied in the
// largest pieces that divide it, 4 or 2 bytes (r3d_gather_rows_narrow):
// the same kernel on a narrower chunk, still a copy of the bytes.
//
// Layout: x (B, N, row_bytes) contiguous, idx (B, M) int32 with M = NQ * K
// -> out (B, M, row_bytes); row_bytes % 16 == 0 for r3d_gather_rows, even
// for r3d_gather_rows_narrow.  An id outside [0, N) gives a zero row, as
// the one-hot product does.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 zero_chunk(uint4) { return make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ uint32_t zero_chunk(uint32_t) { return 0u; }
__device__ __forceinline__ uint16_t zero_chunk(uint16_t) { return 0; }

// V: the piece one thread copies, uint4 (16 bytes), uint32_t or uint16_t
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ x, const int* __restrict__ idx,
                   V* __restrict__ out, long long total, int n, int m, int chunks) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long r = g / chunks;  // output row, b * m + i * K + k
  const int v = static_cast<int>(g - r * chunks);
  const long long b = r / m;
  const int j = __ldg(idx + r);
  V val = zero_chunk(V());
  if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) {
    val = __ldg(x + (b * n + j) * chunks + v);
  }
  out[g] = val;
}

template <typename V>
int gather(const void* x, const void* idx, void* out, int b, int n, int m, int row_bytes,
           void* stream) {
  const int chunks = row_bytes / static_cast<int>(sizeof(V));
  const long long total = static_cast<long long>(b) * m * chunks;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(x), static_cast<const int*>(idx), static_cast<V*>(out), total, n, m,
      chunks);
  return cudaGetLastError();
}

}  // namespace

R3D_EXPORT int r3d_gather_rows(const void* x, const void* idx, void* out, int b, int n, int m,
                               int row_bytes, void* stream) {
  if (row_bytes % 16) return cudaErrorInvalidValue;
  return gather<uint4>(x, idx, out, b, n, m, row_bytes, stream);
}

// Rows of any even number of bytes: 4-byte pieces where they divide the
// row, else 2-byte ones.
R3D_EXPORT int r3d_gather_rows_narrow(const void* x, const void* idx, void* out, int b, int n,
                                      int m, int row_bytes, void* stream) {
  if (row_bytes % 2) return cudaErrorInvalidValue;
  return row_bytes % 4 ? gather<uint16_t>(x, idx, out, b, n, m, row_bytes, stream)
                       : gather<uint32_t>(x, idx, out, b, n, m, row_bytes, stream);
}
