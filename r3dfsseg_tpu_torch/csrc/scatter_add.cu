// Scatter-add, the backward of the EdgeConv neighbour gather:
// dx[b, j, :] = sum of g[b, m, :] over the rows m with idx[b, m] == j.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/fast_gather.py:_scatter_kernel
// (via scatter_add_pallas), which builds a (TM, N) one-hot tile and lets
// the matrix unit compute onehot^T g, with g rounded to bf16 on the way
// in.  That rounding belongs to the TPU's matrix unit, not to the
// function: this kernel sums in f32, as `exact_grad_gather=True` asks.
//
// What bounds it on the H100: bytes.  g (B, M, C) f32 is read once (105
// MB at B = 10, N = 2048, K = 20, C = 64), idx once, dx written once; the
// adds are few.  A direct scatter replaces the one-hot product: one block
// per (cloud, slice of kSlice = 8 channels) keeps its (N, 8) slice of dx
// in shared memory (64 KB at N = 2048), walks the cloud's M = N*K rows
// and adds them with shared-memory atomics, then writes the slice once.
// A warp takes four rows at a time, eight lanes per row, one channel per
// lane: its loads are four full 32-byte sectors, and one atomic
// instruction adds four rows whose banks collide only when their targets
// agree mod 4 (a first version gave each lane a whole row: the lanes'
// targets j * 8 + x then fell on 4 banks, an 8-way conflict per add).
// Each thread issues kUnroll rows' loads before their adds, to keep bytes
// in flight.  kNN graphs have hubs (points that are the neighbour of
// many), so the atomics contend unevenly; shared-memory atomics keep that
// contention on the SM.  The order of the adds varies from run to run, so
// the sum is exact only to f32 rounding of a sum in some order.
//
// Layout: g (B, M, C) f32 contiguous, idx (B, M) int32, C % kSlice == 0 ->
// dx (B, N, C) f32.  Ids outside [0, N) are dropped, as segment_sum does.
#include "common.cuh"

namespace {

constexpr int kSlice = 8;
constexpr int kThreads = 1024;
constexpr int kUnroll = 8;
constexpr int kRowsPerPass = kThreads / kSlice;  // rows one pass of the block covers

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                   float* __restrict__ dx, int n, int m, int c) {
  extern __shared__ __align__(16) float acc[];  // n * kSlice
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kSlice;
  for (int e = threadIdx.x; e < n * kSlice; e += kThreads) acc[e] = 0.f;
  __syncthreads();

  const int ch = threadIdx.x % kSlice;
  const int sub = threadIdx.x / kSlice;  // row within a pass
  const float* gb = g + static_cast<size_t>(b) * m * c + c0 + ch;
  const int* ib = idx + static_cast<size_t>(b) * m;
  for (int r0 = sub; r0 < m; r0 += kRowsPerPass * kUnroll) {
    int j[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRowsPerPass;
      j[u] = r < m ? ib[r] : -1;
      val[u] = r < m ? gb[static_cast<size_t>(r) * c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (static_cast<unsigned>(j[u]) < static_cast<unsigned>(n)) {
        atomicAdd(acc + j[u] * kSlice + ch, val[u]);
      }
    }
  }
  __syncthreads();

  float* out = dx + static_cast<size_t>(b) * n * c + c0;
  for (int e = threadIdx.x; e < n * kSlice; e += kThreads) {
    out[static_cast<size_t>(e / kSlice) * c + e % kSlice] = acc[e];
  }
}

}  // namespace

R3D_EXPORT int r3d_scatter_add(const void* g, const void* idx, void* dx, int b, int n, int m,
                               int c, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n) * kSlice;
  cudaError_t err = r3d_set_smem(scatter_add_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(c / kSlice, b);
  scatter_add_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx), static_cast<float*>(dx), n, m,
      c);
  return cudaGetLastError();
}
