// Exact k-nearest-neighbour search per point cloud.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_knn.py:_knn_kernel in its
// exact mode (exact=True): squared L2 distances (qq + kk) - 2 * inner,
// clamped at 0, self included, k smallest per row with ties to the lowest
// index.  The packed-mantissa mode of the TPU kernel was a VPU economy;
// the H100 does not need it.
//
// Layout: x (B, N, C) f32 contiguous -> out (B, N, k) int32.
// Grid: (ceil(N / kTile), B), kThreads threads per block.  A block owns
// kTile query rows and streams every key of the cloud through shared
// memory in tiles of kTile points (one cloud at C = 64 is 512 KB and does
// not fit).  Per key tile:
//   1. distances: a kTile x kTile inner-product tile, each thread a 4 x 4
//      register sub-tile; query and key tiles sit channel-major in shared
//      memory, so one channel costs two float4 loads for 16 FFMAs;
//   2. selection: one warp per query row keeps the row's sorted top-k
//      list with slot l in lane l (k <= 32).  The tile's distances go by
//      in batches of 32 keys, one per lane; a ballot finds the lanes below
//      the current k-th distance, and each of them, in key order, is
//      inserted by one warp-wide shift (shfl_up) on a strict '<', which
//      keeps lowest-index ties.  Per-thread lists would diverge: early
//      tiles insert on most keys, and a warp then runs every lane's
//      insertion in turn.
// Norms and inner products run the same sequential fmaf chain over the
// channels, so a point's distance to itself is exactly 0.  No TF32.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 distances each
constexpr int kRowsPerWarp = kTile / (kThreads / 32);

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ x, int* __restrict__ out, int n, int c, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // c * kTile, channel-major
  float* k_s = q_s + c * kTile;                  // c * kTile, channel-major
  float* d_s = k_s + c * kTile;                  // kTile * (kTile + 1), row-major
  float* qq_s = d_s + kTile * (kTile + 1);       // kTile
  float* kk_s = qq_s + kTile;                    // kTile

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int r0 = (t / 16) * 4;  // this thread's 4 query rows in the tile
  const int c0 = (t % 16) * 4;  // and 4 keys
  const int lane = t % 32;
  const int warp = t / 32;
  const float* xb = x + static_cast<size_t>(b) * n * c;

  for (int e = t; e < kTile * c; e += kThreads) {
    const int r = e % kTile;
    const int ch = e / kTile;
    q_s[ch * kTile + r] = (row0 + r < n) ? xb[static_cast<size_t>(row0 + r) * c + ch] : 0.f;
  }
  __syncthreads();
  if (t < kTile) {
    float s = 0.f;
    for (int ch = 0; ch < c; ++ch) s = fmaf(q_s[ch * kTile + t], q_s[ch * kTile + t], s);
    qq_s[t] = s;
  }

  // Lane l holds slot l of the top-k lists of rows warp * kRowsPerWarp + i.
  float best_d[kRowsPerWarp];
  int best_i[kRowsPerWarp];
  float worst[kRowsPerWarp];  // each list's slot k - 1, the same in every lane
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    best_d[i] = INFINITY;
    best_i[i] = 0;
    worst[i] = INFINITY;
  }

  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int nk = min(kTile, n - j0);
    __syncthreads();  // the previous tile's keys and distances are consumed
    for (int e = t; e < kTile * c; e += kThreads) {
      const int j = e % kTile;
      const int ch = e / kTile;
      k_s[ch * kTile + j] = (j < nk) ? xb[static_cast<size_t>(j0 + j) * c + ch] : 0.f;
    }
    __syncthreads();
    if (t < kTile) {
      float s = 0.f;
      for (int ch = 0; ch < c; ++ch) s = fmaf(k_s[ch * kTile + t], k_s[ch * kTile + t], s);
      kk_s[t] = s;
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + ch * kTile + r0);
      const float4 bk = *reinterpret_cast<const float4*>(k_s + ch * kTile + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // kk_s is complete
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(qq_s[r0 + i], kk_s[c0 + j]), __fmul_rn(2.f, acc[i][j])), 0.f);
        d_s[(r0 + i) * (kTile + 1) + c0 + j] = (c0 + j < nk) ? d : INFINITY;
      }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float* dr = d_s + (warp * kRowsPerWarp + i) * (kTile + 1);
      for (int half = 0; half < kTile; half += 32) {
        const float d = dr[half + lane];   // +inf past the last key
        unsigned int todo = __ballot_sync(0xffffffffu, d < worst[i]);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const float cd = __shfl_sync(0xffffffffu, d, src);
          if (!(cd < worst[i])) continue;  // the k-th distance fell meanwhile
          const float up_d = __shfl_up_sync(0xffffffffu, best_d[i], 1);
          const int up_i = __shfl_up_sync(0xffffffffu, best_i[i], 1);
          if (lane > 0 && up_d > cd) {         // the slot below holds a larger value
            best_d[i] = up_d;
            best_i[i] = up_i;
          } else if (best_d[i] > cd) {         // first slot above the values <= cd
            best_d[i] = cd;
            best_i[i] = j0 + half + src;
          }
          worst[i] = __shfl_sync(0xffffffffu, best_d[i], k - 1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp * kRowsPerWarp + i;
    if (row < n && lane < k) out[(static_cast<size_t>(b) * n + row) * k + lane] = best_i[i];
  }
}

}  // namespace

// k <= 32: one lane per slot of a top-k list.
R3D_EXPORT int r3d_knn(const void* x, void* out, int b, int n, int c, int k, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(c) * kTile + kTile * (kTile + 1) + 2 * kTile);
  cudaError_t err = r3d_set_smem(knn_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTile - 1) / kTile, b);
  knn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(out), n, c, k);
  return cudaGetLastError();
}
