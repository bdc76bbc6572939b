// Masked farthest point sampling, a batch of independent instances.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_fps.py:_fps_kernel (via
// masked_fps_pallas).  Semantics are those of ops/fps.py:masked_fps:
//   * running min distance starts at +BIG for valid and -1 for invalid
//     points, so the first pick is the first valid point;
//   * each round picks the argmax of the running min distance, lowest
//     index on ties, then lowers it by the direct sum((x - c)^2) distance
//     to the new seed (the plain path's form, not the TPU kernel's Gram
//     form, so the port has one distance rule);
//   * once every valid point is chosen, later slots repeat the lowest
//     valid index (callers mask them with seed_valid).
//
// Layout: feat (P, N, C) f32, valid (P, N) bool (one byte each) ->
// seeds (P, k) int32; the wrapper passes scratch buffers for the running
// min distance (P, N), per-block candidates (P, G), a zeroed per-instance
// arrival counter and the current pick.
//
// The rounds are sequential, but one block per instance would leave most
// of the 132 SMs idle while one SM sweeps up to 15.7 MB of features per
// round.  So each round is one launch over a (G, P) grid:
// every block owns kPoints points, few enough that a round's sweep runs
// as many short warps in parallel, lowers their running min distance
// (one warp per point, lanes over channels, coalesced reads from L2) and
// finds its local argmax; the last block of an instance to arrive
// (threadfence + atomic counter) reduces the G candidates and publishes
// the pick that the next launch reads.  Stream order replaces a grid-wide
// barrier, so no block ever waits for another.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 64;  // points per block: 8 per warp
constexpr float kBig = 3.4e38f;
constexpr float kNeg = -1.f;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax of (v, i) pairs, lowest index on ties; the result is
// left in red_v[0], red_i[0].
__device__ void block_argmax(float v, int i, float* red_v, int* red_i) {
  const int t = threadIdx.x;
  red_v[t] = v;
  red_i[t] = i;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s && better(red_v[t + s], red_i[t + s], red_v[t], red_i[t])) {
      red_v[t] = red_v[t + s];
      red_i[t] = red_i[t + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fps_round_kernel(const float* __restrict__ feat, const unsigned char* __restrict__ valid,
                 float* __restrict__ mind, float* __restrict__ cand_v, int* __restrict__ cand_i,
                 unsigned int* __restrict__ arrived, int* __restrict__ pick,
                 int* __restrict__ seeds, int n, int c, int k, int round) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red_v = reinterpret_cast<float*>(smem);          // kThreads
  int* red_i = reinterpret_cast<int*>(red_v + kThreads);   // kThreads
  int* is_last = red_i + kThreads;                         // 1

  const int p = blockIdx.y;
  const int g = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* f = feat + static_cast<size_t>(p) * n * c;
  const unsigned char* ok = valid + static_cast<size_t>(p) * n;
  float* md = mind + static_cast<size_t>(p) * n;
  const int i0 = g * kPoints;
  const int i1 = min(n, i0 + kPoints);

  if (round == 0) {
    for (int i = i0 + t; i < i1; i += kThreads) md[i] = ok[i] ? kBig : kNeg;
  } else {
    const float* centre = f + static_cast<size_t>(pick[p]) * c;
    for (int i = i0 + warp; i < i1; i += kWarps) {
      if (!ok[i]) continue;  // invalid points stay at -1; uniform across the warp
      const float* xr = f + static_cast<size_t>(i) * c;
      float acc = 0.f;
      for (int ch = lane; ch < c; ch += 32) {
        const float diff = xr[ch] - centre[ch];
        acc = fmaf(diff, diff, acc);
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) md[i] = fminf(md[i], acc);
    }
  }
  __syncthreads();

  float bv = -INFINITY;
  int bi = n;
  for (int i = i0 + t; i < i1; i += kThreads) {
    const float v = md[i];
    if (v > bv) {
      bv = v;
      bi = i;
    }
  }
  block_argmax(bv, bi, red_v, red_i);
  if (t == 0) {
    cand_v[p * n_blocks + g] = red_v[0];
    cand_i[p * n_blocks + g] = red_i[0];
    __threadfence();
    *is_last = atomicAdd(&arrived[p], 1u) == static_cast<unsigned int>(n_blocks - 1);
  }
  __syncthreads();
  if (!*is_last) return;

  __threadfence();
  bv = -INFINITY;
  bi = n;
  for (int j = t; j < n_blocks; j += kThreads) {
    const float v = reinterpret_cast<volatile float*>(cand_v)[p * n_blocks + j];
    const int i = reinterpret_cast<volatile int*>(cand_i)[p * n_blocks + j];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  block_argmax(bv, bi, red_v, red_i);
  if (t == 0) {
    pick[p] = red_i[0];
    seeds[static_cast<size_t>(p) * k + round] = red_i[0];
    arrived[p] = 0u;
  }
}

}  // namespace

// mind: (p, n) f32 scratch; cand_v, cand_i: (p, ceil(n / kPoints)) scratch;
// arrived: (p,) uint32, zero on entry and on return; pick: (p,) int32 scratch.
R3D_EXPORT int r3d_fps(const void* feat, const void* valid, void* seeds, void* mind,
                       void* cand_v, void* cand_i, void* arrived, void* pick, int p, int n,
                       int c, int k, void* stream) {
  const size_t smem = sizeof(float) * 2 * kThreads + sizeof(int);
  const dim3 grid((n + kPoints - 1) / kPoints, p);
  for (int r = 0; r < k; ++r) {
    fps_round_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const unsigned char*>(valid),
        static_cast<float*>(mind), static_cast<float*>(cand_v), static_cast<int*>(cand_i),
        static_cast<unsigned int*>(arrived), static_cast<int*>(pick), static_cast<int*>(seeds),
        n, c, k, r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
