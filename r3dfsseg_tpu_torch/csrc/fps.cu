// Masked farthest point sampling, a batch of independent instances, in one
// cooperative launch per call.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_fps.py:_fps_kernel (via
// masked_fps_pallas), which runs all k rounds inside one pallas_call with
// the features held in VMEM.  Semantics are those of ops/fps.py:masked_fps:
//   * running min distance starts at +BIG for valid and -1 for invalid
//     points, so the first pick is the first valid point (index 0 when
//     there is none);
//   * each round picks the argmax of the running min distance, lowest
//     index on ties, then lowers it by the direct sum((x - c)^2) distance
//     to the new seed (the plain path's form, not the TPU kernel's Gram
//     form, so the port has one distance rule);
//   * once every valid point is chosen, later slots repeat the lowest
//     valid index (callers mask them with seed_valid).
//
// Layout: feat (P, N, C) f32, valid (P, N) bool (one byte each) ->
// seeds (P, k) int32; the wrapper passes scratch for the block candidates
// of the two round parities, (2, grid) each of value and index, and for
// the running min distance (P, N), which only the global-memory branch
// uses.
//
// What bounds it on the H100: k strictly sequential rounds, each a sweep
// over the valid points' features (up to 20,480 x 192 floats, 15.7 MB, at
// the flagship background instance) and an argmax over N.  Read once, the
// features bound a call at a few microseconds; what a call pays is k
// rounds of a sweep, an argmax and a grid-wide barrier.
//
// Design: one cooperative launch (common.cuh: coop_plan, coop_launch) of
// one block per SM, all co-resident.  The P instances share the grid:
// each gets grid / P blocks, and a block owns a contiguous range of one
// instance's points.  The block lists its valid points in index order and
// keeps their features and running min distance in shared memory for the
// whole call.  A round:
//   1. each warp lowers the running min of its points by the distance to
//      the centre row (four points at a time, eight lanes over the
//      channels of each, in a fixed order) and keeps their argmax; the
//      block reduces its warps' argmaxes (lowest index on ties) into a
//      candidate slot of the round's parity; one this_grid().sync();
//   2. warp 0 reduces its instance's candidates (through L2: other blocks
//      wrote them) to the pick, the instance's first block writes
//      seeds[p, round], and warp 0 reads the centre row into shared
//      memory for the block.
// The argmax with the lowest index on ties is a total order, so every
// block derives the same pick whatever the order of the reduction, and a
// call repeats bit for bit.  Two candidate slots suffice: a block writes
// parity r & 1 in round r, and no block reaches round r + 2 before every
// block has passed round r + 1's barrier, after its reads of round r.
// Where a block's features do not fit in shared memory (kOnChip false),
// the same kernel reads them from global memory at every round and keeps
// the running min in the (P, N) scratch.
#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinPoints = 64;      // points per block, at least (ops/cuda_fps.py)
constexpr int kMaxCand = 8;         // candidates a lane reads: at most 256 blocks an instance
constexpr float kBig = 3.4e38f;
constexpr float kNeg = -1.f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The warp's argmax of (v, i), lowest index on ties, in every lane.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Row stride of the features kept on chip: a multiple of 8 that is an odd
// multiple of 8 (8 or 24 mod 32), so four points' rows (the four lane
// groups of a warp, see the sweep) start on different banks.
__host__ __device__ inline int row_stride(int c) {
  const int ld = (c + 7) / 8 * 8;
  return ld % 16 == 0 ? ld + 8 : ld;
}

// Shared memory, in floats: centre row (c, padded to 4), warp argmaxes
// (2 * kWarps), valid-point list (per), running min (per, on chip), and
// with kOnChip the features (per rows of row_stride(c)).
size_t smem_floats(int per, int c, bool on_chip) {
  const size_t head = (static_cast<size_t>(c) + 3) / 4 * 4 + 2 * kWarps + per;
  return head + (on_chip ? static_cast<size_t>(per) * (row_stride(c) + 1) : 0);
}

template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ feat, const unsigned char* __restrict__ valid,
           int* __restrict__ seeds, float* __restrict__ mind, float* cand_v, int* cand_i, int n,
           int c, int k, int bpi, int per) {
  extern __shared__ __align__(16) float smem[];
  float* cen_s = smem;
  float* red_v = cen_s + (c + 3) / 4 * 4;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* vid_s = red_i + kWarps;
  float* md_on = reinterpret_cast<float*>(vid_s + per);
  float* x_s = md_on + per;

  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p = blockIdx.x / bpi;
  const int gl = blockIdx.x - p * bpi;
  const int i0 = gl * per;
  const int cnt = max(0, min(n, i0 + per) - i0);
  const float* f = feat + static_cast<size_t>(p) * n * c;
  const unsigned char* ok = valid + static_cast<size_t>(p) * n + i0;
  float* md = kOnChip ? md_on : mind + static_cast<size_t>(p) * n + i0;
  const int ld = row_stride(c);

  // The block's valid points, in index order (a block-wide scan of ballots).
  int nv = 0;
  for (int base = 0; base < cnt; base += kThreads) {
    const int j = base + t;
    const bool v = j < cnt && ok[j];
    const unsigned bal = __ballot_sync(kFull, v);
    if (lane == 0) red_i[warp] = __popc(bal);
    __syncthreads();
    int off = nv, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? red_i[w] : 0;
      total += red_i[w];
    }
    if (v) vid_s[off + __popc(bal & ((1u << lane) - 1u))] = j;
    nv += total;
    __syncthreads();
  }
  for (int s = t; s < nv; s += kThreads) md[s] = kBig;
  if constexpr (kOnChip) {
    for (int s = warp; s < nv; s += kWarps) {
      const float* from = f + static_cast<size_t>(i0 + vid_s[s]) * c;
      for (int ch = lane; ch < c; ch += 32) x_s[static_cast<size_t>(s) * ld + ch] = from[ch];
    }
  }
  __syncthreads();

  // An invalid point of the range stands for the block at -1 (the lowest
  // index of the range: if the instance has no valid point, every point
  // is at -1 and the pick is its index 0); valid points outrank it.
  const float v_floor = cnt > 0 ? kNeg : -INFINITY;
  const int i_floor = cnt > 0 ? i0 : n;
  for (int r = 0; r < k; ++r) {
    // 1. lower the running min (from round 1 on) and take the argmax
    float wv = -INFINITY;
    int wi = n;
    // A warp takes four points at a time, eight lanes each: lane 4 j + q
    // sums channels j, j + 8, ... of point s0 + q, and the eight partial
    // sums meet in a fixed xor tree.
    const int q = lane & 3;
    const int j = lane >> 2;
    for (int s0 = 4 * warp; s0 < nv; s0 += 4 * kWarps) {
      const int s = s0 + q;
      const int sc = min(s, nv - 1);  // a real point past the list's end
      float v = s < nv ? md[s] : -INFINITY;
      const int i = s < nv ? i0 + vid_s[s] : n;
      if (r > 0) {
        const float* xr = kOnChip ? x_s + static_cast<size_t>(sc) * ld
                                  : f + static_cast<size_t>(i0 + vid_s[sc]) * c;
        float acc = 0.f;
#pragma unroll 4
        for (int ch = j; ch < c; ch += 8) {
          const float diff = xr[ch] - cen_s[ch];
          acc = fmaf(diff, diff, acc);
        }
        acc += __shfl_xor_sync(kFull, acc, 4);
        acc += __shfl_xor_sync(kFull, acc, 8);
        acc += __shfl_xor_sync(kFull, acc, 16);
        v = fminf(v, acc);
        if (j == 0 && s < nv) md[s] = v;
      }
      if (better(v, i, wv, wi)) {
        wv = v;
        wi = i;
      }
    }
    warp_argmax(wv, wi);
    if (lane == 0) {
      red_v[warp] = wv;
      red_i[warp] = wi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < kWarps ? red_v[lane] : v_floor;
      int i = lane < kWarps ? red_i[lane] : i_floor;
      if (better(v_floor, i_floor, v, i)) {
        v = v_floor;
        i = i_floor;
      }
      warp_argmax(v, i);
      if (lane == 0) {
        cand_v[(r & 1) * gridDim.x + blockIdx.x] = v;
        cand_i[(r & 1) * gridDim.x + blockIdx.x] = i;
      }
    }
    grid.sync();

    // 2. the instance's pick, by warp 0; the centre row
    if (warp == 0) {
      // all of a lane's candidate loads in flight at once, then the reduction
      const int first = (r & 1) * gridDim.x + p * bpi;
      float cv[kMaxCand];
      int ci[kMaxCand];
#pragma unroll
      for (int u = 0; u < kMaxCand; ++u) {
        const int e = lane + 32 * u;
        cv[u] = e < bpi ? __ldcg(cand_v + first + e) : -INFINITY;
        ci[u] = e < bpi ? __ldcg(cand_i + first + e) : n;
      }
      float v = cv[0];
      int i = ci[0];
#pragma unroll
      for (int u = 1; u < kMaxCand; ++u) {
        if (better(cv[u], ci[u], v, i)) {
          v = cv[u];
          i = ci[u];
        }
      }
      warp_argmax(v, i);
      if (gl == 0 && lane == 0) seeds[static_cast<size_t>(p) * k + r] = i;
      if (r + 1 < k) {
        for (int ch = lane; ch < c; ch += 32) cen_s[ch] = f[static_cast<size_t>(i) * c + ch];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// mind: (p, n) f32 scratch (the global-memory branch's running min);
// cand_v, cand_i: 2 * p * ceil(n / 64) entries each, at least the
// candidates of both parities; arrived and pick are not used (null).
// p must not exceed the SM count: the wrapper splits larger batches.
R3D_EXPORT int r3d_fps(const void* feat, const void* valid, void* seeds, void* mind,
                       void* cand_v, void* cand_i, void* arrived, void* pick, int p, int n,
                       int c, int k, void* stream) {
  (void)arrived;
  (void)pick;
  if (p < 1 || n < 1 || c < 1 || k < 1) return cudaErrorInvalidValue;
  r3d::CoopLaunch plan{};
  cudaError_t err = r3d::coop_plan(INT_MAX, plan);
  if (err != cudaSuccess) return err;
  if (p > plan.sms || plan.sms > 32 * kMaxCand) return cudaErrorInvalidValue;
  int bpi = plan.sms / p;                            // blocks per instance
  bpi = std::max(1, std::min(bpi, (n + kMinPoints - 1) / kMinPoints));
  int per = (n + bpi - 1) / bpi;                     // points per block
  plan.grid = bpi * p;
  const float* fp = static_cast<const float*>(feat);
  const unsigned char* vp = static_cast<const unsigned char*>(valid);
  int* sp = static_cast<int*>(seeds);
  float* mp = static_cast<float*>(mind);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  void* args[] = {&fp, &vp, &sp, &mp, &cv, &ci, &n, &c, &k, &bpi, &per};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t on_chip = sizeof(float) * smem_floats(per, c, true);
  if (on_chip <= r3d::kSmemLimit) {
    return r3d::coop_launch(fps_kernel<true>, plan, kThreads, on_chip, args, st);
  }
  return r3d::coop_launch(fps_kernel<false>, plan, kThreads,
                          sizeof(float) * smem_floats(per, c, false), args, st);
}
