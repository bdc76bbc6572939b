// Scatter-add at any C and any number of targets n: the shapes
// csrc/scatter_add.cu does not take (an odd C; more targets than one
// block's shared memory holds counts for, about 28k).
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/fast_gather.py:_scatter_kernel
// (via scatter_add_pallas) there, with the tuned kernel's function and
// order of sums, so the result is bit-equal to
// ops/cuda_scatter.py:scatter_add_ordered_reference and to csrc/
// scatter_add.cu where both run: dx[b, j] = the sum, in f32, of the rows
// g[b, m] with idx[b, m] == j, taken in source order in pieces of kPiece
// rows (one piece for a target with none), each piece summed from 0 and
// the pieces added in order from 0.  Ids outside [0, n) are dropped.
//
// What bounds it on the H100: bytes (g read once, dx written once).  This
// kernel is simple, not fast: five launches build the inverse graph as a
// CSR by target in device memory, with no shared-memory limit on n:
//   count:  each cloud's rows in G units, integer atomics into a (B, G, n)
//           count table;
//   reduce: per target, each unit's start within its list (a prefix over
//           the units) and the target's total;
//   scan:   per cloud, the totals into offsets (one block a cloud);
//   fill:   one warp per unit walks its rows in order, 32 at a time, ranks
//           lanes with the same target by __match_any_sync, and writes each
//           row's index at its place: a target's list holds its rows in
//           source order;
//   sum:    one warp per target reads its rows piece by piece, each lane
//           one channel of 32 at a time (any C), and writes dx once.
// No float atomics: a call repeats bit for bit.  A bf16 g is widened to
// f32 in registers (exact), so the bf16 form equals the f32 form on the
// upcast.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kPiece = 32;         // ops/cuda_scatter.py PIECE, csrc/scatter_add.cu kPiece
constexpr int kUnitRows = 4096;    // rows of a fill unit, about
constexpr int kMaxUnits = 128;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

int units_of(int m) { return std::max(1, std::min(kMaxUnits, (m + kUnitRows - 1) / kUnitRows)); }

__device__ __forceinline__ bool valid(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n);
}

__device__ __forceinline__ void unit_rows(int gi, int units, int m, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(gi) * m / units);
  hi = static_cast<int>(static_cast<long long>(gi + 1) * m / units);
}

// cnt (B, G, n) zero on entry: unit (blockIdx.x, blockIdx.y)'s rows per target.
__global__ void count_kernel(const int* __restrict__ idx, int* __restrict__ cnt, int n, int m) {
  const int units = gridDim.x, gi = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  unit_rows(gi, units, m, lo, hi);
  const int* ib = idx + static_cast<size_t>(b) * m;
  int* c = cnt + (static_cast<size_t>(b) * units + gi) * n;
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int j = ib[r];
    if (valid(j, n)) atomicAdd(c + j, 1);
  }
}

// Per target (b, j): each unit's count replaced by its start within the
// target's list; the total into offs[b][j].
__global__ void reduce_kernel(int* __restrict__ cnt, int* __restrict__ offs, int b_count, int n,
                              int units) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(b_count) * n) return;
  const int b = static_cast<int>(e / n), j = static_cast<int>(e % n);
  int* c = cnt + static_cast<size_t>(b) * units * n + j;
  int s = 0;
  for (int gi = 0; gi < units; ++gi) {
    const int k = c[static_cast<size_t>(gi) * n];
    c[static_cast<size_t>(gi) * n] = s;
    s += k;
  }
  offs[static_cast<size_t>(b) * (n + 1) + j] = s;
}

// Cloud blockIdx.x: offs[b][0 .. n) totals -> exclusive offsets, offs[b][n]
// the cloud's rows.  Each thread scans a contiguous chunk.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int* __restrict__ offs, int n) {
  __shared__ int wsum[kScanThreads / 32];
  int* o = offs + static_cast<size_t>(blockIdx.x) * (n + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (n + kScanThreads - 1) / kScanThreads;
  const int j0 = min(static_cast<int>(threadIdx.x) * chunk, n);
  const int j1 = min(j0 + chunk, n);
  int sum = 0;
  for (int j = j0; j < j1; ++j) sum += o[j];
  int incl = sum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += x;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x0 = wsum[lane];  // kScanThreads / 32 == 32 warps
    int x = x0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(kFull, x, s);
      if (lane >= s) x += y;
    }
    wsum[lane] = x - x0;
  }
  __syncthreads();
  int run = wsum[warp] + incl - sum;
  for (int j = j0; j < j1; ++j) {
    const int v = o[j];
    o[j] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) o[n] = run;  // j1 == n for the last thread
}

// Unit (blockIdx.x, blockIdx.y), one warp: each row's index at its place.
__global__ void fill_kernel(const int* __restrict__ idx, int* __restrict__ cnt,
                            const int* __restrict__ offs, int* __restrict__ perm, int n, int m) {
  const int units = gridDim.x, gi = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x;
  int lo, hi;
  unit_rows(gi, units, m, lo, hi);
  const int* ib = idx + static_cast<size_t>(b) * m;
  int* run = cnt + (static_cast<size_t>(b) * units + gi) * n;
  const int* ob = offs + static_cast<size_t>(b) * (n + 1);
  int* pb = perm + static_cast<size_t>(b) * m;
  const unsigned below = (1u << lane) - 1u;
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int r = r0 + lane;
    int j = r < hi ? ib[r] : -1;
    if (!valid(j, n)) j = -1;
    const unsigned peers = __match_any_sync(kFull, j);
    const int start = j >= 0 ? ob[j] + run[j] : 0;
    __syncwarp();
    if (j >= 0) {
      pb[start + __popc(peers & below)] = r;
      if (lane == __ffs(peers) - 1) run[j] += __popc(peers);
    }
    __syncwarp();
  }
}

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
};

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
  }
};

constexpr int kSumWarps = 8;
constexpr int kLanes = 4;  // channels a lane carries per pass: 128 a warp

// One warp per target (b, j): dx[b, j] in the order of the plain version.
template <typename G>
__global__ void __launch_bounds__(32 * kSumWarps)
sum_kernel(const typename G::T* __restrict__ g, const int* __restrict__ offs,
           const int* __restrict__ perm, float* __restrict__ dx, int b_count, int n, int m,
           int c) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (e >= static_cast<long long>(b_count) * n) return;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(e / n), j = static_cast<int>(e % n);
  const int* ob = offs + static_cast<size_t>(b) * (n + 1);
  const int start = ob[j], rows = ob[j + 1] - start;
  const int* pb = perm + static_cast<size_t>(b) * m + start;
  const typename G::T* gb = g + static_cast<size_t>(b) * m * c;
  float* out = dx + (static_cast<size_t>(b) * n + j) * c;
  for (int c0 = 0; c0 < c; c0 += 32 * kLanes) {
    float total[kLanes];
#pragma unroll
    for (int v = 0; v < kLanes; ++v) total[v] = 0.f;
    int done = 0;
    do {  // a piece (one for a target with no rows)
      const int len = min(kPiece, rows - done);
      const int mine = lane < len ? pb[done + lane] : 0;
      float part[kLanes];
#pragma unroll
      for (int v = 0; v < kLanes; ++v) part[v] = 0.f;
      for (int u = 0; u < len; ++u) {
        const size_t at = static_cast<size_t>(__shfl_sync(kFull, mine, u)) * c;
#pragma unroll
        for (int v = 0; v < kLanes; ++v) {
          const int ch = c0 + lane + 32 * v;
          if (ch < c) part[v] = __fadd_rn(part[v], G::load(gb + at + ch));
        }
      }
#pragma unroll
      for (int v = 0; v < kLanes; ++v) total[v] = __fadd_rn(total[v], part[v]);
      done += kPiece;
    } while (done < rows);
#pragma unroll
    for (int v = 0; v < kLanes; ++v) {
      const int ch = c0 + lane + 32 * v;
      if (ch < c) out[ch] = total[v];
    }
  }
}

// The scratch buffer's parts, as byte offsets; end is its size.
struct Layout {
  size_t cnt, offs, perm, end;
};

Layout layout(int b, int n, int m) {
  Layout l{};
  l.cnt = 0;
  l.offs = l.cnt + 4 * static_cast<size_t>(b) * units_of(m) * n;
  l.perm = l.offs + 4 * static_cast<size_t>(b) * (n + 1);
  l.end = l.perm + 4 * static_cast<size_t>(b) * m;
  return l;
}

template <typename G>
int scatter_general(const void* g, const void* idx, void* dx, void* scratch, int b, int n, int m,
                    int c, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 0 || c < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(b, n, m);
  char* base = static_cast<char*>(scratch);
  int* cnt = reinterpret_cast<int*>(base + l.cnt);
  int* offs = reinterpret_cast<int*>(base + l.offs);
  int* perm = reinterpret_cast<int*>(base + l.perm);
  const int* ip = static_cast<const int*>(idx);
  const int units = units_of(m);
  cudaError_t err = cudaMemsetAsync(cnt, 0, l.offs - l.cnt, st);
  if (err != cudaSuccess) return err;
  count_kernel<<<dim3(units, b), 256, 0, st>>>(ip, cnt, n, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long targets = static_cast<long long>(b) * n;
  reduce_kernel<<<static_cast<unsigned>((targets + 255) / 256), 256, 0, st>>>(cnt, offs, b, n,
                                                                             units);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<b, kScanThreads, 0, st>>>(offs, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fill_kernel<<<dim3(units, b), 32, 0, st>>>(ip, cnt, offs, perm, n, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long blocks = (targets + kSumWarps - 1) / kSumWarps;
  sum_kernel<G><<<static_cast<unsigned>(blocks), 32 * kSumWarps, 0, st>>>(
      static_cast<const typename G::T*>(g), offs, perm, static_cast<float*>(dx), b, n, m, c);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch one call takes.
R3D_EXPORT long long r3d_scatter_general_scratch(int b, int n, int m) {
  return static_cast<long long>(layout(b, n, m).end);
}

// dx (B, N, C) f32 from g (B, M, C) f32 (r3d_scatter_general) or bf16
// (r3d_scatter_general_bf16) contiguous and idx (B, M) int32, any C and N,
// with r3d_scatter_general_scratch bytes of scratch.
R3D_EXPORT int r3d_scatter_general(const void* g, const void* idx, void* dx, void* scratch, int b,
                                   int n, int m, int c, void* stream) {
  return scatter_general<F32>(g, idx, dx, scratch, b, n, m, c, stream);
}

R3D_EXPORT int r3d_scatter_general_bf16(const void* g, const void* idx, void* dx, void* scratch,
                                        int b, int n, int m, int c, void* stream) {
  return scatter_general<BF16>(g, idx, dx, scratch, b, n, m, c, stream);
}
