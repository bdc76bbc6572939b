// Scatter-add at any C and any number of targets n: the shapes
// csrc/scatter_add.cu does not take (an odd C; more targets than one
// block's shared memory holds a histogram row of, about 28k).
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
// What bounds it on the H100: bytes (g read once, dx written once).  Its
// design is the tuned kernel's: one cooperative launch per call, one block
// of 16 warps per SM, a build of the inverse graph as a CSR by target in
// source order in which every SM takes part and no warp walks more than a
// few hundred rows, then every warp summing pieces of at most kPiece rows
// with all of a piece's row loads in flight (csrc/scatter.cuh).  What
// differs:
// - The rows are read by the lane readers (`LaneF32`, `LaneBF16`): lane l
//   carries channels l and l + 32 of a chunk of 64, two 4-byte (f32) or
//   2-byte (bf16) loads, so a row may start at any 4-byte or 2-byte
//   offset (an odd C); channels past 64 take further chunks.
// - Where n fits one block's histogram row, the build is the tuned one
//   (`narrow_build`).  Where it does not, the build sorts each cloud's
//   (target, row) pairs by target with a stable LSD radix sort written for
//   this kernel (`wide_build`): P passes of `bits` <= kMaxBits bits each
//   over the target's bits (two at n up to 2^22).  A pass cuts the cloud's
//   elements into units of at most kWideRows, at least one per SM; counts
//   each unit's digits in shared memory; scans the units' counts per digit
//   (a warp per digit, lanes over runs of units); and places the elements
//   as the tuned fill places rows, warps over runs of about kWarpRows
//   elements in order, 32 at a time, lanes with the same digit ranked by
//   __match_any_sync.  Each pass is stable, so the last one leaves each
//   target's rows in source order.  Then every target finds its rows'
//   offset and count by two binary searches over the sorted keys and
//   writes its pieces' records at slots offset / kPiece + target + q:
//   unique, in target order, within cap = n + ceil(M / kPiece), the slots
//   between empty (written so before the passes).
// No float atomics: a call repeats bit for bit.  A bf16 g is widened to
// f32 in registers (exact), so the bf16 form equals the f32 form on the
// upcast.
//
// Scratch (`r3d_scatter_general_scratch` bytes, no initial values): the
// shared parts (records, perm, arrival counters, partial rows), then the
// narrow build's offsets and unit counts, or the wide build's keys and
// rows of the passes (kx, rx, ky: (B, M) int32 each; perm holds the last
// pass's rows), the units' digit counts (B, units, 2^bits), the digit
// totals (B, 2^bits) and each cloud's count of rows kept (B).
#include "scatter.cuh"

namespace {

constexpr int kMaxBits = 11;              // a pass's digits, at most 2^11: 16 warps' rows in 128 KB
constexpr int kWideRows = kWarps * 512;   // elements of a wide unit, at most: 512 a warp

// ---- the wide build: stable LSD radix passes over the target's bits ----

// Pass p's output: the last pass writes (ky, perm), the one before it (kx,
// rx), the one before that (ky, perm) again.
__device__ __forceinline__ int* out_keys(const Args& a, int p) {
  return (a.passes - 1 - p) % 2 == 0 ? a.ky : a.kx;
}

__device__ __forceinline__ int* out_rows(const Args& a, int p) {
  return (a.passes - 1 - p) % 2 == 0 ? a.perm : a.rx;
}

// Elements of pass p in cloud cb: its rows, then those pass 0 kept.
__device__ __forceinline__ int pass_size(const Args& a, int p, int cb) {
  return p == 0 ? a.m : __ldcg(a.nvalid + cb);
}

// Element e of pass p in cloud cb: its key (-1 for an id outside [0, n),
// which pass 0 drops) and its row.
__device__ __forceinline__ int key_at(const Args& a, int p, int cb, int e) {
  const size_t at = static_cast<size_t>(cb) * a.m + e;
  if (p == 0) {
    const int j = a.idx[at];
    return valid(j, a.n) ? j : -1;
  }
  return __ldcg(out_keys(a, p - 1) + at);  // written in this launch: through L2
}

__device__ __forceinline__ int row_at(const Args& a, int p, int cb, int e) {
  return p == 0 ? e : __ldcg(out_rows(a, p - 1) + static_cast<size_t>(cb) * a.m + e);
}

// Elements [lo, hi) of unit gi of `size`.
__device__ __forceinline__ void cut(int size, int units, int gi, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(gi) * size / units);
  hi = static_cast<int>(static_cast<long long>(gi + 1) * size / units);
}

// Unit (cb, gi) of pass p: its elements' counts per digit into cnt[cb][gi].
__device__ void count_digits(const Args& a, int p, int cb, int gi, int* h) {
  const int digits = 1 << a.bits, shift = p * a.bits;
  int lo, hi;
  cut(pass_size(a, p, cb), a.units, gi, lo, hi);
  for (int d = threadIdx.x; d < digits; d += kThreads) h[d] = 0;
  __syncthreads();
#pragma unroll 4
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    const int k = key_at(a, p, cb, e);
    if (k >= 0) atomicAdd(h + ((k >> shift) & (digits - 1)), 1);
  }
  __syncthreads();
  int* out = a.cnt + (static_cast<size_t>(cb) * a.units + gi) * digits;
  for (int d = threadIdx.x; d < digits; d += kThreads) out[d] = h[d];
  __syncthreads();  // h is rewritten by the block's next unit
}

// Digit d of cloud cb, one warp: each unit's start among the digit's
// elements, in place of its count (lane l takes a contiguous run of units,
// the runs' sums scanned across the lanes), and the digit's total.
__device__ void unit_starts(const Args& a, int cb, int d) {
  const int digits = 1 << a.bits, lane = threadIdx.x & 31;
  int* c = a.cnt + static_cast<size_t>(cb) * a.units * digits + d;
  const int g0 = lane * a.units / 32, g1 = (lane + 1) * a.units / 32;
  int s = 0;
#pragma unroll 8
  for (int gi = g0; gi < g1; ++gi) s += __ldcg(c + static_cast<size_t>(gi) * digits);
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  int run = incl - s;
  for (int g = g0; g < g1; g += 8) {  // 8 counts loaded at once, then their starts written
    int k[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      k[u] = g + u < g1 ? __ldcg(c + static_cast<size_t>(g + u) * digits) : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (g + u < g1) c[static_cast<size_t>(g + u) * digits] = run;
      run += k[u];
    }
  }
  if (lane == 31) a.dtot[static_cast<size_t>(cb) * digits + d] = incl;
}

// base[d] = the elements of cloud cb with a digit below d (the exclusive
// scan of the digit totals, each thread a contiguous chunk); returns the
// cloud's elements.  wsum: kWarps ints of scratch.
__device__ int digit_bases(const Args& a, int cb, int* base, int* wsum) {
  const int digits = 1 << a.bits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* tot = a.dtot + static_cast<size_t>(cb) * digits;
  const int chunk = (digits + kThreads - 1) / kThreads;
  const int d0 = min(static_cast<int>(threadIdx.x) * chunk, digits);
  const int d1 = min(d0 + chunk, digits);
  int s = 0;
  for (int d = d0; d < d1; ++d) s += __ldcg(tot + d);
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane < kWarps) wsum[lane] = x;  // inclusive over the warps
  }
  __syncthreads();
  int run = (warp > 0 ? wsum[warp - 1] : 0) + incl - s;
  for (int d = d0; d < d1; ++d) {
    base[d] = run;
    run += __ldcg(tot + d);
  }
  const int total = wsum[kWarps - 1];
  __syncthreads();  // base complete; wsum is rewritten by the next call
  return total;
}

// Unit (cb, gi) of pass p: each element at its place among the cloud's
// elements ordered by digit, in order within a digit.  smem: the digits'
// bases (2^bits), the (kWarps, 2^bits) histogram, kWarps ints of scratch.
__device__ void place_digits(const Args& a, int p, int cb, int gi, int* smem) {
  const int digits = 1 << a.bits, shift = p * a.bits, mask = digits - 1;
  int* base = smem;
  int* hist = base + digits;
  int* wsum = hist + kWarps * digits;
  const int total = digit_bases(a, cb, base, wsum);
  if (p == 0 && gi == 0 && threadIdx.x == 0) a.nvalid[cb] = total;
  int lo, hi;
  cut(pass_size(a, p, cb), a.units, gi, lo, hi);
  const int hw = min(kWarps, max(1, (hi - lo) / kWarpRows));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wlo = lo + static_cast<int>(static_cast<long long>(warp) * (hi - lo) / hw);
  const int whi = lo + static_cast<int>(static_cast<long long>(warp + 1) * (hi - lo) / hw);
  for (int e = threadIdx.x; e < hw * digits; e += kThreads) hist[e] = 0;
  __syncthreads();
  if (warp < hw) {
    int* h = hist + warp * digits;
#pragma unroll 4
    for (int e = wlo + lane; e < whi; e += 32) {
      const int k = key_at(a, p, cb, e);
      if (k >= 0) atomicAdd(h + ((k >> shift) & mask), 1);
    }
  }
  __syncthreads();
  // per digit: each warp's place = the digit's base + the unit's start +
  // the counts of the unit's earlier warps
  const int* start = a.cnt + (static_cast<size_t>(cb) * a.units + gi) * digits;
  for (int d = threadIdx.x; d < digits; d += kThreads) {
    int s = base[d] + __ldcg(start + d);
    for (int w = 0; w < hw; ++w) {
      const int k = hist[w * digits + d];
      hist[w * digits + d] = s;
      s += k;
    }
  }
  __syncthreads();
  // the placing, in order: 32 elements at a time, the keys and rows of
  // kUnroll batches loaded at once
  if (warp < hw) {
    int* h = hist + warp * digits;
    int* ko = out_keys(a, p) + static_cast<size_t>(cb) * a.m;
    int* ro = out_rows(a, p) + static_cast<size_t>(cb) * a.m;
    const unsigned below = (1u << lane) - 1u;
    for (int e0 = wlo; e0 < whi; e0 += 32 * kUnroll) {
      int ks[kUnroll], rs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + 32 * u + lane;
        ks[u] = e < whi ? key_at(a, p, cb, e) : -1;
        rs[u] = e < whi ? row_at(a, p, cb, e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e0 + 32 * u >= whi) break;  // the same for the whole warp
        const int k = ks[u];
        const int d = k >= 0 ? (k >> shift) & mask : -1;
        const unsigned peers = __match_any_sync(kFull, d);
        const int at = d >= 0 ? h[d] : 0;
        __syncwarp();
        if (d >= 0) {
          const int pos = at + __popc(peers & below);
          ko[pos] = k;
          ro[pos] = rs[u];
          if (lane == __ffs(peers) - 1) h[d] = at + __popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();  // the histogram is rewritten by the block's next unit
}

// Target j of cloud cb, the keys sorted: the offset and count of its rows
// (the first key >= j and the first > j, two binary searches in step), and
// its pieces' records at slots offset / kPiece + j + q.  Those are unique
// and in target order: a target's pieces start kPiece rows apart, and the
// next target's offset is at least this one's last piece's start.
__device__ void target_records(const Args& a, int cb, int j) {
  const int* k = a.ky + static_cast<size_t>(cb) * a.m;
  const int size = __ldcg(a.nvalid + cb);
  int lo0 = 0, hi0 = size, lo1 = 0, hi1 = size;
  while (lo0 < hi0 || lo1 < hi1) {
    if (lo0 < hi0) {
      const int mid = (lo0 + hi0) >> 1;
      if (__ldcg(k + mid) < j) lo0 = mid + 1; else hi0 = mid;
    }
    if (lo1 < hi1) {
      const int mid = (lo1 + hi1) >> 1;
      if (__ldcg(k + mid) <= j) lo1 = mid + 1; else hi1 = mid;
    }
  }
  const int rows = lo1 - lo0, np = pieces_of(rows), first = lo0 / kPiece + j;
  const int4 rc = make_int4(j, lo0, rows, first);
  int4* rec = a.rec + static_cast<size_t>(cb) * a.cap;
  for (int q = 0; q < np; ++q) rec[first + q] = rc;
}

__device__ void wide_build(const Args& a, int* smem) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  // the sum's arrival counters, and every record slot empty
  for (long long e = tid; e < static_cast<long long>(a.b) * a.cap; e += threads) {
    a.rec[e] = make_int4(-1, 0, 0, 0);
  }
  for (long long e = tid; e < static_cast<long long>(a.b) * a.n; e += threads) a.arrive[e] = 0;
  const int units = a.b * a.units, digits = 1 << a.bits;
  for (int p = 0; p < a.passes; ++p) {
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      count_digits(a, p, u / a.units, u % a.units, smem);
    }
    grid.sync();
    mark(a, 1 + 3 * p);
    for (long long w = tid >> 5; w < static_cast<long long>(a.b) * digits; w += threads >> 5) {
      unit_starts(a, static_cast<int>(w / digits), static_cast<int>(w % digits));
    }
    grid.sync();
    mark(a, 2 + 3 * p);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      place_digits(a, p, u / a.units, u % a.units, smem);
    }
    grid.sync();
    mark(a, 3 + 3 * p);
  }
  for (long long e = tid; e < static_cast<long long>(a.b) * a.n; e += threads) {
    target_records(a, static_cast<int>(e / a.n), static_cast<int>(e % a.n));
  }
  grid.sync();
  mark(a, 1 + 3 * a.passes);
}

template <typename R>
__global__ void __launch_bounds__(kThreads, 1) scatter_general_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  if (a.passes == 0) {
    narrow_build(a, smem);
  } else {
    mark(a, 0);
    wide_build(a, smem);
  }
  sum_pieces<R>(a);
  if (a.stamps != nullptr) {  // the same for the whole grid
    cg::this_grid().sync();
    mark(a, kMarks - 1);
  }
}

// The wide build's passes, digit bits and units, and its scratch parts as
// byte offsets after the shared parts; end is the buffer's size.
struct Wide {
  int passes, bits, units;
  size_t kx, rx, ky, cnt, dtot, nvalid, end;
};

Wide wide_plan(int b, int n, int m, int c, int grid) {
  Wide w{};
  int kb = 1;  // keys in [0, n): kb bits
  while (kb < 31 && (1LL << kb) < n) ++kb;
  w.passes = (kb + kMaxBits - 1) / kMaxBits;
  w.bits = (kb + w.passes - 1) / w.passes;
  const long long per = std::max(1, grid / b);  // units of a cloud: a multiple of SMs / B
  w.units = static_cast<int>(per * std::max(1LL, (m + kWideRows * per - 1) / (kWideRows * per)));
  const size_t bm = 4 * static_cast<size_t>(b) * m;
  const size_t digits = size_t{1} << w.bits;
  w.kx = shared_layout(b, n, m, c).end;
  w.rx = align16(w.kx + bm);
  w.ky = align16(w.rx + bm);
  w.cnt = align16(w.ky + bm);
  w.dtot = align16(w.cnt + 4 * static_cast<size_t>(b) * w.units * digits);
  w.nvalid = align16(w.dtot + 4 * b * digits);
  w.end = align16(w.nvalid + 4 * static_cast<size_t>(b));
  return w;
}

template <typename R>
int scatter_general(const void* g, const void* idx, void* dx, void* scratch, int b, int n, int m,
                    int c, void* stamps, void* stream) {
  if (b < 1 || n < 1 || m < 0 || c < 1) return cudaErrorInvalidValue;
  r3d::CoopLaunch p{};
  Args a;
  const cudaError_t err = plan(g, idx, dx, scratch, b, n, m, c, p, a);
  if (err != cudaSuccess) return err;
  a.stamps = static_cast<unsigned long long*>(stamps);
  size_t smem = narrow_smem(n, a.hw);
  if (a.hw < 1) {
    const Wide w = wide_plan(b, n, m, c, p.grid);
    char* base = static_cast<char*>(scratch);
    a.offs = nullptr;
    a.kx = reinterpret_cast<int*>(base + w.kx);
    a.rx = reinterpret_cast<int*>(base + w.rx);
    a.ky = reinterpret_cast<int*>(base + w.ky);
    a.cnt = reinterpret_cast<int*>(base + w.cnt);
    a.dtot = reinterpret_cast<int*>(base + w.dtot);
    a.nvalid = reinterpret_cast<int*>(base + w.nvalid);
    a.passes = w.passes;
    a.bits = w.bits;
    a.units = w.units;
    smem = sizeof(int) * ((kWarps + 1) * (size_t{1} << w.bits) + kWarps);
  }
  void* args[] = {&a};
  return r3d::coop_launch(scatter_general_kernel<R>, p, kThreads, smem, args,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// Bytes of scratch one call takes on the current device; -1 if the device
// takes no cooperative launch.
R3D_EXPORT long long r3d_scatter_general_scratch(int b, int n, int m, int c) {
  if (narrow_warps(n) >= 1) return static_cast<long long>(narrow_scratch(b, n, m, c));
  r3d::CoopLaunch p{};
  if (r3d::coop_plan(1 << 30, p) != cudaSuccess) return -1;
  return static_cast<long long>(wide_plan(b, n, m, c, p.grid).end);
}

// dx (B, N, C) f32 from g (B, M, C) f32 (r3d_scatter_general) or bf16
// (r3d_scatter_general_bf16) contiguous and idx (B, M) int32, any C and N,
// with r3d_scatter_general_scratch bytes of scratch.
R3D_EXPORT int r3d_scatter_general(const void* g, const void* idx, void* dx, void* scratch, int b,
                                   int n, int m, int c, void* stream) {
  return scatter_general<LaneF32>(g, idx, dx, scratch, b, n, m, c, nullptr, stream);
}

R3D_EXPORT int r3d_scatter_general_bf16(const void* g, const void* idx, void* dx, void* scratch,
                                        int b, int n, int m, int c, void* stream) {
  return scatter_general<LaneBF16>(g, idx, dx, scratch, b, n, m, c, nullptr, stream);
}

// The same call with its phases timed: stamps, kMarks u64 on the device,
// gets block 0's clock (ns) at the launch's start (0), at the end of each
// build phase (1, ...; the narrow build's count, reduce, scan and fill, or
// the wide build's count, starts and place of each pass and its records)
// and after a grid barrier at the sum's end (kMarks - 1).
R3D_EXPORT int r3d_scatter_general_phases(const void* g, const void* idx, void* dx, void* scratch,
                                          int b, int n, int m, int c, int bf16, void* stamps,
                                          void* stream) {
  return bf16 ? scatter_general<LaneBF16>(g, idx, dx, scratch, b, n, m, c, stamps, stream)
              : scatter_general<LaneF32>(g, idx, dx, scratch, b, n, m, c, stamps, stream);
}

// The kernel's registers and local (spill) bytes a thread, f32 or bf16 g.
R3D_EXPORT int r3d_scatter_general_attributes(int bf16, int* regs, int* local_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = bf16 ? cudaFuncGetAttributes(&f, scatter_general_kernel<LaneBF16>)
                               : cudaFuncGetAttributes(&f, scatter_general_kernel<LaneF32>);
  if (err != cudaSuccess) return err;
  *regs = f.numRegs;
  *local_bytes = static_cast<int>(f.localSizeBytes);
  return cudaSuccess;
}
