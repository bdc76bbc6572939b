// Kernel 6's shared parts: the build of the inverse graph (a CSR by target,
// each target's rows in source order) when one block's shared memory holds
// a histogram row of the N targets, and the sum phase on that CSR.  The
// tuned kernel (csrc/scatter_add.cu: even C, pairs of channels) and the
// general one (csrc/scatter_general.cu: any C and N) are templates of the
// sum phase on the way a warp reads a row's channels (`PairF32`, ...,
// below); so both take the same sums in the same order.
//
// Scratch parts the build and the sum share (`Args`): the piece records
// (B, cap) int4 {target, offset, rows of the target, its first piece} with
// cap = N + ceil(M / kPiece), perm (B, M) int32, the arrival counters (B,
// N) and the partial rows (B, cap, C) f32.
#pragma once

#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 32;      // rows of a piece: one index per lane
constexpr int kUnroll = 8;      // batches of the fill's ids loaded at once
constexpr int kWarpRows = 128;  // the fill's rows per histogram warp, about
constexpr int kUnits = 16;      // units per cloud of the narrow build, at most
constexpr unsigned kFull = 0xffffffffu;
using r3d::kSmemLimit;

struct Args {
  const void* g;
  const int* idx;
  float* dx;
  int* perm;
  int4* rec;
  int* arrive;
  int* offs;
  int* cnt;
  float* part;
  int b;
  int n;
  int m;
  int c;
  int cap;
  int hw;     // most histogram warps of the narrow fill
  int units;  // G, units of a cloud's rows in the build
  // the wide build (csrc/scatter_general.cu); passes == 0: the narrow one
  int* kx;      // (B, M) keys and rows of the odd passes from the last
  int* rx;
  int* ky;      // (B, M) keys of the even passes from the last (rows: perm)
  int* dtot;    // (B, 2^bits) a pass's rows per digit
  int* nvalid;  // (B) rows whose id lies in [0, N)
  int passes;
  int bits;
  // block 0's clock (ns) at each phase's end, where the caller asks
  // (r3d_scatter_general_phases); nullptr: no marks
  unsigned long long* stamps;
};

constexpr int kMarks = 16;  // stamps: the launch's start, the build's phases, the sum's end last

// Mark i of the launch: block 0's clock, once every block has passed the
// grid barrier before it (the start: block 0's first instruction).
__device__ __forceinline__ void mark(const Args& a, int i) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[i] = t;
  }
}

__host__ __device__ __forceinline__ int pieces_of(int rows) {
  return rows > kPiece ? (rows + kPiece - 1) / kPiece : 1;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t{15}; }

// Histogram warps of the narrow fill for n targets: as many (n,) rows as
// fit in shared memory beside the scan's (n + 96) ints, at most 16; 0 when
// not even one fits.
inline int narrow_warps(int n) {
  const long long room = static_cast<long long>(kSmemLimit) - 4LL * (n + 96);
  return static_cast<int>(std::max(0LL, std::min<long long>(kWarps, room / (4LL * n))));
}

// Rows [lo, hi) of unit gi of a cloud.
__device__ __forceinline__ void unit_rows(const Args& a, int gi, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(gi) * a.m / a.units);
  hi = static_cast<int>(static_cast<long long>(gi + 1) * a.m / a.units);
}

__device__ __forceinline__ bool valid(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n);
}

// ---- the narrow build: one pass with a histogram row of all N targets ----
// - Count: each cloud's rows are cut into G contiguous units, one per block
//   (G = min(kUnits, SMs / B): 13 at B = 10, so every SM takes part, 16 at
//   B = 2; more units make the reduce phase's loads cost more than the
//   smaller fill units save); a block counts its unit's rows per target
//   (shared-memory integer atomics) and writes the counts.
// - Reduce (every thread of the grid, one target of one cloud each): each
//   unit's start within the target's list (the counts of the units before
//   it) and the target's total.
// - Scan (one block per cloud): the totals scanned into offsets.  The
//   target's list is cut into pieces of at most kPiece rows (one piece for
//   a target with none), and one record per piece is written; the slots
//   past the cloud's last piece get an empty record.
// - Fill (per unit): `hw` warps each own a contiguous range of the unit's
//   rows (about kWarpRows each) and count it into their own row of an (hw,
//   N) histogram in shared memory, turned into each warp's start within
//   each target; then each warp walks its rows in order, 32 at a time,
//   ranks lanes with the same target by __match_any_sync and writes each
//   row's index at its place.  So a target's list holds its rows in source
//   order.  Ids outside [0, N) are dropped, as segment_sum does.
// The fill's histograms take 4 * hw * N bytes of shared memory, hw up to
// 16, and at least 1.  Scratch of its own: offsets (B, N) and the units'
// counts, then starts, (B, kUnits, N) int32.

// Unit (cloud cb, gi): its rows' counts per target into cnt[cb][gi].
__device__ void count_unit(const Args& a, int cb, int gi, int* h) {
  int lo, hi;
  unit_rows(a, gi, lo, hi);
  const int* ib = a.idx + static_cast<size_t>(cb) * a.m;
  for (int j = threadIdx.x; j < a.n; j += kThreads) h[j] = 0;
  __syncthreads();
#pragma unroll 4
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
    const int j = ib[r];
    if (valid(j, a.n)) atomicAdd(h + j, 1);
  }
  __syncthreads();
  int* out = a.cnt + (static_cast<size_t>(cb) * a.units + gi) * a.n;
  for (int j = threadIdx.x; j < a.n; j += kThreads) out[j] = h[j];
  __syncthreads();  // h is rewritten by the block's next unit
}

// Target j of cloud cb: each unit's start within the target's list, in
// place of its count, and the target's total into offs.
__device__ void reduce_target(const Args& a, int cb, int j) {
  int* cnt = a.cnt + static_cast<size_t>(cb) * a.units * a.n + j;
  int s = 0;
#pragma unroll 8
  for (int gi = 0; gi < a.units; ++gi) {
    const int k = __ldcg(cnt + gi * a.n);  // written in this launch: through L2
    cnt[gi * a.n] = s;
    s += k;
  }
  a.offs[static_cast<size_t>(cb) * a.n + j] = s;
}

// Cloud cb: the targets' totals (in offs) scanned into offsets, and the
// piece records.  smem: the totals (n), then 96 ints of scan scratch.
__device__ void scan_cloud(const Args& a, int cb, int* smem) {
  const int n = a.n;
  int* tot = smem;
  int* wsum = tot + n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    tot[j] = __ldcg(a.offs + static_cast<size_t>(cb) * n + j);
  }
  __syncthreads();

  // offsets and first pieces: exclusive scans over the targets, each thread
  // a contiguous chunk
  const int chunk = (n + kThreads - 1) / kThreads;
  const int j0 = min(static_cast<int>(threadIdx.x) * chunk, n);
  const int j1 = min(j0 + chunk, n);
  int rows = 0, pcs = 0;
  for (int j = j0; j < j1; ++j) {
    rows += tot[j];
    pcs += pieces_of(tot[j]);
  }
  int rows_in = rows, pcs_in = pcs;  // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, rows_in, off);
    const int y = __shfl_up_sync(kFull, pcs_in, off);
    if (lane >= off) {
      rows_in += x;
      pcs_in += y;
    }
  }
  if (lane == 31) {
    wsum[warp] = rows_in;
    wsum[32 + warp] = pcs_in;
  }
  __syncthreads();
  if (warp == 0) {
    int x = lane < kWarps ? wsum[lane] : 0;
    int y = lane < kWarps ? wsum[32 + lane] : 0;
    const int x0 = x, y0 = y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int xs = __shfl_up_sync(kFull, x, off);
      const int ys = __shfl_up_sync(kFull, y, off);
      if (lane >= off) {
        x += xs;
        y += ys;
      }
    }
    wsum[lane] = x - x0;  // exclusive
    wsum[32 + lane] = y - y0;
  }
  __syncthreads();
  int off_r = wsum[warp] + rows_in - rows;
  int off_p = wsum[32 + warp] + pcs_in - pcs;
  int4* rec = a.rec + static_cast<size_t>(cb) * a.cap;
  for (int j = j0; j < j1; ++j) {
    const int t = tot[j];
    const int np = pieces_of(t);
    const int4 rc = make_int4(j, off_r, t, off_p);
    for (int q = 0; q < np; ++q) rec[off_p + q] = rc;
    a.offs[static_cast<size_t>(cb) * n + j] = off_r;
    a.arrive[static_cast<size_t>(cb) * n + j] = 0;
    off_r += t;
    off_p += np;
  }
  if (threadIdx.x == kThreads - 1) wsum[64] = off_p;  // j1 == n here: the cloud's pieces
  __syncthreads();
  for (int p = wsum[64] + threadIdx.x; p < a.cap; p += kThreads) rec[p] = make_int4(-1, 0, 0, 0);
  __syncthreads();  // tot is rewritten by the block's next cloud
}

// Unit (cb, gi): each row's index at its place in its target's list.
// smem: the (hw, n) histogram.
__device__ void fill_unit(const Args& a, int cb, int gi, int* hist) {
  const int n = a.n;
  int lo, hi;
  unit_rows(a, gi, lo, hi);
  const int hw = min(a.hw, max(1, (hi - lo) / kWarpRows));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wlo = lo + static_cast<int>(static_cast<long long>(warp) * (hi - lo) / hw);
  const int whi = lo + static_cast<int>(static_cast<long long>(warp + 1) * (hi - lo) / hw);
  const int* ib = a.idx + static_cast<size_t>(cb) * a.m;
  for (int e = threadIdx.x; e < hw * n; e += kThreads) hist[e] = 0;
  __syncthreads();
  if (warp < hw) {
    int* h = hist + warp * n;
#pragma unroll 4
    for (int r = wlo + lane; r < whi; r += 32) {
      const int j = ib[r];
      if (valid(j, n)) atomicAdd(h + j, 1);
    }
  }
  __syncthreads();
  // per target: each warp's place = the offset + the unit's start + the
  // counts of the unit's earlier warps
  const int* offs = a.offs + static_cast<size_t>(cb) * n;
  const int* start = a.cnt + (static_cast<size_t>(cb) * a.units + gi) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    int s = __ldcg(offs + j) + __ldcg(start + j);
    for (int w = 0; w < hw; ++w) {
      const int k = hist[w * n + j];
      hist[w * n + j] = s;
      s += k;
    }
  }
  __syncthreads();
  // the fill, in source order: 32 rows at a time, the ids of kUnroll
  // batches loaded at once
  if (warp < hw) {
    int* h = hist + warp * n;
    int* perm = a.perm + static_cast<size_t>(cb) * a.m;
    const unsigned below = (1u << lane) - 1u;
    for (int r0 = wlo; r0 < whi; r0 += 32 * kUnroll) {
      int js[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + 32 * u + lane;
        const int j = r < whi ? ib[r] : -1;
        js[u] = valid(j, n) ? j : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + 32 * u >= whi) break;  // the same for the whole warp
        const int j = js[u];
        const unsigned peers = __match_any_sync(kFull, j);
        const int base = j >= 0 ? h[j] : 0;
        __syncwarp();
        if (j >= 0) {
          perm[base + __popc(peers & below)] = r0 + 32 * u + lane;
          if (lane == __ffs(peers) - 1) h[j] = base + __popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();  // the histogram is rewritten by the block's next unit
}

__device__ void narrow_build(const Args& a, int* smem) {
  cg::grid_group grid = cg::this_grid();
  mark(a, 0);
  const int units = a.b * a.units;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    count_unit(a, u / a.units, u % a.units, smem);
  }
  grid.sync();
  mark(a, 1);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < a.b * a.n; e += gridDim.x * kThreads) {
    reduce_target(a, e / a.n, e % a.n);
  }
  grid.sync();
  mark(a, 2);
  for (int cb = blockIdx.x; cb < a.b; cb += gridDim.x) scan_cloud(a, cb, smem);
  grid.sync();
  mark(a, 3);
  for (int u = blockIdx.x; u < units; u += gridDim.x) fill_unit(a, u / a.units, u % a.units, smem);
  grid.sync();
  mark(a, 4);
}

// Shared memory of the narrow build, in bytes.
inline size_t narrow_smem(int n, int hw) {
  return sizeof(int) * (static_cast<size_t>(hw) * n + n + 96);
}

// ---- the sum phase --------------------------------------------------------
// How a warp reads a chunk of 64 channels of a row: each lane carries two
// channels (`Raw`, widened to a float2).  The pair readers take channels
// 2 lane and 2 lane + 1 with one 8-byte (f32) or 4-byte (bf16) load, so C
// must be even and the rows so aligned; the lane readers take channels
// lane and lane + 32 with two 4-byte or 2-byte loads, so any C and rows at
// any 4-byte (f32) or 2-byte (bf16) offset.  Either way a warp's load of a
// row chunk is contiguous, and a bf16 channel is the high half of its f32.
// The partial rows of hubs are f32 and read and written the same way.
struct PairOut {
  static __device__ __forceinline__ int ch(int c0) { return c0 + 2 * (threadIdx.x & 31); }
  static __device__ __forceinline__ float2 partial(const float* p, int c0, int c) {
    const int k = ch(c0);
    return k < c ? __ldcg(reinterpret_cast<const float2*>(p + k)) : make_float2(0.f, 0.f);
  }
  static __device__ __forceinline__ void store(float* out, int c0, int c, float2 v) {
    const int k = ch(c0);
    if (k < c) *reinterpret_cast<float2*>(out + k) = v;
  }
};

struct PairF32 : PairOut {
  using T = float;
  using Raw = float2;
  static __device__ __forceinline__ Raw zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const T* row, int c0, int c) {
    const int k = ch(c0);
    return k < c ? __ldg(reinterpret_cast<const float2*>(row + k)) : zero();
  }
  static __device__ __forceinline__ float2 widen(Raw r) { return r; }
};

struct PairBF16 : PairOut {
  using T = uint16_t;
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ Raw load(const T* row, int c0, int c) {
    const int k = ch(c0);
    return k < c ? __ldg(reinterpret_cast<const uint32_t*>(row + k)) : zero();
  }
  static __device__ __forceinline__ float2 widen(Raw r) {
    return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
  }
};

struct LaneOut {
  static __device__ __forceinline__ int ch(int c0) { return c0 + (threadIdx.x & 31); }
  static __device__ __forceinline__ float2 partial(const float* p, int c0, int c) {
    const int k = ch(c0);
    return make_float2(k < c ? __ldcg(p + k) : 0.f, k + 32 < c ? __ldcg(p + k + 32) : 0.f);
  }
  static __device__ __forceinline__ void store(float* out, int c0, int c, float2 v) {
    const int k = ch(c0);
    if (k < c) out[k] = v.x;
    if (k + 32 < c) out[k + 32] = v.y;
  }
};

struct LaneF32 : LaneOut {
  using T = float;
  using Raw = float2;
  static __device__ __forceinline__ Raw zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const T* row, int c0, int c) {
    const int k = ch(c0);
    return make_float2(k < c ? __ldg(row + k) : 0.f, k + 32 < c ? __ldg(row + k + 32) : 0.f);
  }
  static __device__ __forceinline__ float2 widen(Raw r) { return r; }
};

struct LaneBF16 : LaneOut {
  using T = uint16_t;
  using Raw = uint2;  // channels k and k + 32, each in the low half of its own register
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ Raw load(const T* row, int c0, int c) {
    const int k = ch(c0);
    return make_uint2(k < c ? __ldg(row + k) : 0u, k + 32 < c ? __ldg(row + k + 32) : 0u);
  }
  static __device__ __forceinline__ float2 widen(Raw r) {
    return make_float2(__uint_as_float(r.x << 16), __uint_as_float(r.y << 16));
  }
};

// Piece t's record (an empty one past the last slot).
__device__ __forceinline__ int4 record(const Args& a, long long t) {
  return t < static_cast<long long>(a.b) * a.cap ? __ldcg(a.rec + t) : make_int4(-1, 0, 0, 0);
}

// The lane's row of piece t (record rc): the index of its lane-th row, 0
// past its rows.
__device__ __forceinline__ int row_of(const Args& a, long long t, int4 rc) {
  const int lane = threadIdx.x & 31;
  if (rc.x < 0) return 0;
  const int cb = static_cast<int>(t / a.cap);
  const int q = static_cast<int>(t - static_cast<long long>(cb) * a.cap) - rc.w;
  const int len = min(kPiece, rc.z - q * kPiece);
  return lane < len ? __ldcg(a.perm + static_cast<size_t>(cb) * a.m + rc.y + q * kPiece + lane)
                    : 0;
}

// Every warp of the grid: a warp takes a piece, loads its row indices (one
// per lane), issues the loads of all its rows at once (kPiece rows of a
// chunk of 64 channels, two per lane: 64 registers, hence 16 warps of up to
// 128 registers), loads the next piece's record and row indices meanwhile,
// and adds the rows in order, f32.  A target of one piece writes dx
// directly.  A hub (a target of more rows than kPiece: points that are the
// neighbour of hundreds of rows) has several pieces on several warps: each
// writes its partial row, and the last to arrive (an arrival counter) adds
// the partials in piece order and writes dx.  So every warp has about the
// same number of rows to read, whatever the in-degrees.
template <typename R>
__device__ void sum_pieces(const Args& a) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long total = static_cast<long long>(a.b) * a.cap;
  long long t = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  int4 rc = record(a, t);
  int mrow = row_of(a, t, rc);
  while (t < total) {  // the same for the whole warp, as every branch below
    const long long tn = t + warps;
    const int4 rcn = record(a, tn);
    int mrown = 0;
    if (rc.x < 0) {
      mrown = row_of(a, tn, rcn);
    } else {
      const int j = rc.x;
      const int cb = static_cast<int>(t / a.cap);
      const int q = static_cast<int>(t - static_cast<long long>(cb) * a.cap) - rc.w;
      const int np = pieces_of(rc.z);
      const int len = min(kPiece, rc.z - q * kPiece);
      const typename R::T* gb =
          static_cast<const typename R::T*>(a.g) + static_cast<size_t>(cb) * a.m * a.c;
      float* out = np == 1 ? a.dx + (static_cast<size_t>(cb) * a.n + j) * a.c
                           : a.part + static_cast<size_t>(t) * a.c;
      for (int c0 = 0; c0 < a.c; c0 += 64) {
        typename R::Raw v[kPiece];
#pragma unroll
        for (int u = 0; u < kPiece; ++u) {
          const int row = __shfl_sync(kFull, mrow, u);
          v[u] = u < len ? R::load(gb + static_cast<size_t>(row) * a.c, c0, a.c) : R::zero();
        }
        if (c0 == 0) mrown = row_of(a, tn, rcn);  // in flight with this piece's rows
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kPiece; ++u) {
          if (u < len) {
            const float2 w = R::widen(v[u]);
            acc.x = __fadd_rn(acc.x, w.x);
            acc.y = __fadd_rn(acc.y, w.y);
          }
        }
        R::store(out, c0, a.c, acc);
      }
      if (np > 1) {
        // a hub's piece: the last of its pieces to arrive adds them in order
        __threadfence();  // every lane's partial, before lane 0 arrives
        __syncwarp();
        int seen = 0;
        if (lane == 0) seen = atomicAdd(a.arrive + static_cast<size_t>(cb) * a.n + j, 1);
        if (__shfl_sync(kFull, seen, 0) == np - 1) {
          __threadfence();
          const float* first = a.part + (static_cast<size_t>(cb) * a.cap + rc.w) * a.c;
          float* dst = a.dx + (static_cast<size_t>(cb) * a.n + j) * a.c;
          for (int c0 = 0; c0 < a.c; c0 += 64) {
            float2 acc = make_float2(0.f, 0.f);
            for (int k = 0; k < np; ++k) {
              const float2 v = R::partial(first + static_cast<size_t>(k) * a.c, c0, a.c);
              acc.x = __fadd_rn(acc.x, v.x);
              acc.y = __fadd_rn(acc.y, v.y);
            }
            R::store(dst, c0, a.c, acc);
          }
        }
      }
    }
    t = tn;
    rc = rcn;
    mrow = mrown;
  }
}

// The scratch parts both kernels have, as byte offsets from the buffer's
// start, each 16-byte aligned; `end` is where the build's own parts start.
struct Shared {
  size_t rec, perm, arrive, part, end;
};

inline Shared shared_layout(int b, int n, int m, int c) {
  const size_t cap = static_cast<size_t>(n) + (m + kPiece - 1) / kPiece;
  Shared l{};
  l.rec = 0;
  l.perm = align16(l.rec + 16 * b * cap);
  l.arrive = align16(l.perm + 4 * static_cast<size_t>(b) * m);
  l.part = align16(l.arrive + 4 * static_cast<size_t>(b) * n);
  l.end = align16(l.part + 4 * b * cap * c);
  return l;
}

// Args over `scratch` for the narrow build (the wide one sets its own
// parts after), and the grid; cudaSuccess or the error.
inline cudaError_t plan(const void* g, const void* idx, void* dx, void* scratch, int b, int n,
                        int m, int c, r3d::CoopLaunch& p, Args& a) {
  cudaError_t err = r3d::coop_plan(1 << 30, p);  // one block per SM
  if (err != cudaSuccess) return err;
  const Shared l = shared_layout(b, n, m, c);
  char* base = static_cast<char*>(scratch);
  a = Args{};
  a.g = g;
  a.idx = static_cast<const int*>(idx);
  a.dx = static_cast<float*>(dx);
  a.perm = reinterpret_cast<int*>(base + l.perm);
  a.rec = reinterpret_cast<int4*>(base + l.rec);
  a.arrive = reinterpret_cast<int*>(base + l.arrive);
  a.part = reinterpret_cast<float*>(base + l.part);
  a.offs = reinterpret_cast<int*>(base + l.end);
  a.cnt = reinterpret_cast<int*>(base + align16(l.end + 4 * static_cast<size_t>(b) * n));
  a.b = b;
  a.n = n;
  a.m = m;
  a.c = c;
  a.cap = n + (m + kPiece - 1) / kPiece;
  a.hw = narrow_warps(n);
  a.units = std::max(1, std::min(kUnits, p.grid / b));
  return cudaSuccess;
}

// Bytes of scratch of the narrow build: the shared parts, offsets (B, N),
// the units' counts (B, kUnits, N).
inline size_t narrow_scratch(int b, int n, int m, int c) {
  const size_t end = align16(shared_layout(b, n, m, c).end + 4 * static_cast<size_t>(b) * n);
  return end + 4 * static_cast<size_t>(b) * kUnits * n;
}

}  // namespace
