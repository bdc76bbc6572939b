// Kernel 11: the archived S.d matvec probe, acc = b, then `iters` times acc
// <- (S bf16(acc)) * 0.99, with S an (m, m) bf16 matrix and acc (m, ncols)
// f32, 1 <= ncols <= 128.
//
// Replaces the TPU kernel scripts/archive/proto_cheby2.py:make_matmul_only's
// `kernel`, which keeps S and acc in VMEM and loops over the steps inside
// one kernel, each step one bf16 x bf16 -> f32 dot.
//
// What bounds it on the H100: a step is a (m x m) by (m x ncols) bf16
// product.  At the probe's m = 4480, S is 40.14 MB and bf16(acc) at 128
// columns 1.15 MB (the f32 acc 2.29 MB): reading S once takes 12.0 us at
// 3.35 TB/s, the products 5.2 us on the bf16 tensor cores (989 TFLOP/s),
// so S's bytes bound every step, at every column count.  A step cannot
// start before the last one's acc is complete everywhere: one grid-wide
// barrier at least per step.
//
// Design: one cooperative launch per call (r3d::coop_launch: one block of
// 16 warps per SM, all co-resident), every step inside it.  A step reads
// each entry of S exactly once, at any column count:
// - Work split: S is cut into units of 128 rows (a row group) by 128 k
//   (a chunk); the units, row group by row group and chunk by chunk within
//   one, are dealt to the blocks as equal contiguous ranges, fixed across
//   the steps.  A block's range crosses one row-group boundary or two, so
//   it holds a segment (row group, chunks) of each: a split of K across
//   the blocks that share a row group, with every block's share within one
//   chunk of the others'.
// - Products: a block streams its units through a ring of 3 to 5 stages
//   of shared memory (cp.async, 16 bytes a copy, zero past m): the unit's
//   128 rows of S and the same 128 k of bf16(acc) for the block's 32 NT
//   columns (NT = 1, 2 or 4 by ncols), each as two K blocks of 128-byte
//   rows XOR-swizzled by 16-byte piece, the layout that wgmma reads with
//   its 128-byte swizzle.  The four warpgroups, two over the rows by two
//   over the columns, run wgmma.m64nNk16 bf16 products on them (N = 16
//   NT); each stage's 128 k are summed from zero on the tensor cores and
//   added to the segment's sums in f32 on the CUDA cores (a chain of wgmma
//   sums thousands of k long drifts from f32 sums: 1e-4 of max at m =
//   13968 in 3 steps, 5e-2 in 500).  A warpgroup whose columns all lie
//   past ncols takes no products.  S's rows of a step's first stages are
//   loaded before the barriers that end the step before it.  At a
//   segment's end the block writes its sums to its own slot of a partials
//   buffer (slot = block + row group: distinct for every segment) and
//   starts the next from zero.
// - Then a grid barrier, and every thread of the grid sums the partials of
//   four rows of one column over the blocks of their row group in block
//   order, that is in k order (no atomics: a call repeats bit for bit),
//   scales by 0.99 and writes bf16(acc) for the next step (f32 acc after
//   the last), and a second grid barrier.
//
// Bytes per step through L2 at m = 4480 and 128 columns (35 row groups of
// 35 chunks, 1225 units on 132 blocks, 9 or 10 each, 163 segments): S
// 40.14 MB, read once; bf16(acc) 40.14 MB (each unit reads its 128 k of
// all 128 columns: 32 KB, as much as its 128 rows of S); the partials, 64
// KB a segment: 10.68 MB written and read once; bf16(acc) written, 1.15
// MB.  About 103 MB in all, where the 16-column groups of the earlier
// kernel read S 8 times (321 MB).  A wider row group would read less of
// bf16(acc) and write more partials (256 rows: 20 MB and 39 MB).
//
// Where m, the row stride or S's base is not a multiple of 8 entries,
// lanes load S with 2-byte loads into the stage instead of cp.async.
//
// Layout: s (m, lds) bf16 row-major; b and out (m, ncols) f32 row-major;
// dbuf two (ncols, ldb) bf16 buffers, column-major, ldb a multiple of 8 >=
// m (nothing past m is read, so they need no zero fill); part slots of
// (32 NT, 128) f32, column-major; slots >= grid + row groups.
#include "common.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace cg = cooperative_groups;

using r3d::desc;
using r3d::fence_operands;
using r3d::wgmma_commit_and_wait;
using r3d::wgmma_fence;
using r3d::wgmma_n16;
using r3d::wgmma_n16_first;
using r3d::wgmma_n32;
using r3d::wgmma_n32_first;
using r3d::wgmma_n64;
using r3d::wgmma_n64_first;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 128;              // rows of S in a row group
constexpr int kChunk = 128;             // k entries of a unit
constexpr int kBlockK = 64;             // k entries of a 128-byte swizzled row
constexpr int kPieces = kChunk / 8;     // 16-byte pieces of a unit's row
constexpr int kMaxCols = 128;
constexpr float kScale = 0.99f;

// Columns a block computes with NT: 32 NT, two warpgroups' 16 NT each.
__host__ __device__ constexpr int block_cols(int nt) { return 32 * nt; }

// Stages of the shared-memory ring (40, 48 or 64 KB each): 200 KB or less.
__host__ __device__ constexpr int ring_stages(int nt) { return nt == 4 ? 3 : nt == 2 ? 4 : 5; }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The ring, and 1 KB to align it to the 1024 bytes of the swizzle's period.
size_t stage_smem(int nt) {
  return sizeof(unsigned short) * ring_stages(nt) * static_cast<size_t>(kRows + block_cols(nt)) *
             kChunk + 1024;
}

struct Args {
  const unsigned short* s;
  int lds;
  int m;
  const float* b;
  float* out;
  unsigned short* dbuf;
  int ldb;
  float* part;
  int ncols;
  int iters;
  int chunks;  // ceil(m / kChunk): units of a row group
  int units;   // row groups * chunks
};

// 16 bytes from global memory into shared memory through L2, of which the
// first `bytes` are copied and the rest zero-filled (0 <= bytes <= 16; src
// 16-byte aligned and a valid address even when bytes is 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(bytes)
               : "memory");
}

// Entry offset of piece p (8 entries) of row r of a stage tile of `rows`
// rows: K block p / 8, each rows x 128 bytes with the 16-byte pieces of a
// row XOR-swizzled by row % 8, the layout wgmma's 128-byte swizzle reads.
__device__ __forceinline__ int swz(int rows, int r, int p) {
  return (p >> 3) * rows * kBlockK + r * kBlockK + 8 * ((p & 7) ^ (r & 7));
}

// This block's units [lo, hi): equal contiguous ranges.
__device__ __forceinline__ void block_range(int units, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * units / gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * units / gridDim.x);
}

// The block whose range holds unit u.
__device__ __forceinline__ int owner(int u, int units) {
  return static_cast<int>((static_cast<long long>(u + 1) * gridDim.x - 1) / units);
}

// A unit's row group and chunk, stepped along a block's range.
struct Pos {
  int r;
  int kc;
};

__device__ __forceinline__ Pos unit_pos(int u, int chunks) { return Pos{u / chunks, u % chunks}; }

__device__ __forceinline__ void advance(Pos& p, int chunks) {
  if (++p.kc == chunks) {
    p.kc = 0;
    ++p.r;
  }
}

// Issue the copies of a unit's 128 rows of S into a stage (zero past m).
template <bool kVec>
__device__ __forceinline__ void load_s(const Args& a, Pos u, unsigned short* sa) {
#pragma unroll
  for (int j = 0; j < kRows * kPieces / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int row = i / kPieces;
    const int p = i % kPieces;
    const int k = u.kc * kChunk + 8 * p;
    const int grow = u.r * kRows + row;
    unsigned short* dst = sa + swz(kRows, row, p);
    if constexpr (kVec) {
      const bool ok = grow < a.m && k < a.m;  // m % 8 == 0: a piece is all in or all out
      cp_async16(dst, ok ? a.s + static_cast<size_t>(grow) * a.lds + k : a.s, ok ? 16 : 0);
    } else {
      unsigned int e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        e[q] = (grow < a.m && k + q < a.m) ? __ldg(a.s + static_cast<size_t>(grow) * a.lds + k + q)
                                           : 0u;
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                     e[6] | (e[7] << 16));
    }
  }
}

// Issue the copies of a unit's kChunk k of the ncols columns of d_in into
// a stage (zero past m and for columns past ncols).
template <int NT>
__device__ __forceinline__ void load_d(const Args& a, const unsigned short* d_in, Pos u,
                                       unsigned short* sb) {
  for (int i = threadIdx.x; i < block_cols(NT) * kPieces; i += kThreads) {
    const int n = i / kPieces;
    const int p = i % kPieces;
    const int k = u.kc * kChunk + 8 * p;
    const int bytes = n < a.ncols ? max(0, min(16, 2 * (a.m - k))) : 0;
    cp_async16(sb + swz(block_cols(NT), n, p),
               bytes ? d_in + static_cast<size_t>(n) * a.ldb + k : d_in, bytes);
  }
}

// One stage's products for this thread's warpgroup g = warp / 4: rows 64
// (g % 2) .. + 63 by columns 16 NT (g / 2) .. + 16 NT - 1 of the
// segment's sums, accumulated in acc (wgmma's layout: warp w % 4 of the
// group holds rows 16 (w % 4) + lane / 4 and + 8; register 4 j + 2 h + c
// is row + 8 h, column 8 j + 2 (lane % 4) + c).  The tensor cores sum
// the stage's 128 k from zero, and the result is added to acc in f32 on
// the CUDA cores: a chain of wgmma sums thousands of k long drifts from
// f32 sums (1e-4 of max at m = 13968 in 3 steps), 128 k does not.
template <int NT>
__device__ __forceinline__ void stage_products(const unsigned short* sa, const unsigned short* sb,
                                               float (&acc)[8 * NT]) {
  const int g = threadIdx.x >> 7;
  const unsigned short* pa = sa + (g & 1) * 64 * kBlockK;
  const unsigned short* pb = sb + (g >> 1) * 16 * NT * kBlockK;
  float part[8 * NT];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    // K block ks / 4, then 16 entries (32 bytes) a step within its rows
    const uint64_t da = desc(pa + (ks >> 2) * kRows * kBlockK + 16 * (ks & 3));
    const uint64_t db = desc(pb + (ks >> 2) * block_cols(NT) * kBlockK + 16 * (ks & 3));
    if constexpr (NT == 1) {
      ks == 0 ? wgmma_n16_first(part, da, db) : wgmma_n16(part, da, db);
    } else if constexpr (NT == 2) {
      ks == 0 ? wgmma_n32_first(part, da, db) : wgmma_n32(part, da, db);
    } else {
      ks == 0 ? wgmma_n64_first(part, da, db) : wgmma_n64(part, da, db);
    }
  }
  wgmma_commit_and_wait();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < 8 * NT; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// A segment's sums into its slot ((32 NT, 128) f32, column-major; the live
// columns only), and the accumulators back to zero.
template <int NT>
__device__ __forceinline__ void store_segment(float* slot, int ncols, float (&acc)[8 * NT]) {
  const int g = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int row0 = 64 * (g & 1) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = 16 * NT * (g >> 1) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 8 * NT; ++i) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int n = col0 + 8 * (i >> 2) + (i & 1);
    if (n < ncols) __stcg(slot + n * kRows + row, acc[i]);
    acc[i] = 0.f;
  }
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z),
                     __fadd_rn(x.w, y.w));
}

// The sum over segments: acc rows row .. row + 3 (row % 4 == 0) of column
// col, the partials of row group r added in block order, times 0.99; then
// bf16(acc) into d_out or, after the last step, f32 acc into out.
template <int NT>
__device__ __forceinline__ void reduce_quad(const Args& a, int col, int row, bool last,
                                            unsigned short* d_out) {
  constexpr size_t kSlot = static_cast<size_t>(block_cols(NT)) * kRows;
  const int r = row / kRows;
  const int b0 = owner(r * a.chunks, a.units);
  const int b1 = owner((r + 1) * a.chunks - 1, a.units);
  const float* p = a.part + (static_cast<size_t>(b0 + r) * block_cols(NT) + col) * kRows +
                   (row - r * kRows);
  float4 sum = __ldcg(reinterpret_cast<const float4*>(p));
  for (int bb = b0 + 1; bb <= b1; bb += 4) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bb + j <= b1) v[j] = __ldcg(reinterpret_cast<const float4*>(p + (bb + j - b0) * kSlot));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bb + j <= b1) sum = add4(sum, v[j]);
    }
  }
  const float w[4] = {__fmul_rn(sum.x, kScale), __fmul_rn(sum.y, kScale),
                      __fmul_rn(sum.z, kScale), __fmul_rn(sum.w, kScale)};
  if (last) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row + i < a.m) a.out[static_cast<size_t>(row + i) * a.ncols + col] = w[i];
    }
  } else if (row + 3 < a.m) {
    *reinterpret_cast<uint2*>(d_out + static_cast<size_t>(col) * a.ldb + row) =
        make_uint2(r3d::pack_bf16(w[0], w[1]), r3d::pack_bf16(w[2], w[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row + i < a.m) {
        d_out[static_cast<size_t>(col) * a.ldb + row + i] =
            __bfloat16_as_ushort(__float2bfloat16_rn(w[i]));
      }
    }
  }
}

template <int NT, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) matmul_probe_kernel(Args a) {
  constexpr int kCols = block_cols(NT);
  constexpr int kStages = ring_stages(NT);
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem + ((1024 - base % 1024) % 1024));
  auto stage_a = [&](int i) { return ring + static_cast<size_t>(i) * (kRows + kCols) * kChunk; };
  auto stage_b = [&](int i) { return stage_a(i) + kRows * kChunk; };
  cg::grid_group grid = cg::this_grid();
  const size_t buf = static_cast<size_t>(a.ncols) * a.ldb;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int lo, hi;
  block_range(a.units, lo, hi);
  const Pos first = unit_pos(lo, a.chunks);
  // Warpgroups whose columns all lie past ncols have no products to take.
  const bool active = 16 * NT * (threadIdx.x >> 8) < a.ncols;
  // S does not change between steps: the rows of S of a step's first
  // stages are loaded before the barriers that precede it, as one group.
  auto prefetch_s = [&]() {
    Pos p = first;
#pragma unroll 1
    for (int i = 0; i < kStages - 1 && lo + i < hi; ++i, advance(p, a.chunks)) {
      load_s<kVec>(a, p, stage_a(i));
    }
    r3d::cp_async_commit();
  };
  prefetch_s();

  // bf16(b) into buffer 0.
  for (long long i = tid; i < static_cast<long long>(a.m) * a.ncols; i += threads) {
    const int row = static_cast<int>(i / a.ncols);
    const int col = static_cast<int>(i - static_cast<long long>(row) * a.ncols);
    a.dbuf[static_cast<size_t>(col) * a.ldb + row] = __bfloat16_as_ushort(__float2bfloat16_rn(a.b[i]));
  }
  grid.sync();

  const int quads = (a.m + 3) / 4;
  const long long total = static_cast<long long>(a.ncols) * quads;
  for (int t = 0; t < a.iters; ++t) {
    const unsigned short* d_in = a.dbuf + (t & 1) * buf;
    float acc[8 * NT] = {};
    // One group per stage for d, after the group of S: at unit i the wait
    // below leaves the latest kStages - 2 groups in flight, so unit i's
    // copies of S and of d have both landed.
    Pos next = first;  // the next unit to load
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i, advance(next, a.chunks)) {
      if (lo + i < hi) load_d<NT>(a, d_in, next, stage_b(i));
      r3d::cp_async_commit();
    }
    Pos cur = first;  // the unit to multiply
    for (int u = lo; u < hi; ++u) {
      const int i = u - lo;
      r3d::cp_async_wait<kStages - 2>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      __syncthreads();  // for every thread, and the stage refilled below is free
      if (u + kStages - 1 < hi) {
        const int sv = (i + kStages - 1) % kStages;
        load_s<kVec>(a, next, stage_a(sv));
        load_d<NT>(a, d_in, next, stage_b(sv));
      }
      advance(next, a.chunks);
      r3d::cp_async_commit();
      if (active) stage_products<NT>(stage_a(i % kStages), stage_b(i % kStages), acc);
      const int r = cur.r;
      advance(cur, a.chunks);
      if (active && (cur.kc == 0 || u + 1 == hi)) {  // the segment of row group r ends
        store_segment<NT>(a.part + static_cast<size_t>(blockIdx.x + r) * kCols * kRows, a.ncols,
                          acc);
      }
    }
    r3d::cp_async_wait_all();
    __syncthreads();  // every warp is done with the ring
    const bool last = t + 1 == a.iters;
    if (!last) prefetch_s();
    grid.sync();  // every segment's partials are written

    unsigned short* d_out = a.dbuf + ((t + 1) & 1) * buf;
    for (long long q = tid; q < total; q += threads) {
      const int col = static_cast<int>(q / quads);
      const int row = 4 * static_cast<int>(q - static_cast<long long>(col) * quads);
      reduce_quad<NT>(a, col, row, last, d_out);
    }
    if (!last) grid.sync();  // bf16(acc) is complete and the partials are free
  }
}

bool vec_ok(const void* s, int m, int lds) {
  return m % 8 == 0 && lds % 8 == 0 && reinterpret_cast<std::uintptr_t>(s) % 16 == 0;
}

template <int NT>
cudaError_t launch(const r3d::CoopLaunch& p, bool vec, Args& a, cudaStream_t st) {
  void* args[] = {&a};
  const size_t smem = stage_smem(NT);
  return vec ? r3d::coop_launch(matmul_probe_kernel<NT, true>, p, kThreads, smem, args, st)
             : r3d::coop_launch(matmul_probe_kernel<NT, false>, p, kThreads, smem, args, st);
}

}  // namespace

// Kernel 11, one call: out (m, ncols) after `iters` steps, on a grid of
// `grid` blocks (at most one per SM and one per unit).  dbuf: 2 * ncols *
// ldb bf16; part: `slots` slots of c x 128 f32, c = 32, 64 or 128 (the
// least >= ncols), slots >= grid + ceil(m / 128).
R3D_EXPORT int r3d_matmul_only(const void* s, int lds, const void* b, void* out, void* dbuf,
                               int ldb, void* part, int slots, int m, int ncols, int iters,
                               int grid, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || m < 1 || iters < 1 || lds < m || ldb < m || ldb % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const int groups = ceil_div(m, kRows);
  const int chunks = ceil_div(m, kChunk);
  if (static_cast<long long>(groups) * chunks > (1LL << 30)) return cudaErrorInvalidValue;
  const int units = groups * chunks;
  r3d::CoopLaunch p{};
  cudaError_t err = r3d::coop_plan(grid, p);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > units || p.grid != grid || slots < grid + groups) {
    return cudaErrorInvalidValue;
  }
  Args a{static_cast<const unsigned short*>(s), lds, m, static_cast<const float*>(b),
         static_cast<float*>(out), static_cast<unsigned short*>(dbuf), ldb,
         static_cast<float*>(part), ncols, iters, chunks, units};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(s, m, lds);
  if (ncols <= block_cols(1)) return launch<1>(p, vec, a, st);
  if (ncols <= block_cols(2)) return launch<2>(p, vec, a, st);
  return launch<4>(p, vec, a, st);
}
