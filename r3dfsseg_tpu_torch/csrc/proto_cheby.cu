// Two persistent bf16 tensor-core kernels over an on-chip S: the
// Chebyshev solve of the bf16 episode graph (kernel 7, on the main paths)
// and the archived single-launch Chebyshev probe (kernel 10).  The S.d
// matvec probe (kernel 11) is in matmul_probe.cu.
//
// Replaces the TPU kernels r3dfsseg_tpu/ops/pallas_cheby.py:_cheby_kernel
// (via cheby_solve_pallas; kernel 7) and
// scripts/archive/proto_cheby_pallas.py:_cheby_kernel (via cheby_pallas;
// kernel 10).  Both keep S in the TPU's VMEM and loop over the steps
// inside one kernel; each step feeds the iterate to one bf16 x bf16 -> f32
// dot with S.
//   kernels 7 and 10: r = b, d = r / theta, x = d, then for each of iters -
//     1 steps
//       r <- r - (d - alpha * sd);  d <- c1 * d + c2 * r;  x <- x + d
//     with (c1, c2) computed once on the host, in double, by
//     ops/cuda_cheby.py:coefficients (shared with the plain versions); the
//     updates use round-to-nearest intrinsics in the plain versions' order.
//     Kernel 7 takes d as P = 2 bf16 pieces, hi = bf16(d) and lo = bf16(d -
//     hi), and sd = (S hi) + (S lo), the two f32 sums added in f32: the TPU
//     kernel's `body_packed`, which packs hi and lo as the two halves of one
//     operand so that one dot gives both.  Kernel 10 takes one piece, sd = S
//     bf16(d): the TPU's rejected first version.
//
// What bounds them on the H100: each step reads all of S (4396^2 bf16 =
// 38.65 MB at the flagship graph).  Read once, S bounds kernels 7 and 10
// by bytes (0.0115 ms).  What the design pays instead is reading S again
// at every step (from the 50 MB L2, whose aggregate bandwidth limits that
// part, or from on chip), the per-tile reduction across warps, and one
// grid-wide barrier per step.
//
// Design: one cooperative launch per call (cudaLaunchCooperativeKernel),
// one block of 16 warps per SM, all co-resident (checked with the
// occupancy API; the launch is refused otherwise, never replaced by a spin
// barrier), and cooperative_groups' grid sync between steps.
// - Work split: a step's work is (column group of 8 * NT columns, row of S)
//   positions, cut into equal contiguous ranges, one per block and fixed
//   across steps, so every SM reads the same number of rows of S.  A block
//   walks its range in tiles of at most 16 rows (`TileWalk`).
// - Products: the block stages the live columns of its column group of the
//   bf16 pieces of d for all rows in shared memory (cp.async, zero past m),
//   and its 16 warps split the K range of each tile: a warp runs
//   mma.sync.m16n8k16 bf16 tiles (A = up to 16 rows of S; B = the pieces
//   from shared memory; the k order inside a tile is permuted identically
//   in A and B so that one 8-byte load fills two fragment registers), f32
//   accumulation.  Kernel 7's B holds hi in columns 0 .. c - 1 and lo in c
//   .. 2c - 1: one n = 8 tile for c <= 4 (one mma per A fragment, as the
//   TPU packs both into one dot), two for c = 5 .. 8.  Rows of S read from
//   L2 take 8-byte __ldg loads, and a warp issues its first ones before it
//   waits for the staged pieces, so the staging hides behind them.
// - Kernels 7 and 10 keep S on chip across the steps, as the TPU kernels
//   keep it in VMEM: of each block's range, one tile of 16 rows lives in
//   the warps' registers (each warp holds the A fragments of its k-tiles,
//   18 at most; one n tile only) and the shared memory left over holds the
//   next rows, both loaded once per solve; at the flagship graph (33-34
//   rows per block, 3 columns) all of S is on chip and no step reads it
//   from L2: kernel 10 keeps 20 rows in shared memory, kernel 7 18 (its
//   second piece of d takes 26 KB more, so it sweeps its shared-memory rows
//   one tile at a time, where kernel 10 sweeps two tiles with one B
//   fragment, and the reduction buffer halves).
// - The 16 warps' partial tiles are summed in warp order in shared memory
//   (no atomics: a call repeats bit for bit, wherever its rows of S live),
//   and the tile's owner threads apply the update and write the pieces of
//   d for the next step into the other of two global buffers, so one
//   barrier per step suffices.  r, d and x stay in shared memory across the
//   steps.  The bf16 buffers are read through L2 (cp.async.cg): another
//   block wrote them in the same launch, and L1 is not coherent.
//
// Where M, the row stride or the base is not a multiple of 4 entries, lanes
// load S with 2-byte loads instead.
//
// Layout: s (m, lds) bf16 row-major; b, x and out (m, ncols) f32
// row-major; the bf16 buffers (2, 8 * NT, ldk), column-major, zero-filled
// by the wrapper, with ldk >= m rounded up to 16 and ldk % 64 == 16 (the
// shared-memory fragment loads of a warp then hit distinct banks).
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16;
constexpr int kBatch = 4;            // k-tiles of A loaded at once by a warp
constexpr int kSharedTiles = 2;      // kernel 10: tiles of shared-memory rows per sweep
constexpr int kRegTiles = 18;        // kernels 7, 10: a warp's k-tiles held in registers
                                     // (m <= 16 * 16 * 18 = 4608)
constexpr int kMaxCols = 8;          // kernels 7, 10: live columns of b
using r3d::kSmemLimit;

struct Geometry {
  const unsigned short* s;
  int lds;
  int m;
  int ldk;
  int ktiles;  // ceil(m / 16)
};

// The tiles of a range [pos, hi) of (column group, row) positions: the first
// takes the range's length mod 16 rows (if not 0) and the rest 16 each; a
// tile also ends at a column group's end.
struct TileWalk {
  int pos;
  int hi;
  int m;
  int lead;  // rows of the next tile, unless a group or the range ends first
  int group;
  int row0;
  int nrows;

  __device__ __forceinline__ bool next() {
    if (pos >= hi) return false;
    group = pos / m;
    row0 = pos - group * m;
    nrows = min(lead, min(m - row0, hi - pos));
    lead = kTileRows;
    pos += nrows;
    return true;
  }
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ TileWalk walk(int lo, int hi, int m) {
  const int rem = (hi - lo) % kTileRows;
  return TileWalk{lo, hi, m, rem ? rem : kTileRows, 0, 0, 0};
}

// This block's share [lo, hi) of `positions`: equal contiguous ranges.
__device__ __forceinline__ void block_range(int positions, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * positions / gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * positions / gridDim.x);
}

// Kernels 7 and 10's most tiles per block: a range of at most ceil(m / grid) rows
// is walked in three parts (see `cheby_kernel`).
__host__ __device__ __forceinline__ int max_tiles(int m, int grid) {
  return ceil_div(ceil_div(m, grid), kTileRows) + 2;
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// Entries k .. k + 3 of one row of S in device memory as two packed bf16
// pairs; zero past m or on a row outside the tile.
template <bool kVec>
__device__ __forceinline__ uint2 load_a(const unsigned short* row, bool row_ok, int k, int m) {
  if constexpr (kVec) {
    if (row_ok && k < m) return __ldg(reinterpret_cast<const uint2*>(row + k));
    return make_uint2(0u, 0u);
  } else {
    unsigned int e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = (row_ok && k + q < m) ? __ldg(row + k + q) : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned int a0, unsigned int a1,
                                         unsigned int a2, unsigned int a3, unsigned int b0,
                                         unsigned int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Issue the copy of n bf16 (a multiple of 8) from a global buffer written
// in this launch into shared memory: 16-byte cp.async.cg copies (through
// L2, not L1).  `stage_wait` completes them.
__device__ __forceinline__ void stage(const unsigned short* src, unsigned short* dst, int n) {
  for (int i = threadIdx.x; i < n / 8; i += kThreads) {
    const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(dst + 8 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + 8 * i));
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// One warp's share of a tile read from device memory: rows row0 .. row0 +
// nrows - 1 of S times the NT column tiles of b_s ((8 * NT, ldk) bf16,
// column-major; columns from `live` on repeat column live - 1, and the
// caller drops those outputs), over k-tiles [kt0, kt1).  Lane (g, t) =
// (lane / 4, lane % 4) holds physical k = 16 kt + 4t .. 4t + 3 of rows g
// and g + 8: the first pair stands for the fragment's k = 2t, 2t + 1 and
// the second for 2t + 8, 2t + 9, in A and B alike.  acc[j] is the m16n8
// accumulator of column tile j: rows g, g + 8, columns 8j + 2t, 8j + 2t +
// 1.  With `wait`, the block's staging of b_s is completed after the first
// batch of A loads is issued (every warp reaches it once).
template <int NT, bool kVec>
__device__ __forceinline__ void warp_product(const Geometry& g, int row0, int nrows, int kt0,
                                             int kt1, const unsigned short* b_s, int live,
                                             bool wait, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bool oka = gid < nrows;
  const bool okb = gid + 8 < nrows;
  const unsigned short* pa = g.s + static_cast<size_t>(row0 + (oka ? gid : 0)) * g.lds;
  const unsigned short* pb = g.s + static_cast<size_t>(row0 + (okb ? gid + 8 : 0)) * g.lds;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  }
  for (int kt = kt0;; kt += kBatch) {
    uint2 lo[kBatch];
    uint2 hi[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = (kt + q) * 16 + 4 * tig;
      const bool in = kt + q < kt1;
      lo[q] = load_a<kVec>(pa, oka && in, k, g.m);
      hi[q] = load_a<kVec>(pb, okb && in, k, g.m);
    }
    if (wait) {
      stage_wait();
      wait = false;
    }
    if (kt >= kt1) break;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (kt + q >= kt1) break;
      const int k = (kt + q) * 16 + 4 * tig;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 bv =
            *reinterpret_cast<const uint2*>(b_s + min(8 * j + gid, live - 1) * g.ldk + k);
        mma_bf16(acc[j], lo[q].x, hi[q].x, lo[q].y, hi[q].y, bv.x, bv.y);
      }
    }
  }
}

// Where a walk's rows of S come from.
enum Source { kFromL2, kFromShared, kFromRegisters };

// Load a warp's A fragments of rows row0 .. row0 + nrows - 1 of S for its
// k-tiles [kt0, kt1) into registers, in `warp_product`'s layout.
template <int KREG, bool kVec>
__device__ __forceinline__ void load_fragments(const Geometry& g, int row0, int nrows, int kt0,
                                               int kt1, unsigned int (&areg)[KREG][4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bool oka = gid < nrows;
  const bool okb = gid + 8 < nrows;
  const unsigned short* pa = g.s + static_cast<size_t>(row0 + (oka ? gid : 0)) * g.lds;
  const unsigned short* pb = g.s + static_cast<size_t>(row0 + (okb ? gid + 8 : 0)) * g.lds;
#pragma unroll
  for (int q = 0; q < KREG; ++q) {
    const int k = (kt0 + q) * 16 + 4 * tig;
    const bool in = kt0 + q < kt1;
    const uint2 lo = load_a<kVec>(pa, oka && in, k, g.m);
    const uint2 hi = load_a<kVec>(pb, okb && in, k, g.m);
    areg[q][0] = lo.x;
    areg[q][1] = hi.x;
    areg[q][2] = lo.y;
    areg[q][3] = hi.y;
  }
}

// `warp_product` for a tile whose A fragments the warp holds in registers
// (zero past the warp's k-tiles, so those products add nothing; their B
// loads are clamped to the last k-tile).
template <int KREG>
__device__ __forceinline__ void warp_product_registers(const Geometry& g,
                                                       const unsigned int (&areg)[KREG][4],
                                                       int kt0, const unsigned short* b_s,
                                                       int live, bool wait, float (&acc)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned short* bp = b_s + min(lane >> 2, live - 1) * g.ldk + 4 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  if (wait) stage_wait();
#pragma unroll
  for (int q = 0; q < KREG; ++q) {
    const uint2 bv = *reinterpret_cast<const uint2*>(bp + min(kt0 + q, g.ktiles - 1) * 16);
    mma_bf16(acc, areg[q][0], areg[q][1], areg[q][2], areg[q][3], bv.x, bv.y);
  }
}

// `warp_product` for up to TT tiles whose rows of S lie in shared memory,
// in one sweep over the warp's k-tiles that loads each B fragment once.
// a_s[i] is tile i's first row (row stride ldk), of n[i] rows; rows past a
// tile repeat its last row, and the caller drops those outputs.
template <int TT, int NT>
__device__ __forceinline__ void warp_product_shared(const Geometry& g,
                                                    const unsigned short* const (&a_s)[TT],
                                                    const int (&n)[TT], int ntl, int kt0,
                                                    int kt1, const unsigned short* b_s,
                                                    int live, bool wait,
                                                    float (&acc)[TT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig4 = 4 * (lane & 3);
  const unsigned short* pa[TT];
  const unsigned short* pb[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    pa[i] = a_s[i] + min(gid, n[i] - 1) * g.ldk + tig4;
    pb[i] = a_s[i] + min(gid + 8, n[i] - 1) * g.ldk + tig4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }
  const unsigned short* bp[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bp[j] = b_s + min(8 * j + gid, live - 1) * g.ldk + tig4;
  if (wait) stage_wait();
#pragma unroll 4
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k = kt * 16;
    uint2 bv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) bv[j] = *reinterpret_cast<const uint2*>(bp[j] + k);
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      if (i < ntl) {
        const uint2 lo = *reinterpret_cast<const uint2*>(pa[i] + k);
        const uint2 hi = *reinterpret_cast<const uint2*>(pb[i] + k);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], lo.x, hi.x, lo.y, hi.y, bv[j].x, bv[j].y);
      }
    }
  }
}

// The tiles of one walk, for one step: rows of S from device memory (one
// tile per sweep), from res_s (whose row 0 is row res_row0; TT tiles per
// sweep) or from the registers areg (a walk of one tile).  The block
// stages the first `live` columns of a tile's column group of d_in
// ((ncols_pad, ldk) bf16, this step's buffer) whenever the group changes.
// epi(slot, row, col, sd) applies the update of one entry, where sd =
// (S piece)[row, col] with one piece of d (P = 1) and (S hi)[row, col] +
// (S lo)[row, col] with two (P = 2: hi in columns 0 .. live / 2 - 1, lo in
// the next live / 2; each summed over the warps, then the two added), and
// slot = tile * 16 * 8 + row in the tile * 8 + col numbers the block's
// entries of up to 8 columns; `tile` counts on across walks.  red holds TT
// * 16 warps' partial tiles.
template <int NT, bool kVec, Source kSrc, int TT, int P, int KREG, class Epi>
__device__ void step_walk(const Geometry& g, TileWalk w, int& tile, int& staged,
                          const unsigned short* res_s, int res_row0,
                          const unsigned int (&areg)[KREG][4], int live,
                          const unsigned short* d_in, unsigned short* b_s, float* red,
                          const Epi& epi) {
  static_assert(TT == 1 || kSrc == kFromShared, "several tiles: shared rows only");
  static_assert(kSrc != kFromRegisters || (NT == 1 && TT == 1), "one register tile");
  constexpr int kCols = 8 * NT;
  constexpr int kOut = kTileRows * kCols;  // entries of a tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kt0 = warp * g.ktiles / kWarps;
  const int kt1 = (warp + 1) * g.ktiles / kWarps;
  for (;;) {
    int row0[TT];
    int n[TT];
    int ntl = 0;
    int group = 0;
    for (; ntl < TT && w.next(); ++ntl) {
      row0[ntl] = w.row0;
      n[ntl] = w.nrows;
      group = w.group;
    }
    if (ntl == 0) return;
#pragma unroll
    for (int i = 1; i < TT; ++i) {
      if (i >= ntl) {
        row0[i] = row0[0];
        n[i] = n[0];
      }
    }
    const bool fresh = group != staged;
    if (fresh) {
      stage(d_in + static_cast<size_t>(group) * kCols * g.ldk, b_s, live * g.ldk);
      staged = group;
    }
    float acc[TT][NT][4];
    if constexpr (kSrc == kFromRegisters) {
      warp_product_registers<KREG>(g, areg, kt0, b_s, live, fresh, acc[0][0]);
    } else if constexpr (kSrc == kFromShared) {
      const unsigned short* a_s[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) a_s[i] = res_s + static_cast<size_t>(row0[i] - res_row0) * g.ldk;
      warp_product_shared<TT, NT>(g, a_s, n, ntl, kt0, kt1, b_s, live, fresh, acc);
    } else {
      warp_product<NT, kVec>(g, row0[0], n[0], kt0, kt1, b_s, live, fresh, acc[0]);
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          red[(((i * kWarps) + warp) * 4 * NT + 4 * j + q) * 32 + lane] = acc[i][j][q];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < ntl * kOut) {
      const int i = threadIdx.x / kOut;
      const int e = threadIdx.x - i * kOut;
      const int r = e / kCols;
      const int col = e - r * kCols;
      auto total = [&](int cc) {  // entry (r, cc) of the tile, summed in warp order
        const int src = (r & 7) * 4 + ((cc & 7) >> 1);
        const int reg = 4 * (cc >> 3) + 2 * (r >> 3) + (cc & 1);
        float sum = 0.f;
        for (int v = 0; v < kWarps; ++v) sum += red[((i * kWarps + v) * 4 * NT + reg) * 32 + src];
        return sum;
      };
      float sum = total(col);
      if constexpr (P == 2) {
        if (col < live / 2) sum = __fadd_rn(sum, total(col + live / 2));  // S hi + S lo
      }
      int r0 = row0[0];
      int nr = n[0];
#pragma unroll
      for (int q = 1; q < TT; ++q) {
        if (i == q) {
          r0 = row0[q];
          nr = n[q];
        }
      }
      if (r < nr) epi((tile + i) * kTileRows * 8 + r * 8 + col, r0 + r, group * kCols + col, sum);
    }
    __syncthreads();  // red and b_s are rewritten by the next sweep
    tile += ntl;
  }
}

// The P bf16 pieces of d[row, col] into a (8 * NT, ldk) buffer: hi = bf16(d)
// in column col and, with P = 2, lo = bf16(d - hi) in column c + col (d - hi
// is exact in f32).
template <int P>
__device__ __forceinline__ void store_pieces(unsigned short* buf, int c, int ldk, int row,
                                             int col, float d) {
  const unsigned short hi = bf16_bits(d);
  buf[col * ldk + row] = hi;
  if constexpr (P == 2) buf[(c + col) * ldk + row] = bf16_bits(__fsub_rn(d, bf16_value(hi)));
}

// Kernels 7 and 10's update of entry (row, col) for one step.  The block's
// entries of r, d and x stay in shared memory across the steps (st, three
// arrays of `per` floats); only the P bf16 pieces of d go through device
// memory.
template <int P>
struct ChebyUpdate {
  float* st;
  int per;
  unsigned short* d_out;
  int c;
  int ldk;
  float alpha;
  float c1;
  float c2;

  __device__ __forceinline__ void operator()(int slot, int row, int col, float sd) const {
    if (col >= c) return;
    float* r = st + slot;
    float* d = r + per;
    float* x = d + per;
    const float dv = *d;
    const float md = __fsub_rn(dv, __fmul_rn(alpha, sd));  // (I - alpha S) d
    const float rv = __fsub_rn(*r, md);
    const float dn = __fadd_rn(__fmul_rn(c1, dv), __fmul_rn(c2, rv));
    *r = rv;
    *d = dn;
    *x = __fadd_rn(*x, dn);
    store_pieces<P>(d_out, c, ldk, row, col, dn);
  }
};

// Shared memory: `cols` columns of the pieces of d, the warps' partial
// tiles of `tt` tiles, then (kernels 7 and 10) the state of `tiles` tiles
// and the resident rows of S.
size_t base_smem(int cols, int nt, int ldk, int tt = 1) {
  return sizeof(unsigned short) * cols * static_cast<size_t>(ldk) +
         sizeof(float) * tt * kWarps * 4 * nt * 32;
}

size_t state_smem(int tiles) { return sizeof(float) * 3 * tiles * kTileRows * 8; }

// Kernels 7 (P = 2 pieces of d, NT = 1 or 2 column tiles, TT = 1 shared
// tile per sweep) and 10 (P = 1, NT = 1, TT = 2).  A block's range of rows
// [lo, hi) is walked in three parts: rows read from L2 at every step [lo,
// a), one tile held in the warps' registers [a, b) (with KREG > 0: each
// warp keeps its k-tiles' A fragments, KREG at most), and rows kept in
// shared memory [b, hi).  `onchip` caps the rows kept in registers and
// shared memory, `resident` the rows shared memory has room for.
template <bool kVec, int KREG, int P, int NT, int TT>
__global__ void __launch_bounds__(kThreads, 1)
cheby_kernel(Geometry g, const float* __restrict__ b, float* x, unsigned short* dbuf, int c,
             int iters, float alpha, float theta, const float* __restrict__ coef, int resident,
             int onchip) {
  static_assert(KREG == 0 || NT == 1, "the register tile takes one column tile");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* b_s = reinterpret_cast<unsigned short*>(smem);
  float* red = reinterpret_cast<float*>(smem + sizeof(unsigned short) * P * c * g.ldk);
  float* st = red + TT * kWarps * 4 * NT * 32;
  const int per = max_tiles(g.m, gridDim.x) * kTileRows * 8;
  unsigned short* res_s = reinterpret_cast<unsigned short*>(st + 3 * per);
  cg::grid_group grid = cg::this_grid();
  const size_t buf = static_cast<size_t>(8) * NT * g.ldk;
  const int live = P * c;
  int lo, hi;
  block_range(g.m, lo, hi);
  const int in_regs = KREG > 0 ? min(kTileRows, min(hi - lo, onchip)) : 0;
  const int in_smem = min(resident, min(hi - lo - in_regs, onchip - in_regs));
  const int a = hi - in_smem - in_regs;
  const int bnd = hi - in_smem;
  const TileWalk parts[3] = {walk(lo, a, g.m), walk(a, bnd, g.m), walk(bnd, hi, g.m)};
  const int warp = threadIdx.x >> 5;
  const int kt0 = warp * g.ktiles / kWarps;
  const int kt1 = (warp + 1) * g.ktiles / kWarps;

  // The block's entries: r = b, d = b / theta, x = d, the pieces of d into
  // buffer 0; thread i < 128 owns entry (i / 8, i % 8) of each tile, as in
  // `step_walk`.  The register tile's fragments, and the shared-memory rows
  // of S (zero past m).
  const int r_in = threadIdx.x >> 3;
  const int col = threadIdx.x & 7;
  const bool owner = threadIdx.x < kTileRows * 8 && col < c;
  int tile = 0;
  for (TileWalk w : parts) {
    for (; w.next(); ++tile) {
      if (owner && r_in < w.nrows) {
        const int row = w.row0 + r_in;
        const int slot = tile * kTileRows * 8 + threadIdx.x;
        const float v = b[row * c + col];
        const float dv = __fdiv_rn(v, theta);
        st[slot] = v;
        st[slot + per] = dv;
        st[slot + 2 * per] = dv;
        store_pieces<P>(dbuf, c, g.ldk, row, col, dv);
      }
    }
  }
  unsigned int areg[KREG > 0 ? KREG : 1][4];
  if constexpr (KREG > 0) load_fragments<KREG, kVec>(g, a, in_regs, kt0, kt1, areg);
  if constexpr (kVec) {  // 8-byte cp.async copies, all in flight at once
    for (int i = 4 * threadIdx.x; i < in_smem * g.ldk; i += 4 * kThreads) {
      const int r = i / g.ldk;
      const int k = i - r * g.ldk;
      if (k < g.m) {
        const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(res_s + i));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to),
                     "l"(g.s + static_cast<size_t>(bnd + r) * g.lds + k));
      } else {
        *reinterpret_cast<uint2*>(res_s + i) = make_uint2(0u, 0u);
      }
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < in_smem * g.ldk; i += kThreads) {
      const int r = i / g.ldk;
      const int k = i - r * g.ldk;
      res_s[i] = k < g.m ? __ldg(g.s + static_cast<size_t>(bnd + r) * g.lds + k)
                         : static_cast<unsigned short>(0);
    }
  }
  stage_wait();  // the shared-memory rows have landed
  if (iters > 1) grid.sync();

  ChebyUpdate<P> epi{st, per, nullptr, c, g.ldk, alpha, 0.f, 0.f};
  for (int t = 0; t + 1 < iters; ++t) {
    epi.d_out = dbuf + ((t + 1) & 1) * buf;
    epi.c1 = coef[2 * t];
    epi.c2 = coef[2 * t + 1];
    const unsigned short* d_in = dbuf + (t & 1) * buf;
    int tl = 0;
    int staged = -1;
    step_walk<NT, kVec, kFromL2, 1, P>(g, parts[0], tl, staged, nullptr, 0, areg, live, d_in, b_s,
                                       red, epi);
    if constexpr (KREG > 0) {
      step_walk<1, kVec, kFromRegisters, 1, P>(g, parts[1], tl, staged, nullptr, 0, areg, live,
                                               d_in, b_s, red, epi);
    }
    step_walk<NT, kVec, kFromShared, TT, P>(g, parts[2], tl, staged, res_s, bnd, areg, live, d_in,
                                            b_s, red, epi);
    if (t + 2 < iters) grid.sync();
  }

  __syncthreads();
  tile = 0;
  for (TileWalk w : parts) {
    for (; w.next(); ++tile) {
      if (owner && r_in < w.nrows) {
        x[(w.row0 + r_in) * c + col] = st[tile * kTileRows * 8 + threadIdx.x + 2 * per];
      }
    }
  }
}

bool ldk_ok(int m, int ldk) { return ldk % 64 == 16 && ldk >= ceil_div(m, 16) * 16; }

bool vec_ok(const void* s, int m, int lds) {
  return m % 4 == 0 && lds % 4 == 0 && reinterpret_cast<std::uintptr_t>(s) % 8 == 0;
}

template <bool kVec, int P, int NT, int TT>
cudaError_t launch_solve(const r3d::CoopLaunch& p, bool regs, size_t smem, void** args,
                         cudaStream_t st) {
  if constexpr (NT == 1) {
    if (regs) return r3d::coop_launch(cheby_kernel<kVec, kRegTiles, P, NT, TT>, p, kThreads,
                                      smem, args, st);
  }
  return r3d::coop_launch(cheby_kernel<kVec, 0, P, NT, TT>, p, kThreads, smem, args, st);
}

// One solve of kernel 7 (P = 2) or 10 (P = 1): x (m, c) after `iters`
// steps.  dbuf: 2 * 8 * ceil(P * c / 8) * ldk bf16, zero-filled; coef: 2 *
// (iters - 1) device floats, (c1, c2) per step.  max_resident caps the rows
// of S a block keeps on chip, in registers and shared memory (-1: as many
// as fit).
// Shared memory one block of the solve needs besides rows of S, on a grid
// of `grid` blocks: the pieces of d of every row, the warps' partial tiles,
// and r, d and x of the block's tiles.
template <int P>
size_t solve_smem(int m, int c, int ldk, int grid) {
  return base_smem(P * c, ceil_div(P * c, 8), ldk, P == 1 ? kSharedTiles : 1) +
         state_smem(max_tiles(m, grid));
}

template <int P>
int solve(const void* s, int lds, const void* b, void* x, void* dbuf, int m, int c, int ldk,
          int iters, float alpha, float theta, const void* coef, int max_resident, void* stream) {
  if (c < 1 || c > kMaxCols || m < 1 || iters < 1 || lds < m || !ldk_ok(m, ldk)) {
    return cudaErrorInvalidValue;
  }
  // One block per SM (at most one per tile of 16 rows): every block stages
  // its column group of the pieces of d at every step, so more blocks would
  // read more of it.
  r3d::CoopLaunch p{};
  cudaError_t err = r3d::coop_plan(ceil_div(m, kTileRows), p);
  if (err != cudaSuccess) return err;
  const int nt = ceil_div(P * c, 8);
  const size_t used = solve_smem<P>(m, c, ldk, p.grid);
  const size_t row_bytes = sizeof(unsigned short) * static_cast<size_t>(ldk);
  int resident = used > kSmemLimit ? 0 : static_cast<int>((kSmemLimit - used) / row_bytes);
  resident = std::min(resident, ceil_div(m, p.grid));
  int onchip = max_resident >= 0 ? max_resident : m;
  const size_t smem = used + std::min(resident, onchip) * row_bytes;
  Geometry g{static_cast<const unsigned short*>(s), lds, m, ldk, ceil_div(m, 16)};
  const float* bp = static_cast<const float*>(b);
  float* xp = static_cast<float*>(x);
  unsigned short* db = static_cast<unsigned short*>(dbuf);
  const float* cp = static_cast<const float*>(coef);
  void* args[] = {&g, &bp, &xp, &db, &c, &iters, &alpha, &theta, &cp, &resident, &onchip};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(s, m, lds);
  const bool regs = ceil_div(g.ktiles, kWarps) <= kRegTiles;  // a warp's k-tiles fit its registers
  if constexpr (P == 1) {
    return vec ? launch_solve<true, 1, 1, kSharedTiles>(p, regs, smem, args, st)
               : launch_solve<false, 1, 1, kSharedTiles>(p, regs, smem, args, st);
  } else if (nt == 1) {
    return vec ? launch_solve<true, P, 1, 1>(p, regs, smem, args, st)
               : launch_solve<false, P, 1, 1>(p, regs, smem, args, st);
  } else {
    return vec ? launch_solve<true, P, 2, 1>(p, regs, smem, args, st)
               : launch_solve<false, P, 2, 1>(p, regs, smem, args, st);
  }
}

}  // namespace

// Kernel 7, one solve with d split into bf16 hi + lo (see `solve`).
R3D_EXPORT int r3d_cheby(const void* s, int lds, const void* b, void* x, void* dbuf, int m, int c,
                         int ldk, int iters, float alpha, float theta, const void* coef,
                         void* stream) {
  return solve<2>(s, lds, b, x, dbuf, m, c, ldk, iters, alpha, theta, coef, -1, stream);
}

// 1 when kernel 7's block fits shared memory for (m, c) on the current
// device, else 0.
R3D_EXPORT int r3d_cheby_fits(int m, int c, int ldk) {
  r3d::CoopLaunch p{};
  if (c < 1 || c > kMaxCols || m < 1 || !ldk_ok(m, ldk) ||
      r3d::coop_plan(ceil_div(m, kTileRows), p) != cudaSuccess) {
    return 0;
  }
  return solve_smem<2>(m, c, ldk, p.grid) <= kSmemLimit ? 1 : 0;
}

// Kernel 10, one solve with d rounded to one bf16 (see `solve`).
R3D_EXPORT int r3d_proto_cheby(const void* s, int lds, const void* b, void* x, void* dbuf,
                               int m, int c, int ldk, int iters, float alpha, float theta,
                               const void* coef, int max_resident, void* stream) {
  return solve<1>(s, lds, b, x, dbuf, m, c, ldk, iters, alpha, theta, coef, max_resident, stream);
}
