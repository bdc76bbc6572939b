// Tiles, fragments and mask bits shared by the attention kernels
// (attention_fwd.cu and attention_fwd_bf16.cu, kernel 2; attention_bwd.cu
// and attention_bwd_bf16.cu, kernel 5; the wide and grouped forms).
//
// Every product is a 3xTF32 mma.sync.m16n8k8 (common.cuh).  A block has
// kWarps warps and streams kChunk-row tiles of the "column" operands (K and
// V; Q and dY in the dK/dV kernel) through a two-stage cp.async ring in
// shared memory; a warp owns 16 "rows" (queries; keys in dK/dV) and keeps
// their operands in registers, their sums in registers, and its softmax
// statistics in registers (reduced across a quad with shuffles).
//
// Layout of a staged tile: kChunk rows x kDP channels f32 (D <= 64 zero
// padded), row-major, 16-byte chunk c of row r stored at chunk c ^ swz(r):
// (r, ch) at float r * kDP + 4 ((ch / 4) ^ swz(r)) + ch % 4.  Two kinds of fragment load read it without bank conflicts:
//   - "along channels" (B of q k^T-like products): lane (g, t) reads the
//     float4 at row 8j + g, channels 16kk + 4t .. + 3.  The channel order
//     inside each 16 is permuted alike in A and B: k-step 2kk + h takes
//     channels 16kk + 4t + 2h (as fragment k = t) and + 1 (k = t + 4), so
//     one float4 feeds two k-steps.  A quarter warp reads rows 2m and 2m + 1,
//     and swz puts them in opposite halves of the 32 banks.
//   - "along rows" (B of p v-like products): lane (g, t) reads rows
//     r0 + 2t and r0 + 2t + 1 at channel 8nn + g.  The key order of the
//     k-step is permuted the same way in A: fragment k = t is key 2t, k =
//     t + 4 is key 2t + 1, which is exactly where the m16n8 accumulator of
//     the previous product holds them, so P (or dS) is the A operand
//     straight from registers, with no shuffle.  swz sends rows 0, 2, 4, 6
//     (and 1, 3, 5, 7) mod 8 to four different chunk pairs.
// After a tile arrives, one pass of the block splits it in place into tf32
// hi and a second buffer of lo (`split_tiles`), once per tile rather than
// once per warp that reads it.
#pragma once

#include <cmath>

#include "common.cuh"
#include "philox.cuh"

namespace r3d_attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;             // rows of a staged tile
constexpr int kDP = 64;                // channels of a staged tile
constexpr int kTileF = kChunk * kDP;   // floats of a staged tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22, results below
// 2^-126 flushed to 0, 2^-inf = 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) ^ ((r & 1) << 1)) << 1; }

// Issue the copy of rows [row0, row0 + kChunk) of an (n, d) f32 matrix into
// a staged tile; rows past n and channels past d are zeros.
__device__ __forceinline__ void stage_tile(const float* src, int row0, int n, int d, float* dst) {
  for (int e = threadIdx.x; e < kChunk * (kDP / 4); e += kThreads) {
    const int r = e >> 4;
    const int c = e & 15;
    const bool ok = row0 + r < n && 4 * c < d;
    const float* from = ok ? src + static_cast<size_t>(row0 + r) * d + 4 * c : src;
    r3d::cp_async16(dst + r * kDP + ((c ^ swz(r)) << 2), from, ok);
  }
}

// Split `count` floats (a multiple of 4 * kThreads) of arrived tiles:
// hi = tf32(x * mul) in place, lo = tf32(x * mul - hi) into `lo`.
__device__ __forceinline__ void split_tiles(float* hi, float* lo, int count, float mul) {
  for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads) {
    const float4 x = *reinterpret_cast<const float4*>(hi + e);
    const float xs[4] = {x.x * mul, x.y * mul, x.z * mul, x.w * mul};
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r3d::split_tf32(xs[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A warp's 16 rows [row0, row0 + 16) of an (n, d) matrix times mul, as the
// A operand of "along channels" products: x[kk][0] is row g, channels 16kk
// + 4t .. + 3, x[kk][1] the same of row g + 8; zeros past n and d.
__device__ __forceinline__ void load_rows(const float* src, int row0, int n, int d, float mul,
                                          float4 (&x)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + 8 * hf;
      const int ch = 16 * kk + 4 * t;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && ch < d) {
        v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * d + ch);
        v = make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
      }
      x[kk][hf] = v;
    }
  }
}

// The hi and lo A fragments of k-step ks (see the layout note).
__device__ __forceinline__ void row_frag(const float4 (&x)[4][2], int ks, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float4 u = x[ks >> 1][0];
  const float4 w = x[ks >> 1][1];
  const bool h = ks & 1;
  r3d::split_tf32(h ? u.z : u.x, hi[0], lo[0]);
  r3d::split_tf32(h ? w.z : w.x, hi[1], lo[1]);
  r3d::split_tf32(h ? u.w : u.y, hi[2], lo[2]);
  r3d::split_tf32(h ? w.w : w.y, hi[3], lo[3]);
}

// The hi and lo A fragments of an accumulator tile c (16 x 8, as an m16n8
// product leaves it) used as the next product's 16 x 8 A over its columns.
__device__ __forceinline__ void acc_frag(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  r3d::split_tf32(c[0], hi[0], lo[0]);
  r3d::split_tf32(c[2], hi[1], lo[1]);
  r3d::split_tf32(c[1], hi[2], lo[2]);
  r3d::split_tf32(c[3], hi[3], lo[3]);
}

// A lane's offsets into a staged tile, fixed for the whole kernel, so that
// every fragment load is one shared-memory load at a register plus an
// immediate (r0 a multiple of 8; the layout note above):
//   along channels, row r0 + 8j + g, channels 16kk + 4t ..:
//     r0 * kDP + 512j + 16kk + (kk odd ? ch[1] : ch[0]);
//   along rows, rows r0 + 8j + 2t + dl, channel 8nn + g:
//     r0 * kDP + 512j + 32 (nn / 4) + row[dl][nn % 4].
struct Lane {
  int g, t;
  int ch[2];
  int row[2][4];
};

__device__ __forceinline__ Lane lane_offsets() {
  Lane ln;
  const int lane = threadIdx.x & 31;
  ln.g = lane >> 2;
  ln.t = lane & 3;
  const int c = ln.t ^ swz(ln.g);  // chunk 4kk + t of row g sits at chunk 4kk ^ c
  const int base = ln.g * kDP + 4 * (c & 3);
  ln.ch[0] = base + 16 * (c >> 2);
  ln.ch[1] = base - 16 * (c >> 2);
#pragma unroll
  for (int dl = 0; dl < 2; ++dl) {
    const int r = 2 * ln.t + dl;
    const int m = swz(r) >> 1;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ln.row[dl][q] = r * kDP + 8 * (q ^ m) + 4 * (ln.g >> 2) + (ln.g & 3);
  }
  return ln;
}

// acc[j] += X Y^T over the channels for n-tiles j < NT: X the warp's rows
// (registers), Y the staged rows r0 + 8j + g (tile hi, lo), in 3xTF32 with
// the small terms first: a_lo b_hi, a_hi b_lo, a_hi b_hi, or with
// kBLoFirst a_hi b_lo, a_lo b_hi, a_hi b_hi, so that a product taken with
// its operands' roles swapped (B A for A B) adds the same exact terms in
// the same order.  The B fragments of up to four n-tiles are loaded first
// and each of the three passes runs over those accumulators in turn, so
// consecutive mma.sync are independent.
template <int NT, bool kBLoFirst>
__device__ __forceinline__ void product_along_channels(float (&acc)[NT][4],
                                                       const float4 (&x)[4][2],
                                                       const float* hi, const float* lo,
                                                       int r0, int d, const Lane& ln) {
  constexpr int kGroup = NT < 4 ? NT : 4;
  hi += r0 * kDP;
  lo += r0 * kDP;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= d) break;
    const int off = 16 * kk + ln.ch[kk & 1];
    uint32_t ah[2][4], al[2][4];
    row_frag(x, 2 * kk, ah[0], al[0]);
    row_frag(x, 2 * kk + 1, ah[1], al[1]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kGroup) {
      float4 bh[kGroup], bl[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        bh[j] = *reinterpret_cast<const float4*>(hi + off + 512 * (j0 + j));
        bl[j] = *reinterpret_cast<const float4*>(lo + off + 512 * (j0 + j));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const bool b_lo = term == 2 ? false : (term == 0) == kBLoFirst;
          const uint32_t(&a)[4] = term == 2 ? ah[h] : (b_lo ? ah[h] : al[h]);
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float4 b = b_lo ? bl[j] : bh[j];
            r3d::mma_tf32(acc[j0 + j], a, bits(h ? b.z : b.x), bits(h ? b.w : b.y));
          }
        }
      }
    }
  }
}

// out[nn] += P T over the rows, for k-steps j < NT: P the accumulator
// tiles p[j] (columns r0 + 8j ..), T the staged rows (tile hi, lo),
// output channels 8nn + .. < d, the passes ordered as above over four
// output n-tiles at a time.
template <int NT>
__device__ __forceinline__ void product_along_rows(float (&out)[8][4], const float (&p)[NT][4],
                                                   const float* hi, const float* lo, int r0,
                                                   int d, const Lane& ln) {
  hi += r0 * kDP;
  lo += r0 * kDP;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ph[4], pl[4];
    acc_frag(p[j], ph, pl);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      if (8 * n0 >= d) break;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int dl = 0; dl < 2; ++dl) {
          const int off = 512 * j + 8 * n0 + ln.row[dl][q];
          bh[q][dl] = bits(hi[off]);
          bl[q][dl] = bits(lo[off]);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], pl, bh[q][0], bh[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], ph, bl[q][0], bl[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], ph, bh[q][0], bh[q][1]);
    }
  }
}

// Mask factors of a lane's accumulator entries of a (query, key) tile:
// rows i_g and i_g + 8, keys col and col + 1 (col = 8j + 2t, a multiple
// of 2 in a 4-key Philox group).  The lane pair (t, t ^ 1) shares one
// group: the even lane draws row i_g's four words, the odd lane row i_g +
// 8's, and they swap halves, so no Philox call is computed twice.
// Returns {(i_g, col), (i_g, col + 1), (i_g + 8, col), (i_g + 8, col + 1)}.
__device__ __forceinline__ float4 row_mask(const r3d::Dropout& drop, int b, int i_g, int col) {
  const bool odd = threadIdx.x & 1;
  const uint4 w = drop.words(b, i_g + (odd ? 8 : 0), col >> 2);
  const uint32_t got0 = __shfl_xor_sync(kFull, odd ? w.x : w.z, 1);
  const uint32_t got1 = __shfl_xor_sync(kFull, odd ? w.y : w.w, 1);
  return make_float4(drop.factor(odd ? got0 : w.x), drop.factor(odd ? got1 : w.y),
                     drop.factor(odd ? w.z : got0), drop.factor(odd ? w.w : got1));
}

// Mask factors of a lane's entries of a (key, query) tile: keys k0 + g and
// k0 + g + 8 (k0 % 16 == 0), queries i0 + 2t and i0 + 2t + 1 (i0 % 8 ==
// 0).  Lane (g, t) draws query i0 + g's words of keys k0 + 4t .. + 3; a
// quad ORs its four nibbles into the 16-key mask of its query, and each
// lane fetches the masks of queries 2t and 2t + 1: one Philox call per
// lane per 8 x 16 tile, none twice.
// Returns {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.  In two
// steps: `col_mask_bits`, the 16-key masks of queries 2t and 2t + 1 (bit r:
// key k0 + r kept), then `col_mask_factors`.
__device__ __forceinline__ uint2 col_mask_bits(const r3d::Dropout& drop, int b, int k0, int i0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint4 w = drop.words(b, i0 + g, (k0 >> 2) + t);
  uint32_t m = (drop.kept(w.x) | drop.kept(w.y) << 1 | drop.kept(w.z) << 2 |
                drop.kept(w.w) << 3) << (4 * t);
  m |= __shfl_xor_sync(kFull, m, 1);
  m |= __shfl_xor_sync(kFull, m, 2);
  return make_uint2(__shfl_sync(kFull, m, 8 * t), __shfl_sync(kFull, m, 8 * t + 4));
}

__device__ __forceinline__ float4 col_mask_factors(uint2 m, float s) {
  const int g = (threadIdx.x & 31) >> 2;
  return make_float4((m.x >> g & 1u) ? s : 0.f, (m.y >> g & 1u) ? s : 0.f,
                     (m.x >> (g + 8) & 1u) ? s : 0.f, (m.y >> (g + 8) & 1u) ? s : 0.f);
}

__device__ __forceinline__ float4 col_mask(const r3d::Dropout& drop, int b, int k0, int i0) {
  return col_mask_factors(col_mask_bits(drop, b, k0, i0), drop.scale);
}

// ---- the bf16 forms (q, k, v bf16: the bf16 encoder) ------------------
// Past D = 64 (attention_wide_bf16.cu, attention_group_bf16.cu) products
// are single bf16 mma.sync.m16n8k16 tiles (common.cuh) with f32 sums;
// tiles and fragments are the f32 forms' in shape (a warp owns 16 rows,
// kChunk-row tiles of the column operands stream through a two-stage
// cp.async ring), in bf16:
//   - a staged tile is kChunk rows x kDP T bf16 channels (T = 2 or 4
//     channel tiles of 64), row r's 16-byte chunk c (channels 8c .. 8c +
//     7) stored at chunk c ^ (r % 8), so that the eight rows an ldmatrix
//     tile reads lie in eight different bank groups;
//   - B fragments come from it by ldmatrix: "along channels" (B of q k^T-
//     like products, ldsm_x4: two n-tiles of 8 rows x one k-step of 16
//     channels) and "along rows" (B of p v-like products, ldsm_x4_trans:
//     one k-step of 16 rows x two n-tiles of 8 channels);
//   - an m16n8 accumulator pair (n-tiles 2s, 2s + 1) is the A operand of
//     the next product's k-step s as it stands, rounded to bf16 pairs
//     (`acc_frag_bf16`): P (or dS) goes from registers to the tensor cores
//     with no shuffle.
// D % 8 == 0 (whole 16-byte chunks).  attention_group_bf16.cu stages
// chunks of channels of a wider row (`stage_cols_bf16`).  At D <= 64 the
// wgmma kernels take `acc_frag_bf16` too (attention_fwd_bf16.cu and
// attention_bwd_bf16.cu), and the forward `load_rows_bf16` for its scaled
// q: wgmma's register A operand is mma.sync's A fragment in each warp.

// Issue the copy of rows [row0, row0 + kR) of a bf16 matrix of n rows,
// `ld` entries apart, into a staged bf16 tile of T channel tiles (64 T
// channels a row): the row's first w entries from src, zeros past them
// and past n.  src may start at any channel that is a multiple of 8 (the
// channel groups of attention_group_bf16.cu).
template <int T = 1, int kR = kChunk>
__device__ __forceinline__ void stage_cols_bf16(const uint16_t* src, int row0, int n, int ld,
                                                int w, uint16_t* dst) {
  static_assert(T == 1 || T == 2 || T == 4, "16-byte chunks per row: a power of two");
  constexpr int kShift = T == 1 ? 3 : (T == 2 ? 4 : 5);  // log2 of a row's 8 T chunks
  for (int e = threadIdx.x; e < kR * (kDP / 8) * T; e += kThreads) {
    const int r = e >> kShift;
    const int c = e & ((1 << kShift) - 1);
    const bool ok = row0 + r < n && 8 * c < w;
    const uint16_t* from = ok ? src + static_cast<size_t>(row0 + r) * ld + 8 * c : src;
    r3d::cp_async16(dst + r * kDP * T + ((c ^ (r & 7)) << 3), from, ok);
  }
}

// The same of an (n, d) bf16 matrix from its first channel.
template <int T = 1, int kR = kChunk>
__device__ __forceinline__ void stage_tile_bf16(const uint16_t* src, int row0, int n, int d,
                                                uint16_t* dst) {
  stage_cols_bf16<T, kR>(src, row0, n, d, d, dst);
}

// A warp's 16 rows [row0, row0 + 16) of an (n, d) bf16 matrix, each entry
// times mul and rounded to bf16 (exact for mul = 1), as the A operand of
// "along channels" products: a[kk] is k-step kk (channels 16kk ..); zeros
// past n and d.
__device__ __forceinline__ void load_rows_bf16(const uint16_t* src, int row0, int n, int d,
                                               float mul, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1);
      const int ch = 16 * kk + 2 * t + 8 * (i >> 1);
      uint32_t w = 0u;
      if (r < n && ch < d) {
        w = *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(r) * d + ch);
        w = r3d::pack_bf16(r3d::bf16_lo(w) * mul, r3d::bf16_hi(w) * mul);
      }
      a[kk][i] = w;
    }
  }
}

// acc[j] += X Y^T over the channels < d, for n-tiles j < NT (NT even): X
// the 16 staged rows r0 .. r0 + 15 of `rows`, Y the staged rows c0 + 8j ..
// of `tile` (both T channel tiles wide; r0 % 16 == 0, c0 % 8 == 0).  A and
// B fragments both come by ldmatrix: A as four 8 x 8 tiles (rows 0-7 and
// 8-15 of channels 16kk .. + 7, then of + 8 .. + 15), B by one ldsm_x4 for
// each n-tile pair j, j + 1: lane l addresses row c0 + 8 (j + l / 16) + l %
// 8 at channel chunk 2 kk + (l / 8) % 2 (stored at that chunk ^ (row %
// 8)), so that b[0], b[1] are n-tile j's two k-halves and b[2], b[3] n-tile
// j + 1's (attention_wide_bf16.cu, attention_group_bf16.cu).
template <int T, int NT>
__device__ __forceinline__ void product_along_channels_wide(float (&acc)[NT][4],
                                                            const uint16_t* rows, int r0,
                                                            const uint16_t* tile, int c0, int d) {
  constexpr int kW = kDP * T;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;  // the ldmatrix tile this lane addresses
  const int rr = lane & 7;
  const uint16_t* arow = rows + (r0 + 8 * (mi & 1) + rr) * kW;
#pragma unroll
  for (int kk = 0; kk < 4 * T; ++kk) {
    if (16 * kk >= d) break;
    uint32_t a[4];
    r3d::ldsm_x4(a, arow + (((2 * kk + (mi >> 1)) ^ rr) << 3));
    const int chunk = 2 * kk + (mi & 1);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int row = c0 + 8 * (j + (mi >> 1)) + rr;
      uint32_t b[4];
      r3d::ldsm_x4(b, tile + row * kW + ((chunk ^ rr) << 3));
      r3d::mma_bf16(acc[j], a, b[0], b[1]);
      r3d::mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// k-step s of an accumulator tile pair (columns 16s .. 16s + 15) as a bf16
// A operand.
template <int NT>
__device__ __forceinline__ void acc_frag_bf16(const float (&p)[NT][4], int s,
                                              uint32_t (&a)[4]) {
  a[0] = r3d::pack_bf16(p[2 * s][0], p[2 * s][1]);
  a[1] = r3d::pack_bf16(p[2 * s][2], p[2 * s][3]);
  a[2] = r3d::pack_bf16(p[2 * s + 1][0], p[2 * s + 1][1]);
  a[3] = r3d::pack_bf16(p[2 * s + 1][2], p[2 * s + 1][3]);
}

// out[nn] += P T over the rows, for the NT / 2 k-steps of the accumulator
// tiles p (columns r0 .. r0 + 8 NT of the staged `tile`, T channel tiles
// wide, P rounded to bf16), output channels 8nn .. < d.
template <int NT, int T = 1>
__device__ __forceinline__ void product_along_rows_bf16(float (&out)[8 * T][4],
                                                        const float (&p)[NT][4],
                                                        const uint16_t* tile, int r0, int d) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int rr = lane & 7;
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    uint32_t a[4];
    acc_frag_bf16<NT>(p, s, a);
    const int row = r0 + 16 * s + 8 * (mi & 1) + rr;
#pragma unroll
    for (int nn = 0; nn < 8 * T; nn += 2) {
      if (8 * nn >= d) break;
      uint32_t b[4];
      r3d::ldsm_x4_trans(b, tile + row * kDP * T + (((nn + (mi >> 1)) ^ rr) << 3));
      r3d::mma_bf16(out[nn], a, b[0], b[1]);
      r3d::mma_bf16(out[nn + 1], a, b[2], b[3]);
    }
  }
}

// Warps per key or query split of a block (S) and the launch shape.  A
// block covers 16 * kWarps / S rows; each of its S splits of warps takes
// kChunk / S columns of every staged tile, and the splits' partial sums
// are merged in split order at the end.  S is the smallest of 1, 2, 4 that
// starts at least four blocks per SM (two rounds of the two blocks an SM
// holds): B = 10, N = 2048 takes 2 (640 blocks), B = 2 takes 4 (256).  On
// the H100 that choice measured fastest for both batches (PERF.md).
inline int splits(int b, int n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int s = 1; s < 4; s *= 2) {
    const int rows = 16 * kWarps / s;
    if (static_cast<long long>(b) * ((n + rows - 1) / rows) >= 4LL * sms) return s;
  }
  return 4;
}

// Warp `warp`'s lane-private area of `count` floats in shared memory, where
// the S warps of a row group leave their partials for the group's first
// warp to merge.
__device__ __forceinline__ float* lane_slot(float* smem, int warp, int count) {
  return smem + (warp * 32 + (threadIdx.x & 31)) * count;
}

// ---- the f32 forward's one pass (attention_fwd.cu, attention_wide.cu) ----

// Step 2 of a key tile: the online softmax in f32 registers over the
// warp's scores s (NT n-tiles from key0; rows g (e = 0, 1) and g + 8 (e =
// 2, 3)): the row max across the quad, s <- exp(s - m_new) (0 on masked
// keys) times the mask where kDropout, the row sums l (undropped) and the
// output o (NO n-tiles of 8 channels) rescaled by exp(m - m_new).
template <bool kDropout, int NT, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&o)[NO][4], const r3d::Dropout& drop,
                                               int b, int row_g, int key0, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    mb[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no key yet: everything stays 0
    const float f = exp2_fast((m[r] - mb[r]) * kLog2e);  // 0 while m = -inf
    m[r] = mx[r];
    l[r] *= f;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      o[nn][2 * r] *= f;
      o[nn][2 * r + 1] *= f;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_fast((s[j][e] - mb[e >> 1]) * kLog2e);  // 0 on masked keys
      l[e >> 1] += s[j][e];
    }
    if constexpr (kDropout) {
      // l above stays undropped; the accumulator takes the masked tile
      const float4 f = row_mask(drop, b, row_g, key0 + 8 * j + 2 * t);
      s[j][0] *= f.x;
      s[j][1] *= f.y;
      s[j][2] *= f.z;
      s[j][3] *= f.w;
    }
  }
}

// The end of a block: the S splits of each row group merged in split order
// (S > 1), then y = o / l over the warp's rows (channels < w, rows ld
// floats apart) and, where lse is not null, lse = m + log l.
template <int S, int NO>
__device__ __forceinline__ void finish_rows(float* smem, float (&o)[NO][4], float (&m)[2],
                                            float (&l)[2], float* __restrict__ y,
                                            float* __restrict__ lse, size_t base, int b, int n,
                                            int w, int ld, int row0, int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if constexpr (S > 1) {
    // merge the S splits of each row group, in split order
    constexpr int kSlot = 4 * NO + 4;  // o, m, l
    __syncthreads();                   // every warp is done with the ring
    float* mine = lane_slot(smem, warp, kSlot);
#pragma unroll
    for (int nn = 0; nn < NO; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * nn + e] = o[nn][e];
    mine[4 * NO] = m[0];
    mine[4 * NO + 1] = m[1];
    mine[4 * NO + 2] = l[0];
    mine[4 * NO + 3] = l[1];
    __syncthreads();
    if (warp % S != 0) return;
    float mm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(smem, warp + sp, kSlot);
      mm[0] = fmaxf(mm[0], other[4 * NO]);
      mm[1] = fmaxf(mm[1], other[4 * NO + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = 0.f;
#pragma unroll
      for (int nn = 0; nn < NO; ++nn) o[nn][2 * r] = o[nn][2 * r + 1] = 0.f;
    }
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(smem, warp + sp, kSlot);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float f = other[4 * NO + r] == -INFINITY
                            ? 0.f
                            : exp2_fast((other[4 * NO + r] - mm[r]) * kLog2e);
        l[r] += f * other[4 * NO + 2 + r];
#pragma unroll
        for (int nn = 0; nn < NO; ++nn) {
          o[nn][2 * r] += f * other[4 * nn + 2 * r];
          o[nn][2 * r + 1] += f * other[4 * nn + 2 * r + 1];
        }
      }
    }
    m[0] = mm[0];
    m[1] = mm[1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l[r];
    float* yr = y + base + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      const int ch = 8 * nn + 2 * t;
      if (ch < w)
        *reinterpret_cast<float2*>(yr + ch) =
            make_float2(o[nn][2 * r] * inv, o[nn][2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0) lse[static_cast<size_t>(b) * n + row] = m[r] + logf(l[r]);
  }
}

// ---- the bf16 forward's two passes (attention_fwd_bf16.cu, attention_wide_bf16.cu)

// Scores of keys past n (a ragged last tile) to -inf.
template <int NT>
__device__ __forceinline__ void mask_ragged_keys(float (&s)[NT][4], int key0, int n, int t) {
  if (key0 + 8 * NT <= n) return;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + 2 * t + (e & 1) >= n) s[j][e] = -INFINITY;
}

// Pass 1 over a key tile: the running row max m across the quad and the
// lane's part of l, rescaled by exp(m - m_new) when the max grows.
template <int NT>
__device__ __forceinline__ void row_stats(const float (&s)[NT][4], float (&m)[2],
                                          float (&l)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    mb[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no key yet: l stays 0
    l[r] *= exp2_fast((m[r] - mb[r]) * kLog2e);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += exp2_fast((s[j][e] - mb[e >> 1]) * kLog2e);
}

// The end of pass 1: l summed across the quad, then the S splits' (m, l)
// of each row group merged in split order by every warp of the group, so
// all of them hold the same bits.  `slots` is shared memory apart from the
// ring.
template <int S>
__device__ __forceinline__ void merge_stats(float* slots, float (&m)[2], float (&l)[2],
                                            int warp) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if constexpr (S > 1) {
    float* mine = lane_slot(slots, warp, 4);
    mine[0] = m[0];
    mine[1] = m[1];
    mine[2] = l[0];
    mine[3] = l[1];
    __syncthreads();
    const int first = warp - warp % S;
    float mm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(slots, first + sp, 4);
      mm[0] = fmaxf(mm[0], other[0]);
      mm[1] = fmaxf(mm[1], other[1]);
    }
    float ll[2] = {0.f, 0.f};
#pragma unroll
    for (int sp = 0; sp < S; ++sp) {
      const float* other = lane_slot(slots, first + sp, 4);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ll[r] += other[r] == -INFINITY ? 0.f
                                       : exp2_fast((other[r] - mm[r]) * kLog2e) * other[2 + r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mm[r];
      l[r] = ll[r];
    }
  }
}

// The S splits' partial sums (NO n-tiles of 8 channels) of each row group
// added in split order (S > 1) by the group's first warp, which writes rows
// row0 + g, row0 + g + 8 of out (< n, channels < d; rows ld floats apart)
// times mul and returns true; the group's other warps return false.
template <int S, int NO>
__device__ __forceinline__ bool store_rows(float* smem, float (&acc)[NO][4],
                                           float* __restrict__ out, size_t base, int row0, int n,
                                           int d, int ld, float mul, int warp, int g, int t) {
  if constexpr (S > 1) {
    __syncthreads();  // every warp is done with the ring
    float* mine = lane_slot(smem, warp, 4 * NO);
#pragma unroll
    for (int nn = 0; nn < NO; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * nn + e] = acc[nn][e];
    __syncthreads();
    if (warp % S != 0) return false;
#pragma unroll 1  // one split's partials live at a time (registers)
    for (int sp = 1; sp < S; ++sp) {
      const float* other = lane_slot(smem, warp + sp, 4 * NO);
#pragma unroll
      for (int nn = 0; nn < NO; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] += other[4 * nn + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* o = out + base + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      const int ch = 8 * nn + 2 * t;
      if (ch < d)
        *reinterpret_cast<float2*>(o + ch) = make_float2(acc[nn][2 * r] * mul,
                                                         acc[nn][2 * r + 1] * mul);
    }
  }
  return true;
}

// The end of pass 2: y = o summed over the splits (`store_rows`), then
// lse = m + log l.
template <int S, int NO>
__device__ __forceinline__ void finish_sums(float* smem, float (&o)[NO][4], const float (&m)[2],
                                            const float (&l)[2], float* __restrict__ y,
                                            float* __restrict__ lse, size_t base, int b, int n,
                                            int d, int ld, int row0, int warp, int g, int t) {
  if (!store_rows<S>(smem, o, y, base, row0, n, d, ld, 1.f, warp, g, t) || lse == nullptr ||
      t != 0)
    return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < n) lse[static_cast<size_t>(b) * n + row] = m[r] + logf(l[r]);
  }
}

// The bf16 backward's pre-pass (attention_bwd_bf16.cu,
// attention_wide_bf16.cu, attention_group_bf16.cu), one warp per row:
// Delta = rowsum(bf16(dY) * Y), bf16(dY) and the forward's scaled q, bf16(q
// * qscale), any d (d even).  A template, so a source that does not launch
// it compiles none.
template <int = 0>
__global__ void attn_bwd_prep_bf16_kernel(const uint16_t* __restrict__ q,
                                          const float* __restrict__ dy,
                                          const float* __restrict__ y, float* __restrict__ delta,
                                          uint16_t* __restrict__ qs, uint16_t* __restrict__ dyb,
                                          int rows, int d, float qscale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int ch = 2 * lane; ch < d; ch += 64) {
    const float2 a = *reinterpret_cast<const float2*>(dy + off + ch);
    const float2 c = *reinterpret_cast<const float2*>(y + off + ch);
    const uint32_t w = r3d::pack_bf16(a.x, a.y);
    *reinterpret_cast<uint32_t*>(dyb + off + ch) = w;
    s = fmaf(r3d::bf16_lo(w), c.x, s);
    s = fmaf(r3d::bf16_hi(w), c.y, s);
    const uint32_t x = *reinterpret_cast<const uint32_t*>(q + off + ch);
    *reinterpret_cast<uint32_t*>(qs + off + ch) =
        r3d::pack_bf16(r3d::bf16_lo(x) * qscale, r3d::bf16_hi(x) * qscale);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

}  // namespace r3d_attn
