// Single-head attention forward and backward on f32 q, k, v at head widths
// D > 64, D % 4 == 0 (r3d_attn_wide_tf32_fwd, r3d_attn_wide_tf32_bwd): the
// shapes the tuned f32 kernels (attention_fwd.cu, attention_bwd.cu; D <= 64)
// do not take, on the same 3xTF32 tensor-core products.  The wrapper
// zero-pads an unaligned D to a multiple of 4 (exact); bf16 q, k, v past 64
// run attention_wide_bf16.cu and attention_group_bf16.cu.
//
// Replaces the TPU kernels r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (:54, via _fwd_impl :160) and _attn_bwd_kernel (:78, via
// _bwd_impl :190) on f32 operands past 64 channels (the pretraining
// network's 128-wide head, r3dfsseg_tpu/config.py:60; a user's
// `--output_dim` above 64), which run their products at Precision.HIGHEST
// (:48-51).  The function is the tuned f32 kernels' (ops/cuda_attention.py's
// plain versions): the same Philox mask (philox.cuh), q multiplied by scale
// = 1 / tau, y = softmax(s) * M v with lse = m + log l; backward Delta =
// rowsum(dY * Y), P = exp(s - lse), dQ = dS K * scale, dK = dS^T q * scale
// from the unscaled q, dV = Pd^T dY; f32 sums throughout, every product a
// 3xTF32 mma.sync.m16n8k8 (common.cuh: a_lo b_hi + a_hi b_lo + a_hi b_hi,
// f32-level accuracy, where one tf32 pass misses the gates).
//
// The design: the tuned kernels' tiles (attention.cuh; 4 warps a block, a
// warp owns 16 rows, 64-row column tiles through a two-stage cp.async ring,
// each arrived stage split once by the block into tf32 hi in place and lo
// in a second buffer, S >= 2 splits of the columns merged in split order:
// by B x N in the forward, two in the backward),
// with what f32 past 64 channels does not fit:
//   - registers: a warp's 16 rows are not held in registers (16 x 128 f32
//     is 64 registers a lane, beside a 16 x 128 accumulator of 64 more):
//     the block's own rows are staged in the ring beside the column tile,
//     chunk by chunk, and read as A fragments from shared memory;
//   - shared memory: f32 doubles every byte of the bf16 tiles, and the hi /
//     lo split doubles them again, so the contraction over D (S = q k^T;
//     dPd = dY v^T) is summed in chunks, k-steps in channel order into one
//     accumulator: 64 channels in the forward (the tuned tile), 32 in the
//     backward, whose stages hold four operands (a 32-channel staged tile:
//     the tuned layout at half the row, the same swizzle);
//   - the output product's operand (V; K in dQ; dY, then q, in dK/dV) is
//     the group's slice of at most kGroupW = 128 channels of the column
//     tile, staged once per column tile (with its second chunk) as two raw
//     64-channel tiles and split at fragment load, as P is;
//   - past 128 channels the outputs go in groups of 128 along the grid's z
//     axis (attention_group_bf16.cu's structure): every group sums S over
//     all of D in the same chunk order with the same code, so its m, l and P
//     are the other groups' bit for bit and its slice of y and of the
//     gradients is what one block would write; group 0 alone writes lse.
// Why 128 and not 64 channels a group: a 16 x 128 accumulator is 64
// registers, which the kernels hold beside their scores (ptxas -v, PERF.md
// section 6); 64-channel groups would repeat S once more per 64 channels
// ((G + 1) N^2 D forward products against 2 in the bound: 1.5x at D = 128),
// where 128-channel groups repeat nothing up to D = 128.
// The forward is one pass (the tuned f32 forward's online softmax).  The
// backward is a Delta pre-pass and one launch of two kinds of block:
// dK/dV blocks, which sum dV and dK in two sweeps over the queries, one 16
// x 128 accumulator at a time (attention_wide_bf16.cu's register budget),
// and dQ blocks.  In (N x N x D) products a cloud takes G + 1 in the
// forward (S per group, then P V over its slice) and 5 G + 3 in the
// backward (dK/dV: S, dV; S, dPd, dK; dQ: S, dPd, dQ; G groups), against 2
// and 5 in the bound: 2 and 8 at D <= 128.  No float atomics and a fixed
// order of sums: a call repeats bit for bit.  Shared memory: 92-105 KB a
// block, two blocks of 4 warps an SM (64-channel chunks in the backward
// would fit one).
//
// What bounds it on the H100: the products, 4 B N^2 D operations forward
// and 10 B N^2 D backward, each run as 3 tf32 tensor-core passes against
// 495 TFLOP/s: 0.156 ms and 0.390 ms at a training step's two calls (B = 10
// + 2, N = 2048, D = 128); the bytes (q, k, v, y, dy, dq, dk, dv f32) are
// below.  As for the tuned kernels, the instructions around each mma.sync
// set the pace, not the tensor cores: a chunk step's staging and hi / lo
// split, the fragment loads, the split of P and of the output operand at
// load, the softmax between the products (PERF.md, section 6).  So the
// staging and split loops have fixed trip counts and the steps walk their
// chunks with no division.
#include <algorithm>
#include <cmath>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace r3d_attn;

constexpr int kFwdCh = 64;                  // channels of a forward contraction chunk
constexpr int kBwdCh = 32;                  // of a backward one
constexpr int kGroupTiles = 2;              // 64-channel tiles of an output group
constexpr int kGroupW = kDP * kGroupTiles;  // its channels
constexpr int kNO = 8 * kGroupTiles;        // output n-tiles of a warp's accumulator

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Issue the copy of rows [row0, row0 + kR) of an f32 matrix of n rows, `ld`
// floats apart, into a staged tile of kR rows x W floats (W = 32 or 64;
// the tuned layout, 16-byte chunk c of row r at chunk c ^ swz(r)): the
// row's first w floats from src (w % 4 == 0), zeros past them and past n.
// A thread copies chunk c = tid % (W / 4) of rows tid / (W / 4) + kStep i,
// kStep = kThreads / (W / 4) a multiple of 8, so its swizzled column and
// its pointers' steps are fixed for the call (attention.cuh `stage_tile`
// gives each thread the same chunks).
template <int W, int kR>
__device__ __forceinline__ void stage_cols(const float* src, int row0, int n, int ld, int w,
                                           float* dst) {
  constexpr int kC = W / 4;              // 16-byte chunks a row
  constexpr int kStep = kThreads / kC;   // rows one pass of the block covers
  static_assert(kStep % 8 == 0 && kR % kStep == 0, "whole passes, one swizzle a thread");
  const int c = threadIdx.x % kC;
  const int r = threadIdx.x / kC;
  const bool col_ok = 4 * c < w;
  const float* from = src + static_cast<size_t>(row0 + r) * ld + 4 * c;
  dst += r * W + ((c ^ swz(r)) << 2);
#pragma unroll
  for (int i = 0; i < kR / kStep; ++i) {
    const bool ok = col_ok && row0 + r + kStep * i < n;
    r3d::cp_async16(dst + kStep * i * W, ok ? from + static_cast<size_t>(kStep * i) * ld : src,
                    ok);
  }
}

// hi = tf32(x * mul) in place, lo = tf32(x * mul - hi) into `lo`, for the
// kCount floats of an arrived stage: attention.cuh `split_tiles` with its
// trip count fixed.
template <int kCount>
__device__ __forceinline__ void split_stage(float* hi, float* lo, float mul) {
  static_assert(kCount % (4 * kThreads) == 0, "whole passes of the block");
  hi += 4 * threadIdx.x;
  lo += 4 * threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCount / (4 * kThreads); ++i) {
    const float4 x = ld4(hi + 4 * kThreads * i);
    const float xs[4] = {x.x * mul, x.y * mul, x.z * mul, x.w * mul};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r3d::split_tf32(xs[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + 4 * kThreads * i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + 4 * kThreads * i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The group's slice of a column tile: rows [row0, row0 + kChunk), channels
// [0, w) of src as two raw 64-channel tiles (the second only when w > 64).
__device__ __forceinline__ void stage_group(const float* src, int row0, int n, int ld, int w,
                                            float* dst) {
  stage_cols<kDP, kChunk>(src, row0, n, ld, w, dst);
  if (w > kDP) stage_cols<kDP, kChunk>(src + kDP, row0, n, ld, w - kDP, dst + kTileF);
}

// A lane's offsets into a W-channel staged tile "along channels" (as
// attention.cuh `lane_offsets` for the 64-channel one): row 8j + g,
// channels 16kk + 4t .. + 3 at 8 W j + 16kk + ch[kk & 1].
template <int W>
__device__ __forceinline__ void chunk_offsets(int (&ch)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = (lane & 3) ^ swz(g);
  const int base = g * W + 4 * (c & 3);
  ch[0] = base + 16 * (c >> 2);
  ch[1] = base - 16 * (c >> 2);
}

// acc[j] += X Y^T over a chunk's channels < w, for n-tiles j < NT: X the
// 16 staged rows xr0 .. xr0 + 15 of (xh, xl), Y the staged rows yr0 + 8j +
// g of (yh, yl), both W-channel tiles split into hi and lo.  The A
// fragments are the float4 of rows g and g + 8 at the lane's channels (the
// tuned `row_frag` order); the terms as attention.cuh
// `product_along_channels` orders them (kBLoFirst for the roles swapped).
template <int NT, bool kBLoFirst, int W>
__device__ __forceinline__ void chunk_product(float (&acc)[NT][4], const float* xh,
                                              const float* xl, int xr0, const float* yh,
                                              const float* yl, int yr0, int w,
                                              const int (&ch)[2]) {
  constexpr int kGroup = NT < 4 ? NT : 4;
  xh += xr0 * W;
  xl += xr0 * W;
  yh += yr0 * W;
  yl += yr0 * W;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    if (16 * kk >= w) break;
    const int off = 16 * kk + ch[kk & 1];
    const float4 uh = ld4(xh + off), wh = ld4(xh + off + 8 * W);
    const float4 ul = ld4(xl + off), wl = ld4(xl + off + 8 * W);
    const uint32_t ah[2][4] = {{bits(uh.x), bits(wh.x), bits(uh.y), bits(wh.y)},
                               {bits(uh.z), bits(wh.z), bits(uh.w), bits(wh.w)}};
    const uint32_t al[2][4] = {{bits(ul.x), bits(wl.x), bits(ul.y), bits(wl.y)},
                               {bits(ul.z), bits(wl.z), bits(ul.w), bits(wl.w)}};
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kGroup) {
      float4 bh[kGroup], bl[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        bh[j] = ld4(yh + off + 8 * W * (j0 + j));
        bl[j] = ld4(yl + off + 8 * W * (j0 + j));
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

// out[nn] += P T over the rows, for k-steps j < NT: P the accumulator tiles
// p[j] (columns r0 + 8j ..), T the group's raw tiles (output channels 8nn +
// .. < w, 64 a tile), each entry split into hi and lo as it is loaded; the
// passes ordered as attention.cuh `product_along_rows` orders them.
template <int NT>
__device__ __forceinline__ void group_product(float (&out)[kNO][4], const float (&p)[NT][4],
                                              const float* tile, int r0, int w, const Lane& ln) {
  tile += r0 * kDP;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ph[4], pl[4];
    acc_frag(p[j], ph, pl);
#pragma unroll
    for (int n0 = 0; n0 < kNO; n0 += 4) {
      if (8 * n0 >= w) break;
      const float* tt = tile + (n0 / 8) * kTileF + 512 * j + 8 * (n0 % 8);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int dl = 0; dl < 2; ++dl) r3d::split_tf32(tt[ln.row[dl][q]], bh[q][dl], bl[q][dl]);
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], pl, bh[q][0], bh[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], ph, bl[q][0], bl[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) r3d::mma_tf32(out[n0 + q], ph, bh[q][0], bh[q][1]);
    }
  }
}

// A block's place: its cloud, its group's first channel c0 and width w,
// and the chunks of kCh channels that span d.
struct Place {
  int b, c0, w, chunks;
  size_t base;
  __device__ Place(int n, int d, int kCh)
      : b(blockIdx.y), c0(blockIdx.z * kGroupW), w(min(kGroupW, d - c0)),
        chunks((d + kCh - 1) / kCh), base(static_cast<size_t>(blockIdx.y) * n * d) {}
};

// A step of the ring: chunk h of column tile c, the i-th step, in ring
// slot i & 1; `next` walks the chunks of a tile, then the tiles, with no
// division by the chunk count.
struct Step {
  int i, c, h;
  __device__ Step next(int chunks) const {
    return h + 1 == chunks ? Step{i + 1, c + 1, 0} : Step{i + 1, c, h + 1};
  }
};

// ---- forward ------------------------------------------------------------
// A forward stage: the K chunk of a key tile, then the block's rows of the
// q chunk; after the two stages, the lo halves of the current one, then
// the group's V tiles.
__host__ __device__ constexpr int fwd_stage(int s) {
  return (kChunk + 16 * kWarps / s) * kFwdCh;
}
constexpr size_t fwd_smem(int s) {
  return sizeof(float) * (3 * fwd_stage(s) + kGroupTiles * kTileF);
}

template <int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_tf32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ y,
                          float* __restrict__ lse, int n, int d, float scale,
                          r3d::Dropout drop) {
  static_assert(S >= 2, "a warp's keys of a tile are one pass of at most 32");
  constexpr int kCh = kFwdCh;
  constexpr int kRows = 16 * kWarps / S;  // queries of a block
  constexpr int kCols = kChunk / S;       // keys of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kKc = kChunk * kCh;       // floats of a staged K chunk
  constexpr int kStage = fwd_stage(S);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* lo = ring + 2 * kStage;
  float* vt = lo + kStage;
  const int warp = threadIdx.x >> 5;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  int ch[2];
  chunk_offsets<kCh>(ch);
  const int r0 = 16 * (warp / S);  // the warp's first row in the block's q chunk
  const int row0 = blockIdx.x * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first key of the warp
  const Place at(n, d, kCh);
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step x: chunk x.h of key tile x.c, and with the second chunk the
  // tile's V slice, when every warp is done with the previous tile's
  auto stage = [&](const Step& x) {
    const int cc = x.h * kCh;
    float* st = ring + (x.i & 1) * kStage;
    stage_cols<kCh, kChunk>(k + at.base + cc, x.c * kChunk, n, d, d - cc, st);
    stage_cols<kCh, kRows>(q + at.base + cc, blockIdx.x * kRows, n, d, d - cc, st + kKc);
    if (x.h == 1) stage_group(v + at.base + at.c0, x.c * kChunk, n, d, at.w, vt);
  };

  stage(Step{0, 0, 0});
  r3d::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kNO][4], s[NT][4];
  zero(o);
  zero(s);
  for (Step x{0, 0, 0}; x.i < steps; x = x.next(at.chunks)) {
    float* st = ring + (x.i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();  // step x has arrived; every warp is done with the one before
    if (x.i + 1 < steps) stage(x.next(at.chunks));
    r3d::cp_async_commit();
    split_stage<kKc>(st, lo, 1.f);
    split_stage<kRows * kCh>(st + kKc, lo + kKc, scale);  // q * scale, as the tuned forward
    __syncthreads();
    chunk_product<NT, false, kCh>(s, st + kKc, lo + kKc, r0, st, lo, cb, d - x.h * kCh,
                                  ch);  // S
    if (x.h != at.chunks - 1) continue;
    const int key0 = x.c * kChunk + cb;
    mask_ragged_keys<NT>(s, key0, n, t);
    online_softmax<kDropout>(s, m, l, o, drop, at.b, row0 + g, key0, t);
    group_product<NT>(o, s, vt, cb, at.w, ln);  // O += P V
    zero(s);
  }
  finish_rows<S>(smem, o, m, l, y + at.c0, blockIdx.z == 0 ? lse : nullptr, at.base, at.b, n,
                 at.w, d, row0, warp, g, t);
}

// ---- backward -----------------------------------------------------------
// Delta = rowsum(dY * Y): one warp per row.
__global__ void attn_wide_tf32_delta_kernel(const float* __restrict__ dy,
                                            const float* __restrict__ y,
                                            float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = dy + static_cast<size_t>(row) * d;
  const float* c = y + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int ch = lane; ch < d; ch += 32) s = fmaf(a[ch], c[ch], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// A backward stage, in both kinds of block: two chunks of the block's rows
// and two of a column tile.  dQ: the K and V chunks of a key tile, then
// the block's rows of the q and dY chunks; after the two stages, the lo
// halves of the current one, then the group's K tiles.  dK/dV: the block's
// rows of the K and V chunks, then the q and dY chunks of a query tile;
// after the lo halves, the group's dY (sweep 1) or q (sweep 2) tiles, then
// the query tile's lse and Delta.
__host__ __device__ constexpr int bwd_stage(int s) {
  return 2 * (kChunk + 16 * kWarps / s) * kBwdCh;
}
constexpr size_t dq_smem(int s) {
  return sizeof(float) * (3 * bwd_stage(s) + kGroupTiles * kTileF);
}
constexpr size_t dkdv_smem(int s) { return dq_smem(s) + sizeof(float) * 2 * kChunk; }

// (a) dV, then dK, of the group's channels of a warp's 16 keys, in row
// block bx.  Score tiles are (key, query).
template <int S, bool kDropout>
__device__ __forceinline__ void dkdv_block(int bx, float* smem, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ dy,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           float* __restrict__ dk, float* __restrict__ dv, int n,
                                           int d, float scale, const r3d::Dropout& drop) {
  static_assert(S >= 2, "a warp's queries of a tile are one pass of at most 32");
  constexpr int kCh = kBwdCh;
  constexpr int kRows = 16 * kWarps / S;  // keys of a block
  constexpr int kCols = kChunk / S;       // queries of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kRc = kRows * kCh;        // floats of the block's rows of a chunk
  constexpr int kQc = kChunk * kCh;       // of a query tile's chunk
  constexpr int kStage = bwd_stage(S);
  float* ring = smem;
  float* lo = ring + 2 * kStage;
  float* gt = lo + kStage;
  float* stats = gt + kGroupTiles * kTileF;  // lse, then Delta
  const int warp = threadIdx.x >> 5;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  int ch[2];
  chunk_offsets<kCh>(ch);
  const int r0 = 16 * (warp / S);
  const int key0 = bx * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first query of the warp
  const Place at(n, d, kCh);
  const float* lse_b = lse + static_cast<size_t>(at.b) * n;
  const float* delta_b = delta + static_cast<size_t>(at.b) * n;
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step x: chunk x.h of the block's keys and of query tile x.c (K and q;
  // sweep 2 also V and dY), and with the second chunk the tile's group
  // slice of dY (sweep 1) or q (sweep 2), its lse and Delta (zeros past n,
  // whose terms then vanish: dY = 0 and Delta = 0 there)
  auto stage = [&](const Step& x, bool sweep2) {
    const int c = x.c, cc = x.h * kCh;
    float* st = ring + (x.i & 1) * kStage;
    stage_cols<kCh, kRows>(k + at.base + cc, bx * kRows, n, d, d - cc, st);
    stage_cols<kCh, kChunk>(q + at.base + cc, c * kChunk, n, d, d - cc, st + 2 * kRc);
    if (sweep2) {
      stage_cols<kCh, kRows>(v + at.base + cc, bx * kRows, n, d, d - cc, st + kRc);
      stage_cols<kCh, kChunk>(dy + at.base + cc, c * kChunk, n, d, d - cc, st + 2 * kRc + kQc);
    }
    if (x.h != 1) return;
    stage_group((sweep2 ? q : dy) + at.base + at.c0, c * kChunk, n, d, at.w, gt);
    static_assert(kThreads == 2 * kChunk, "one thread per lse and Delta entry");
    const int e = threadIdx.x;
    const float* src = e < kChunk ? lse_b : delta_b;
    const int row = c * kChunk + (e & (kChunk - 1));
    r3d::cp_async4(stats + e, row < n ? src + row : src, row < n);
  };
  // split step i's stage: K rows, V rows (sweep 2), q * scale, dY (sweep 2)
  auto split = [&](float* st, bool sweep2) {
    split_stage<kRc>(st, lo, 1.f);
    if (sweep2) split_stage<kRc>(st + kRc, lo + kRc, 1.f);
    split_stage<kQc>(st + 2 * kRc, lo + 2 * kRc, scale);  // q * scale, as the forward
    if (sweep2) split_stage<kQc>(st + 2 * kRc + kQc, lo + 2 * kRc + kQc, 1.f);
  };
  float acc[kNO][4];
  float s[NT][4], dp[NT][4];

  // 1. dV = Pd^T dY
  stage(Step{0, 0, 0}, false);
  r3d::cp_async_commit();
  zero(acc);
  zero(s);
  for (Step x{0, 0, 0}; x.i < steps; x = x.next(at.chunks)) {
    float* st = ring + (x.i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (x.i + 1 < steps) stage(x.next(at.chunks), false);
    r3d::cp_async_commit();
    split(st, false);
    __syncthreads();
    chunk_product<NT, true, kCh>(s, st, lo, r0, st + 2 * kRc, lo + 2 * kRc, cb, d - x.h * kCh,
                                 ch);  // S^T
    if (x.h != at.chunks - 1) continue;
    const int c = x.c;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(stats + cb + 8 * j + 2 * t);
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = col_mask(drop, at.b, key0, c * kChunk + cb + 8 * j);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e) * fs[e];  // Pd^T
    }
    group_product<NT>(acc, s, gt, cb, at.w, ln);  // dV += Pd^T dY
    zero(s);
  }
  store_rows<S>(smem, acc, dv + at.c0, at.base, key0, n, at.w, d, 1.f, warp, g, t);

  // 2. dK = dS^T q * scale
  __syncthreads();  // every warp is done with the ring and the merge's slots
  stage(Step{0, 0, 0}, true);
  r3d::cp_async_commit();
  zero(acc);
  zero(dp);
  for (Step x{0, 0, 0}; x.i < steps; x = x.next(at.chunks)) {
    float* st = ring + (x.i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (x.i + 1 < steps) stage(x.next(at.chunks), true);
    r3d::cp_async_commit();
    split(st, true);
    __syncthreads();
    const int w = d - x.h * kCh;
    chunk_product<NT, true, kCh>(s, st, lo, r0, st + 2 * kRc, lo + 2 * kRc, cb, w, ch);  // S^T
    chunk_product<NT, true, kCh>(dp, st + kRc, lo + kRc, r0, st + 2 * kRc + kQc,
                            lo + 2 * kRc + kQc, cb, w, ch);  // dPd^T
    if (x.h != at.chunks - 1) continue;
    const int c = x.c;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(stats + cb + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(stats + kChunk + cb + 8 * j + 2 * t);
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = col_mask(drop, at.b, key0, c * kChunk + cb + 8 * j);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_fast((s[j][e] - ((e & 1) ? ls.y : ls.x)) * kLog2e);
        dp[j][e] = pe * (dp[j][e] * fs[e] - ((e & 1) ? dl.y : dl.x));  // dS^T
      }
    }
    group_product<NT>(acc, dp, gt, cb, at.w, ln);  // dK += dS^T q
    zero(s);
    zero(dp);
  }
  store_rows<S>(smem, acc, dk + at.c0, at.base, key0, n, at.w, d, scale, warp, g, t);
}

// (b) dQ of the group's channels of a warp's 16 queries, in row block bx.
// Score tiles are (query, key).
template <int S, bool kDropout>
__device__ __forceinline__ void dq_block(int bx, float* smem, const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dy,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ dq,
                                         int n, int d, float scale, const r3d::Dropout& drop) {
  static_assert(S >= 2, "a warp's keys of a tile are one pass of at most 32");
  constexpr int kCh = kBwdCh;
  constexpr int kRows = 16 * kWarps / S;  // queries of a block
  constexpr int kCols = kChunk / S;       // keys of a tile per warp
  constexpr int NT = kCols / 8;
  constexpr int kKc = kChunk * kCh;       // floats of a key tile's chunk
  constexpr int kRc = kRows * kCh;        // of the block's rows of a chunk
  constexpr int kStage = bwd_stage(S);
  float* ring = smem;
  float* lo = ring + 2 * kStage;
  float* kg = lo + kStage;
  const int warp = threadIdx.x >> 5;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  int ch[2];
  chunk_offsets<kCh>(ch);
  const int r0 = 16 * (warp / S);
  const int row0 = bx * kRows + r0;
  const int cb = (warp % S) * kCols;  // tile-relative first key of the warp
  const Place at(n, d, kCh);
  const int steps = (n + kChunk - 1) / kChunk * at.chunks;

  // step x: chunk x.h of key tile x.c (K, V) and of the block's rows (q,
  // dY), and with the second chunk the tile's group slice of K
  auto stage = [&](const Step& x) {
    const int c = x.c, cc = x.h * kCh;
    float* st = ring + (x.i & 1) * kStage;
    stage_cols<kCh, kChunk>(k + at.base + cc, c * kChunk, n, d, d - cc, st);
    stage_cols<kCh, kChunk>(v + at.base + cc, c * kChunk, n, d, d - cc, st + kKc);
    stage_cols<kCh, kRows>(q + at.base + cc, bx * kRows, n, d, d - cc, st + 2 * kKc);
    stage_cols<kCh, kRows>(dy + at.base + cc, bx * kRows, n, d, d - cc,
                           st + 2 * kKc + kRc);
    if (x.h == 1) stage_group(k + at.base + at.c0, c * kChunk, n, d, at.w, kg);
  };

  stage(Step{0, 0, 0});
  r3d::cp_async_commit();
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lq[r] = row < n ? lse[static_cast<size_t>(at.b) * n + row] : 0.f;
    dl[r] = row < n ? delta[static_cast<size_t>(at.b) * n + row] : 0.f;
  }
  float acc[kNO][4];
  float s[NT][4], dp[NT][4];
  zero(acc);
  zero(s);
  zero(dp);
  for (Step x{0, 0, 0}; x.i < steps; x = x.next(at.chunks)) {
    float* st = ring + (x.i & 1) * kStage;
    r3d::cp_async_wait_all();
    __syncthreads();
    if (x.i + 1 < steps) stage(x.next(at.chunks));
    r3d::cp_async_commit();
    split_stage<2 * kKc>(st, lo, 1.f);
    split_stage<kRc>(st + 2 * kKc, lo + 2 * kKc, scale);  // q * scale, as the forward
    split_stage<kRc>(st + 2 * kKc + kRc, lo + 2 * kKc + kRc, 1.f);
    __syncthreads();
    const int w = d - x.h * kCh;
    chunk_product<NT, false, kCh>(s, st + 2 * kKc, lo + 2 * kKc, r0, st, lo, cb, w, ch);  // S
    chunk_product<NT, false, kCh>(dp, st + 2 * kKc + kRc, lo + 2 * kKc + kRc, r0, st + kKc,
                             lo + kKc, cb, w, ch);  // dPd
    if (x.h != at.chunks - 1) continue;
    const int j0 = x.c * kChunk + cb;
    const bool ragged = j0 + kCols > n;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kDropout) f = row_mask(drop, at.b, row0 + g, j0 + 8 * j + 2 * t);
      const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_fast((s[j][e] - lq[e >> 1]) * kLog2e);
        // a key past n has zero K and V, but exp(0 - lse) may overflow
        if (ragged && j0 + 8 * j + 2 * t + (e & 1) >= n) pe = 0.f;
        s[j][e] = pe * (dp[j][e] * fs[e] - dl[e >> 1]);  // dS
      }
    }
    group_product<NT>(acc, s, kg, cb, at.w, ln);  // dQ += dS K
    zero(s);
    zero(dp);
  }
  store_rows<S>(smem, acc, dq + at.c0, at.base, row0, n, at.w, d, scale, warp, g, t);
}

// The backward's two kinds of block in one launch: row blocks [0, X) of
// grid.x = 2 X sum dK and dV, [X, 2 X) dQ.  The two take the same
// shared memory and threads and need nothing from each other, so the
// launch's last wave mixes them (at a training step's B = 10, 1280 blocks
// on 264 resident ones, where two launches of 640 each end on a wave 0.42
// full); the dK/dV blocks, the longer, start first.
template <int S, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_tf32_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dy,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int d, float scale,
                          r3d::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int blocks = gridDim.x / 2;
  if (static_cast<int>(blockIdx.x) < blocks)
    dkdv_block<S, kDropout>(blockIdx.x, smem, q, k, v, dy, lse, delta, dk, dv, n, d, scale,
                            drop);
  else
    dq_block<S, kDropout>(blockIdx.x - blocks, smem, q, k, v, dy, lse, delta, dq, n, d, scale,
                          drop);
}

// The backward's splits: always two, 32 columns of a tile a warp.  Its
// launch holds both kinds of block, so two splits start about one round of
// two blocks an SM from a training step's B = 2 on (N = 2048: 256 blocks),
// where four would give a warp 16 columns.
constexpr int kBwdSplits = 2;

static_assert(fwd_smem(2) <= r3d::kSmemLimit / 2 &&
                  dkdv_smem(kBwdSplits) <= r3d::kSmemLimit / 2,
              "two blocks fit an SM's shared memory");
static_assert(fwd_smem(4) >= sizeof(float) * (4 * kNO + 4) * kThreads &&
                  dq_smem(kBwdSplits) >= sizeof(float) * 4 * kNO * kThreads,
              "the merges' lane slots fit the shared memory");

// The launch shape: ceil(d / 128) groups of 128 channels (the last cut at
// d) and, in the forward, S key splits, the smallest of 2 and 4 that
// starts four blocks an SM over the groups' blocks (attention.cuh
// `splits`; S >= 2 keeps a warp's columns of a tile to one pass of 32).
struct Plan {
  int groups, s;
};

Plan plan(int b, int n, int d) {
  const int groups = (d + kGroupW - 1) / kGroupW;
  const int blocks = static_cast<int>(std::min(1LL * b * groups, 1LL << 24));
  return {groups, std::max(2, splits(blocks, n))};
}

// f(S, kDropout) with S (2 or 4) and the dropout flag as compile-time
// constants.
template <typename F>
cudaError_t dispatch(int s, bool dropout, F&& f) {
  auto with_s = [&](auto sc) {
    return dropout ? f(sc, std::true_type{}) : f(sc, std::false_type{});
  };
  return s == 2 ? with_s(std::integral_constant<int, 2>{})
                : with_s(std::integral_constant<int, 4>{});
}

dim3 grid_of(int b, int n, int s, int groups) {
  return dim3((n + 16 * kWarps / s - 1) / (16 * kWarps / s), b, groups);
}

bool takes(int b, int n, int d) {
  return b >= 1 && b <= 65535 && n >= 1 && d > kDP && d % 4 == 0 &&
         (d + kGroupW - 1) / kGroupW <= 65535;
}

}  // namespace

// The forward: q, k, v (B, N, D) f32 contiguous, D > 64, D % 4 == 0 -> y
// (B, N, D) f32 and, when lse is not null, lse (B, N) f32.  scale = 1 /
// tau; the dropout arguments as r3d_attn_fwd's.
R3D_EXPORT int r3d_attn_wide_tf32_fwd(const void* q, const void* k, const void* v, void* y,
                                      void* lse, int b, int n, int d, float scale, int dropout,
                                      unsigned seed_lo, unsigned seed_hi, unsigned threshold,
                                      float keep_scale, unsigned b0, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  const Plan p = plan(b, n, d);
  return dispatch(p.s, dropout != 0, [&](auto sc, auto dc) {
    constexpr int S = decltype(sc)::value;
    return r3d_launch(attn_wide_tf32_fwd_kernel<S, decltype(dc)::value>,
                      grid_of(b, n, S, p.groups), dim3(kThreads), fwd_smem(S),
                      static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
                      static_cast<const float*>(k), static_cast<const float*>(v),
                      static_cast<float*>(y), static_cast<float*>(lse), n, d, scale, drop);
  });
}

// The backward, with r3d_attn_bwd's arguments: q, k, v as the forward's; y,
// dy (B, N, D) f32, lse (B, N) f32; delta (B, N) f32 scratch -> dq, dk, dv
// (B, N, D) f32.  scale = 1 / tau.
R3D_EXPORT int r3d_attn_wide_tf32_bwd(const void* q, const void* k, const void* v,
                                      const void* y, const void* dy, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int b, int n,
                                      int d, float scale, int dropout, unsigned seed_lo,
                                      unsigned seed_hi, unsigned threshold, float keep_scale,
                                      unsigned b0, void* stream) {
  if (!takes(b, n, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const float*>(q);
  const auto kp = static_cast<const float*>(k);
  const auto vp = static_cast<const float*>(v);
  const auto dyp = static_cast<const float*>(dy);
  const auto lp = static_cast<const float*>(lse);
  const auto dl = static_cast<float*>(delta);
  const int rows = b * n;
  attn_wide_tf32_delta_kernel<<<(rows * 32 + 255) / 256, 256, 0, st>>>(
      dyp, static_cast<const float*>(y), dl, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  dim3 grid = grid_of(b, n, kBwdSplits, plan(b, n, d).groups);
  grid.x *= 2;  // dK/dV blocks, then dQ blocks
  auto launch = [&](auto kernel) {
    return r3d_launch(kernel, grid, dim3(kThreads), dkdv_smem(kBwdSplits), st, qp, kp, vp, dyp,
                      lp, static_cast<const float*>(dl), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), n, d, scale, drop);
  };
  return dropout != 0 ? launch(attn_wide_tf32_bwd_kernel<kBwdSplits, true>)
                      : launch(attn_wide_tf32_bwd_kernel<kBwdSplits, false>);
}
