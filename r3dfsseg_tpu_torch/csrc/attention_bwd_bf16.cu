// Kernel 5's bf16 form at D <= 64 (r3d_attn_bwd_bf16, the bf16 encoder's
// attention backward): dq, dk, dv of y = (P * M) v on bf16 q, k, v (B, N,
// D), D a multiple of 8 up to 64, from the forward's f32 y and lse and the
// f32 cotangent dy, to f32 dq, dk, dv (B, N, D).
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_bwd_kernel (:78, via _bwd_impl :190), its lowp branch (:84-125),
// with its arithmetic: Pd = P * M with P = exp(s - lse) on the scaled query
// bf16(q * bf16(1 / tau)) and the forward's Philox mask M (philox.cuh);
// dY, Pd and dS rounded to bf16 before their products, with f32 sums;
//     dV = Pd^T dY,   dS = P * (dY V^T * M - Delta),
//     dK = bf16(dS)^T q / tau (the unscaled q),   dQ = bf16(dS) K / tau,
// each times the f32 factor 1 / tau; Delta = rowsum(bf16(dY) * Y) (the
// f32 form's rowsum(dP * P), attention_bwd.cu).
//
// What bounds it on the H100: five products of B N^2 D multiply-adds, 10
// B N^2 D operations on the bf16 tensor cores (989 TFLOP/s; 0.0326 ms for
// a training step's two calls, B = 10 and 2 at N = 2048, D = 64), beside
// fixed CUDA-core work per score: an exp2 on the SFU, dS, two bf16 roundings
// and one Philox4x32-10 per 4 scores in training (measured in the
// forward, attention_fwd_bf16.cu, that work paces these tiles).  The
// inputs and outputs are small (5.9 MB a step); what this design adds is
// dS in bf16, B N^2 entries written once and read once (83.9 MB at B = 10,
// 16.8 at B = 2: 0.060 ms a step at 3.35 TB/s).
//
// Design: three launches, no float atomics, each sum in a fixed order, so
// repeated calls are bit-equal.
//   0. The pre-pass (attention.cuh `attn_bwd_prep_bf16_kernel`, one warp a
//      row): Delta, bf16(dY) and the scaled query qs = bf16(q * bf16(1 /
//      tau)) into the wrapper's scratch.
//   a. dK/dV (`attn_bwd_dkdv_bf16_wgmma_kernel`): a block owns 64 keys,
//      one warpgroup, three blocks an SM (at most 168 registers a thread,
//      74 KB of shared memory), so that one block's CUDA-core work
//      overlaps another's products.  It loads the block's K and V tiles
//      once and keeps two stages filled, each the qs, q and bf16(dY) tiles
//      of 64 queries (64 x 64 bf16, the 128-byte swizzle; zeros past N and
//      D) and their lse and Delta, by cp.async: tile t + 1's copies are
//      issued while tile t is computed, and a barrier a tile hands a stage
//      over.  (A producer warp, as attention_fwd_bf16.cu has, makes five
//      warps a block, and ptxas caps two such blocks an SM at 168
//      registers.)  It takes each tile in two halves of 32 queries (the
//      registers): S^T = K qs^T and dPd^T = V dY^T (wgmma.m64n32k16 with
//      both operands in shared memory, k-steps past D not issued; while
//      they run, the half's mask bits by `col_mask`'s words, the
//      accumulator being (key, query) tiles of m16n8 per warp), then on
//      the CUDA cores P^T = exp2((S^T - lse) log2 e) (while dPd^T
//      finishes), Pd^T = P^T M and dS^T = P^T (dPd^T M - Delta); Pd^T and
//      dS^T go from the accumulators straight into bf16 register A
//      operands (`acc_frag_bf16`) of dV += Pd^T dY and dK += dS^T q, with
//      dY and q as MN-major B operands.  While those run, the warpgroup
//      writes the same bf16 dS^T into a staging tile in the 128-byte
//      swizzle, which behind a second barrier it copies to the scratch in
//      16-byte pieces (coalesced): each score, mask and exp is computed
//      once, and the dQ product reads the bits that dK's read.  Keys and
//      queries past N get P = 0, so their dS entries are zeros.
//   b. dQ (`attn_bwd_dq_bf16_wgmma_kernel`): a block owns 64 queries, a
//      warpgroup and a producer warp that fills a ring of dS^T and K tiles
//      on mbarriers (as attention_fwd_bf16.cu), and sums dQ = bf16(dS) K
//      over the key tiles in order: dS as the MN-major A operand straight
//      from the scratch's swizzled tile (a contiguous 8 KB copy), K the
//      MN-major B.  Bound by the bytes of dS.
// Filling 132 SMs: B = 10 has 320 key tiles, less than one round of the
// three dK/dV blocks an SM holds, and B = 2 only 64, so the dK/dV kernel
// cuts its query tiles in contiguous ranges over the kCluster = 2 blocks
// of a thread block cluster that share a key tile (measured on the H100,
// 2 beat 1 and 4 at both; at N <= 64 rank 0 takes no tile); each block
// leaves its partial dK and dV in shared memory, and behind a cluster
// barrier block r sums rows r 32 .. of both in rank order through
// distributed shared memory (`merge_partials`).  (The dQ kernel cut the
// same way was faster at B = 2 and slower at B = 10, measured.)
//
// K and V stay in shared memory, read by each S^T and dPd^T product, not
// in registers as A operands loaded once (4 k-steps x 4 registers each at
// D = 64, 32 a thread): measured on the H100 (`chip_smoke.py --only attn`,
// one call), that form took 0.1703 ms a call at B = 10 at three blocks an
// SM (158-168 registers, the cap of 65536 / 384 rounded down to 8, no
// spill) and 0.1756 at two (174-208), against 0.1570-0.1579 for this one
// (156-158 registers); PERF.md §6, PR 20.
//
// The scratch dS: tile (b, key tile kt, query tile qt) of T = ceil(N / 64)
// is 64 keys x 64 queries of bf16 at element ((b T + kt) T + qt) 4096, key
// r's 16-byte piece c (queries 8c .. 8c + 7) at piece c ^ (r % 8) of its
// 128-byte row: the layout wgmma reads (`bwd_bf16_ds_offset` in
// ops/cuda_attention.py mirrors it).  It takes 8 KB per (key tile, query
// tile), so it grows as B N^2: 2 B T^2 4096 bytes, 83.9 MB at B = 10 and
// N = 2048, 537 MB per cloud at N = 16384.
#include <cmath>

#include "attention.cuh"
#include "wgmma.cuh"

namespace {

using namespace r3d_attn;
using r3d::cluster_rank;
using r3d::cluster_sync;
using r3d::cp_async_arrive;
using r3d::fence_async_shared;
using r3d::launch_clusters;
using r3d::ld_remote4;
using r3d::load_tile;
using r3d::mbar_arrive;
using r3d::mbar_init;
using r3d::mbar_wait;
using r3d::remote;
using r3d::smem_u32;

constexpr int kRows = 64;                      // keys of a dK/dV block, queries of a dQ block
constexpr int kTileElems = 64 * 64;            // bf16 entries of a staged tile (8 KB)
constexpr int kGroupThreads = 128;             // a warpgroup
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kPStride = 72;                   // floats per row of a partial dK or dV
constexpr int kCluster = 2;                    // dK/dV blocks sharing a key tile
constexpr size_t kTileBytes = sizeof(uint16_t) * kTileElems;

// dK/dV: two stages (qs, q, dY tiles), the block's K and V tiles, the
// dS^T staging tile, lse and Delta of each stage's queries: 74 KB, three
// blocks an SM
constexpr int kStagesKV = 2;
constexpr size_t kRingKV = 3 * kTileBytes * kStagesKV;
constexpr size_t kSmemKV = 1024 + kRingKV + 3 * kTileBytes + sizeof(float) * 2 * 64 * kStagesKV;
static_assert(2 * sizeof(float) * kRows * kPStride <= kRingKV, "the partials fit in the ring");
// dQ: a dS^T tile and a K tile a stage, barriers; a warpgroup and a
// producer warp
constexpr int kStagesQ = 4;
constexpr int kBlockThreadsQ = kGroupThreads + 32;
constexpr size_t kSmemQ = 1024 + 2 * kTileBytes * kStagesQ + sizeof(uint64_t) * 2 * kStagesQ;

// The copies of query tile t into a dK/dV stage by the block's 128
// threads: the qs, q and dY tiles, then lse and Delta of its queries
// (zeros past n; their products then vanish, and their P is set to 0).
__device__ __forceinline__ void load_stage(const uint16_t* qs, const uint16_t* q,
                                           const uint16_t* dyb, const float* lse_b,
                                           const float* delta_b, int t, int n, int d,
                                           uint16_t* st, float* ss) {
  const int tid = threadIdx.x;
  load_tile<kGroupThreads>(qs, t * 64, n, d, st, tid);
  load_tile<kGroupThreads>(q, t * 64, n, d, st + kTileElems, tid);
  load_tile<kGroupThreads>(dyb, t * 64, n, d, st + 2 * kTileElems, tid);
  const int row = t * 64 + (tid & 63);
  const float* src = tid < 64 ? lse_b : delta_b;
  r3d::cp_async4(ss + tid, row < n ? src + row : src, row < n);
}

// The staged dS^T tile of query tile t to the scratch in 16-byte pieces
// (coalesced), by the block's 128 threads.
__device__ __forceinline__ void copy_staged(const uint16_t* staged, uint16_t* ds_kt, int t) {
  const uint4* from = reinterpret_cast<const uint4*>(staged);
  uint4* to = reinterpret_cast<uint4*>(ds_kt + static_cast<size_t>(t) * kTileElems);
#pragma unroll
  for (int m = 0; m < kTileElems / 8 / kGroupThreads; ++m)
    to[threadIdx.x + kGroupThreads * m] = from[threadIdx.x + kGroupThreads * m];
}

// A warpgroup's 64 x 64 accumulator (register 4 j + 2 h + c: row 16 w +
// lane / 4 + 8 h of warp w, channel 8 j + 2 (lane % 4) + c) times mul into
// rows row0 .. of out (rows < n, channels < d; d floats a row).
__device__ __forceinline__ void write_acc(const float (&acc)[32], float* out, float mul,
                                          int row0, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * h;
    if (row >= n) continue;
    float* o = out + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = 8 * j + 2 * tq;
      if (ch < d)
        *reinterpret_cast<float2*>(o + ch) =
            make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// The same accumulator as a partial in shared memory, kPStride floats a row.
__device__ __forceinline__ void park_acc(const float (&acc)[32], float* part) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(part + (16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * h) *
                                            kPStride + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The partial dK and dV (64 x kPStride floats each, dK's first, at part)
// that each block of the cluster parked, summed over its kCluster blocks:
// behind a cluster barrier, block `rank` adds keys rank 64 / kCluster ..
// of all of them in rank order through distributed shared memory and
// writes them to rows key0 .. of dk (times scale) and dv (< n, channels <
// d); a second barrier keeps every block's partials until all have read
// them.
__device__ __forceinline__ void merge_partials(const float* part, float* dk, float* dv,
                                               float scale, int key0, int n, int d, int rank) {
  cluster_sync();
  constexpr int kSlice = kRows / kCluster;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * kSlice * 16; i += kGroupThreads) {
    const int m = i / (kSlice * 16);  // 0: dK, 1: dV
    const int row = rank * kSlice + (i >> 4) % kSlice;
    const int ch = 4 * (i & 15);
    const float* at = part + (m * kRows + row) * kPStride + ch;
    float4 sum = ld_remote4(remote(at, 0));
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      const float4 x = ld_remote4(remote(at, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (key0 + row < n && ch < d) {
      const float mul = m == 0 ? scale : 1.f;
      *reinterpret_cast<float4*>((m == 0 ? dk : dv) + static_cast<size_t>(key0 + row) * d + ch) =
          make_float4(sum.x * mul, sum.y * mul, sum.z * mul, sum.w * mul);
    }
  }
  cluster_sync();
}

// (a) dK, dV of the block's 64 keys over its cluster rank's query tiles,
// and bf16(dS^T) of those tiles into the scratch.  One warpgroup, which
// also issues its own copies (tile t + 1's while tile t is computed), and
// takes each tile in two halves of 32 queries, so that three blocks fit
// an SM (at most 168 registers a thread).
template <bool kDropout>
__global__ void __launch_bounds__(kGroupThreads, 3)
attn_bwd_dkdv_bf16_wgmma_kernel(const uint16_t* __restrict__ qs, const uint16_t* __restrict__ q,
                                const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                                const uint16_t* __restrict__ dyb, const float* __restrict__ lse,
                                const float* __restrict__ delta, uint16_t* __restrict__ ds,
                                float* __restrict__ dk, float* __restrict__ dv, int n, int d,
                                float scale, r3d::Dropout drop) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* kvt = ring + 3 * kTileElems * kStagesKV;  // K tile, then V tile
  uint16_t* staged = kvt + 2 * kTileElems;            // the dS^T tile
  float* stats = reinterpret_cast<float*>(staged + kTileElems);

  const int b = blockIdx.y;
  const int rank = static_cast<int>(cluster_rank());
  const int kt = blockIdx.x / kCluster;
  const int key0 = kt * kRows;
  const int tiles = (n + 63) / 64;
  const int lo = rank * tiles / kCluster;  // this block's query tiles [lo, hi)
  const int hi = (rank + 1) * tiles / kCluster;
  const size_t base = static_cast<size_t>(b) * n * d;
  const float* lse_b = lse + static_cast<size_t>(b) * n;
  const float* delta_b = delta + static_cast<size_t>(b) * n;

  // K and V once, with the first stage
  load_tile<kGroupThreads>(k + base, key0, n, d, kvt, threadIdx.x);
  load_tile<kGroupThreads>(v + base, key0, n, d, kvt + kTileElems, threadIdx.x);
  if (lo < hi) load_stage(qs + base, q + base, dyb + base, lse_b, delta_b, lo, n, d, ring, stats);
  r3d::cp_async_commit();

  // keys key0 + krow and + 8 of warp w's 16
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int krow = 16 * warp + g;
  const int ksteps = (d + 15) / 16;
  const bool ragged_keys = key0 + kRows > n;
  float gk[32], gv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;
  const uint64_t dka = r3d::desc(kvt);
  const uint64_t dva = r3d::desc(kvt + kTileElems);
  uint16_t* ds_kt = ds + (static_cast<size_t>(b) * tiles + kt) * tiles * kTileElems;

  int it = 0;
#pragma unroll 1
  for (int t = lo; t < hi; ++t, ++it) {
    // tile t's copies landed and made visible to wgmma; behind the barrier
    // every thread is done with tile t - 1, whose stage takes tile t + 1
    r3d::cp_async_wait_all();
    fence_async_shared();
    __syncthreads();
    const int s = it & 1;
    if (t + 1 < hi)
      load_stage(qs + base, q + base, dyb + base, lse_b, delta_b, t + 1, n, d,
                 ring + 3 * (s ^ 1) * kTileElems, stats + 2 * 64 * (s ^ 1));
    r3d::cp_async_commit();
    const uint16_t* qst = ring + 3 * s * kTileElems;
    const uint16_t* qt = qst + kTileElems;
    const uint16_t* dyt = qt + kTileElems;
    const float* ss = stats + 2 * 64 * s;
    const int q0 = t * 64;
    const bool ragged = ragged_keys || q0 + 64 > n;
    uint32_t pa[2][2][4], sa[2][2][4];  // [half][k-step]: Pd^T and dS^T as A operands
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = 32 * half;  // the half's first query in the tile
      // S^T = K qs^T and dPd^T = V dY^T over the channels (+32 bytes a
      // k-step), two groups of products; meanwhile the half's mask bits
      float sc[16], dp[16];
      const uint64_t dqs = r3d::desc(qst + 64 * qh);
      const uint64_t ddy = r3d::desc(dyt + 64 * qh);
      r3d::wgmma_fence();
      r3d::wgmma_n32_first(sc, dka, dqs);
#pragma unroll
      for (int ks = 1; ks < 4; ++ks)
        if (ks < ksteps) r3d::wgmma_n32(sc, dka + 2 * ks, dqs + 2 * ks);
      r3d::wgmma_commit();
      r3d::wgmma_n32_first(dp, dva, ddy);
#pragma unroll
      for (int ks = 1; ks < 4; ++ks)
        if (ks < ksteps) r3d::wgmma_n32(dp, dva + 2 * ks, ddy + 2 * ks);
      r3d::wgmma_commit();
      uint2 mbits[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mbits[j] = kDropout ? col_mask_bits(drop, b, key0 + 16 * warp, q0 + qh + 8 * j)
                            : make_uint2(0u, 0u);
      // S^T done (and in the second half the first half's dV, dK products)
      r3d::wgmma_wait<1>();
      r3d::fence_operands(sc);
      if (half == 1) {
        r3d::keep_operands(pa[0]);
        r3d::keep_operands(sa[0]);
      }
      // P^T = exp2((S^T - lse) log2 e): accumulator register 4 j + 2 h + c
      // is key krow + 8 h, query q0 + qh + 8 j + 2 tq + c
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(ss + qh + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * j + e;
          float pe = exp2_fast((sc[r] - ((e & 1) ? ls.y : ls.x)) * kLog2e);
          // keys and queries past n: P = 0 (their dS entries are zeros)
          if (ragged &&
              (key0 + krow + 8 * (e >> 1) >= n || q0 + qh + 8 * j + 2 * tq + (e & 1) >= n))
            pe = 0.f;
          sc[r] = pe;
        }
      }
      r3d::wgmma_wait<0>();
      r3d::fence_operands(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(ss + 64 + qh + 8 * j + 2 * tq);
        const float4 f = kDropout ? col_mask_factors(mbits[j], drop.scale)
                                  : make_float4(1.f, 1.f, 1.f, 1.f);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * j + e;
          const float pe = sc[r];
          sc[r] = pe * fs[e];                                       // Pd^T
          dp[r] = pe * (dp[r] * fs[e] - ((e & 1) ? dl.y : dl.x));   // dS^T
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        acc_frag_bf16<4>(reinterpret_cast<const float(&)[4][4]>(sc), ks, pa[half][ks]);
        acc_frag_bf16<4>(reinterpret_cast<const float(&)[4][4]>(dp), ks, sa[half][ks]);
      }
      // dV += Pd^T dY and dK += dS^T q over the half's queries (k-step ks:
      // queries qh + 16 ks ..)
      r3d::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        r3d::wgmma_rs_n64<1>(gv, pa[half][ks], r3d::desc_mn(dyt + 64 * (qh + 16 * ks)));
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        r3d::wgmma_rs_n64<1>(gk, sa[half][ks], r3d::desc_mn(qt + 64 * (qh + 16 * ks)));
      r3d::wgmma_commit();
      // meanwhile bf16(dS^T) into the staging tile: register i of k-step
      // ks is key krow + 8 (i % 2), queries qh + 16 ks + 8 (i / 2) + 2 tq,
      // + 1
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = krow + 8 * (i & 1);
          const int piece = qh / 8 + 2 * ks + (i >> 1);
          *reinterpret_cast<uint32_t*>(staged + row * 64 + ((piece ^ (row & 7)) << 3) + 2 * tq) =
              sa[half][ks][i];
        }
    }
    r3d::wgmma_wait<0>();
    r3d::fence_operands(gv);
    r3d::fence_operands(gk);
    r3d::keep_operands(pa[1]);
    r3d::keep_operands(sa[1]);
    // the staged tile complete: to the scratch (the next tile's stores into
    // it follow the next barrier)
    __syncthreads();
    copy_staged(staged, ds_kt, t);
  }
  r3d::cp_async_wait_all();  // the empty group past the last tile
  __syncthreads();           // every read of the ring done

  // dK (times 1 / tau) and dV: the partials in the ring (every stage
  // consumed), merged over the cluster
  float* part = reinterpret_cast<float*>(smem);
  park_acc(gk, part);
  park_acc(gv, part + kRows * kPStride);
  merge_partials(part, dk + base, dv + base, scale, key0, n, d, rank);
}

// (b) dQ of the block's 64 queries: bf16(dS) K / tau over the key tiles
// in order.
__global__ void __launch_bounds__(kBlockThreadsQ, 3)
attn_bwd_dq_bf16_wgmma_kernel(const uint16_t* __restrict__ ds, const uint16_t* __restrict__ k,
                              float* __restrict__ dq, int n, int d, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // dS^T tile, then K tile, a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kTileElems * kStagesQ);
  uint64_t* empty = full + kStagesQ;

  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int tiles = (n + 63) / 64;
  const size_t base = static_cast<size_t>(b) * n * d;
  const int lane = threadIdx.x & 31;
  // tile (b, kt, qt) of the scratch at ds_q + kt * tiles * kTileElems
  const uint16_t* ds_q = ds + (static_cast<size_t>(b) * tiles * tiles + qt) * kTileElems;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kGroupWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kGroupThreads) {
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStagesQ;
      mbar_wait(&empty[s], ((t / kStagesQ) & 1) ^ 1);  // the first round passes at once
      uint16_t* st = ring + 2 * s * kTileElems;
      const uint16_t* src = ds_q + static_cast<size_t>(t) * tiles * kTileElems;
#pragma unroll
      for (int i = 0; i < kTileElems / 8 / 32; ++i) {
        const int e = 8 * (lane + 32 * i);
        r3d::cp_async16(st + e, src + e, true);  // the tile as it lies: already swizzled
      }
      load_tile(k + base, t * 64, n, d, st + kTileElems, lane);
      cp_async_arrive(&full[s]);
    }
    r3d::cp_async_wait_all();
    return;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStagesQ;
    mbar_wait(&full[s], (t / kStagesQ) & 1);
    fence_async_shared();
    const uint16_t* st = ring + 2 * s * kTileElems;
    // k-step s: keys 16 s .. of the tile, 16 rows of both tiles
    r3d::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      r3d::wgmma_ss_n64<1, 1>(acc, r3d::desc_mn(st + 16 * 64 * ks),
                              r3d::desc_mn(st + kTileElems + 16 * 64 * ks));
    r3d::wgmma_commit_and_wait();
    r3d::fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  write_acc(acc, dq + base, scale, qt * kRows, n, d);
}

struct Bwd {
  const uint16_t *q, *k, *v;
  const float *y, *dy, *lse;
  float* delta;
  uint16_t *qs, *dyb, *ds;
  float *dq, *dk, *dv;
};

// The dK/dV launch in clusters of kCluster, then the dQ launch.
cudaError_t launch(const Bwd& a, int b, int n, int d, float scale, bool dropout,
                   r3d::Dropout drop, cudaStream_t st) {
  const int tiles = (n + kRows - 1) / kRows;
  const dim3 grid(tiles * kCluster, b);
  const float* delta = a.delta;
  cudaError_t err =
      dropout ? launch_clusters(attn_bwd_dkdv_bf16_wgmma_kernel<true>, grid, kGroupThreads,
                                kSmemKV, kCluster, st, a.qs, a.q, a.k, a.v, a.dyb, a.lse, delta,
                                a.ds, a.dk, a.dv, n, d, scale, drop)
              : launch_clusters(attn_bwd_dkdv_bf16_wgmma_kernel<false>, grid, kGroupThreads,
                                kSmemKV, kCluster, st, a.qs, a.q, a.k, a.v, a.dyb, a.lse, delta,
                                a.ds, a.dk, a.dv, n, d, scale, drop);
  if (err != cudaSuccess) return err;
  return launch_clusters(attn_bwd_dq_bf16_wgmma_kernel, dim3(tiles, b), kBlockThreadsQ, kSmemQ, 1,
                         st, static_cast<const uint16_t*>(a.ds), a.k, a.dq, n, d, scale);
}

}  // namespace

// q, k, v (B, N, D) bf16 with D % 8 == 0, D <= 64; y, dy f32 (the
// forward's output and its cotangent); lse (B, N) f32 -> dq, dk, dv f32.
// Scratch from the wrapper: delta (B, N) f32, qs and dyb (B, N, D) bf16, ds
// B T^2 64 x 64 bf16 (T = ceil(N / 64)).  scale = 1 / tau (f32), qscale =
// bf16(1 / tau), the forward's.
R3D_EXPORT int r3d_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* y,
                                 const void* dy, const void* lse, void* delta, void* qs,
                                 void* dyb, void* ds, void* dq, void* dk, void* dv, int b, int n,
                                 int d, float scale, float qscale, int dropout, unsigned seed_lo,
                                 unsigned seed_hi, unsigned threshold, float keep_scale,
                                 void* stream) {
  if (d < 8 || d > kDP || d % 8 != 0 || b < 1 || n < 1 || b > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const Bwd a{static_cast<const uint16_t*>(q),  static_cast<const uint16_t*>(k),
              static_cast<const uint16_t*>(v),  static_cast<const float*>(y),
              static_cast<const float*>(dy),    static_cast<const float*>(lse),
              static_cast<float*>(delta),       static_cast<uint16_t*>(qs),
              static_cast<uint16_t*>(dyb),      static_cast<uint16_t*>(ds),
              static_cast<float*>(dq),          static_cast<float*>(dk),
              static_cast<float*>(dv)};
  const int rows = b * n;
  attn_bwd_prep_bf16_kernel<><<<(rows * 32 + 255) / 256, 256, 0, st>>>(a.q, a.dy, a.y, a.delta,
                                                                       a.qs, a.dyb, rows, d,
                                                                       qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale};
  return launch(a, b, n, d, scale, dropout != 0, drop, st);
}
