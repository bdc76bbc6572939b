// Kernel 2's bf16 form at D <= 64 (r3d_attn_fwd_bf16, the bf16 encoder's
// attention forward): softmax(q k^T * scale) [dropout] v on bf16 q, k, v
// (B, N, D), D a multiple of 8 up to 64, to f32 y (B, N, D) and lse (B, N).
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_attention.py:
// _attn_fwd_kernel (via _fwd_impl), its lowp branch (:57-73), with the
// TPU kernel's arithmetic where it is defined:
// - the scaled query bf16(q * scale), scale = bf16(1 / tau) from the
//   wrapper, rounded to bf16 (`load_rows_bf16`);
// - the scores s = sum of exact bf16 products in f32; the row max m and
//   the row sum l of exp(s - m) over the undropped scores;
// - P = exp(s - m) * (1 / l), times the dropout mask in f32 (philox.cuh,
//   drawn once per word by attention.cuh's `row_mask`, the words that
//   attention_bwd.cu draws again), rounded to bf16 as the A operand of
//   P V, with f32 sums; y and lse = m + log l in f32.
// Because P is normalised before it is rounded, l must be complete before
// any P: two passes over the keys, the first for (m, l), the second for P
// V, so a call takes 3 products of B N^2 D multiply-adds (q k^T twice).
//
// What bounds it on the H100: the products, 6 B N^2 D operations on the
// bf16 tensor cores (989 TFLOP/s; 0.0196 ms for a training step's two
// calls, B = 10 and 2 at N = 2048, D = 64; 0.0130 for the function's own
// 4 B N^2 D), beside fixed CUDA-core work per score: two exp2 on the SFU,
// and in training one Philox4x32-10 per 4 scores.  The bytes are far
// below (q, k, v read, y and lse written: 2.6 MB a step).  Measured
// (PERF.md), the CUDA cores pace it, not the tensor cores: scratch
// variants without the products ran as fast, and the mask's Philox takes
// some 40% of a training call (hoisting the 4 of its 19 per-score
// multiplies that depend on the row or the key group alone did not change
// that).
//
// Design:
// - Products: wgmma.m64n64k16 bf16 tiles (wgmma.cuh).  A block holds 64
//   query rows, one consumer warpgroup; it keeps its rows' scaled q in
//   registers, read once from device memory, as the register A operand of
//   S = q k^T (k-steps of 16 channels; the channels
//   of q and of the K tile are zero past D up to 64, so D = 8, 24, 40 sum
//   exact zeros in their last k-step, and k-steps wholly past D are not
//   issued).  K is the K-major B operand.  In pass 2 P leaves the S
//   accumulator straight for the register A operand of O += P V (tiles 2s
//   and 2s + 1 rounded to bf16 pairs are k-step s, `acc_frag_bf16`); V is
//   the MN-major B operand (the transpose bit).
// - Loads: a ring of kStages stages in shared memory, each a K tile and a
//   V tile of 64 keys x 64 channels (8 KB each, the 128-byte swizzle that
//   wgmma reads; zeros past N and past D).  One producer warp issues
//   16-byte cp.async copies into a stage and hands it to the consumers on
//   the stage's `full` mbarrier (cp.async.mbarrier.arrive: it completes
//   when the copies have landed); the four consumer warps arrive on its
//   `empty` mbarrier once their products have read it.  Pass 1 fills only
//   the K tile of a stage, pass 2 both; the producer runs ahead across the
//   passes.
// - Overlap: three blocks an SM (160 threads, at most 136 registers a
//   thread, 68 KB of shared memory each), whose warpgroups run out of
//   step, so that one's exp2, Philox and bf16 packing on the CUDA cores
//   overlap another's wgmma and a third's waits.  Measured on the H100
//   (PERF.md), this beat two consumer warpgroups of one block of
//   128 rows (one block an SM) by 15-25%; a warpgroup that issues the next
//   tile's q k^T before its softmax (the products' latency hidden inside
//   one warpgroup) ran slower than either, and so did a deeper ring.
// - Filling 132 SMs: the keys are cut in contiguous ranges of whole
//   64-key tiles over the C = 1, 2 or 4 blocks of a thread block cluster
//   that share a row tile (the wrapper's `fwd_bf16_cluster` picks C and
//   passes it: the smallest that starts four blocks an SM, else 4; B = 10
//   at N = 2048 takes 2, 640 blocks, and B = 2 takes 4, 256 blocks).
//   After pass 1 each block leaves its rows' (m, l) in shared memory;
//   behind a cluster barrier every block reads all C through distributed
//   shared memory and merges them in rank order (m the max, l = sum of
//   exp(m_r - m) l_r), so all C hold the same bits.  Pass 2's partial
//   outputs are already normalised and simply add: each block leaves its
//   64 x 64 partial in shared memory, and behind a second barrier block r
//   sums rows r 64 / C .. of all C in rank order and writes them; a third
//   barrier keeps every block's shared memory alive until the others have
//   read it.  With C = 1 the outputs go from registers.  No atomics and a
//   fixed order of every sum: repeated calls are bit-equal.
// The ragged last key tile is masked to -inf (`mask_ragged_keys`); rows
// of the ragged last row tile are computed and not stored.
#include <cmath>

#include "attention.cuh"
#include "wgmma.cuh"

namespace {

using namespace r3d_attn;

constexpr int kBlockRows = 64;                 // query rows of a block: its warpgroup's
constexpr int kKeys = 64;                      // keys of a staged tile
constexpr int kTileElems = kKeys * 64;         // bf16 entries of a staged tile (8 KB)
constexpr int kStages = 3;
constexpr int kConsumerThreads = 128;          // the consumer warpgroup
constexpr int kBlockThreads = kConsumerThreads + 32;  // and the producer warp
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kOStride = 72;                   // floats per row of the partial outputs
constexpr int kBlocksPerSm = 3;

constexpr size_t kRingBytes = sizeof(uint16_t) * 2 * kTileElems * kStages;
constexpr size_t kPartialBytes = sizeof(float) * kBlockRows * kOStride;
constexpr size_t kStatsBytes = sizeof(float) * 2 * kBlockRows;
constexpr size_t kSmem = 1024 + kRingBytes + kPartialBytes + kStatsBytes +
                         sizeof(uint64_t) * 2 * kStages;

using r3d::cluster_arrive;
using r3d::cluster_rank;
using r3d::cluster_sync;
using r3d::cluster_wait;
using r3d::cp_async_arrive;
using r3d::fence_async_shared;
using r3d::ld_remote;
using r3d::ld_remote4;
using r3d::load_tile;
using r3d::mbar_arrive;
using r3d::mbar_init;
using r3d::mbar_wait;
using r3d::remote;
using r3d::smem_u32;

// ---- tiles and products ------------------------------------------------
// s = (q * scale) K^T over a staged K tile: the warpgroup's 64 rows by the
// tile's 64 keys, `ksteps` k-steps of 16 channels.
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qa)[4][4],
                                       const uint16_t* kt, int ksteps) {
  float(&acc)[32] = reinterpret_cast<float(&)[32]>(s);
  const uint64_t db = r3d::desc(kt);
  r3d::wgmma_fence();
  r3d::wgmma_rs_n64_first<0>(acc, qa[0], db);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) {
    if (ks < ksteps) r3d::wgmma_rs_n64<0>(acc, qa[ks], db + 2 * ks);  // +32 bytes a k-step
  }
  r3d::wgmma_commit_and_wait();
  r3d::fence_operands(acc);
}

// o += P V over a staged V tile: P's k-step s the keys 16 s .. + 15.
__device__ __forceinline__ void add_pv(float (&o)[32], const uint32_t (&pa)[4][4],
                                       const uint16_t* vt) {
  r3d::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) r3d::wgmma_rs_n64<1>(o, pa[s], r3d::desc_mn(vt + 16 * 64 * s));
  r3d::wgmma_commit_and_wait();
  r3d::fence_operands(o);
  r3d::keep_operands(pa);
}

template <int C, bool kDropout>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
attn_fwd_bf16_wgmma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v, float* __restrict__ y,
                           float* __restrict__ lse, int n, int d, float scale,
                           r3d::Dropout drop) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + kRingBytes);
  float* stat_m = part + kBlockRows * kOStride;
  float* stat_l = stat_m + kBlockRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(stat_l + kBlockRows);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.y;
  const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int row0 = (blockIdx.x / C) * kBlockRows;
  const int tiles = (n + kKeys - 1) / kKeys;
  const int lo = rank * tiles / C;  // this block's key tiles [lo, hi)
  const int hi = (rank + 1) * tiles / C;
  const size_t base = static_cast<size_t>(b) * n * d;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // The producer warp: pass 1's K tiles, then pass 2's K and V tiles,
    // through the ring in one sequence of stages.
    int it = 0;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
      for (int t = lo; t < hi; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // the first round passes at once
        uint16_t* kt = ring + 2 * s * kTileElems;
        load_tile(k + base, t * kKeys, n, d, kt, lane);
        if (pass == 1) load_tile(v + base, t * kKeys, n, d, kt + kTileElems, lane);
        cp_async_arrive(&full[s]);
      }
      if (C > 1 && pass == 0) cluster_arrive();  // barrier 1 (the statistics)
    }
    if constexpr (C > 1) {
      cluster_wait();
      cluster_sync();  // barrier 2 (the partial outputs)
      cluster_sync();  // barrier 3 (every remote read done)
    } else {
      r3d::cp_async_wait_all();
    }
    return;
  }

  // The consumer warpgroup: rows row0 .. + 63, warp w's 16 from rw.
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int lrow = 16 * (threadIdx.x >> 5) + g;  // row in the block
  const int rw = row0 + lrow - g;
  const int ksteps = (d + 15) / 16;
  uint32_t qa[4][4];
  load_rows_bf16(q + base, rw, n, d, scale, qa);

  // 1. the row statistics over this block's keys
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  int it = 0;
#pragma unroll 1
  for (int t = lo; t < hi; ++t, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    fence_async_shared();
    float sc[8][4];
    scores(sc, qa, ring + 2 * s * kTileElems, ksteps);
    if (lane == 0) mbar_arrive(&empty[s]);
    mask_ragged_keys<8>(sc, t * kKeys, n, tq);
    row_stats<8>(sc, m, l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if constexpr (C > 1) {
    // merge the C blocks' (m, l) in rank order; every block gets the same
    if (tq == 0) {
      stat_m[lrow] = m[0];
      stat_l[lrow] = l[0];
      stat_m[lrow + 8] = m[1];
      stat_l[lrow + 8] = l[1];
    }
    cluster_sync();  // barrier 1
    float mr[2][C], lr[2][C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mr[h][r] = ld_remote(remote(stat_m + lrow + 8 * h, r));
        lr[h][r] = ld_remote(remote(stat_l + lrow + 8 * h, r));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = -INFINITY;
#pragma unroll
      for (int r = 0; r < C; ++r) mm = fmaxf(mm, mr[h][r]);
      float ll = 0.f;
#pragma unroll
      for (int r = 0; r < C; ++r)
        ll += mr[h][r] == -INFINITY ? 0.f : exp2_fast((mr[h][r] - mm) * kLog2e) * lr[h][r];
      m[h] = mm;
      l[h] = ll;
    }
  }
  if (lse != nullptr && rank == 0 && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      if (row < n) lse[static_cast<size_t>(b) * n + row] = m[h] + logf(l[h]);
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};

  // 2. O = P V with the normalised P over this block's keys
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll 1
  for (int t = lo; t < hi; ++t, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    fence_async_shared();
    const uint16_t* kt = ring + 2 * s * kTileElems;
    float sc[8][4];
    scores(sc, qa, kt, ksteps);
    const int key0 = t * kKeys;
    mask_ragged_keys<8>(sc, key0, n, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = exp2_fast((sc[j][e] - m[e >> 1]) * kLog2e) * inv[e >> 1];  // 0 on masked keys
      if constexpr (kDropout) {
        const float4 f = row_mask(drop, b, rw + g, key0 + 8 * j + 2 * tq);
        sc[j][0] *= f.x;
        sc[j][1] *= f.y;
        sc[j][2] *= f.z;
        sc[j][3] *= f.w;
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) acc_frag_bf16<8>(sc, ks, pa[ks]);
    add_pv(o, pa, kt + kTileElems);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // 3. y: accumulator register 4 j + 2 h + c is row lrow + 8 h, channel 8 j
  // + 2 tq + c
  if constexpr (C == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      if (row >= n) continue;
      float* yr = y + base + static_cast<size_t>(row) * d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * tq;
        if (ch < d) *reinterpret_cast<float2*>(yr + ch) = make_float2(o[4 * j + 2 * h],
                                                                      o[4 * j + 2 * h + 1]);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(part + (lrow + 8 * h) * kOStride + 8 * j + 2 * tq) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    cluster_sync();  // barrier 2
    // rows rank * 128 / C .. of the block's tile: the C partials in rank order
    constexpr int kSlice = kBlockRows / C;
#pragma unroll 1
    for (int i = threadIdx.x; i < kSlice * 16; i += kConsumerThreads) {
      const int row = rank * kSlice + (i >> 4);
      const int ch = 4 * (i & 15);
      const float* at = part + row * kOStride + ch;
      float4 sum = ld_remote4(remote(at, 0));
#pragma unroll
      for (int r = 1; r < C; ++r) {
        const float4 x = ld_remote4(remote(at, r));
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      if (row0 + row < n && ch < d)
        *reinterpret_cast<float4*>(y + base + static_cast<size_t>(row0 + row) * d + ch) = sum;
    }
    cluster_sync();  // barrier 3
  }
}

template <int C, bool kDropout>
cudaError_t launch(const uint16_t* q, const uint16_t* k, const uint16_t* v, float* y, float* lse,
                   int b, int n, int d, float scale, r3d::Dropout drop, cudaStream_t st) {
  return r3d::launch_clusters(attn_fwd_bf16_wgmma_kernel<C, kDropout>,
                              dim3(((n + kBlockRows - 1) / kBlockRows) * C, b), kBlockThreads,
                              kSmem, C, st, q, k, v, y, lse, n, d, scale, drop);
}

template <int C>
cudaError_t launch_c(const uint16_t* q, const uint16_t* k, const uint16_t* v, float* y,
                     float* lse, int b, int n, int d, float scale, bool dropout,
                     r3d::Dropout drop, cudaStream_t st) {
  return dropout ? launch<C, true>(q, k, v, y, lse, b, n, d, scale, drop, st)
                 : launch<C, false>(q, k, v, y, lse, b, n, d, scale, drop, st);
}

}  // namespace

// q, k, v (B, N, D) bf16 with D % 8 == 0, D <= 64; y (B, N, D) f32; lse
// (B, N) f32 or null (eval); cluster the cluster size C (1, 2 or 4; the
// wrapper's `fwd_bf16_cluster` chooses it); scale = bf16(1 / tau);
// dropout != 0 selects the kernel with the mask.
R3D_EXPORT int r3d_attn_fwd_bf16(const void* q, const void* k, const void* v, void* y,
                                 void* lse, int b, int n, int d, int cluster, float scale,
                                 int dropout, unsigned seed_lo, unsigned seed_hi,
                                 unsigned threshold, float keep_scale, unsigned b0, void* stream) {
  if (d < 8 || d > kDP || d % 8 != 0 || b < 1 || n < 1 || b > 65535) return cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4) return cudaErrorInvalidValue;
  const r3d::Dropout drop{seed_lo, seed_hi, threshold, keep_scale, b0};
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const uint16_t*>(q);
  auto kp = static_cast<const uint16_t*>(k);
  auto vp = static_cast<const uint16_t*>(v);
  auto yp = static_cast<float*>(y);
  auto lp = static_cast<float*>(lse);
  switch (cluster) {
    case 1:
      return launch_c<1>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
    case 2:
      return launch_c<2>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
    default:
      return launch_c<4>(qp, kp, vp, yp, lp, b, n, d, scale, dropout != 0, drop, st);
  }
}
