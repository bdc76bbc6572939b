// Exact k-nearest-neighbour search per point cloud.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_knn.py:_knn_kernel in its
// exact mode (exact=True): squared L2 distances (qq + kk) - 2 * inner,
// clamped at 0, self included, k smallest per row with ties to the lowest
// index.  The TPU kernel upcasts its input on load (:52-53), so a bf16 x is
// searched in its f32 upcast.  The packed-mantissa mode of the TPU kernel
// was a VPU economy; the H100 does not need it.
//
// Layout: x (B, N, C) f32 (r3d_knn, r3d_knn_split) or bf16 (the _bf16
// entries) contiguous -> out (B, N, k) int32, k <= 32, C <= 256.
//
// What bounds it on the H100: the inner products, 2 B N^2 C operations,
// taken as three tf32 tensor-core passes on f32 (3xTF32, common.cuh) and
// one on bf16, and the selection of k of N keys per row, which no peak
// rate covers: most keys are rejected by one compare, and about k ln(N /
// k) per row are merged.  The selection sets the pace at the flagship
// shapes; the products and the staging are the rest.
//
// Design.  Grid (ceil(N / 64), B, S), blocks of 4 warps; a warp owns 16
// query rows and keeps their channels in registers (the A operand,
// attention.cuh's layout).  Key tiles of 64 points stream through a
// cp.async ring, row-major and swizzled, C > 64 in 64-channel chunks (the
// query rows reloaded per chunk), C = 9 zero-padded to 16 channels.  The
// kernel is a template on the staged element, one source for the two
// routes:
//   - f32: a two-stage ring of f32 tiles (attention.cuh's swizzle, 16-byte
//     copies where C % 4 == 0, else 4-byte ones); one pass of the block
//     splits an arrived tile in place into tf32 hi and a lo tile and takes
//     the keys' norms, four threads per key; the query rows are f32 and are
//     split at each fragment load; 3xTF32 mma.sync.m16n8k8 products
//     (attention.cuh:product_along_channels); three blocks an SM.
//   - bf16: bf16 tiles as they are, 128 bytes a key (8-channel chunk q of
//     key r at chunk q ^ (r % 8)), a three-stage ring (16-byte copies where
//     C % 8 == 0, else 2-byte loads), no split pass and no lo tile; the
//     query rows are bf16 pairs in registers, widened at fragment load;
//     one tf32 mma.sync.m16n8k8 a k-step on the widened values, in the f32
//     route's k-grouping: a bf16 value is a tf32 value, so the f32 route on
//     the upcast adds two all-zero products and then these, and the sums,
//     the distances and the lists are the f32 route's bit for bit (the sign
//     of an exact zero aside, which the clamp and the compares ignore).
//     Half the registers for the rows and half the shared memory for the
//     tiles: the launch bounds ask four blocks an SM.
// Norms of queries and of keys are the same function of a point's
// channels (`group_norm`, a fixed tree over 4-channel groups, on the f32
// values or the widened bf16 ones), so duplicate points tie bit for bit
// and a bf16 point's norm is its upcast's.  Per key tile and warp:
//   1. inner products: a 16 x 64 accumulator tile;
//   2. d = max((qq + kk) - 2 * inner, 0) in registers, ops/knn.py's
//      grouping; a key survives if d is below its row's current k-th
//      distance, held in registers;
//   3. survivors go into their row's batch in shared memory, by column,
//      and lanes r and r + 16 merge row r's batch, in column order, into
//      the row's list (`List`: the k nearest so far, the largest first,
//      half of it in each lane's registers; a candidate below the k-th
//      enters one half by a fixed chain of compares that sinks it to its
//      place, the lower half's top moving up when it enters there).  The
//      first tile of a scan merges only what a bound from the tile itself
//      lets through (`first_tile_bound`); every tile's batch is merged
//      before the next tile, so the thresholds stay the rows' current
//      k-th distances and all warps merge at once.
// Keys reach a list in increasing index order (a split's partial lists: in
// split order, each in (d, index) order), so a newcomer is the last of the
// keys at its distance: comparing distances alone orders by (d, index),
// and ties go to the lowest index exactly.
//
// Where B x ceil(N / 64) blocks would leave SMs idle (B = 2 at N = 2048),
// the wrapper asks for S key splits (r3d_knn_split): each block scans N / S
// keys and leaves its rows' lists in scratch, and the last block of a row
// tile to arrive (threadfence, atomic counter, reset to 0 after) merges the
// S lists.  No float atomics: a call repeats bit for bit.
#include <cmath>
#include <cstdint>

#include "attention.cuh"

namespace {

using namespace r3d_attn;  // kWarps = 4, kThreads = 128, kChunk = 64 keys, kDP = 64 channels

constexpr int kMaxC = 256;
constexpr int kMaxK = 32;
constexpr int kStride = kChunk + 1;  // floats per batch row (a tile's columns)
constexpr int kKeyBytes = 2 * kDP;   // a key's row of a staged bf16 tile: 8 chunks of 16 bytes

// The two routes, by the staged element: f32 (`float`), or bf16 bits
// (`uint16_t`).  The ring holds kStages key tiles (the f32 route also the
// lo half of the current one); then key and query norms and each warp's
// 16 candidate batches.  kBlocks: blocks an SM the launch bounds ask for.
template <typename T>
struct Route;

template <>
struct Route<float> {
  static constexpr int kStages = 2;
  static constexpr int kBlocks = 3;
  static constexpr size_t kTile = sizeof(float) * kTileF;
  static constexpr size_t kRing = (kStages + 1) * kTile;
  using Query = float4[4][2];        // the warp's rows, as attention.cuh's load_rows
};

template <>
struct Route<uint16_t> {
  static constexpr int kStages = 3;
  static constexpr int kBlocks = 4;  // 120-128 registers, no spill
  static constexpr size_t kTile = kChunk * kKeyBytes;
  static constexpr size_t kRing = kStages * kTile;
  using Query = uint32_t[4][2][2];   // the same channels as bf16 pairs
};

template <typename T>
constexpr size_t smem_bytes() {
  return Route<T>::kRing + sizeof(float) * (2 * kChunk + kWarps * 16 * kStride);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Width of 64-channel chunk h of c channels: 16 where at most 16 are
// left (C = 9), else 64.
__device__ __forceinline__ int chunk_width(int c, int h) { return c - h * kDP <= 16 ? 16 : kDP; }

// Sum of squares of a 4-channel group, in a fixed order.
__device__ __forceinline__ float group_norm(float4 v) {
  return fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, __fmul_rn(v.x, v.x))));
}

// Issue the copy of keys [key0, key0 + 64) below `end`, channels [ch0, ch0
// + w) of the cloud, into a staged tile (attention.cuh's layout); channels
// past c and keys past `end` are zeros.
__device__ __forceinline__ void stage_keys(const float* xb, int key0, int end, int c, int ch0,
                                           int w, bool vec, unsigned char* tile) {
  float* dst = reinterpret_cast<float*>(tile);
  if (vec) {  // c % 4 == 0 and a 16-byte aligned base: whole groups
    const int lg = w == 16 ? 2 : 4;  // log2 of the groups per key
    for (int e = threadIdx.x; e < kChunk * w / 4; e += kThreads) {
      const int r = e >> lg;
      const int q = e & ((w >> 2) - 1);
      const int ch = ch0 + 4 * q;
      const bool ok = key0 + r < end && ch < c;
      const float* from = ok ? xb + static_cast<size_t>(key0 + r) * c + ch : xb;
      r3d::cp_async16(dst + r * kDP + ((q ^ swz(r)) << 2), from, ok);
    }
  } else {
    const int lg = w == 16 ? 4 : 6;
    for (int e = threadIdx.x; e < kChunk * w; e += kThreads) {
      const int r = e >> lg;
      const int cc = e & (w - 1);
      const int ch = ch0 + cc;
      const bool ok = key0 + r < end && ch < c;
      const float* from = ok ? xb + static_cast<size_t>(key0 + r) * c + ch : xb;
      r3d::cp_async4(dst + r * kDP + (((cc >> 2) ^ swz(r)) << 2) + (cc & 3), from, ok);
    }
  }
}

// The bf16 route's tile: key r's channels [8q, 8q + 8) are the 16 bytes at
// r * 128 + ((q ^ (r % 8)) << 4).  A fragment load (8 bytes: row 8j + g,
// channels 16kk + 4t ..) then spreads a warp over all 32 banks twice.
// 16-byte copies where c % 8 == 0 on a 16-byte aligned base (C = 64: one
// 128-byte line a key), else 2-byte loads stored as they arrive (C = 9).
__device__ __forceinline__ void stage_keys(const uint16_t* xb, int key0, int end, int c, int ch0,
                                           int w, bool vec, unsigned char* tile) {
  if (vec) {
    const int lg = w == 16 ? 1 : 3;  // log2 of the 16-byte chunks per key
    for (int e = threadIdx.x; e < kChunk * w / 8; e += kThreads) {
      const int r = e >> lg;
      const int q = e & ((w >> 3) - 1);
      const int ch = ch0 + 8 * q;
      const bool ok = key0 + r < end && ch < c;
      const uint16_t* from = ok ? xb + static_cast<size_t>(key0 + r) * c + ch : xb;
      r3d::cp_async16(tile + r * kKeyBytes + ((q ^ (r & 7)) << 4), from, ok);
    }
  } else {
    const int lg = w == 16 ? 4 : 6;
    for (int e = threadIdx.x; e < kChunk * w; e += kThreads) {
      const int r = e >> lg;
      const int cc = e & (w - 1);
      const int ch = ch0 + cc;
      const bool ok = key0 + r < end && ch < c;
      const uint16_t v = ok ? __ldg(xb + static_cast<size_t>(key0 + r) * c + ch) : uint16_t{0};
      *reinterpret_cast<uint16_t*>(tile + r * kKeyBytes + (((cc >> 3) ^ (r & 7)) << 4) +
                                   2 * (cc & 7)) = v;
    }
  }
}

// The norms of 64 points over one channel chunk of G 4-channel groups into
// out[0 .. 64) (or added to it, after the first chunk): `group(r, q)` gives
// point r's group q.  Four neighbouring threads share a point, thread u
// taking groups u, u + 4, ...; each sums its groups in a fixed tree and
// the four partial sums meet in a fixed xor tree, the same for a point as
// a key and as a query.
template <int G, typename Group>
__device__ __forceinline__ void chunk_norms(Group group, float* out, bool first) {
  constexpr int kV = G / 4;  // groups per thread: 1 or 4
  const int u = threadIdx.x & 3;
  float s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (threadIdx.x >> 2) + 32 * i;
    float n[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) n[v] = group_norm(group(r, u + 4 * v));
    if constexpr (kV == 1) {
      s[i] = n[0];
    } else {
      s[i] = (n[0] + n[1]) + (n[2] + n[3]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i] += __shfl_xor_sync(kFull, s[i], off);
  if (u == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (threadIdx.x >> 2) + 32 * i;
      out[r] = first ? s[i] : out[r] + s[i];
    }
  }
}

template <typename Group>
__device__ __forceinline__ void tile_norms(Group group, int w, float* kk_s, bool first) {
  if (w == 16) {
    chunk_norms<4>(group, kk_s, first);
  } else {
    chunk_norms<16>(group, kk_s, first);
  }
}

// An arrived tile of width w: the f32 route splits it in place into tf32 hi
// and `lo`; both take its keys' norms over the chunk into kk_s, from the
// values as staged (a bf16 value widened: the bits of its f32 upcast).
__device__ __forceinline__ void prepare_keys(float* hi, float* lo, int w, float* kk_s, bool first) {
  tile_norms(
      [&](int r, int q) {
        const int at = r * kDP + ((q ^ swz(r)) << 2);
        const float4 v = *reinterpret_cast<const float4*>(hi + at);
        uint32_t h[4], l[4];
        r3d::split_tf32(v.x, h[0], l[0]);
        r3d::split_tf32(v.y, h[1], l[1]);
        r3d::split_tf32(v.z, h[2], l[2]);
        r3d::split_tf32(v.w, h[3], l[3]);
        *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
        return v;
      },
      w, kk_s, first);
}

__device__ __forceinline__ void prepare_keys(const unsigned char* tile, int w, float* kk_s,
                                             bool first) {
  tile_norms(
      [&](int r, int q) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            tile + r * kKeyBytes + (((q >> 1) ^ (r & 7)) << 4) + 8 * (q & 1));
        return make_float4(r3d::bf16_lo(v.x), r3d::bf16_hi(v.x), r3d::bf16_lo(v.y),
                           r3d::bf16_hi(v.y));
      },
      w, kk_s, first);
}

// The norms of the block's 64 query rows into qq_s, by prepare_keys' rule
// (the same bits a key of the same point gets).
template <typename T>
__device__ __forceinline__ void query_norms(const T* xb, int row0, int n, int c, int nchunk,
                                            float* qq_s) {
  for (int h = 0; h < nchunk; ++h) {
    tile_norms(
        [&](int r, int q) {
          const int ch = h * kDP + 4 * q;
          const T* src = xb + static_cast<size_t>(row0 + r) * c + ch;
          const bool live = row0 + r < n;
          return make_float4(live && ch < c ? widen(src[0]) : 0.f,
                             live && ch + 1 < c ? widen(src[1]) : 0.f,
                             live && ch + 2 < c ? widen(src[2]) : 0.f,
                             live && ch + 3 < c ? widen(src[3]) : 0.f);
        },
        chunk_width(c, h), qq_s, h == 0);
    __syncthreads();  // chunks of another width give a point to another thread
  }
}

// A warp's 16 query rows [row0, row0 + 16), channels [ch0, ch0 + 64), as
// attention.cuh's load_rows leaves them (4-byte loads: any C); zeros past
// n and c.
__device__ __forceinline__ void load_query(const float* xb, int row0, int n, int c, int ch0,
                                           float4 (&x)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + 8 * hf;
      const int ch = ch0 + 16 * kk + 4 * t;
      const float* src = xb + static_cast<size_t>(r) * c + ch;
      const bool live = r < n;
      x[kk][hf] = make_float4(live && ch < c ? src[0] : 0.f, live && ch + 1 < c ? src[1] : 0.f,
                              live && ch + 2 < c ? src[2] : 0.f, live && ch + 3 < c ? src[3] : 0.f);
    }
}

// The same channels of the same rows as bf16 pairs: q[kk][hf][0] holds
// channels 16kk + 4t and + 1 (low half first), q[kk][hf][1] + 2 and + 3.
__device__ __forceinline__ void load_query(const uint16_t* xb, int row0, int n, int c, int ch0,
                                           uint32_t (&q)[4][2][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + 8 * hf;
      const int ch = ch0 + 16 * kk + 4 * t;
      const uint16_t* src = xb + static_cast<size_t>(r) * c + ch;
      const bool live = r < n;
      uint32_t e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = live && ch + i < c ? src[i] : 0u;
      q[kk][hf][0] = e[0] | e[1] << 16;
      q[kk][hf][1] = e[2] | e[3] << 16;
    }
}

// The f32 route's inner products: 3xTF32 (attention.cuh).
__device__ __forceinline__ void inner_products(float (&acc)[8][4], const float4 (&qr)[4][2],
                                               const unsigned char* tile, const float* lo, int w,
                                               const Lane& ln) {
  product_along_channels<8, false>(acc, qr, reinterpret_cast<const float*>(tile), lo, 0, w, ln);
}

// The bf16 route's: acc[j] += X Y^T over the channels, X the warp's rows
// (bf16 pairs), Y the tile's keys 8j + g, one tf32 mma.sync.m16n8k8 per
// 8-channel k-step in the f32 route's k-grouping (k-step 2kk + h takes
// channels 16kk + 4t + 2h and + 1).  A bf16 value widened (its bits << 16)
// is a tf32 value, its 3xTF32 split has hi = the value and lo = 0, and the
// f32 route's three passes add two all-zero products before hi hi: this
// one pass adds the same products to the same sums in the same order.
__device__ __forceinline__ void inner_products(float (&acc)[8][4], const uint32_t (&q)[4][2][2],
                                               const unsigned char* tile, const float*, int w,
                                               const Lane& ln) {
  const unsigned char* row = tile + ln.g * kKeyBytes + 8 * (ln.t & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= w) break;
    const int chunk = ((2 * kk + (ln.t >> 1)) ^ ln.g) << 4;
    uint2 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const uint2*>(row + 8 * kKeyBytes * j + chunk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a[4] = {q[kk][0][h] << 16, q[kk][1][h] << 16, q[kk][0][h] & 0xffff0000u,
                             q[kk][1][h] & 0xffff0000u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t bw = h ? b[j].y : b[j].x;
        r3d::mma_tf32(acc[j], a, bw << 16, bw & 0xffff0000u);
      }
    }
  }
}

// A row's list: its k nearest keys so far, the largest first, K = 2 H
// slots in two lanes' registers: lane r < 16 holds slots 0 .. H - 1 of
// warp row r (the upper half; its slot 0 is the row's k-th distance),
// lane r + 16 slots H .. K - 1.  Slots past k hold -inf, below any
// distance, so they never move.
template <int H>
struct List {
  float d[H];
  int i[H];

  __device__ __forceinline__ bool lower() const { return threadIdx.x & 16; }

  __device__ __forceinline__ void reset(int k) {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s) {
      d[s] = base + s < k ? INFINITY : -INFINITY;
      i[s] = -1;
    }
  }

  // The row's k-th distance, in both lanes of the row.
  __device__ __forceinline__ float top() const { return __shfl_sync(kFull, d[0], threadIdx.x & 15); }

  // (dv, iv) replaces this half's slot 0 and sinks to its place by a fixed
  // chain (the carried distance is a min: one dependent FMNMX a slot).  It
  // sinks past an equal distance only when `force`d: a newcomer comes after
  // the keys of its distance in (d, index) order (keys reach a list in
  // index order), the lower half's top moving up comes before them.
  __device__ __forceinline__ void insert(float dv, int iv, bool force) {
#pragma unroll
    for (int s = 0; s + 1 < H; ++s) {
      const float nd = d[s + 1];
      const int ni = i[s + 1];
      const bool sink = force || dv < nd;
      d[s] = fmaxf(dv, nd);
      i[s] = sink ? ni : iv;
      dv = fminf(dv, nd);
      iv = sink ? iv : ni;
    }
    d[H - 1] = dv;
    i[H - 1] = iv;
  }

  // Offer (dv, iv), the same in both lanes of a row (dv = +inf: nothing),
  // with the whole warp converged.  Below the row's k-th it enters: into
  // the lower half if below that half's top, which then moves up into the
  // upper half in place of the row's largest; else into the upper half.
  // Both halves run their chain at once.
  __device__ __forceinline__ void offer(float dv, int iv) {
    const bool below = dv < d[0];  // the lower lane's test
    const int mate = threadIdx.x | 16;
    const float up_d = __shfl_sync(kFull, below ? d[0] : dv, mate);
    const int up_i = __shfl_sync(kFull, below ? i[0] : iv, mate);
    const bool up_force = __shfl_sync(kFull, below, mate);
    if (!(dv < top())) return;
    if (lower()) {
      if (below) insert(dv, iv, false);
    } else {
      insert(up_d, up_i, up_force);
    }
  }

  // This half's real slots of the k, smallest first: indices into an int
  // row, or (d, index) pairs into a partial list.
  __device__ __forceinline__ void write(int k, int* dst) const {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s)
      if (base + s < k) dst[k - 1 - base - s] = i[s];
  }
  __device__ __forceinline__ void write(int k, int2* dst) const {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s)
      if (base + s < k) dst[k - 1 - base - s] = make_int2(__float_as_int(d[s]), i[s]);
  }
};

// Before a split's first merge, a bound on each row's k-th distance from
// the first tile alone, so that not all 64 keys need merging: each lane
// keeps the M = ceil(K / 4) smallest of its 16 distances of the row, and
// the largest of its quad's M-th smallest has at least 4 M >= k of the
// tile's distances at or below it.  thr becomes the next float above it
// (a key survives if d < thr).  d holds +inf past the keys.
template <int K>
__device__ __forceinline__ void first_tile_bound(const float (&d)[8][4], float (&thr)[2]) {
  constexpr int M = (K + 3) / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float least[M];
#pragma unroll
    for (int s = 0; s < M; ++s) least[s] = INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = d[j][2 * r + e];
#pragma unroll
        for (int s = 0; s < M; ++s) {
          const float lo = fminf(least[s], v);
          v = fmaxf(least[s], v);
          least[s] = lo;
        }
      }
    float b = least[M - 1];
    b = fmaxf(b, __shfl_xor_sync(kFull, b, 1));
    b = fmaxf(b, __shfl_xor_sync(kFull, b, 2));
    thr[r] = b < INFINITY ? __uint_as_float(__float_as_uint(b + 0.f) + 1u) : INFINITY;
  }
}

// T: the staged element (Route).  The f32 route runs three blocks an SM
// (12 warps): 168 registers, a few bytes of spill, faster than two blocks
// without spill (PERF.md, section 6).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, Route<T>::kBlocks)
knn_kernel(const T* __restrict__ x, int* __restrict__ out, int2* part, unsigned* arrived, int n,
           int c, int k, int vec) {
  constexpr int kStages = Route<T>::kStages;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_block;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  float* lo = reinterpret_cast<float*>(ring + kStages * Route<T>::kTile);  // f32 route only
  float* kk_s = reinterpret_cast<float*>(ring + Route<T>::kRing);
  float* qq_s = kk_s + kChunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* batch = qq_s + kChunk + warp * 16 * kStride;
  const Lane ln = lane_offsets();
  const int g = ln.g;
  const int t = ln.t;
  const int b = blockIdx.y;
  const int splits = gridDim.z;
  const int row0 = blockIdx.x * kChunk;
  const int row0w = row0 + 16 * warp;
  const T* xb = x + static_cast<size_t>(b) * n * c;
  const int tiles = (n + kChunk - 1) / kChunk;
  const int per_split = (tiles + splits - 1) / splits;
  const int t0 = blockIdx.z * per_split;
  const int t1 = min(tiles, t0 + per_split);
  const int end = min(n, t1 * kChunk);
  const int nchunk = (c + kDP - 1) / kDP;
  const int units = max(0, t1 - t0) * nchunk;  // (key tile, channel chunk) pairs
  // issue unit v's copy into its stage
  auto stage = [&](int v) {
    const int hv = v % nchunk;
    stage_keys(xb, (t0 + v / nchunk) * kChunk, end, c, hv * kDP, chunk_width(c, hv), vec,
               ring + (v % kStages) * Route<T>::kTile);
  };

  for (int v = 0; v + 1 < kStages; ++v) {
    if (v < units) stage(v);
    r3d::cp_async_commit();
  }
  query_norms(xb, row0, n, c, nchunk, qq_s);
  typename Route<T>::Query qr;
  if (nchunk == 1) load_query(xb, row0w, n, c, 0, qr);

  List<K / 2> list;  // lanes r and r + 16: row row0w + r
  list.reset(k);
  float thr[2] = {INFINITY, INFINITY};  // the k-th distance of rows g and g + 8
  float acc[8][4];
  for (int u = 0; u < units; ++u) {
    const int tile = t0 + u / nchunk;
    const int h = u - (u / nchunk) * nchunk;
    unsigned char* keys = ring + (u % kStages) * Route<T>::kTile;
    r3d::cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u has arrived; every warp is done with unit u - 1
    if (u + kStages - 1 < units) stage(u + kStages - 1);
    r3d::cp_async_commit();
    const int w = chunk_width(c, h);
    if constexpr (kStages == 2) {
      prepare_keys(reinterpret_cast<float*>(keys), lo, w, kk_s, h == 0);
    } else {
      prepare_keys(keys, w, kk_s, h == 0);
    }
    __syncthreads();

    // 1. inner products
    if (nchunk > 1) load_query(xb, row0w, n, c, h * kDP, qr);
    if (h == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    inner_products(acc, qr, keys, lo, w, ln);
    if (h + 1 < nchunk) continue;

    // 2. distances and survivors; e < 2: row g, e >= 2: row g + 8
    const int key0 = tile * kChunk;
    const float qq[2] = {qq_s[16 * warp + g], qq_s[16 * warp + g + 8]};
    unsigned mask[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(kk_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + 8 * j + 2 * t + (e & 1);
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(qq[e >> 1], (e & 1) ? kv.y : kv.x), __fmul_rn(2.f, acc[j][e])),
            0.f);
        acc[j][e] = col < end ? d : INFINITY;
      }
    }
    if (tile == t0) first_tile_bound<K>(acc, thr);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (acc[j][e] < thr[e >> 1]) mask[e >> 1] |= 1u << (2 * j + (e & 1));
    // 3. the survivors into their rows' batches by column, each row's as a
    // mask of the tile's 64 columns; then the merges
    if (!__any_sync(kFull, mask[0] | mask[1])) continue;
    float* rows[2] = {batch + g * kStride, batch + (g + 8) * kStride};
    unsigned long long cols[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned long long m = 0ull;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m |= static_cast<unsigned long long>(mask[r] >> (2 * j) & 3u) << (8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (mask[r] >> (2 * j + e) & 1u) rows[r][8 * j + 2 * t + e] = acc[j][2 * r + e];
      }
      m |= __shfl_xor_sync(kFull, m, 1);
      cols[r] = m | __shfl_xor_sync(kFull, m, 2);
    }
    __syncwarp();
    // lanes r and r + 16 (r < 8) merge row r, quad r's row g; lanes 8 + r
    // and 24 + r row 8 + r, quad r's row g + 8
    const int from = 4 * (lane & 7);
    const unsigned long long cols_g = __shfl_sync(kFull, cols[0], from);
    const unsigned long long cols_g8 = __shfl_sync(kFull, cols[1], from);
    unsigned long long todo = (lane & 15) < 8 ? cols_g : cols_g8;
    const float* mine = batch + (lane & 15) * kStride;
    const int rounds = __reduce_max_sync(kFull, __popcll(todo));
    for (int it = 0; it < rounds; ++it) {
      const int col = todo ? __ffsll(static_cast<long long>(todo)) - 1 : 0;
      const float dv = todo ? mine[col] : INFINITY;
      todo &= todo - 1;
      list.offer(dv, key0 + col);
    }
    __syncwarp();
    thr[0] = __shfl_sync(kFull, list.d[0], g);
    thr[1] = __shfl_sync(kFull, list.d[0], g + 8);
  }

  const int row = min(row0w + (lane & 15), n - 1);
  const bool live = row0w + (lane & 15) < n;
  if (splits == 1) {
    if (live) list.write(k, out + (static_cast<size_t>(b) * n + row) * k);
    return;
  }
  // Splits: leave this split's lists, and the last block of the row tile
  // merges all of them.
  if (live) list.write(k, part + ((static_cast<size_t>(b) * splits + blockIdx.z) * n + row) * k);
  __threadfence();
  __syncthreads();
  unsigned* counter = arrived + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last_block = atomicAdd(counter, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  list.reset(k);
  for (int sp = 0; sp < splits; ++sp) {
    const int2* from = part + ((static_cast<size_t>(b) * splits + sp) * n + row) * k;
    for (int j = 0; j < k; ++j) {
      const float dv = live ? __int_as_float(__ldcg(&from[j].x)) : INFINITY;
      if (!__any_sync(kFull, dv < list.top())) break;  // every split's list is ascending
      list.offer(dv, __ldcg(&from[j].y));
    }
  }
  if (live) list.write(k, out + (static_cast<size_t>(b) * n + row) * k);
  if (threadIdx.x == 0) *counter = 0u;
}

template <typename T, int K>
cudaError_t launch(const T* x, int* out, int2* part, unsigned* arrived, int b, int n, int c, int k,
                   int splits, cudaStream_t st) {
  // whole 16-byte copies: 4 f32 or 8 bf16 channels, on a 16-byte aligned base
  const int vec = c % (16 / sizeof(T)) == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const dim3 grid((n + kChunk - 1) / kChunk, b, splits);
  return r3d_launch(knn_kernel<T, K>, grid, dim3(kThreads), smem_bytes<T>(), st, x, out, part,
                    arrived, n, c, k, vec);
}

template <typename T>
cudaError_t knn(const void* x, void* out, void* part, void* arrived, int b, int n, int c, int k,
                int splits, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || c < 1 || c > kMaxC || k < 1 || k > kMaxK || k > n ||
      splits < 1 || splits > 64 || (splits > 1 && (part == nullptr || arrived == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const auto xp = static_cast<const T*>(x);
  const auto op = static_cast<int*>(out);
  const auto pp = static_cast<int2*>(part);
  const auto ap = static_cast<unsigned*>(arrived);
  const auto st = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch<T, 8>(xp, op, pp, ap, b, n, c, k, splits, st);
  if (k <= 16) return launch<T, 16>(xp, op, pp, ap, b, n, c, k, splits, st);
  if (k <= 20) return launch<T, 20>(xp, op, pp, ap, b, n, c, k, splits, st);
  return launch<T, 32>(xp, op, pp, ap, b, n, c, k, splits, st);
}

template <typename T>
cudaError_t attributes(int k, int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes a;
  const auto kernel = k <= 8    ? &knn_kernel<T, 8>
                      : k <= 16 ? &knn_kernel<T, 16>
                      : k <= 20 ? &knn_kernel<T, 20>
                                : &knn_kernel<T, 32>;
  cudaError_t err = r3d_set_smem(kernel, smem_bytes<T>());
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        smem_bytes<T>());
  }
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// One scan of all keys per row tile; x f32, or bf16 (the _bf16 entries).
R3D_EXPORT int r3d_knn(const void* x, void* out, int b, int n, int c, int k, void* stream) {
  return knn<float>(x, out, nullptr, nullptr, b, n, c, k, 1, stream);
}

R3D_EXPORT int r3d_knn_bf16(const void* x, void* out, int b, int n, int c, int k, void* stream) {
  return knn<uint16_t>(x, out, nullptr, nullptr, b, n, c, k, 1, stream);
}

// `splits` key splits per row tile.  part: (b, splits, n, k) 8-byte
// scratch ((d, index) pairs); arrived: (b, ceil(n / 64)) uint32, zero on entry and on return.
R3D_EXPORT int r3d_knn_split(const void* x, void* out, void* part, void* arrived, int b, int n,
                             int c, int k, int splits, void* stream) {
  return knn<float>(x, out, part, arrived, b, n, c, k, splits, stream);
}

R3D_EXPORT int r3d_knn_split_bf16(const void* x, void* out, void* part, void* arrived, int b,
                                  int n, int c, int k, int splits, void* stream) {
  return knn<uint16_t>(x, out, part, arrived, b, n, c, k, splits, stream);
}

// The kernel that a call with this k launches (bf16: the bf16 route's):
// its registers a thread, local memory (spill) bytes a thread, and blocks
// an SM at its shared memory.
R3D_EXPORT int r3d_knn_attributes(int bf16, int k, int* regs, int* local_bytes,
                                  int* blocks_per_sm) {
  return bf16 ? attributes<uint16_t>(k, regs, local_bytes, blocks_per_sm)
              : attributes<float>(k, regs, local_bytes, blocks_per_sm);
}
