// k-nearest-neighbour search at any k <= N and any C, in both modes of the
// TPU kernel: exact keys, and packed keys.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_knn.py:_knn_kernel
// (knn_indices_pallas :99) where csrc/knn.cu does not take the shape (k > 32
// or C > 256), and in its packed mode (exact=False, :74-95, knn_impl
// "pallas") at every shape.  Each (row, column) gets one unsigned key, so
// the keys of a row are unique and its k smallest are one set in one order,
// whatever order they are visited in:
//   exact:  key = bits(d) << 32 | col (64 bits), d = max((qq + kk) - 2 inner,
//           0) (ops/knn.py's grouping): by distance, then lowest index, as
//           `knn_indices`;
//   packed: key = (bits(d) & ~low) | col (32 bits), d = max((qq - 2 inner) +
//           kk, 0) (pallas_knn.py:74's grouping), low = the bit_length(N - 1)
//           low bits: the TPU kernel's int32 key, whose low bits are the
//           column.
// d >= 0 is never -0 (qq, kk >= +0, and x - x = +0), so its bits order as
// its value.  qq and kk come from one pre-pass (one fma chain per point over
// its channels in order), and inner(i, j) is one fma chain from +0 over the
// channels in order (zero-filled channels add +0 products, which leave such
// a chain's bits as they are), so inner(i, j) = inner(j, i) bit for bit and
// every key is the one the earlier simple FFMA kernel built: the output is
// bit-equal to its output on every input.
//
// What bounds it on the H100: the inner products, 2 B N^2 C operations, in
// FFMA against 67 TFLOP/s (f32 fma chains keep the keys' bits, and with them
// chip_smoke.packed_agreement's rounding model), and the selection of k of N
// keys per row, which no peak rate covers: most keys are rejected by one
// compare with the row's k-th, and about k (1 + ln(N / k)) a row enter its
// list.
//
// Design.  Grid (ceil(N / 64), B, S), blocks of 4 warps and 64 query rows,
// warp w owning rows 16 w .. 16 w + 15.
// 1. Register micro-tiles.  Lane (g, t) = (lane / 8, lane % 8) sums the
//    products of its rows g + 4 i (i < 4) with the tile's keys t + 8 j (j <
//    8) in 32 registers: per 4 channels 4 + 8 16-byte shared loads for 128
//    FMAs, and each staged key serves the block's 64 rows.  Points are staged
//    in rows of an odd number of 16-byte groups, so the 4 rows and the 8 keys
//    that a load reads at once lie on distinct banks.
// 2. A 3-stage cp.async ring of (key tile, channel chunk) units: 64 keys x 32
//    channels and the keys' norms, 16-byte copies where C % 4 == 0, else
//    4-byte copies zero-filled to a multiple of 4 channels (C = 9 runs 12).
//    Any C runs in chunks, the accumulators carried across them.  The
//    block's queries stay in shared memory for the whole scan up to C = 256;
//    past it each unit stages its query chunk beside the keys.
// 3. Threshold-filtered, batched selection.  Each lane keeps its four rows'
//    current k-th keys in registers; a key below its row's goes into the
//    row's batch in shared memory (a shared atomic counter gives its slot:
//    keys are unique, so their order in a batch does not matter), and after
//    each tile the warp merges its rows' batches into their lists and reloads
//    the thresholds.  k <= 64: a row's list in two lanes' registers (lanes r
//    and r + 16, half each, the largest first; a key below the k-th sinks
//    into one half by a fixed chain of compares, both halves in one code
//    path, as csrc/knn.cu's List; past k = 32 two blocks an SM, so the list
//    does not spill), and before a scan's first merge a bound from its first
//    tile (each lane's ceil(k / 8)-th smallest key of the row, the largest of
//    the row's 8 lanes) keeps most of that tile's 64 keys out.  k > 64: the
//    list ascending in shared memory, or in device memory where 64 rows of
//    lists do not fit (k past about 400), and the warp merges one row's batch
//    at a time, 32 keys at once, by one sorted merge: a key's place is its
//    rank in the batch plus its rank in the list (a binary search), and each
//    list key above the batch's least moves up by the number of batch keys
//    below it, from the top down in steps of 32 (each step read, then
//    written).  (At k = 40 such lists were measured slower than registers:
//    PERF.md, section 6.)
// 4. Key splits where B x ceil(N / 64) blocks would leave SMs idle
//    (ops/cuda_knn.py:splits; B = 2 at N = 2048 takes 4): each block scans
//    its share of the key tiles and leaves its rows' lists in scratch, and
//    the last block of a row tile to arrive (threadfence, atomic counter,
//    reset to 0 after) merges the other splits' lists into its own by key.
// No float atomics: a call repeats bit for bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;            // query rows per block
constexpr int kWarps = 4;            // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;            // keys per staged tile (= kRows: one staging routine)
constexpr int kChunk = 32;           // channels per staged chunk
constexpr int kLd = kChunk + 4;      // floats per staged point: 9 groups of 4
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kResidentC = 256;      // queries stay in shared memory up to this C
constexpr int kMaxRegK = 64;         // lists in registers up to this k
constexpr int kBatchLd = kTile + 1;  // keys per batch row: a warp's 16 rows on distinct banks
constexpr unsigned kFull = 0xffffffffu;

// The two key forms; `make` is the earlier kernel's arithmetic, operation
// for operation.
template <bool kPacked>
struct Keys;

template <>
struct Keys<true> {
  using Key = uint32_t;
  __device__ static __forceinline__ Key make(float qq, float kk, float inner, int col,
                                             unsigned low) {
    const float d = fmaxf(__fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, inner)), kk), 0.f);
    return (__float_as_uint(d) & ~low) | static_cast<unsigned>(col);
  }
  __device__ static __forceinline__ int index(Key key, unsigned low) {
    return static_cast<int>(key & low);
  }
};

template <>
struct Keys<false> {
  using Key = unsigned long long;
  __device__ static __forceinline__ Key make(float qq, float kk, float inner, int col,
                                             unsigned) {
    const float d = fmaxf(__fsub_rn(__fadd_rn(qq, kk), __fmul_rn(2.f, inner)), 0.f);
    return static_cast<Key>(__float_as_uint(d)) << 32 | static_cast<unsigned>(col);
  }
  __device__ static __forceinline__ int index(Key key, unsigned) {
    return static_cast<int>(static_cast<unsigned>(key));
  }
};

// Where a call keeps its lists.
enum Place : int { kInRegisters = 0, kInShared = 1, kInDevice = 2 };

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// A block's shared memory, in bytes: the ring, the resident queries, the
// survivor batches (64 keys a row) and their counters, the merges' sorted
// batches (32 keys a warp), the lists.
struct Layout {
  int ldq;       // floats per resident query row; 0: queries staged with each chunk
  size_t stage;  // one ring stage: keys, their norms, [the query chunk]
  size_t q, batch, cnt, sorted, lists, total;
};

__host__ __device__ inline Layout layout(int c, int k, int key_bytes, int place) {
  Layout l;
  const int w = (c + 3) & ~3;
  l.ldq = c <= kResidentC ? ((w + 7) & ~7) + 4 : 0;  // an odd number of 4-float groups
  l.stage = sizeof(float) * (kTile * kLd + kTile + (l.ldq ? 0 : kRows * kLd));
  l.q = kStages * l.stage;
  l.batch = align16(l.q + sizeof(float) * kRows * l.ldq);
  l.cnt = align16(l.batch + static_cast<size_t>(key_bytes) * kRows * kBatchLd);
  l.sorted = align16(l.cnt + sizeof(int) * kRows);
  l.lists = l.sorted + (place != kInRegisters ? static_cast<size_t>(key_bytes) * kWarps * 32 : 0);
  l.total = l.lists + (place == kInShared ? static_cast<size_t>(key_bytes) * kRows * k : 0);
  return l;
}

int list_place(int c, int k, int key_bytes) {
  if (k <= kMaxRegK) return kInRegisters;
  return layout(c, k, key_bytes, kInShared).total + 64 <= r3d::kSmemLimit ? kInShared : kInDevice;
}

// Channels [ch0, ch0 + w) of a chunk: 32, or what is left rounded up to 4.
__device__ __forceinline__ int chunk_width(int c, int ch0) {
  const int left = c - ch0;
  return left >= kChunk ? kChunk : (left + 3) & ~3;
}

// Issue the copies of points [p0, p0 + 64) below `lim`, channels [ch0, ch0 +
// w) (w a multiple of 4), into rows of `ld` floats at dst; zeros past lim and
// past c.  `vec`: c % 4 == 0 and x 16-byte aligned.
__device__ __forceinline__ void stage_points(const float* xb, int p0, int lim, int c, int ch0,
                                             int w, int ld, bool vec, float* dst) {
  if (vec) {
    const int groups = w >> 2;
    for (int e = threadIdx.x; e < kTile * groups; e += kThreads) {
      const int r = e / groups;
      const int q = e - r * groups;
      const bool ok = p0 + r < lim;
      const float* from = ok ? xb + static_cast<size_t>(p0 + r) * c + ch0 + 4 * q : xb;
      r3d::cp_async16(dst + r * ld + 4 * q, from, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * w; e += kThreads) {
      const int r = e / w;
      const int cc = e - r * w;
      const bool ok = p0 + r < lim && ch0 + cc < c;
      const float* from = ok ? xb + static_cast<size_t>(p0 + r) * c + ch0 + cc : xb;
      r3d::cp_async4(dst + r * ld + cc, from, ok);
    }
  }
}

// acc[i][j] += the products of the lane's row g + 4 i of the warp with key t
// + 8 j over w channels (a multiple of 4), one fma chain each, channels in
// order.  qs: the block's query rows (ld lq) at the chunk's first channel;
// ks: the staged key chunk.
__device__ __forceinline__ void products(float (&acc)[4][8], const float* qs, int lq,
                                         const float* ks, int w) {
  const int lane = threadIdx.x & 31;
  const float* qp = qs + (16 * (threadIdx.x >> 5) + (lane >> 3)) * lq;
  const float* kp = ks + (lane & 7) * kLd;
#pragma unroll 2
  for (int g = 0; g < w; g += 4) {
    float4 a[4], v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qp + 4 * i * lq + g);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = *reinterpret_cast<const float4*>(kp + 8 * j * kLd + g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
      }
  }
}

// A row's list for k <= 64: its k smallest keys so far, the largest first,
// K = 2 H slots in two lanes' registers: lane r < 16 holds slots 0 .. H - 1
// of warp row r (its slot 0 is the row's k-th key), lane r + 16 slots H ..
// K - 1.  Empty real slots hold the largest key (~0, above any real key);
// slots past k hold 0, which no key is below, so they never move.
template <typename Key, int H>
struct List {
  Key v[H];

  __device__ __forceinline__ bool lower() const { return threadIdx.x & 16; }

  __device__ __forceinline__ void reset(int k) {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s) v[s] = base + s < k ? ~Key(0) : Key(0);
  }

  // The row's k-th key, in both lanes of the row.
  __device__ __forceinline__ Key top() const { return __shfl_sync(kFull, v[0], threadIdx.x & 15); }

  // x replaces this half's slot 0 and sinks to its place.
  __device__ __forceinline__ void insert(Key x) {
#pragma unroll
    for (int s = 0; s + 1 < H; ++s) {
      const Key nx = v[s + 1];
      const bool sink = x < nx;
      v[s] = sink ? nx : x;
      x = sink ? x : nx;
    }
    v[H - 1] = x;
  }

  // Offer x, the same in both lanes of a row (~0: nothing), with the whole
  // warp converged.  Below the row's k-th it enters: into the lower half if
  // below that half's largest, which then moves up into the upper half in
  // place of the row's k-th; else into the upper half.  Both halves run one
  // insert at once.
  __device__ __forceinline__ void offer(Key x) {
    const bool below = x < v[0];  // the lower lane's test
    const Key up = __shfl_sync(kFull, below ? v[0] : x, threadIdx.x | 16);
    if (x < top() && (below || !lower())) insert(lower() ? x : up);
  }

  // This half's real slots, smallest first: keys into a partial list, or
  // their columns into an output row.
  __device__ __forceinline__ void write(int k, Key* dst) const {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s)
      if (base + s < k) dst[k - 1 - base - s] = v[s];
  }
  template <typename Index>
  __device__ __forceinline__ void write(int k, int* dst, Index index) const {
    const int base = lower() ? H : 0;
#pragma unroll
    for (int s = 0; s < H; ++s)
      if (base + s < k) dst[k - 1 - base - s] = index(v[s]);
  }
};

// Before a scan's first merge (lists in registers, k <= 64), a bound on the
// k-th key of one of the lane's rows from the first tile alone, so that not
// all 64 of its keys reach the list: the lane takes the m-th smallest of its
// 8 keys of the row (~0 past the keys), m = ceil(k / 8), and the largest of
// those over the row's 8 lanes has at least 8 m >= k of the tile's keys at
// or below it.  ~0 where no bound is found.
template <typename Key>
__device__ __forceinline__ Key first_tile_bound(const Key (&key)[8], int k) {
  const int m = (k + 7) >> 3;
  Key b = Key(0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int rank = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) rank += key[t] < key[j];
    if (rank < m && key[j] > b) b = key[j];
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const Key o = __shfl_xor_sync(kFull, b, off);
    b = o > b ? o : b;
  }
  return b;
}

// The warp merges candidate c (one per lane, ~0: none; unique keys) into the
// ascending list lst of k keys: the candidates below lst[k - 1] enter, the
// largest keys leave.  sorted: 32 keys of scratch.
template <typename Key>
__device__ __forceinline__ void merge_batch(Key* lst, int k, Key c, Key* sorted) {
  constexpr Key kNone = ~Key(0);
  const int lane = threadIdx.x & 31;
  if (!(c < lst[k - 1])) c = kNone;
  const unsigned valid = __ballot_sync(kFull, c != kNone);
  if (!valid) return;
  int rank = 0;  // among the candidates
#pragma unroll 8
  for (int t = 0; t < 32; ++t) rank += __shfl_sync(kFull, c, t) < c;
  int lo = 0;  // in the list: #{lst < c}
  if (c != kNone) {
    int hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lst[mid] < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    sorted[rank] = c;
  }
  __syncwarp();
  const int m = __popc(valid);
  const int least = __ffs(__ballot_sync(kFull, c != kNone && rank == 0)) - 1;
  const int p0 = __shfl_sync(kFull, lo, least);  // list keys below every candidate stay
  int len = k;  // the list's keys: those past them are ~0 and stay so
  if (lst[k - 1] == kNone) {
    int hi = k;
    len = p0;
    while (len < hi) {
      const int mid = (len + hi) >> 1;
      if (lst[mid] != kNone) {
        len = mid + 1;
      } else {
        hi = mid;
      }
    }
  }
  for (int top = min(k - 1, len); top > p0; top -= 32) {  // keys [max(p0, top - 32), top) move up
    const int i = top - 1 - lane;
    Key v = kNone;
    int to = k;
    if (i >= p0) {
      v = lst[i];
      int a = 0, z = m;  // #{candidates < v}
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (sorted[mid] < v) {
          a = mid + 1;
        } else {
          z = mid;
        }
      }
      to = i + a;
    }
    __syncwarp();
    if (to < k) lst[to] = v;
    __syncwarp();
  }
  if (c != kNone && lo + rank < k) lst[lo + rank] = c;
  __syncwarp();
}

__global__ void knn_norms_kernel(const float* __restrict__ x, float* __restrict__ nrm, int rows,
                                 int c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + static_cast<size_t>(r) * c;
  float s = 0.f;
  for (int ch = 0; ch < c; ++ch) s = fmaf(p[ch], p[ch], s);
  nrm[r] = s;
}

// K: the register list's slots (8, 20, 32, 48 or 64; past 32 two blocks an
// SM, so that the list's registers do not spill), or 0 for lists in memory
// (`place` kInShared or kInDevice).  part: (B, S, N, k) keys, each split's
// lists (and the lists themselves where they live in device memory);
// arrived: (B, ceil(N / 64)) counters, zero on entry and on return.
template <bool kPacked, int K>
__global__ void __launch_bounds__(kThreads, K > 32 ? 2 : 3)
knn_general_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                   int* __restrict__ out, typename Keys<kPacked>::Key* part, unsigned* arrived,
                   int n, int c, int k, unsigned low, int vec, int place) {
  using KeyOps = Keys<kPacked>;
  using Key = typename KeyOps::Key;
  constexpr Key kNone = ~Key(0);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const Layout lay = layout(c, k, sizeof(Key), place);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3;
  const int b = blockIdx.y;
  const int splits = gridDim.z;
  const int row0 = blockIdx.x * kRows;
  const float* xb = x + static_cast<size_t>(b) * n * c;
  const float* nb = nrm + static_cast<size_t>(b) * n;
  const int tiles = (n + kTile - 1) / kTile;
  const int per_split = (tiles + splits - 1) / splits;
  const int t0 = blockIdx.z * per_split;
  const int t1 = min(tiles, t0 + per_split);
  const int end = min(n, t1 * kTile);
  const int nchunk = (c + kChunk - 1) / kChunk;
  const int units = max(0, t1 - t0) * nchunk;  // (key tile, channel chunk) pairs
  const int stage_floats = static_cast<int>(lay.stage / sizeof(float));
  float* ring = reinterpret_cast<float*>(smem);
  float* qres = reinterpret_cast<float*>(smem + lay.q);
  Key* batch = reinterpret_cast<Key*>(smem + lay.batch);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
  Key* sorted = reinterpret_cast<Key*>(smem + lay.sorted) + 32 * warp;
  auto part_row = [&](int split, int row) {
    return part + ((static_cast<size_t>(b) * splits + split) * n + row) * k;
  };
  // block row r's list in memory
  auto list_of = [&](int r) {
    Key* shared_lists = reinterpret_cast<Key*>(smem + lay.lists);
    return place == kInShared ? shared_lists + static_cast<size_t>(r) * k
                              : part_row(blockIdx.z, row0 + r);
  };
  auto stage_unit = [&](int v) {
    const int tile = t0 + v / nchunk;
    const int h = v - (v / nchunk) * nchunk;
    const int ch0 = h * kChunk;
    const int w = chunk_width(c, ch0);
    float* st = ring + (v % kStages) * stage_floats;
    stage_points(xb, tile * kTile, end, c, ch0, w, kLd, vec, st);
    if (h == nchunk - 1 && threadIdx.x < kTile) {  // the keys' norms, with their last chunk
      const int j = tile * kTile + threadIdx.x;
      r3d::cp_async4(st + kTile * kLd + threadIdx.x, j < end ? nb + j : nb, j < end);
    }
    if (!lay.ldq) stage_points(xb, row0, n, c, ch0, w, kLd, vec, st + kTile * kLd + kTile);
  };

  if (threadIdx.x < kRows) cnt[threadIdx.x] = 0;
  if constexpr (K == 0) {  // each warp keeps its own rows' lists
    for (int r = 16 * warp; r < 16 * warp + 16 && row0 + r < n; ++r) {
      Key* l = list_of(r);
      for (int i = lane; i < k; i += 32) l[i] = kNone;
    }
  }
  if (lay.ldq) stage_points(xb, row0, n, c, 0, (c + 3) & ~3, lay.ldq, vec, qres);
#pragma unroll
  for (int v = 0; v < kStages - 1; ++v) {
    if (v < units) stage_unit(v);
    r3d::cp_async_commit();
  }

  // the lane's rows 16 warp + g + 4 i of the block
  bool live[4];
  float qq[4];
  Key thr[4];  // their k-th keys so far (0 for rows past n: nothing is below)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 16 * warp + g + 4 * i;
    live[i] = row < n;
    qq[i] = live[i] ? nb[row] : 0.f;
    thr[i] = live[i] ? kNone : Key(0);
  }
  List<Key, (K > 0 ? K / 2 : 1)> list;  // k <= 64: lanes r and r + 16 hold warp row r's
  if constexpr (K > 0) list.reset(k);

  float acc[4][8];
  for (int u = 0; u < units; ++u) {
    r3d::cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u has arrived; every warp is done with unit u - 1
    if (u + kStages - 1 < units) stage_unit(u + kStages - 1);
    r3d::cp_async_commit();
    const int tile = t0 + u / nchunk;
    const int h = u - (u / nchunk) * nchunk;
    const float* st = ring + (u % kStages) * stage_floats;
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const int ch0 = h * kChunk;
    products(acc, lay.ldq ? qres + ch0 : st + kTile * kLd + kTile, lay.ldq ? lay.ldq : kLd, st,
             chunk_width(c, ch0));
    if (h + 1 < nchunk) continue;

    // keys, and the survivors into their rows' batches
    const int key0 = tile * kTile;
    const float* kk_s = st + kTile * kLd;
    if constexpr (K > 0) {
      if (tile == t0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Key key[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = key0 + (lane & 7) + 8 * j;
            key[j] = col < end ? KeyOps::make(qq[i], kk_s[(lane & 7) + 8 * j], acc[i][j], col, low)
                               : kNone;
          }
          const Key bound = first_tile_bound(key, k);
          if (live[i] && bound != kNone) thr[i] = bound + 1;  // the keys at or below it
        }
      }
    }
    bool pushed = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = key0 + (lane & 7) + 8 * j;
      const float kk = kk_s[(lane & 7) + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Key key = KeyOps::make(qq[i], kk, acc[i][j], col, low);
        if (col < end && key < thr[i]) {
          const int r = 16 * warp + g + 4 * i;
          batch[r * kBatchLd + atomicAdd(&cnt[r], 1)] = key;
          pushed = true;
        }
      }
    }
    if (!__any_sync(kFull, pushed)) continue;
    __syncwarp();
    // the merges, and the new thresholds
    if constexpr (K > 0) {
      const int r = 16 * warp + (lane & 15);
      const int m = cnt[r];
      const int rounds = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(m)));
      for (int it = 0; it < rounds; ++it) list.offer(it < m ? batch[r * kBatchLd + it] : kNone);
      __syncwarp();
      if (lane < 16) cnt[r] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Key t = __shfl_sync(kFull, list.v[0], g + 4 * i);
        thr[i] = live[i] ? t : Key(0);
      }
    } else {  // lists in memory: the warp merges one row at a time
      const int mine = lane < 16 ? cnt[16 * warp + lane] : 0;
      unsigned todo = __ballot_sync(kFull, mine > 0);
      while (todo) {
        const int r = 16 * warp + __ffs(todo) - 1;
        todo &= todo - 1;
        const int m = cnt[r];
        Key* l = list_of(r);
        for (int s0 = 0; s0 < m; s0 += 32)
          merge_batch(l, k, s0 + lane < m ? batch[r * kBatchLd + s0 + lane] : kNone, sorted);
      }
      if (lane < 16) cnt[16 * warp + lane] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (live[i]) thr[i] = list_of(16 * warp + g + 4 * i)[k - 1];
    }
  }

  if (splits > 1) {
    // Leave this split's lists (those in device memory are there already),
    // and the last block of the row tile merges the others into its own.
    if constexpr (K > 0) {
      const int row = row0 + 16 * warp + (lane & 15);
      if (row < n) list.write(k, part_row(blockIdx.z, row));
    } else if (place == kInShared) {
      for (int r = 16 * warp; r < 16 * warp + 16 && row0 + r < n; ++r) {
        const Key* l = list_of(r);
        Key* dst = part_row(blockIdx.z, row0 + r);
        for (int i = lane; i < k; i += 32) dst[i] = l[i];
      }
    }
    __threadfence();
    __syncthreads();
    unsigned* counter = arrived + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last_block = atomicAdd(counter, 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    if constexpr (K > 0) {
      const int row = row0 + 16 * warp + (lane & 15);
      const bool lv = row < n;
      for (int sp = 0; sp < splits; ++sp) {
        if (sp == static_cast<int>(blockIdx.z)) continue;
        const Key* from = part_row(sp, lv ? row : 0);
        for (int j = 0; j < k; ++j) {  // every split's list is ascending
          const Key cand = lv ? __ldcg(from + j) : kNone;
          if (!__any_sync(kFull, cand < list.top())) break;
          list.offer(cand);
        }
      }
    } else {
      for (int r = 16 * warp; r < 16 * warp + 16 && row0 + r < n; ++r) {
        Key* l = list_of(r);
        for (int sp = 0; sp < splits; ++sp) {
          if (sp == static_cast<int>(blockIdx.z)) continue;
          const Key* from = part_row(sp, row0 + r);
          for (int s0 = 0; s0 < k; s0 += 32) {
            const Key cand = s0 + lane < k ? __ldcg(from + s0 + lane) : kNone;
            if (!__any_sync(kFull, cand < l[k - 1])) break;
            merge_batch(l, k, cand, sorted);
          }
        }
      }
    }
    if (threadIdx.x == 0) *counter = 0u;
  }

  if constexpr (K > 0) {
    const int row = row0 + 16 * warp + (lane & 15);
    if (row < n)
      list.write(k, out + (static_cast<size_t>(b) * n + row) * k,
                 [low](Key key) { return KeyOps::index(key, low); });
  } else {
    for (int r = 16 * warp; r < 16 * warp + 16 && row0 + r < n; ++r) {
      const Key* l = list_of(r);
      int* dst = out + (static_cast<size_t>(b) * n + row0 + r) * k;
      for (int i = lane; i < k; i += 32) dst[i] = KeyOps::index(l[i], low);
    }
  }
}

template <bool kPacked, int K>
cudaError_t launch(const float* x, const float* nrm, int* out, void* part, unsigned* arrived,
                   int b, int n, int c, int k, int splits, int place, cudaStream_t st) {
  using Key = typename Keys<kPacked>::Key;
  const int bits = n > 1 ? 32 - __builtin_clz(static_cast<unsigned>(n - 1)) : 1;
  const unsigned low = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  const int vec = c % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const dim3 grid((n + kRows - 1) / kRows, b, splits);
  return r3d_launch(knn_general_kernel<kPacked, K>, grid, dim3(kThreads),
                    layout(c, k, sizeof(Key), place).total, st, x, nrm, out,
                    static_cast<Key*>(part), arrived, n, c, k, low, vec, place);
}

template <bool kPacked>
cudaError_t dispatch(const float* x, const float* nrm, int* out, void* part, unsigned* arrived,
                     int b, int n, int c, int k, int splits, int place, cudaStream_t st) {
  if (k <= 8) return launch<kPacked, 8>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
  if (k <= 20)
    return launch<kPacked, 20>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
  if (k <= 32)
    return launch<kPacked, 32>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
  if (k <= 48)
    return launch<kPacked, 48>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
  if (k <= kMaxRegK)
    return launch<kPacked, 64>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
  return launch<kPacked, 0>(x, nrm, out, part, arrived, b, n, c, k, splits, place, st);
}

}  // namespace

// Bytes of the key scratch `part` a call needs: each split's lists where
// splits > 1 or the lists live in device memory (64 rows of them past a
// block's shared memory), else 0.
R3D_EXPORT long long r3d_knn_general_scratch(int b, int n, int c, int k, int packed, int splits) {
  const int key_bytes = packed ? 4 : 8;
  const bool needed = splits > 1 || list_place(c, k, key_bytes) == kInDevice;
  return needed ? static_cast<long long>(key_bytes) * b * splits * n * k : 0LL;
}

// x (B, N, C) f32 contiguous -> out (B, N, k) int32; nrm (B, N) f32 scratch;
// part: r3d_knn_general_scratch bytes (null when that is 0); arrived: (B,
// ceil(N / 64)) uint32, zero on entry and on return (null when splits is 1);
// packed 0 (exact keys) or 1 (the TPU kernel's packed keys); splits: key
// splits per row tile (ops/cuda_knn.py:splits).
R3D_EXPORT int r3d_knn_general(const void* x, void* out, void* nrm, void* part, void* arrived,
                               int b, int n, int c, int k, int packed, int splits,
                               void* stream) {
  const int key_bytes = packed ? 4 : 8;
  if (b < 1 || b > 65535 || n < 1 || c < 1 || k < 1 || k > n || splits < 1 || splits > 64 ||
      (r3d_knn_general_scratch(b, n, c, k, packed, splits) > 0 && part == nullptr) ||
      (splits > 1 && arrived == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto np = static_cast<float*>(nrm);
  const int rows = b * n;
  knn_norms_kernel<<<(rows + 255) / 256, 256, 0, st>>>(xp, np, rows, c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int place = list_place(c, k, key_bytes);
  const auto op = static_cast<int*>(out);
  const auto ap = static_cast<unsigned*>(arrived);
  if (packed) return dispatch<true>(xp, np, op, part, ap, b, n, c, k, splits, place, st);
  return dispatch<false>(xp, np, op, part, ap, b, n, c, k, splits, place, st);
}
