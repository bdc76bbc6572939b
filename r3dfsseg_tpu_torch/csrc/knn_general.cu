// k-nearest-neighbour search at any k <= N and any C, in both modes of the
// TPU kernel: exact, and packed keys.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_knn.py:_knn_kernel where
// csrc/knn.cu does not take the shape (k > 32 or C > 256), and in its
// packed mode (exact=False, knn_impl="pallas") at every shape.  The
// selection runs once, over one unsigned 64-bit key per (row, column), so
// that keys are unique and the k smallest of a row are one set in one
// order:
//   exact:  key = bits(d) << 32 | col, d = max((qq + kk) - 2 * inner, 0)
//           (ops/knn.py's grouping): by distance, then lowest index, as
//           `knn_indices`;
//   packed: key = (bits(d) & ~low) | col, d = max((qq - 2 * inner) + kk,
//           0) (pallas_knn.py:74's grouping), low = the bit_length(N - 1)
//           low bits: the TPU kernel's int32 key, whose low bits are the
//           column.
// d >= 0 is never -0 (qq, kk >= +0, and x - x = +0), so its bits order as
// its value.
//
// What bounds it on the H100: the inner products, 2 B N^2 C operations,
// here FFMA in f32 against 67 TFLOP/s, and the selection, which no peak
// rate covers.  This kernel is simple, not fast: the tuned csrc/knn.cu
// keeps the shapes it takes.
//
// Design.  A pre-pass writes each point's squared norm (channels in order,
// one fma chain), so a point's norm as a query and as a key is one value
// and duplicate points tie bit for bit.  Grid (ceil(N / 8), B), 8 warps;
// warp w owns query row row0 + w.  Key tiles of 64 points stream through
// shared memory in 32-channel chunks with the block's 8 query rows; lane l
// sums the products of keys l and l + 32 over the channels in order (fma),
// so inner(i, j) = inner(j, i) bit for bit.  Each row keeps its k smallest
// keys so far in ascending order in shared memory (in device memory when k
// rows of 8 bytes per warp do not fit, r3d_knn_general_scratch).  A key
// below the row's k-th (every key while the list is short) enters it: the
// warp counts the keys below it (its place) and moves the larger ones up
// by one slot, from the top down.  Keys are unique, so the list after the
// last tile is the k smallest in order, whatever order they arrived in.
// No float atomics: a call repeats bit for bit.
#include "common.cuh"

namespace {

constexpr int kRows = 8;                 // query rows per block, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kTile = 64;                // keys per staged tile
constexpr int kChunk = 32;               // channels per staged chunk
constexpr int kKeyLd = kChunk + 1;       // floats per staged key (bank-conflict free)
constexpr size_t kStageBytes = sizeof(float) * (kRows * kChunk + kTile * kKeyLd);
constexpr size_t kListSmemMax = 160 * 1024;  // lists beyond this live in device memory
constexpr unsigned kFull = 0xffffffffu;

__global__ void knn_norms_kernel(const float* __restrict__ x, float* __restrict__ nrm, int rows,
                                 int c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + static_cast<size_t>(r) * c;
  float s = 0.f;
  for (int ch = 0; ch < c; ++ch) s = fmaf(p[ch], p[ch], s);
  nrm[r] = s;
}

// The warp inserts `key` (the same in every lane) into the ascending list
// L of `len` keys, at most k; a key at or above the k-th of a full list
// does not enter.
__device__ __forceinline__ void insert(unsigned long long* list, int& len, int k,
                                       unsigned long long key) {
  const int lane = threadIdx.x & 31;
  if (len == k && key >= list[k - 1]) return;
  int below = 0;
  for (int i = lane; i < len; i += 32) below += list[i] < key;
  const int pos = __reduce_add_sync(kFull, below);
  const int top = len < k ? len : k - 1;  // slots [pos, top) move up one; a full list drops its last
  for (int hi = top; hi > pos; hi -= 32) {
    const int i = hi - 1 - lane;
    const bool mv = i >= pos;
    const unsigned long long v = mv ? list[i] : 0ull;
    __syncwarp();
    if (mv) list[i + 1] = v;
    __syncwarp();
  }
  if (lane == 0) list[pos] = key;
  __syncwarp();
  if (len < k) ++len;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
knn_general_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                   int* __restrict__ out, unsigned long long* glist, int n, int c, int k,
                   unsigned low) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);             // [kRows][kChunk]
  float* ks = qs + kRows * kChunk;                         // [kTile][kKeyLd]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + warp;
  const bool live = row < n;
  const float* xb = x + static_cast<size_t>(b) * n * c;
  const float* nb = nrm + static_cast<size_t>(b) * n;
  unsigned long long* list =
      glist != nullptr
          ? glist + (static_cast<size_t>(b) * n + (live ? row : 0)) * k
          : reinterpret_cast<unsigned long long*>(smem + kStageBytes) + static_cast<size_t>(warp) * k;
  const float qq = live ? nb[row] : 0.f;
  int len = 0;

  for (int key0 = 0; key0 < n; key0 += kTile) {
    float acc[2] = {0.f, 0.f};
    for (int ch0 = 0; ch0 < c; ch0 += kChunk) {
      const int w = min(kChunk, c - ch0);
      __syncthreads();  // every warp is done with the previous chunk
      {
        const int r = threadIdx.x / kChunk, cc = threadIdx.x % kChunk;
        const int qr = blockIdx.x * kRows + r;
        qs[r * kChunk + cc] = qr < n && cc < w ? xb[static_cast<size_t>(qr) * c + ch0 + cc] : 0.f;
      }
      for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
        const int j = e / kChunk, cc = e % kChunk;
        ks[j * kKeyLd + cc] =
            key0 + j < n && cc < w ? xb[static_cast<size_t>(key0 + j) * c + ch0 + cc] : 0.f;
      }
      __syncthreads();
      const float* qr = qs + warp * kChunk;
      for (int cc = 0; cc < w; ++cc) {
        const float a = qr[cc];
        acc[0] = fmaf(a, ks[lane * kKeyLd + cc], acc[0]);
        acc[1] = fmaf(a, ks[(lane + 32) * kKeyLd + cc], acc[1]);
      }
    }
    if (!live) continue;  // the whole warp; its later chunks still stage and sync
    unsigned long long key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = key0 + lane + 32 * h;
      if (j >= n) {
        key[h] = ~0ull;
        continue;
      }
      const float kk = nb[j];
      const float two = __fmul_rn(2.f, acc[h]);
      if (kPacked) {
        const float d = fmaxf(__fadd_rn(__fsub_rn(qq, two), kk), 0.f);
        key[h] = (__float_as_uint(d) & ~low) | static_cast<unsigned>(j);
      } else {
        const float d = fmaxf(__fsub_rn(__fadd_rn(qq, kk), two), 0.f);
        key[h] = static_cast<unsigned long long>(__float_as_uint(d)) << 32 |
                 static_cast<unsigned>(j);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned long long thr = len == k ? list[k - 1] : ~0ull;
      unsigned m = __ballot_sync(kFull, key[h] < thr);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        insert(list, len, k, __shfl_sync(kFull, key[h], src));
      }
    }
  }
  if (!live) return;
  int* dst = out + (static_cast<size_t>(b) * n + row) * k;
  const unsigned mask = kPacked ? low : 0xffffffffu;
  for (int i = lane; i < k; i += 32) dst[i] = static_cast<int>(static_cast<unsigned>(list[i]) & mask);
}

bool lists_fit(int k) { return static_cast<size_t>(kRows) * k * 8 <= kListSmemMax; }

}  // namespace

// Bytes of device scratch a call needs for its lists: 0 where the lists fit
// in shared memory.
R3D_EXPORT long long r3d_knn_general_scratch(int b, int n, int k) {
  return lists_fit(k) ? 0LL : 8LL * b * n * k;
}

// x (B, N, C) f32 contiguous -> out (B, N, k) int32; nrm (B, N) f32 scratch;
// lists: r3d_knn_general_scratch bytes (or null when that is 0); packed 0
// (exact keys) or 1 (the TPU kernel's packed keys).
R3D_EXPORT int r3d_knn_general(const void* x, void* out, void* nrm, void* lists, int b, int n,
                               int c, int k, int packed, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || c < 1 || k < 1 || k > n ||
      (!lists_fit(k) && lists == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto np = static_cast<float*>(nrm);
  const int rows = b * n;
  knn_norms_kernel<<<(rows + 255) / 256, 256, 0, st>>>(xp, np, rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bits = n > 1 ? 32 - __builtin_clz(static_cast<unsigned>(n - 1)) : 1;
  const unsigned low = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  const bool in_smem = lists_fit(k);
  const size_t smem = kStageBytes + (in_smem ? static_cast<size_t>(kRows) * k * 8 : 0);
  auto gl = in_smem ? nullptr : static_cast<unsigned long long*>(lists);
  const dim3 grid((n + kRows - 1) / kRows, b);
  if (packed) {
    return r3d_launch(knn_general_kernel<true>, grid, dim3(kThreads), smem, st, xp, np,
                      static_cast<int*>(out), gl, n, c, k, low);
  }
  return r3d_launch(knn_general_kernel<false>, grid, dim3(kThreads), smem, st, xp, np,
                    static_cast<int*>(out), gl, n, c, k, low);
}
