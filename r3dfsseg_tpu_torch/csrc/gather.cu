// Row gather: out[b, i, k, :] = x[b, idx[b, i, k], :].
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/fast_gather.py:_gather_kernel
// (via gather_onehot_pallas), which builds a (TM, N) one-hot tile per step
// and lets the matrix unit compute onehot @ table, only to put the gather
// on the TPU's MXU.  Each output row is one table row, so on Hopper the
// same function is a row copy: bit-exact for any element type, with no
// products at all.
//
// What bounds it on the H100: bytes.  The output is written once (105 MB at
// B = 10, N = NQ = 2048, K = 20, C = 64 f32), the table is read once from
// device memory (5 MB; later reads of a row hit L2) and idx once (1.6 MB).
//
// Rows of a multiple of 16 bytes (r3d_gather_rows): one thread copies one
// 16-byte chunk of a row, neighbouring lanes on neighbouring chunks, so a
// warp reads whole 128-byte lines of two rows (f32, C = 64) and writes 512
// contiguous bytes.  The copy moves raw bytes (uint4), so f32 and bf16
// tables share the kernel.
//
// Rows of any other even number of bytes rb (r3d_gather_rows_narrow; the
// TPU kernel takes any C).  The output (B, M, rb) is one contiguous run of
// bytes, and G = 16 / gcd(rb, 16) consecutive rows (4 at C = 63 f32, 8 at
// C = 63 bf16, 2 at C = 60 bf16) end on a 16-byte boundary: cut into such
// groups, the output is written entirely in aligned 16-byte stores
// (st.global.cs, streaming), whatever rb is; only the reads from the table
// are misaligned (2-byte aligned rows), and the table stays in L2.  A warp
// owns a run of 32 x S consecutive 16-byte chunks (S = 4; fewer for rows
// under 8 bytes, so that a run spans at most 258 rows):
//   1. its lanes load the index of each row the run touches once, into the
//      warp's slots in shared memory, as the row's source row b N + j (or
//      -1: an id outside [0, N) gives a zero row, as the one-hot product
//      does), each lane counting its rows' cloud b on, 32 rows a step;
//   2. lane l writes chunks l, l + 32, ...: a cursor (slot, byte offset in
//      the row) walks the chunk's four 4-byte words.  Where every row
//      starts 4-aligned (rb % 4 == 0 on a 4-aligned table: any C in f32,
//      even C in bf16), a word is one aligned 4-byte load of one row; else
//      (odd C in bf16) each half of a word is taken from the aligned 4-byte
//      word of the table that holds it, the two joined by one byte permute
//      (PRMT), the cursor moving to the next row between them where a row
//      ends inside the word: no branch on the alignment, so a warp does
//      not diverge on it.  An aligned word never leaves the 32-byte sector
//      of the table byte it serves;
//   3. the cursor moves 512 bytes to the lane's next chunk by adding 512 /
//      rb rows and 512 % rb bytes: no division per chunk or piece, 32-bit
//      slots and offsets, 64-bit addresses.
// Where B M rb is not a multiple of 16, the last chunk is written as the
// halfwords that are there (the tail).  ops/cuda_gather.py:narrow_plan and
// narrow_words mirror the plan and the cursor for the CPU tests.
//
// Layout: x (B, N, row_bytes) contiguous, idx (B, M) int32 with M = NQ * K
// -> out (B, M, row_bytes), 16-byte aligned; row_bytes % 16 == 0 for
// r3d_gather_rows, even for r3d_gather_rows_narrow.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                   uint4* __restrict__ out, long long total, int n, int m, int chunks) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long r = g / chunks;  // output row, b * m + i * K + k
  const int v = static_cast<int>(g - r * chunks);
  const long long b = r / m;
  const int j = __ldg(idx + r);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) {
    val = __ldg(x + (b * n + j) * chunks + v);
  }
  out[g] = val;
}

// ---- narrow rows ----------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSteps = 4;     // chunks a lane writes in a run
constexpr int kSlots = 260;      // index slots a warp: the rows of a run, and one past

// A lane's read position: the slot of the current row, the even byte offset
// in it, and the row's first source byte (nullptr: a zero row).  kAligned:
// every row starts 4-byte aligned (rb % 4 == 0 on a 4-byte aligned table),
// so every word is one aligned load and no row ends inside a word; else
// each 2-byte half of a word comes from the aligned word that holds it,
// the row moving on between the halves where it ends.
template <bool kAligned>
struct Cursor {
  int slot, off;
  const unsigned char* src;

  __device__ __forceinline__ void at(const int* rows, const unsigned char* x, int rb) {
    const int s = rows[slot];
    src = s < 0 ? nullptr : x + static_cast<size_t>(s) * rb;
  }

  // The next 4 bytes of the output, and the cursor past them.
  __device__ __forceinline__ uint32_t word(const int* rows, const unsigned char* x, int rb) {
    if constexpr (kAligned) {
      const uint32_t v = src ? __ldg(reinterpret_cast<const uint32_t*>(src + off)) : 0u;
      off += 4;
      if (off == rb) {
        ++slot;
        off = 0;
        at(rows, x, rb);
      }
      return v;
    } else {  // each half from its aligned word, joined by one byte permute
      const unsigned char* a = src ? src + off : nullptr;
      off += 2;
      if (off == rb) {
        ++slot;
        off = 0;
        at(rows, x, rb);
      }
      const unsigned char* b = src ? src + off : nullptr;
      off += 2;
      if (off == rb) {
        ++slot;
        off = 0;
        at(rows, x, rb);
      }
      const auto ua = reinterpret_cast<uintptr_t>(a);
      const auto ub = reinterpret_cast<uintptr_t>(b);
      const uint32_t wa = a ? __ldg(reinterpret_cast<const uint32_t*>(ua & ~uintptr_t{3})) : 0u;
      const uint32_t wb = b ? __ldg(reinterpret_cast<const uint32_t*>(ub & ~uintptr_t{3})) : 0u;
      return __byte_perm(wa, wb, (ua & 2 ? 0x32u : 0x10u) | (ub & 2 ? 0x7600u : 0x5400u));
    }
  }
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
gather_narrow_kernel(const unsigned char* __restrict__ x, const int* __restrict__ idx,
                     uint4* __restrict__ out, int rows, int n, int m, int rb, int steps, int dq,
                     int dr, long long chunks, long long full) {
  __shared__ int slots[kWarps][kSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32 * steps;
  if (c0 >= chunks) return;
  // 1. the run's rows: from the one holding its first byte, one past its last
  const long long p0 = 16 * c0;
  const int r0 = static_cast<int>(p0 / rb);
  const int base = static_cast<int>(p0 - static_cast<long long>(r0) * rb);
  const int nr = (base + 512 * steps - 1) / rb + 2;
  int* run = slots[warp];
  int bq = (r0 + lane) / m;              // row r0 + i's cloud and place in it,
  int rem = r0 + lane - bq * m;          // moved 32 rows a step
  for (int i = lane; i < nr; i += 32) {
    const int r = r0 + i;
    int s = -1;
    if (r < rows) {
      const int j = __ldg(idx + r);
      if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) s = bq * n + j;
    }
    run[i] = s;
    for (rem += 32; rem >= m; rem -= m) ++bq;
  }
  __syncwarp();
  // 2. the lane's chunks
  Cursor<kAligned> cur;
  const int first = base + 16 * lane;
  cur.slot = first / rb;
  cur.off = first - cur.slot * rb;
  for (int s = 0; s < steps; ++s) {
    const long long c = c0 + lane + 32 * s;
    if (c >= chunks) break;
    if (s > 0) {  // 3. 512 bytes on
      cur.slot += dq;
      cur.off += dr;
      if (cur.off >= rb) {
        cur.off -= rb;
        ++cur.slot;
      }
    }
    cur.at(run, x, rb);
    Cursor<kAligned> w = cur;
    uint4 v;
    v.x = w.word(run, x, rb);
    v.y = w.word(run, x, rb);
    v.z = w.word(run, x, rb);
    v.w = w.word(run, x, rb);
    if (c < full) {
      __stcs(out + c, v);
    } else {  // the tail: the halfwords before the output's end
      auto h = reinterpret_cast<uint16_t*>(out + c);
      const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
      const int left = static_cast<int>((static_cast<long long>(rows) * rb - 16 * c) / 2);
      for (int e = 0; e < left; ++e) h[e] = static_cast<uint16_t>(ws[e >> 1] >> (16 * (e & 1)));
    }
  }
}

}  // namespace

R3D_EXPORT int r3d_gather_rows(const void* x, const void* idx, void* out, int b, int n, int m,
                               int row_bytes, void* stream) {
  if (row_bytes % 16) return cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  const long long total = static_cast<long long>(b) * m * chunks;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(idx), static_cast<uint4*>(out), total,
      n, m, chunks);
  return cudaGetLastError();
}

// Rows of any even number of bytes, in aligned groups of 16-byte chunks.
// x 2-byte aligned, out 16-byte aligned, b m < 2^31 rows, b n < 2^31.
R3D_EXPORT int r3d_gather_rows_narrow(const void* x, const void* idx, void* out, int b, int n,
                                      int m, int row_bytes, void* stream) {
  if (row_bytes < 2 || row_bytes % 2 || reinterpret_cast<uintptr_t>(x) % 2 ||
      reinterpret_cast<uintptr_t>(out) % 16 || b < 0 || m < 0 ||
      static_cast<long long>(b) * m >= (1ll << 31) || static_cast<long long>(b) * n >= (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  const int rows = b * m;
  const long long bytes = static_cast<long long>(rows) * row_bytes;
  const long long chunks = (bytes + 15) / 16;
  if (chunks == 0) return cudaSuccess;
  const int steps = row_bytes >= 2 * kMaxSteps ? kMaxSteps : row_bytes / 2;
  const long long runs = (chunks + 32 * steps - 1) / (32 * steps);
  const long long blocks = (runs + kWarps - 1) / kWarps;
  const bool aligned = row_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const auto kernel = aligned ? &gather_narrow_kernel<true> : &gather_narrow_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int*>(idx), static_cast<uint4*>(out),
      rows, n, m, row_bytes, steps, 512 / row_bytes, 512 % row_bytes, chunks, bytes / 16);
  return cudaGetLastError();
}
