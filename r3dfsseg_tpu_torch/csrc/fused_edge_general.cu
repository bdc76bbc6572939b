// The fused EdgeConv tail (kernel 9) at any shape: any square C >= 1 (up
// to kMaxC), any K >= 1 and any number of points P = B * N >= 1, on an f32
// or a bf16 e.  The five passes and their algebra are csrc/fused_edge.cu's
// (which see), the tuned kernel that takes C = 64, P a multiple of 8 and a
// K whose tile fits in shared memory; every other shape comes here.
//
// Replaces the same TPU kernel, scripts/archive/fused_edge.py:_call and its
// bodies (:63-209), which take any C, any K and any N that `_tile_n` tiles
// (:50-59), with e of any float type read as f32 and d_e written in e's.
//
// What bounds it on the H100: operations, the (rows x C) x (C x C)
// products, as the tuned kernel; this one is simple and not tuned.  Its
// design takes the three limits of the tuned tile apart:
// - W1 larger than shared memory: every product runs over chunks of kCols
//   columns of W1 (and of W1^T), each staged in shared memory in turn, with
//   the h0 = leaky(BN0(e)) rows of the chunk's kCols input channels beside
//   it; each output sums its C products in channel order (fmaf from 0), as
//   the tuned kernel's mm_tile does, so at C = 64 the values of l1 and of
//   dh0 are the tuned kernel's;
// - K past shared memory: the max over k runs in its own kernel
//   (edge_route_kernel) over groups of points, kRows / K whole points a
//   group where K <= kRows, else one point a group in chunks of kRows rows,
//   with each (point, channel)'s running max, its k, z1 and l1 kept in
//   shared memory across the chunks; the backward passes (bwd2, bwd3) then
//   run over tiles of kRows rows with no regard to points
//   (edge_rows_kernel), reading each row's routing (the k of the max and
//   dz1 there, written by the route kernel to a (P, C) scratch) from device
//   memory;
// - P not a multiple of 8: the last group and the last tile are partial,
//   masked entry by entry.
// Sums are deterministic: each block adds its own rows, in the order it
// takes them, into its own row of a partial array in device memory (dW1
// there too: C^2 floats do not fit a block's registers), and
// r3d::sum_partials_kernel adds the rows in block order; no float atomics.
//
// Launches per pass: stats1 rows + sums; fwd route; bwd1 route + sums;
// bwd2 route, rows + sums; bwd3 route, rows.
//
// Layout: e (P, K, C) f32 or bf16 contiguous; dout (P, C) f32; W1 (C, C)
// as (C_in, C_out); vec (kNumVec, C) as csrc/fused_edge.cu's Vec; out: fwd
// (P, C) f32, bwd3 (P, K, C) of e's type; partial (grid, n_sums) zeroed by
// the caller; sums (n_sums) as the tuned kernel's; kstar (P, C) int32 and
// dzr (P, C) f32 scratch of the backward passes.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // rows per product tile
constexpr int kCols = 64;   // columns of W1 (and input channels) per chunk
constexpr int kMaxC = 3072; // bwd2 and bwd3 keep a tile's dl1, kRows x C, in shared memory
// Strides of the staged chunks, one float past a multiple of the 32 banks
// so that a warp's stores across channels (h0) or along the sum (W1^T)
// fall in distinct banks; reads are broadcasts or consecutive.
constexpr int kHs = kRows + 1;   // hs: [input channel][row]
constexpr int kWs = kCols + 1;   // ws: [input channel][column] or [column][input channel]
constexpr float kSlope = 0.2f;

enum Vec { kAff0, kSh0, kAff1, kSh1, kInv1, kMu1, kG1inv, kMr1, kMr2, kInv0, kMu0, kG0inv, kMq1,
           kMq2, kNumVec };
enum Pass { kStats1 = 0, kFwd = 1, kBwd1 = 2, kBwd2 = 3, kBwd3 = 4 };

__device__ __forceinline__ float leaky(float z) { return z > 0.f ? z : kSlope * z; }
__device__ __forceinline__ float bn(float x, float aff, float sh) {
  return __fadd_rn(__fmul_rn(x, aff), sh);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {  // round to nearest even
  uint16_t b;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(b) : "f"(v));
  *p = b;
}

__host__ __device__ constexpr int n_sums(int pass, int c) {
  return pass == kStats1 || pass == kBwd1 ? 2 * c : pass == kBwd2 ? c * c + 2 * c : 0;
}

// Shared memory of the rows kernel: hs, ws, two (kRows x kCols) tiles and,
// for bwd2 and bwd3, dl1 (kRows x C).
__host__ __device__ constexpr size_t rows_smem_bytes(int pass, int c) {
  return sizeof(float) * (static_cast<size_t>(kCols) * kHs + kCols * kWs + 2 * kRows * kCols +
                          (pass == kStats1 ? 0 : static_cast<size_t>(kRows) * c));
}

// Thread tid's four entries of a (kRows x kCols) tile: column tid % kCols,
// rows tid / kCols + 4 u.
__device__ __forceinline__ int tile_row(int u) { return threadIdx.x / kCols + 4 * u; }

// acc[u] = l1[row0 + tile_row(u)][c0 + tid % kCols] for the nr rows from
// row0 and the nc columns from c0, l1 = leaky(BN0(e)) @ W1, the products
// over the C input channels in order, kCols at a time: hs holds h0 of the
// chunk as [channel][row], ws the chunk of W1 as [channel][column].
// Entries past nr or nc are left at 0.  Begins with a __syncthreads().
template <typename T>
__device__ void l1_tile(const T* __restrict__ e, const float* __restrict__ w1,
                        const float* __restrict__ vec, long long row0, int nr, int c0, int nc,
                        int c, float* hs, float* ws, float acc[4]) {
  const int tid = threadIdx.x;
  const int j = tid % kCols;
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.f;
  for (int q0 = 0; q0 < c; q0 += kCols) {
    const int nq = min(kCols, c - q0);
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, qq = i % kCols;
      float v = 0.f;
      if (r < nr && qq < nq) {
        const int q = q0 + qq;
        v = leaky(bn(to_f32(e[(row0 + r) * c + q]), vec[kAff0 * c + q], vec[kSh0 * c + q]));
      }
      hs[qq * kHs + r] = v;
    }
    for (int i = tid; i < kCols * kCols; i += kThreads) {
      const int qq = i / kCols, cc = i % kCols;
      ws[qq * kWs + cc] =
          (qq < nq && cc < nc) ? w1[static_cast<size_t>(q0 + qq) * c + c0 + cc] : 0.f;
    }
    __syncthreads();
    for (int qq = 0; qq < nq; ++qq) {
      const float w = ws[qq * kWs + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(hs[qq * kHs + tile_row(u)], w, acc[u]);
    }
  }
}

// The max over k of each (point, channel): fwd writes it; bwd1 sums r1 =
// dz1 and r2 = dz1 * xhat1 at it into the block's partial row; the route
// mode (for bwd2 and bwd3) writes its k and dz1 = dout * leaky'(z1) there.
// Work items: (group of points, chunk of kCols channels).
enum RouteMode { kRouteFwd = 0, kRouteBwd1 = 1, kRouteOnly = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
edge_route_kernel(const T* __restrict__ e, const float* __restrict__ dout,
                  const float* __restrict__ w1, const float* __restrict__ vec,
                  float* __restrict__ out, float* __restrict__ partial, int* __restrict__ kstar,
                  float* __restrict__ dzr, long long n_points, int k, int c) {
  __shared__ float hs[kCols * kHs];
  __shared__ float ws[kCols * kWs];
  __shared__ float lt[kRows * kCols];              // the l1 tile, [row][column]
  __shared__ float best[kRows * kCols], bz[kRows * kCols], bl[kRows * kCols];
  __shared__ int bk[kRows * kCols];                // per (point of the group, column)
  const int tid = threadIdx.x;
  const int j = tid % kCols;
  const int pts = k <= kRows ? kRows / k : 1;      // points per group
  const long long groups = (n_points + pts - 1) / pts;
  const int chunks = (c + kCols - 1) / kCols;
  float* part = kMode == kRouteBwd1 ? partial + static_cast<size_t>(blockIdx.x) * 2 * c : nullptr;

  for (long long item = blockIdx.x; item < groups * chunks; item += gridDim.x) {
    const long long p0 = (item / chunks) * pts;
    const int c0 = static_cast<int>(item % chunks) * kCols;
    const int nc = min(kCols, c - c0);
    const int np = static_cast<int>(min(static_cast<long long>(pts), n_points - p0));
    const int rows = np * k;
    for (int k0 = 0; k0 < rows; k0 += kRows) {
      const int nr = min(kRows, rows - k0);
      float acc[4];
      l1_tile(e, w1, vec, p0 * k + k0, nr, c0, nc, c, hs, ws, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) lt[tile_row(u) * kCols + j] = acc[u];
      __syncthreads();
      // each (point s, column cc) by one thread, its rows of this tile in k order
      for (int pair = tid; pair < np * kCols; pair += kThreads) {
        const int s = pair / kCols, cc = pair % kCols;
        if (cc >= nc) continue;
        const int lo = max(s * k, k0), hi = min(s * k + k, k0 + nr);
        const float aff1 = vec[kAff1 * c + c0 + cc], sh1 = vec[kSh1 * c + c0 + cc];
        for (int rr = lo; rr < hi; ++rr) {
          const int kk = rr - s * k;
          const float l1 = lt[(rr - k0) * kCols + cc];
          const float z1 = bn(l1, aff1, sh1);
          const float h1 = leaky(z1);
          if (kk == 0 || h1 > best[pair]) {  // lowest k on ties
            best[pair] = h1;
            bz[pair] = z1;
            bl[pair] = l1;
            bk[pair] = kk;
          }
        }
      }
      // (the next tile's l1_tile begins with a __syncthreads)
    }
    __syncthreads();
    for (int pair = tid; pair < np * kCols; pair += kThreads) {
      const int s = pair / kCols, cc = pair % kCols;
      if (cc >= nc) continue;
      const size_t at = static_cast<size_t>(p0 + s) * c + c0 + cc;
      if (kMode == kRouteFwd) {
        out[at] = best[pair];
        continue;
      }
      const float dz = dout[at] * (bz[pair] > 0.f ? 1.f : kSlope);
      if (kMode == kRouteOnly) {
        kstar[at] = bk[pair];
        dzr[at] = dz;
      } else {  // bwd1: this pair's terms, summed below by column
        const int col = c0 + cc;
        best[pair] = dz;
        bz[pair] = dz * ((bl[pair] - vec[kMu1 * c + col]) * vec[kInv1 * c + col]);
      }
    }
    if (kMode == kRouteBwd1) {
      __syncthreads();
      if (tid < nc) {  // the group's points in order, into this block's partial
        float a = part[c0 + tid], b = part[c + c0 + tid];
        for (int s = 0; s < np; ++s) {
          a += best[s * kCols + tid];
          b += bz[s * kCols + tid];
        }
        part[c0 + tid] = a;
        part[c + c0 + tid] = b;
      }
    }
    __syncthreads();  // the state is free for the next item
  }
}

// stats1, bwd2 and bwd3 over tiles of kRows edge rows (any rows: a tile may
// span points), each tile's l1 by chunks of kCols columns.
template <typename T, int kPass>
__global__ void __launch_bounds__(kThreads)
edge_rows_kernel(const T* __restrict__ e, const float* __restrict__ w1,
                 const float* __restrict__ vec, const int* __restrict__ kstar,
                 const float* __restrict__ dzr, T* __restrict__ de, float* __restrict__ partial,
                 long long n_points, int k, int c) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                        // kCols x kHs
  float* ws = hs + kCols * kHs;            // kCols x kWs
  float* ta = ws + kCols * kWs;            // kRows x kCols
  float* tb = ta + kRows * kCols;          // kRows x kCols
  float* dl = tb + kRows * kCols;          // kRows x C (bwd2, bwd3)
  const int tid = threadIdx.x;
  const int j = tid % kCols;
  const long long n_rows = n_points * k;
  const long long tiles = (n_rows + kRows - 1) / kRows;
  float* part =
      kPass == kBwd3 ? nullptr : partial + static_cast<size_t>(blockIdx.x) * n_sums(kPass, c);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    const int nr = static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
    for (int c0 = 0; c0 < c; c0 += kCols) {
      const int nc = min(kCols, c - c0);
      float acc[4];
      l1_tile(e, w1, vec, row0, nr, c0, nc, c, hs, ws, acc);
      if (kPass == kStats1) {
#pragma unroll
        for (int u = 0; u < 4; ++u) ta[tile_row(u) * kCols + j] = acc[u];
        __syncthreads();
        if (tid < nc) {  // the tile's rows in order, into this block's partial
          float a = part[c0 + tid], b = part[c + c0 + tid];
          for (int r = 0; r < nr; ++r) {
            const float v = ta[r * kCols + tid];
            a += v;
            b = fmaf(v, v, b);
          }
          part[c0 + tid] = a;
          part[c + c0 + tid] = b;
        }
        continue;
      }
      // dl1 = g1inv * (dz1 - mr1 - xhat1 * mr2), dz1 nonzero at the max's k only
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tile_row(u);
        if (r >= nr || j >= nc) continue;
        const long long row = row0 + r;
        const int col = c0 + j;
        const size_t at = static_cast<size_t>(row / k) * c + col;
        const float xhat1 = (acc[u] - vec[kMu1 * c + col]) * vec[kInv1 * c + col];
        const float dz = static_cast<int>(row % k) == kstar[at] ? dzr[at] : 0.f;
        dl[r * c + col] =
            vec[kG1inv * c + col] * (dz - vec[kMr1 * c + col] - xhat1 * vec[kMr2 * c + col]);
      }
    }
    if (kPass == kStats1) continue;
    __syncthreads();  // dl complete

    if (kPass == kBwd2) {  // dW1 += h0^T dl1, kCols input channels at a time
      for (int q0 = 0; q0 < c; q0 += kCols) {
        const int nq = min(kCols, c - q0);
        for (int i = tid; i < kRows * kCols; i += kThreads) {
          const int r = i / kCols, qq = i % kCols;
          float v = 0.f;
          if (r < nr && qq < nq) {
            const int q = q0 + qq;
            v = leaky(bn(to_f32(e[(row0 + r) * c + q]), vec[kAff0 * c + q], vec[kSh0 * c + q]));
          }
          hs[qq * kHs + r] = v;
        }
        __syncthreads();
        for (int i = tid; i < nq * c; i += kThreads) {
          const int qq = i / c, col = i % c;
          float* w = part + static_cast<size_t>(q0 + qq) * c + col;
          float a = *w;
          for (int r = 0; r < nr; ++r) a = fmaf(hs[qq * kHs + r], dl[r * c + col], a);
          *w = a;
        }
        __syncthreads();
      }
    }

    // dh0 = dl1 @ W1^T by chunks of kCols input channels (q) and of kCols
    // columns (the sum), then dz0 = dh0 * leaky'(z0)
    for (int q0 = 0; q0 < c; q0 += kCols) {
      const int nq = min(kCols, c - q0);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < c; c0 += kCols) {
        const int nc = min(kCols, c - c0);
        __syncthreads();
        for (int i = tid; i < kCols * kCols; i += kThreads) {  // ws[cc][qq] = W1[q0 + qq][c0 + cc]
          const int qq = i / kCols, cc = i % kCols;
          ws[cc * kWs + qq] =
              (qq < nq && cc < nc) ? w1[static_cast<size_t>(q0 + qq) * c + c0 + cc] : 0.f;
        }
        __syncthreads();
        for (int cc = 0; cc < nc; ++cc) {
          const float w = ws[cc * kWs + j];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] = fmaf(dl[tile_row(u) * c + c0 + cc], w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tile_row(u);
        float dz0 = 0.f, xhat0 = 0.f;
        if (r < nr && j < nq) {
          const int q = q0 + j;
          const long long at = (row0 + r) * c + q;
          const float ev = to_f32(e[at]);
          const float h0 = leaky(bn(ev, vec[kAff0 * c + q], vec[kSh0 * c + q]));
          dz0 = acc[u] * (h0 > 0.f ? 1.f : kSlope);
          xhat0 = (ev - vec[kMu0 * c + q]) * vec[kInv0 * c + q];
          if (kPass == kBwd3)
            store(de + at,
                  vec[kG0inv * c + q] * (dz0 - vec[kMq1 * c + q] - xhat0 * vec[kMq2 * c + q]));
        }
        if (kPass == kBwd2) {
          ta[r * kCols + j] = dz0;
          tb[r * kCols + j] = xhat0;
        }
      }
      if (kPass == kBwd2) {
        __syncthreads();
        if (tid < nq) {  // q1 = sum dz0, q2 = sum dz0 * xhat0, the tile's rows in order
          float* q1 = part + static_cast<size_t>(c) * c + q0 + tid;
          float a = q1[0], b = q1[c];
          for (int r = 0; r < nr; ++r) {
            a += ta[r * kCols + tid];
            b = fmaf(ta[r * kCols + tid], tb[r * kCols + tid], b);
          }
          q1[0] = a;
          q1[c] = b;
        }
      }
    }
    __syncthreads();  // dl and the tiles are free for the next tile
  }
}

struct Grid {
  int route = 0;  // blocks of the route kernel (0: the pass has none)
  int rows = 0;   // blocks of the rows kernel
};

template <typename Kernel>
cudaError_t fill(Kernel kernel, size_t smem, long long items, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = r3d_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<int>(items < cap ? items : cap);
  return cudaSuccess;
}

long long route_items(long long n_points, int k, int c) {
  const int pts = k <= kRows ? kRows / k : 1;
  return (n_points + pts - 1) / pts * ((c + kCols - 1) / kCols);
}

constexpr bool has_route(int pass) { return pass != kStats1; }
constexpr bool has_rows(int pass) { return pass == kStats1 || pass == kBwd2 || pass == kBwd3; }
constexpr int route_mode(int pass) {
  return pass == kFwd ? kRouteFwd : pass == kBwd1 ? kRouteBwd1 : kRouteOnly;
}

template <typename T, int kPass>
cudaError_t plan(long long n_points, int k, int c, Grid* g) {
  cudaError_t err = cudaSuccess;
  if constexpr (has_route(kPass))
    err = fill(edge_route_kernel<T, route_mode(kPass)>, 0, route_items(n_points, k, c),
               &g->route);
  if constexpr (has_rows(kPass)) {
    if (err == cudaSuccess)
      err = fill(edge_rows_kernel<T, kPass>, rows_smem_bytes(kPass, c),
                 (n_points * k + kRows - 1) / kRows, &g->rows);
  }
  return err;
}

template <typename T, int kPass>
cudaError_t launch(const void* e, const void* dout, const void* w1, const void* vec, void* out,
                   void* partial, void* sums, void* kstar, void* dzr, long long n_points, int k,
                   int c, const Grid& g, cudaStream_t s) {
  const T* et = static_cast<const T*>(e);
  const float* w = static_cast<const float*>(w1);
  const float* v = static_cast<const float*>(vec);
  float* part = static_cast<float*>(partial);
  int* ks = static_cast<int*>(kstar);
  float* dz = static_cast<float*>(dzr);
  cudaError_t err = cudaSuccess;
  if constexpr (has_route(kPass)) {
    edge_route_kernel<T, route_mode(kPass)><<<g.route, kThreads, 0, s>>>(
        et, static_cast<const float*>(dout), w, v, static_cast<float*>(out), part, ks, dz,
        n_points, k, c);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if constexpr (has_rows(kPass)) {
    const size_t smem = rows_smem_bytes(kPass, c);
    if ((err = r3d_set_smem(edge_rows_kernel<T, kPass>, smem)) != cudaSuccess) return err;
    edge_rows_kernel<T, kPass><<<g.rows, kThreads, smem, s>>>(
        et, w, v, ks, dz, static_cast<T*>(out), part, n_points, k, c);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_sums(kPass, c) == 0) return cudaSuccess;
  const int blocks = kPass == kBwd1 ? g.route : g.rows;
  r3d::sum_partials_kernel<><<<(n_sums(kPass, c) + 255) / 256, 256, 0, s>>>(
      part, static_cast<float*>(sums), blocks, n_sums(kPass, c));
  return cudaGetLastError();
}

template <typename T>
cudaError_t plan_of(int pass, long long n_points, int k, int c, Grid* g) {
  switch (pass) {
    case kStats1: return plan<T, kStats1>(n_points, k, c, g);
    case kFwd: return plan<T, kFwd>(n_points, k, c, g);
    case kBwd1: return plan<T, kBwd1>(n_points, k, c, g);
    case kBwd2: return plan<T, kBwd2>(n_points, k, c, g);
    case kBwd3: return plan<T, kBwd3>(n_points, k, c, g);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(int pass, const void* e, const void* dout, const void* w1, const void* vec,
                void* out, void* partial, void* sums, void* kstar, void* dzr, long long n_points,
                int k, int c, const Grid& g, cudaStream_t s) {
  switch (pass) {
    case kStats1:
      return launch<T, kStats1>(e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c,
                                g, s);
    case kFwd:
      return launch<T, kFwd>(e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c, g,
                             s);
    case kBwd1:
      return launch<T, kBwd1>(e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c,
                              g, s);
    case kBwd2:
      return launch<T, kBwd2>(e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c,
                              g, s);
    case kBwd3:
      return launch<T, kBwd3>(e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c,
                              g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The grids of a pass (blocks[0]: the route kernel's, blocks[1]: the rows
// kernel's; 0 where the pass runs none): as many blocks as fit on the
// device at once, at most one per work item.  bf16: e is bf16.
R3D_EXPORT int r3d_fused_edge_general_blocks(int pass, int bf16, long long n_points, int k, int c,
                                             int* blocks) {
  if (n_points < 1 || k < 1 || c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  Grid g;
  const cudaError_t err = bf16 ? plan_of<uint16_t>(pass, n_points, k, c, &g)
                               : plan_of<float>(pass, n_points, k, c, &g);
  blocks[0] = g.route;
  blocks[1] = g.rows;
  return err;
}

// One pass with the grids r3d_fused_edge_general_blocks gave.
R3D_EXPORT int r3d_fused_edge_general(int pass, int bf16, const void* e, const void* dout,
                                      const void* w1, const void* vec, void* out, void* partial,
                                      void* sums, void* kstar, void* dzr, long long n_points,
                                      int k, int c, int route_blocks, int rows_blocks,
                                      void* stream) {
  if (n_points < 1 || k < 1 || c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  Grid g;
  g.route = route_blocks;
  g.rows = rows_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<uint16_t>(pass, e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k,
                              c, g, s)
              : run<float>(pass, e, dout, w1, vec, out, partial, sums, kstar, dzr, n_points, k, c,
                           g, s);
}
