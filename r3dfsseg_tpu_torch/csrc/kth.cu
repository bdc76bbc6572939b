// Per-row k-th smallest distance: one read of each row, an exact select of
// its k-th value, and the bisection replayed on scalars.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/pallas_kth.py:_kth_kernel (via
// kth_smallest_per_row_pallas).  Same result: bracket [0, hi] with hi =
// max(row max finite, 1e-6), where finite means d < 0.5 * 1e30 (the
// affinity's self/invalid sentinel); then `iters` steps of mid = 0.5 * (lo +
// hi), count(d <= mid) >= k ? hi = mid : lo = mid; the result is hi.
//
// Why the replay is exact: count(d <= mid) >= k holds exactly when v_k <=
// mid, v_k being the k-th smallest finite entry (with multiplicity).  Entries
// that are not finite (sentinels, +inf, NaN) are never <= mid, because mid
// <= hi < 0.5 * 1e30.  So once a block knows v_k and hi, one thread runs the
// steps on scalars with the same round-to-nearest mid-point (no contraction);
// with fewer than k finite entries v_k = +inf and no step passes.  The
// result equals the plain version bit for bit.
//
// What bounds it on the H100: the bytes of one read of the matrix (77 MB
// f32, 38.65 MB bf16 at the flagship 4396 x 4396; 23 / 11.5 us at 3.35
// TB/s).  The design keeps every later step on chip:
//   1. load: 16-byte loads (a scalar head where a bf16 row starts 8 bytes
//      off a 16-byte boundary, and a scalar tail), four in flight per
//      thread; each entry is mapped to an order-preserving key (unsigned
//      order = float order; a bf16 entry keeps its 16-bit key, as it is
//      upcast exactly) and stored in shared memory, non-finite entries as
//      a marker above every key; the finite keys' min, max and count are
//      reduced on the way;
//   2. select: radix passes over the keys in shared memory.  A pass's digit
//      is the top 8 bits of (key - lo) over the live key range [lo, lo +
//      span], not a fixed bit field: distances cluster in a few exponents,
//      and a fixed sign-and-exponent digit would put most of a row in one
//      bin (256 shared-memory atomics on one address).  The bucket holding
//      rank r narrows the range 256-fold and keeps the remaining rank.  Once
//      the range holds one key (ties), that key is v_k; once it holds at
//      most 128 entries, they are compacted and each thread ranks one
//      against the others.  On pairwise distances of random 192-d features
//      (4396 x 4396, k = 200) one pass leaves 16-45 entries, f32 and bf16,
//      so a row costs three sweeps of shared memory and about ten barriers
//      (the bisection it replaces: 32 sweeps and ~320 barriers).
// One block of 128 threads per row (4396 rows): the row's keys (17.6 KB f32,
// 8.8 KB bf16) and the histogram take ~20 KB, and the kernel fits in 48
// registers, so 10 blocks share an SM; while some sweep shared memory, the
// others' loads are in flight.  256 threads per row, 8 loads in flight per
// thread, a bound for 12 blocks per SM, or 1024 bins gave no clear gain on
// the H100.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kCap = kThreads;     // a range of at most this many entries is ranked directly
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr float kFinite = 0.5f * 1e30f;

// Order-preserving keys: flip every bit of a negative value, only the sign
// bit of a positive one.  kNone marks an entry that is not finite; it is
// above the key of every finite value (+inf's key is below it).
template <typename T>  // float, or unsigned short holding bf16 bits
struct Keys;

template <>
struct Keys<float> {
  using Key = unsigned int;
  static constexpr Key kNone = 0xFFFFFFFFu;
  __device__ static float value(float v) { return v; }
  __device__ static Key key(float v) {
    const unsigned u = __float_as_uint(v);
    return (u >> 31) ? ~u : (u | 0x80000000u);
  }
  __device__ static float unkey(unsigned k) {
    return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
  }
};

template <>
struct Keys<unsigned short> {
  using Key = unsigned short;
  static constexpr Key kNone = 0xFFFFu;
  __device__ static float value(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  __device__ static Key key(unsigned short b) {
    return static_cast<Key>((b >> 15) ? ~b : (b | 0x8000u));
  }
  __device__ static float unkey(unsigned k) {
    return __uint_as_float(((k >> 15) ? (k & 0x7FFFu) : (~k & 0xFFFFu)) << 16);
  }
};

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // entries per 16-byte load

// Key slots a row takes in shared memory: the row shifted by up to kVec - 1
// so that its 16-byte-aligned body lands on 16-byte-aligned slots.
template <typename T>
__host__ __device__ constexpr int slots(int m) {
  return (m + 2 * kVec<T> - 2) / kVec<T> * kVec<T>;
}

template <typename T>
union Vec {
  uint4 u;
  T e[kVec<T>];
  typename Keys<T>::Key k[kVec<T>];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
kth_kernel(const T* __restrict__ d, float* __restrict__ out, int m, int k, int iters) {
  using K = Keys<T>;
  using Key = typename K::Key;
  constexpr int V = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* keys = reinterpret_cast<Key*>(smem);
  __shared__ unsigned hist[kBins];
  __shared__ unsigned cand[kCap];
  __shared__ unsigned red[3][kWarps];
  __shared__ unsigned sel[4];  // bucket, remaining rank, entries in it; the k-th key
  __shared__ unsigned ncand;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const T* row = d + static_cast<size_t>(blockIdx.x) * m;
  const int n_slots = slots<T>(m);

  // ---- 1. load: keys into shared memory; min, max and count of the finite
  const int head = min(m, static_cast<int>((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) /
                              static_cast<int>(sizeof(T)));
  const int pad = (V - head) % V;
  const int nvec = (m - head) / V;
  const int tail0 = head + nvec * V;
  unsigned kmin = 0xFFFFFFFFu, kmax = 0u, cnt = 0u;
  auto take = [&](T x) -> Key {
    if (!(K::value(x) < kFinite)) return K::kNone;
    const Key key = K::key(x);
    kmin = min(kmin, static_cast<unsigned>(key));
    kmax = max(kmax, static_cast<unsigned>(key));
    ++cnt;
    return key;
  };
  if (t < head) keys[pad + t] = take(row[t]);
  if (t < m - tail0) keys[pad + tail0 + t] = take(row[tail0 + t]);
  if (t < pad) keys[t] = K::kNone;
  for (int i = pad + m + t; i < n_slots; i += kThreads) keys[i] = K::kNone;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  uint4* kbody = reinterpret_cast<uint4*>(keys + pad + head);
  for (int i0 = t; i0 < nvec; i0 += kThreads * kUnroll) {
    Vec<T> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads < nvec) x[u].u = __ldg(body + i0 + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads < nvec) {
        Vec<T> y;
#pragma unroll
        for (int e = 0; e < V; ++e) y.k[e] = take(x[u].e[e]);
        kbody[i0 + u * kThreads] = y.u;
      }
    }
  }
  kmin = __reduce_min_sync(0xFFFFFFFFu, kmin);
  kmax = __reduce_max_sync(0xFFFFFFFFu, kmax);
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) {
    red[0][warp] = kmin;
    red[1][warp] = kmax;
    red[2][warp] = cnt;
  }
  if (t == 0) ncand = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    kmin = min(kmin, red[0][w]);
    kmax = max(kmax, red[1][w]);
  }
  cnt = red[2][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) cnt += red[2][w];

  // ---- 2. select v_k among the finite keys
  float vk;
  if (k <= 0) {
    vk = -__int_as_float(0x7F800000);   // every count passes
  } else if (static_cast<unsigned>(k) > cnt) {
    vk = __int_as_float(0x7F800000);    // no count passes
  } else {
    const uint4* kv = reinterpret_cast<const uint4*>(keys);
    const int n_kv = n_slots / V;
    unsigned lo = kmin, span = kmax - kmin, rank = k, live = cnt;
    while (span != 0 && live > kCap) {
      const int shift = max(32 - __clz(span) - kBits, 0);
      for (int i = t; i < kBins; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int i = t; i < n_kv; i += kThreads) {
        Vec<T> x;
        x.u = kv[i];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const unsigned off = static_cast<unsigned>(x.k[e]) - lo;
          if (off <= span) atomicAdd(&hist[off >> shift], 1u);
        }
      }
      __syncthreads();
      if (warp == 0) {  // the bucket holding `rank`: lane l scans bins 8l .. 8l + 7
        constexpr int per = kBins / 32;
        unsigned h[per], sum = 0;
#pragma unroll
        for (int i = 0; i < per; ++i) sum += h[i] = hist[lane * per + i];
        unsigned incl = sum;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const unsigned o = __shfl_up_sync(0xFFFFFFFFu, incl, s);
          if (lane >= s) incl += o;
        }
        unsigned before = incl - sum;
        if (before < rank && rank <= incl) {
#pragma unroll
          for (int i = 0; i < per; ++i) {
            if (rank > before && rank <= before + h[i]) {
              sel[0] = lane * per + i;
              sel[1] = rank - before;
              sel[2] = h[i];
            }
            before += h[i];
          }
        }
      }
      __syncthreads();
      const unsigned b = sel[0];
      rank = sel[1];
      live = sel[2];
      lo += b << shift;
      span = min(span - (b << shift), (1u << shift) - 1u);
    }
    if (span == 0) {
      vk = K::unkey(lo);
    } else {  // at most kCap entries in range: compact, then rank each
      for (int i = t; i < n_kv; i += kThreads) {
        Vec<T> x;
        x.u = kv[i];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const unsigned key = x.k[e];
          if (key - lo <= span) cand[atomicAdd(&ncand, 1u)] = key;
        }
      }
      __syncthreads();
      if (static_cast<unsigned>(t) < live) {
        const unsigned mine = cand[t];
        unsigned below = 0;
        for (unsigned j = 0; j < live; ++j) {
          const unsigned c = cand[j];
          below += (c < mine) | ((c == mine) & (j < static_cast<unsigned>(t)));
        }
        if (below == rank - 1) sel[3] = mine;
      }
      __syncthreads();
      vk = K::unkey(sel[3]);
    }
  }

  // ---- 3. the bisection, replayed on scalars
  if (t == 0) {
    const float mx = cnt ? K::unkey(kmax) : 0.f;
    float hi = fmaxf(fmaxf(mx, 0.f), 1e-6f);
    float lo = 0.f;
    for (int it = 0; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (vk <= mid) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    out[blockIdx.x] = hi;
  }
}

// The variant for rows that one block's shared memory does not hold
// (`r3d_kth_fits` refuses them): the same select and the same replay, bit
// for bit, with the row read from device memory (through L2) once per
// pass instead of once into shared memory: a pass for the min, max and
// count of the finite keys, one per radix pass, one to compact the last
// range.  256 threads per row, entries read in order by neighbouring
// threads; a row is 240 KB or more, so few rows are in flight at once and
// most passes hit L2.
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideCap = kWideThreads;

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
kth_wide_kernel(const T* __restrict__ d, float* __restrict__ out, int m, int k, int iters) {
  using K = Keys<T>;
  __shared__ unsigned hist[kBins];
  __shared__ unsigned cand[kWideCap];
  __shared__ unsigned red[3][kWideWarps];
  __shared__ unsigned sel[4];  // bucket, remaining rank, entries in it; the k-th key
  __shared__ unsigned ncand;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const T* row = d + static_cast<size_t>(blockIdx.x) * m;
  // the key of entry i, or kNone when it is not finite
  auto key_at = [&](int i) -> unsigned {
    const T x = row[i];
    return K::value(x) < kFinite ? static_cast<unsigned>(K::key(x))
                                 : static_cast<unsigned>(K::kNone);
  };

  // ---- 1. min, max and count of the finite keys
  unsigned kmin = 0xFFFFFFFFu, kmax = 0u, cnt = 0u;
  for (int i = t; i < m; i += kWideThreads) {
    const unsigned key = key_at(i);
    if (key != static_cast<unsigned>(K::kNone)) {
      kmin = min(kmin, key);
      kmax = max(kmax, key);
      ++cnt;
    }
  }
  kmin = __reduce_min_sync(0xFFFFFFFFu, kmin);
  kmax = __reduce_max_sync(0xFFFFFFFFu, kmax);
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) {
    red[0][warp] = kmin;
    red[1][warp] = kmax;
    red[2][warp] = cnt;
  }
  if (t == 0) ncand = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) {
    kmin = min(kmin, red[0][w]);
    kmax = max(kmax, red[1][w]);
  }
  cnt = red[2][0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) cnt += red[2][w];

  // ---- 2. select v_k among the finite keys
  float vk;
  if (k <= 0) {
    vk = -__int_as_float(0x7F800000);   // every count passes
  } else if (static_cast<unsigned>(k) > cnt) {
    vk = __int_as_float(0x7F800000);    // no count passes
  } else {
    unsigned lo = kmin, span = kmax - kmin, rank = k, live = cnt;
    while (span != 0 && live > kWideCap) {
      const int shift = max(32 - __clz(span) - kBits, 0);
      for (int i = t; i < kBins; i += kWideThreads) hist[i] = 0;
      __syncthreads();
      for (int i = t; i < m; i += kWideThreads) {
        const unsigned off = key_at(i) - lo;   // kNone is above lo + span
        if (off <= span) atomicAdd(&hist[off >> shift], 1u);
      }
      __syncthreads();
      if (warp == 0) {  // the bucket holding `rank`: lane l scans bins 8l .. 8l + 7
        constexpr int per = kBins / 32;
        unsigned h[per], sum = 0;
#pragma unroll
        for (int i = 0; i < per; ++i) sum += h[i] = hist[lane * per + i];
        unsigned incl = sum;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const unsigned o = __shfl_up_sync(0xFFFFFFFFu, incl, s);
          if (lane >= s) incl += o;
        }
        unsigned before = incl - sum;
        if (before < rank && rank <= incl) {
#pragma unroll
          for (int i = 0; i < per; ++i) {
            if (rank > before && rank <= before + h[i]) {
              sel[0] = lane * per + i;
              sel[1] = rank - before;
              sel[2] = h[i];
            }
            before += h[i];
          }
        }
      }
      __syncthreads();
      const unsigned b = sel[0];
      rank = sel[1];
      live = sel[2];
      lo += b << shift;
      span = min(span - (b << shift), (1u << shift) - 1u);
    }
    if (span == 0) {
      vk = K::unkey(lo);
    } else {  // at most kWideCap entries in range: compact, then rank each
      for (int i = t; i < m; i += kWideThreads) {
        const unsigned key = key_at(i);
        if (key - lo <= span) cand[atomicAdd(&ncand, 1u)] = key;
      }
      __syncthreads();
      if (static_cast<unsigned>(t) < live) {
        const unsigned mine = cand[t];
        unsigned below = 0;
        for (unsigned j = 0; j < live; ++j) {
          const unsigned c = cand[j];
          below += (c < mine) | ((c == mine) & (j < static_cast<unsigned>(t)));
        }
        if (below == rank - 1) sel[3] = mine;
      }
      __syncthreads();
      vk = K::unkey(sel[3]);
    }
  }

  // ---- 3. the bisection, replayed on scalars
  if (t == 0) {
    const float mx = cnt ? K::unkey(kmax) : 0.f;
    float hi = fmaxf(fmaxf(mx, 0.f), 1e-6f);
    float lo = 0.f;
    for (int it = 0; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (vk <= mid) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    out[blockIdx.x] = hi;
  }
}

template <typename T>
cudaError_t launch_wide(const void* d, void* out, int rows, int m, int k, int iters,
                        void* stream) {
  if (rows < 1 || m < 1) return cudaErrorInvalidValue;
  return r3d_launch(kth_wide_kernel<T>, dim3(rows), dim3(kWideThreads), 0,
                    static_cast<cudaStream_t>(stream), static_cast<const T*>(d),
                    static_cast<float*>(out), m, k, iters);
}

template <typename T>
size_t smem_bytes(int m) {
  return sizeof(T) * static_cast<size_t>(slots<T>(m));
}

// Static shared memory of a block beside the row's keys.
constexpr size_t kStaticSmem = sizeof(unsigned) * (kBins + kCap + 3 * kWarps + 4 + 1);

template <typename T>
cudaError_t launch(const void* d, void* out, int rows, int m, int k, int iters, void* stream) {
  if (rows < 1 || m < 1 || smem_bytes<T>(m) + kStaticSmem > r3d::kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  return r3d_launch(kth_kernel<T>, dim3(rows), dim3(kThreads), smem_bytes<T>(m),
                    static_cast<cudaStream_t>(stream), static_cast<const T*>(d),
                    static_cast<float*>(out), m, k, iters);
}

}  // namespace

R3D_EXPORT int r3d_kth(const void* d, void* out, int rows, int m, int k, int iters,
                       void* stream) {
  return launch<float>(d, out, rows, m, k, iters, stream);
}

R3D_EXPORT int r3d_kth_bf16(const void* d, void* out, int rows, int m, int k, int iters,
                            void* stream) {
  return launch<unsigned short>(d, out, rows, m, k, iters, stream);
}

// 1 when a row of m entries of `elem_bytes` (4: f32, 2: bf16) fits one
// block's shared memory, else 0.
R3D_EXPORT int r3d_kth_fits(int m, int elem_bytes) {
  const size_t row = elem_bytes == 4 ? smem_bytes<float>(m) : smem_bytes<unsigned short>(m);
  return m >= 1 && row + kStaticSmem <= r3d::kSmemLimit ? 1 : 0;
}

// The variant for rows of any width (read from device memory per pass),
// f32 and bf16: the same result as r3d_kth and r3d_kth_bf16.
R3D_EXPORT int r3d_kth_wide(const void* d, void* out, int rows, int m, int k, int iters,
                            void* stream) {
  return launch_wide<float>(d, out, rows, m, k, iters, stream);
}

R3D_EXPORT int r3d_kth_wide_bf16(const void* d, void* out, int rows, int m, int k, int iters,
                                 void* stream) {
  return launch_wide<unsigned short>(d, out, rows, m, k, iters, stream);
}
