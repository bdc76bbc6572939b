// Fused EdgeConv tail over the raw edge tensor e (B*N points, K rows of C):
//     h0 = leaky(e * aff0 + sh0),  l1 = h0 @ W1,  z1 = l1 * aff1 + sh1,
//     out = max over k of leaky(z1),
// in five passes: stats1 (sums of l1 and l1^2 for BN1's batch statistics),
// fwd (out), and the three passes of the batch-norm backward: bwd1 (r1 =
// sum dz1, r2 = sum dz1 * xhat1), bwd2 (dW1 = h0^T dl1, q1 = sum dz0, q2 =
// sum dz0 * xhat0) and bwd3 (d_e).  Leaky slope 0.2; the max routes its
// gradient to the lowest k among ties.
//
// Replaces the TPU kernel scripts/archive/fused_edge.py:_call with its
// bodies _stats1_kernel, _fwd_kernel, _bwd1_kernel, _bwd2_kernel and
// _bwd3_kernel (the same per-row algebra, :63-209).  The TPU grid runs in
// order and carries the channel sums in a revisited output block
// (:242-244).  Hopper's blocks run in no order, so here a persistent grid
// (as many blocks as fit on the SMs at once) loops over tiles of kPoints
// points, each block keeps its share of the sums in registers and writes
// one partial, and r3d::sum_partials_kernel adds the partials in block order:
// no float atomics, so a result repeats from run to run.
//
// What bounds it on the H100: operations.  Each pass runs one (rows x 64)
// x (64 x 64) product (bwd2 three, bwd3 two) over the 409,600 edge rows of
// the flagship support batch (B = 10, N = 2048, K = 20): 3.36 GFLOP per
// product, 0.050 ms at the f32 peak, against 105 MB of e read in 0.031 ms.
// The products are FP32 FFMA on CUDA cores (no TF32: the port pins f32
// matmuls).  A tile's h0 = leaky(BN0(e)) (and l1, then dl1, in place) stay
// in shared memory with W1 (and W1^T for the backward): a 256-thread block
// computes 4 x 8 output sub-tiles, four rows times two groups of four
// columns 32 apart, so a quarter-warp reads one broadcast float4 of h0 and
// 128 contiguous bytes of W1 per load, 12 loads per 128 FFMAs.  Each
// backward pass recomputes the forward from e, as on the TPU, so nothing
// of the (B, N, K, C) chain is written to device memory but d_e.
//
// BN affines and the statistics are computed outside (ops/fused_edge.py);
// the staging and BN1 use round-to-nearest multiply then add in the plain
// version's order, so h0 and z1 differ from it only through the product.
//
// e of either type: the kernel is a template on e's element type, f32
// (r3d_fused_edge) or bf16 (r3d_fused_edge_bf16, the bf16 encoder's
// e_raw, as the archive's bodies take it: `e_ref[0].astype(jnp.float32)`,
// d_e written in e's type, :209).  A bf16 entry is widened to f32 as it
// is loaded (exact), and everything after the load is the f32 code, so
// every pass of the bf16 form gives the f32 form's bits on e's upcast, d_e
// rounded once to bf16 (round to nearest even).  It reads 2 bytes per
// entry of e and writes 2 per entry of d_e.
//
// Layout: e (P, K, 64) f32 or bf16 contiguous and 16-byte aligned, with P =
// B * N a multiple of kPoints; dout (P, 64) f32; W1 (64, 64) as (C_in,
// C_out); vec (kNumVec, 64), the rows named by Vec (rows a pass does not
// read may hold anything); out: fwd (P, 64) f32, bwd3 (P, K, 64) of e's
// type; partial (grid, n_sums); sums (n_sums): stats1 [s1, s2], bwd1 [r1,
// r2], bwd2 [dW1 (64 x 64), q1, q2].  Shapes past this tile (C != 64, P
// not a multiple of 8, K past shared memory) take csrc/fused_edge_general.cu.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kC = 64;        // channels in and out of W1
constexpr int kPoints = 8;    // points per tile: kPoints * K rows
constexpr int kThreads = 256;
constexpr int kRedFloats = 2 * kThreads * 8;  // per-thread partials of two 8-channel sums
constexpr float kSlope = 0.2f;

enum Vec { kAff0, kSh0, kAff1, kSh1, kInv1, kMu1, kG1inv, kMr1, kMr2, kInv0, kMu0, kG0inv, kMq1,
           kMq2, kNumVec };
enum Pass { kStats1 = 0, kFwd = 1, kBwd1 = 2, kBwd2 = 3, kBwd3 = 4 };

__device__ __forceinline__ float leaky(float z) { return z > 0.f ? z : kSlope * z; }
__device__ __forceinline__ float bn(float x, float aff, float sh) {
  return __fadd_rn(__fmul_rn(x, aff), sh);
}

__host__ __device__ constexpr bool backward_product(int pass) {
  return pass == kBwd2 || pass == kBwd3;
}
__host__ __device__ constexpr int n_sums(int pass) {
  return pass == kStats1 || pass == kBwd1 ? 2 * kC : pass == kBwd2 ? kC * kC + 2 * kC : 0;
}

// Floats of shared memory: W1 [, W1^T], vec, then the tile region (h0 and,
// but for stats1, l1), which the final reduction reuses.
__host__ __device__ constexpr int smem_floats(int pass, int k) {
  const int rows = kPoints * k;
  const int tile = (pass == kStats1 ? 1 : 2) * rows * kC;
  return kC * kC * (backward_product(pass) ? 2 : 1) + kNumVec * kC +
         (tile > kRedFloats ? tile : kRedFloats);
}

// acc[i][j] = sum_q a[r0 + i][q] * b[q][col(j)], col(j) = 4 cg + j (j < 4),
// 32 + 4 cg + j - 4 (j >= 4); a (rows, 64) and b (64, 64) in shared memory.
__device__ __forceinline__ void mm_tile(const float* __restrict__ a, const float* __restrict__ b,
                                        int r0, int cg, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll 2
  for (int q = 0; q < kC; q += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = a4[((r0 + i) * kC + q) / 4];
      av[i][0] = v.x;
      av[i][1] = v.y;
      av[i][2] = v.z;
      av[i][3] = v.w;
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float4 b0 = b4[(q + qq) * (kC / 4) + cg];
      const float4 b1 = b4[(q + qq) * (kC / 4) + 8 + cg];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = av[i][qq];
        acc[i][0] = fmaf(x, b0.x, acc[i][0]);
        acc[i][1] = fmaf(x, b0.y, acc[i][1]);
        acc[i][2] = fmaf(x, b0.z, acc[i][2]);
        acc[i][3] = fmaf(x, b0.w, acc[i][3]);
        acc[i][4] = fmaf(x, b1.x, acc[i][4]);
        acc[i][5] = fmaf(x, b1.y, acc[i][5]);
        acc[i][6] = fmaf(x, b1.z, acc[i][6]);
        acc[i][7] = fmaf(x, b1.w, acc[i][7]);
      }
    }
  }
}

__device__ __forceinline__ int col(int cg, int j) { return j < 4 ? 4 * cg + j : 28 + 4 * cg + j; }

// Four consecutive entries of e as f32 (16 bytes of f32, or 8 of bf16: a
// bf16 is the high half of its f32), and four f32 stored in e's type.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(r3d::bf16_lo(u.x), r3d::bf16_hi(u.x), r3d::bf16_lo(u.y), r3d::bf16_hi(u.y));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(r3d::pack_bf16(v.x, v.y), r3d::pack_bf16(v.z, v.w));
}

// T: e's element type, float or uint16_t (the bits of a bf16)
template <int kPass, typename T>
__global__ void __launch_bounds__(kThreads)
fused_edge_kernel(const T* __restrict__ e, const float* __restrict__ dout,
                  const float* __restrict__ w1g, const float* __restrict__ vecg,
                  void* __restrict__ out_, float* __restrict__ partial, int n_points, int k) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBack = backward_product(kPass);
  const int rows = kPoints * k;
  float* w1 = smem;
  float* w1t = w1 + kC * kC;  // kBack only
  float* vec = w1t + (kBack ? kC * kC : 0);
  float* h = vec + kNumVec * kC;
  float* l = h + rows * kC;  // not stats1
  float* red = h;            // after the last tile
  const int tid = threadIdx.x;
  const int cg = tid % 8;  // fixed: the product loop strides by kThreads

  for (int i = tid; i < kC * kC; i += kThreads) {
    const float w = w1g[i];
    w1[i] = w;
    if (kBack) w1t[(i % kC) * kC + i / kC] = w;
  }
  for (int i = tid; i < kNumVec * kC; i += kThreads) vec[i] = vecg[i];

  float sum_a[8], sum_b[8];  // stats1: s1, s2; bwd2: q1, q2 (channels col(cg, j))
  float dw[16];              // bwd2: dW1[4 (tid / 16) + ii][4 (tid % 16) + jj]
  float r1 = 0.f, r2 = 0.f;  // bwd1: channel tid % 64
#pragma unroll
  for (int j = 0; j < 8; ++j) sum_a[j] = sum_b[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) dw[j] = 0.f;

  const int n_tiles = n_points / kPoints;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // W1 and vec staged; the last tile's readers are done
    const size_t row0 = static_cast<size_t>(tile) * rows;  // first edge row of the tile
    const T* et = e + row0 * kC;
    for (int i = tid; i < rows * kC / 4; i += kThreads) {
      float4 v = load4(et + 4 * i);
      const int c = (4 * i) % kC;
      v.x = leaky(bn(v.x, vec[kAff0 * kC + c], vec[kSh0 * kC + c]));
      v.y = leaky(bn(v.y, vec[kAff0 * kC + c + 1], vec[kSh0 * kC + c + 1]));
      v.z = leaky(bn(v.z, vec[kAff0 * kC + c + 2], vec[kSh0 * kC + c + 2]));
      v.w = leaky(bn(v.w, vec[kAff0 * kC + c + 3], vec[kSh0 * kC + c + 3]));
      reinterpret_cast<float4*>(h)[i] = v;
    }
    __syncthreads();

    // l1 = h0 @ W1: stats1 sums it, the other passes keep it in l
    for (int t = tid; t < rows * 2; t += kThreads) {  // rows / 4 row groups x 8 column groups
      const int r0 = (t / 8) * 4;
      float acc[4][8];
      mm_tile(h, w1, r0, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kPass == kStats1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum_a[j] += acc[i][j];
            sum_b[j] = fmaf(acc[i][j], acc[i][j], sum_b[j]);
          }
        } else {
          float4* l4 = reinterpret_cast<float4*>(l + (r0 + i) * kC);
          l4[cg] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          l4[8 + cg] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
    if (kPass == kStats1) continue;
    __syncthreads();

    // max over k per (point, channel), lowest k on ties
    for (int u = tid; u < kPoints * kC; u += kThreads) {
      const int p = u / kC;
      const int c = u % kC;
      const float aff1 = vec[kAff1 * kC + c], sh1 = vec[kSh1 * kC + c];
      float best = 0.f, best_z = 0.f, best_l = 0.f;
      int best_k = 0;
      for (int kk = 0; kk < k; ++kk) {
        const float l1 = l[(p * k + kk) * kC + c];
        const float z1 = bn(l1, aff1, sh1);
        const float h1 = leaky(z1);
        if (kk == 0 || h1 > best) {
          best = h1;
          best_z = z1;
          best_l = l1;
          best_k = kk;
        }
      }
      const size_t point = static_cast<size_t>(tile) * kPoints + p;
      if (kPass == kFwd) {
        static_cast<float*>(out_)[point * kC + c] = best;
        continue;
      }
      const float inv1 = vec[kInv1 * kC + c], mu1 = vec[kMu1 * kC + c];
      const float dz = dout[point * kC + c] * (best_z > 0.f ? 1.f : kSlope);
      if (kPass == kBwd1) {
        r1 += dz;
        r2 += dz * ((best_l - mu1) * inv1);
        continue;
      }
      // dl1 = g1inv * (dz1 - mr1 - xhat1 * mr2), in place of l1
      const float g1inv = vec[kG1inv * kC + c], mr1 = vec[kMr1 * kC + c],
                  mr2 = vec[kMr2 * kC + c];
      for (int kk = 0; kk < k; ++kk) {
        float* lp = l + (p * k + kk) * kC + c;
        const float xhat1 = (*lp - mu1) * inv1;
        *lp = g1inv * (((kk == best_k) ? dz : 0.f) - mr1 - xhat1 * mr2);
      }
    }
    if (!kBack) continue;
    __syncthreads();

    if (kPass == kBwd2) {  // dW1 += h0^T dl1, a 4 x 4 sub-tile per thread
      const float4* h4 = reinterpret_cast<const float4*>(h);
      const float4* d4 = reinterpret_cast<const float4*>(l);
      for (int r = 0; r < rows; ++r) {
        const float4 a = h4[r * (kC / 4) + tid / 16];
        const float4 d = d4[r * (kC / 4) + tid % 16];
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dw[ii * 4 + jj] = fmaf(av[ii], dv[jj], dw[ii * 4 + jj]);
        }
      }
    }

    // dh0 = dl1 @ W1^T, dz0 = dh0 * leaky'(z0) (z0 > 0 exactly where h0 > 0)
    for (int t = tid; t < rows * 2; t += kThreads) {
      const int r0 = (t / 8) * 4;
      float acc[4][8];
      mm_tile(l, w1t, r0, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t row = row0 + r0 + i;
        const float4 e0 = load4(e + row * kC + 4 * cg), e1 = load4(e + row * kC + 32 + 4 * cg);
        const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
        float de[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col(cg, j);
          const float dz0 = acc[i][j] * (h[(r0 + i) * kC + c] > 0.f ? 1.f : kSlope);
          const float xhat0 = (ev[j] - vec[kMu0 * kC + c]) * vec[kInv0 * kC + c];
          if (kPass == kBwd2) {
            sum_a[j] += dz0;
            sum_b[j] = fmaf(dz0, xhat0, sum_b[j]);
          } else {
            de[j] = vec[kG0inv * kC + c] *
                    (dz0 - vec[kMq1 * kC + c] - xhat0 * vec[kMq2 * kC + c]);
          }
        }
        if (kPass == kBwd3) {
          T* og = static_cast<T*>(out_) + row * kC;
          store4(og + 4 * cg, make_float4(de[0], de[1], de[2], de[3]));
          store4(og + 32 + 4 * cg, make_float4(de[4], de[5], de[6], de[7]));
        }
      }
    }
  }

  // this block's partial sums, reduced across threads in a fixed order
  if constexpr (n_sums(kPass) != 0) {
    float* part = partial + static_cast<size_t>(blockIdx.x) * n_sums(kPass);
    __syncthreads();
    if constexpr (kPass == kBwd1) {
      red[tid] = r1;
      red[kThreads + tid] = r2;
      __syncthreads();
      if (tid < kC) {
        float a = 0.f, b = 0.f;
        for (int m = tid; m < kThreads; m += kC) {
          a += red[m];
          b += red[kThreads + m];
        }
        part[tid] = a;
        part[kC + tid] = b;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[tid * 8 + j] = sum_a[j];
        red[kThreads * 8 + tid * 8 + j] = sum_b[j];
      }
      __syncthreads();
      const int off = kPass == kBwd2 ? kC * kC : 0;
      if (tid < kC) {
        const int c = tid;
        const int g = (c % 32) / 4;
        const int j = c % 4 + (c >= 32 ? 4 : 0);
        float a = 0.f, b = 0.f;
        for (int m = g; m < kThreads; m += 8) {
          a += red[m * 8 + j];
          b += red[kThreads * 8 + m * 8 + j];
        }
        part[off + c] = a;
        part[off + kC + c] = b;
      }
      if constexpr (kPass == kBwd2) {
        const int i0 = (tid / 16) * 4, c0 = (tid % 16) * 4;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) part[(i0 + ii) * kC + c0 + jj] = dw[ii * 4 + jj];
        }
      }
    }
  }
}

template <int kPass, typename T>
cudaError_t prepare(int k, size_t* smem, int* blocks) {
  *smem = sizeof(float) * static_cast<size_t>(smem_floats(kPass, k));
  if (blocks != nullptr) *blocks = 0;
  if (blocks != nullptr && *smem > r3d::kSmemLimit) return cudaSuccess;  // K past the tile
  cudaError_t err = r3d_set_smem(fused_edge_kernel<kPass, T>, *smem);
  if (err != cudaSuccess || blocks == nullptr) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_edge_kernel<kPass, T>,
                                                      kThreads, *smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;  // 0: the tile does not fit
  return cudaSuccess;
}

template <int kPass, typename T>
cudaError_t launch(const void* e, const void* dout, const void* w1, const void* vec, void* out,
                   void* partial, void* sums, int n_points, int k, int grid,
                   cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<kPass, T>(k, &smem, nullptr);
  if (err != cudaSuccess) return err;
  fused_edge_kernel<kPass, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(e), static_cast<const float*>(dout),
      static_cast<const float*>(w1), static_cast<const float*>(vec), out,
      static_cast<float*>(partial), n_points, k);
  if ((err = cudaGetLastError()) != cudaSuccess || n_sums(kPass) == 0) return err;
  r3d::sum_partials_kernel<><<<(n_sums(kPass) + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), grid, n_sums(kPass));
  return cudaGetLastError();
}

template <typename T>
int blocks_of(int pass, int k, int* blocks) {
  size_t smem = 0;
  switch (pass) {
    case kStats1: return prepare<kStats1, T>(k, &smem, blocks);
    case kFwd: return prepare<kFwd, T>(k, &smem, blocks);
    case kBwd1: return prepare<kBwd1, T>(k, &smem, blocks);
    case kBwd2: return prepare<kBwd2, T>(k, &smem, blocks);
    case kBwd3: return prepare<kBwd3, T>(k, &smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(int pass, const void* e, const void* dout, const void* w1, const void* vec, void* out,
        void* partial, void* sums, int n_points, int k, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pass) {
    case kStats1:
      return launch<kStats1, T>(e, dout, w1, vec, out, partial, sums, n_points, k, grid, s);
    case kFwd: return launch<kFwd, T>(e, dout, w1, vec, out, partial, sums, n_points, k, grid, s);
    case kBwd1: return launch<kBwd1, T>(e, dout, w1, vec, out, partial, sums, n_points, k, grid, s);
    case kBwd2: return launch<kBwd2, T>(e, dout, w1, vec, out, partial, sums, n_points, k, grid, s);
    case kBwd3: return launch<kBwd3, T>(e, dout, w1, vec, out, partial, sums, n_points, k, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The grid of a pass: as many blocks as fit on the device's SMs at once;
// 0 where the tile of K rows per point does not fit (the wrapper then
// takes csrc/fused_edge_general.cu).
R3D_EXPORT int r3d_fused_edge_blocks(int pass, int k, int* blocks) {
  return blocks_of<float>(pass, k, blocks);
}
R3D_EXPORT int r3d_fused_edge_bf16_blocks(int pass, int k, int* blocks) {
  return blocks_of<uint16_t>(pass, k, blocks);
}

// One pass over n_points points with grid blocks (<= the number of tiles),
// on an f32 or a bf16 e.
R3D_EXPORT int r3d_fused_edge(int pass, const void* e, const void* dout, const void* w1,
                              const void* vec, void* out, void* partial, void* sums,
                              int n_points, int k, int grid, void* stream) {
  return run<float>(pass, e, dout, w1, vec, out, partial, sums, n_points, k, grid, stream);
}
R3D_EXPORT int r3d_fused_edge_bf16(int pass, const void* e, const void* dout, const void* w1,
                                   const void* vec, void* out, void* partial, void* sums,
                                   int n_points, int k, int grid, void* stream) {
  return run<uint16_t>(pass, e, dout, w1, vec, out, partial, sums, n_points, k, grid, stream);
}
