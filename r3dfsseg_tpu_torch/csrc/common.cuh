// Shared declarations of the port's hand-written kernels.
//
// Every kernel library entry point is a plain C function (loaded with
// ctypes by r3dfsseg_tpu_torch/kernels/build.py): pointers and the CUDA
// stream arrive as void*, sizes as int, and the function returns
// cudaGetLastError() right after its launch so the wrapper can raise on a
// refused launch.  Kernels allocate nothing: the wrapper owns every buffer.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#define R3D_EXPORT extern "C"

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs
// it (Hopper allows up to 227 KB per block).
template <typename Kernel>
static cudaError_t r3d_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// kernel<<<grid, block, smem, stream>>>(args...) with `smem` bytes of
// dynamic shared memory, the SM's carveout set to shared memory first so
// that several such blocks fit on one SM; returns the launch's error.
template <typename... Params, typename... Args>
static cudaError_t r3d_launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                              cudaStream_t stream, Args... args) {
  cudaError_t err = r3d_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

namespace r3d {

// Shared memory one block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;

// sums[o] = sum over blocks, in block order, of partial[block][o]: the
// second pass of a kernel whose blocks each write one partial of its sums
// (no float atomics, so a result repeats from run to run).  A template, so
// a source that does not launch it compiles none.
template <int = 0>
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ sums, int blocks, int n) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * n + o];
  sums[o] = s;
}

// ---- cooperative launches (one grid-wide barrier per step or round) ---
// A kernel that calls cooperative_groups' this_grid().sync() must have all
// its blocks resident at once; the launch below checks that with the
// occupancy API and refuses a grid that would not be, rather than risk a
// barrier that never opens.
struct CoopLaunch {
  int grid;  // blocks
  int sms;
};

// One block per SM, at most `blocks`; refuses a device without cooperative
// launches.
static cudaError_t coop_plan(int blocks, CoopLaunch& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return cudaErrorNotSupported;
  out.grid = blocks < 1 ? 1 : (blocks < out.sms ? blocks : out.sms);
  return cudaSuccess;
}

// The cooperative launch of p.grid blocks of `threads` threads with `smem`
// bytes of dynamic shared memory, or the error that refuses it.
template <typename Kernel>
static cudaError_t coop_launch(Kernel kernel, const CoopLaunch& p, int threads, size_t smem,
                               void** args, cudaStream_t stream) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = r3d_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * p.sms < p.grid) return cudaErrorCooperativeLaunchTooLarge;  // not co-resident
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.grid),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- tf32 tensor-core products (mma.sync, sm_80 and later) ------------
// An f32 x is split into hi = tf32(x), rounded to nearest with ties away
// from zero, and lo = tf32(x - hi); x - hi is exact in f32, so hi + lo
// keeps 22 significant bits of x.  A product a b is then taken as a_hi b_hi
// + a_hi b_lo + a_lo b_hi on the tensor cores (each tf32 x tf32 product is
// exact, the sums f32), dropping only a_lo b_lo, about 2^-22 of |a b|:
// f32-level accuracy, where one tf32 pass keeps 11 bits.
//
// The rounding is cvt.rna.tf32.f32's, done on the bits: add half a unit of
// the 10-bit mantissa to the magnitude and clear the 13 low bits (a carry
// into the exponent is the correct result).  Two integer ops, where ptxas
// expands cvt.rna.tf32 for sm_90 into a longer sequence that also handles
// NaN and infinity; the operands here are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b for one 16 x 8 x 8 tile.  Lane (g, t) = (lane / 4, lane % 4)
// holds a = {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]}, b =
// {B[t][g], B[t + 4][g]} and d = {D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 tensor-core products (mma.sync, sm_80 and later) ------------
// d += a b for one 16 x 16 x 16 tile of bf16 products (exact in f32) with
// f32 sums.  Lane (g, t) = (lane / 4, lane % 4) holds, as bf16 pairs (low
// half first), a = {A[g][2t..2t+1], A[g + 8][2t..], A[g][2t + 8..],
// A[g + 8][2t + 8..]}, b = {B[2t..2t+1][g], B[2t + 8..2t + 9][g]}, and d as
// mma_tf32's (the same m16n8 accumulator layout).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest even into a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The two bf16 of a pair as f32 (exact: bf16 is an f32's high half).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ldmatrix: four 8 x 8 tiles of 16-bit entries from shared memory, lane l
// giving the address of row l % 8 of tile l / 8 (16 contiguous bytes).
// Without .trans register i of lane (g, t) holds row g, entries 2t and 2t +
// 1 of tile i; with .trans rows 2t and 2t + 1 of entry g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- asynchronous copies from device memory into shared memory --------
// 16 bytes through L2 (cp.async.cg), or zeros when !valid (src-size 0;
// src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (cp.async.ca), or zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; a __syncthreads() after it makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace r3d
