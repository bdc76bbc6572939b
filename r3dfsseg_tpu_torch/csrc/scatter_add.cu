// Scatter-add, the backward of the EdgeConv neighbour gather:
// dx[b, j, :] = sum of g[b, m, :] over the rows m with idx[b, m] == j.
//
// Replaces the TPU kernel r3dfsseg_tpu/ops/fast_gather.py:_scatter_kernel
// (via scatter_add_pallas), which builds a (TM, N) one-hot tile and lets
// the matrix unit compute onehot^T g, with g rounded to bf16 on the way
// in.  That rounding belongs to the TPU's matrix unit, not to the
// function: this kernel sums in f32, as `exact_grad_gather=True` asks.
//
// What bounds it on the H100: bytes.  g (B, M, C) f32 is read once (105
// MB at B = 10, N = 2048, K = 20, C = 64), idx once, dx written once; the
// adds are few.  The design pulls instead of pushing: it inverts the graph
// and lets a warp sum each target's rows, so g is read in whole rows (256
// bytes at C = 64, one coalesced load per warp), dx is written once, there
// are no float atomics, and the sums run in a fixed order (a call repeats
// bit for bit).  One cooperative launch per call, one block of 16 warps
// per SM, four grid barriers: the narrow build (count, reduce, scan and
// fill phases, csrc/scatter.cuh) makes the CSR by target in source order,
// then every warp sums pieces of at most kPiece rows, two channels a lane
// read as one pair (`PairF32`, `PairBF16`).
//
// A bf16 g (the bf16 encoder's cotangent; r3d_scatter_add_bf16) is read at
// its own width, 4 bytes per pair of channels, as the TPU kernel reads it
// (fast_gather.py:63-66), widened to f32 in registers (exact) and summed in
// the same order: the same bits as the f32 form on the upcast g, with half
// the bytes of g to read.
//
// Layout: g (B, M, C) f32 or bf16 contiguous and 16-byte aligned, idx (B,
// M) int32, C % 2 == 0, and a histogram row of N in shared memory
// (`r3d_scatter_add_warps` >= 1) -> dx (B, N, C) f32.  Scratch: one buffer
// of `r3d_scatter_add_scratch` bytes from the caller, no initial values.
#include "scatter.cuh"

namespace {

template <typename R>
__global__ void __launch_bounds__(kThreads, 1) scatter_add_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  narrow_build(a, smem);
  sum_pieces<R>(a);
}

template <typename R>
int scatter_add(const void* g, const void* idx, void* dx, void* scratch, int b, int n, int m,
                int c, void* stream) {
  if (b < 1 || n < 1 || m < 0 || c < 2 || c % 2 != 0 || narrow_warps(n) < 1) {
    return cudaErrorInvalidValue;
  }
  r3d::CoopLaunch p{};
  Args a;
  const cudaError_t err = plan(g, idx, dx, scratch, b, n, m, c, p, a);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  return r3d::coop_launch(scatter_add_kernel<R>, p, kThreads, narrow_smem(n, a.hw), args,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// Histogram warps of the fill for n targets: as many (n,) rows as fit in
// shared memory beside the scan's (n + 96) ints, at most 16; 0 when not
// even one fits.
R3D_EXPORT int r3d_scatter_add_warps(int n) { return narrow_warps(n); }

// Bytes of scratch one call takes.
R3D_EXPORT long long r3d_scatter_add_scratch(int b, int n, int m, int c) {
  return static_cast<long long>(narrow_scratch(b, n, m, c));
}

// One call: dx (B, N, C) from g and idx, with `r3d_scatter_add_scratch`
// bytes of scratch; g f32.
R3D_EXPORT int r3d_scatter_add(const void* g, const void* idx, void* dx, void* scratch, int b,
                               int n, int m, int c, void* stream) {
  return scatter_add<PairF32>(g, idx, dx, scratch, b, n, m, c, stream);
}

// The same with a bf16 g.
R3D_EXPORT int r3d_scatter_add_bf16(const void* g, const void* idx, void* dx, void* scratch,
                                    int b, int n, int m, int c, void* stream) {
  return scatter_add<PairBF16>(g, idx, dx, scratch, b, n, m, c, stream);
}
