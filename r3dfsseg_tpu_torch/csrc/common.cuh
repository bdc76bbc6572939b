// Shared declarations of the port's hand-written kernels.
//
// Every kernel library entry point is a plain C function (loaded with
// ctypes by r3dfsseg_tpu_torch/kernels/build.py): pointers and the CUDA
// stream arrive as void*, sizes as int, and the function returns
// cudaGetLastError() right after its launch so the wrapper can raise on a
// refused launch.  Kernels allocate nothing: the wrapper owns every buffer.
#pragma once

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
