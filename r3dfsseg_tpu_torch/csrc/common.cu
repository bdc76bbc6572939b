#include "common.cuh"

R3D_EXPORT const char* r3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
