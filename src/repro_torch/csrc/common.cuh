// Shared helpers of the port's hand-written CUDA kernels (sm_90a).
//
// Each kernel library has a plain C interface loaded with ctypes: pointers
// and the stream arrive as void*, shapes as int, and every launch entry
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// the runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage dtype codes shared with repro_torch/kernels/_build.py.
enum StorageDtype { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// Thread layout of every ELL kernel here: one thread per (row, feature)
// pair.  Consecutive threads take consecutive features, so a gathered
// table row is read coalesced and the row's nbr/wts entries are one
// broadcast load per k.  blockDim = (feature threads, rows per block).
constexpr int kThreadsPerBlock = 256;

inline dim3 ell_block(int feat) {
  int bx = ((feat + 31) / 32) * 32;
  if (bx > 128) bx = 128;
  return dim3(bx, kThreadsPerBlock / bx);
}

inline dim3 ell_grid(int rows, int feat, dim3 block) {
  return dim3((rows + block.y - 1) / block.y,
              (feat + block.x - 1) / block.x);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
