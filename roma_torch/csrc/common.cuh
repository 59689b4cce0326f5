// Shared helpers for the roma_torch kernels. Each kernel source is built
// into its own shared library with a plain C interface (loaded by ctypes);
// every launcher returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define ROMA_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// round a float to bf16 and back (the bf16 storage rounding point)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the low (high) bf16 of a packed pair, as a float
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
