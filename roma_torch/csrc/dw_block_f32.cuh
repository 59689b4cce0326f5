// One depthwise-separable refiner block in float32, the float32 entry of
// the chained scale-1 blocks (dw_chain.cu) and of the whole-block kernel
// (dw_block_mm.cu), on planar NCHW float32:
//   y = relu(dw5x5(x) * scale + shift)   (zeros padding 2; * and + rounded apart)
//   z = M^T y + bias                     (C x C 1x1 conv, m[c * C + d])
// with no rounding to bf16, as the plain version (dw_chain.py::
// block_plain_nchw) computes for a float32 input. A simple kernel: a block
// takes 32 pixels of one row, first every (channel, pixel) y into shared
// memory (25 FMAs from the global loads, read through L1), then every
// (output channel, pixel) z as C FMAs over the staged y; C <= 160.
#pragma once

#include "common.cuh"

namespace dwf32 {

constexpr int kTW = 32;        // pixels of a row a block
constexpr int kThreads = 256;
constexpr int kMaxC = 160;

__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ x, float* __restrict__ z, const float* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             const float* __restrict__ m, const float* __restrict__ bias, int C, int H, int W) {
  __shared__ float ys[kMaxC * kTW];
  const int x0 = blockIdx.x * kTW, y = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)H * W;
  const float* xb = x + (long long)b * C * plane;
  for (int i = threadIdx.x; i < C * kTW; i += kThreads) {
    const int c = i / kTW, xx = x0 + i % kTW;
    float v = 0.0f;
    if (xx < W) {
      const float* xp = xb + c * plane;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const int yy = y + dy - 2;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) {
          const int xc = xx + dx - 2;
          if (xc < 0 || xc >= W) continue;
          acc = fmaf(xp[(long long)yy * W + xc], w[(dy * 5 + dx) * C + c], acc);
        }
      }
      v = fmaxf(__fadd_rn(__fmul_rn(acc, scale[c]), shift[c]), 0.0f);
    }
    ys[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * kTW; i += kThreads) {
    const int d = i / kTW, px = i % kTW, xx = x0 + px;
    if (xx >= W) continue;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(m[c * C + d], ys[c * kTW + px], acc);
    z[((long long)b * C + d) * plane + (long long)y * W + xx] = __fadd_rn(acc, bias[d]);
  }
}

// x, z: (B, C, H, W) float32; w (5, 5, C); scale, shift, bias (C,); m (C, C)
inline int launch(const void* x, void* z, const void* w, const void* scale, const void* shift,
                  const void* m, const void* bias, int B, int C, int H, int W,
                  cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, H, B);
  block_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(z), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(m), static_cast<const float*>(bias), C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace dwf32
