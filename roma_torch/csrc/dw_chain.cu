// One fused narrow-channel refiner block, launched once per block of the
// scale-1 refiner's chain (block_in + 8 hidden blocks):
//   y = bf16(relu(dw5x5(x) * scale + shift))        (zeros padding 2)
//   z = bf16(M^T y + bias)                           (C x C 1x1 conv)
//
// Replaces the TPU kernel roma_tpu/ops/pallas/depthwise.py
// (dw5x5_mm_chain -> _frame_block -> _kernel_ncw_mm_frame), with its two
// bf16 rounding points: the ReLU output and the block output.
//
// Bound on the H100: bytes at C = 24 (about 1,200 FLOPs a pixel against
// 96 bytes moved, well under the card's FLOP:byte ratio even for fp32 FMA).
// Design: planar NCHW bf16. A 256-thread block owns an 8 x 32 pixel tile,
// stages the (8+4) x (32+4) x C halo tile and the block's weights in shared
// memory, and gives each thread one pixel: its C depthwise sums stay in
// registers, are rounded to bf16, and feed the C x C mix straight from
// registers, so the activation touches device memory once in and once out
// per block. The TPU version's width-major lane padding and padded frame
// have no counterpart: the halo comes from predicated loads.

#include "common.cuh"

namespace {

constexpr int kTH = 8;
constexpr int kTW = 32;
constexpr int kHH = kTH + 4;
constexpr int kHW = kTW + 4;

template <int C>
__global__ void __launch_bounds__(kTH * kTW)
dw_block_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                const bf16* __restrict__ w,      // (5, 5, C)
                const float* __restrict__ scale, // (C,)
                const float* __restrict__ shift, // (C,)
                const bf16* __restrict__ m,      // (C, C): z[d] = sum_c m[c][d] y[c]
                const float* __restrict__ bias,  // (C,)
                int H, int W) {
  __shared__ bf16 tile[C][kHH][kHW];
  __shared__ float sw[25][C];
  __shared__ float sm[C][C];
  __shared__ float ssc[C], ssh[C], sb[C];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTH;
  const int tx0 = blockIdx.x * kTW;
  const long long plane = (long long)H * W;
  const bf16* xb = x + (long long)b * C * plane;

  for (int i = tid; i < C * kHH * kHW; i += kTH * kTW) {
    const int c = i / (kHH * kHW);
    const int rem = i - c * (kHH * kHW);
    const int yy = rem / kHW;
    const int xx = rem - yy * kHW;
    const int gy = ty0 - 2 + yy;
    const int gx = tx0 - 2 + xx;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[c * plane + (long long)gy * W + gx];
    tile[c][yy][xx] = v;
  }
  for (int i = tid; i < 25 * C; i += kTH * kTW) sw[i / C][i % C] = bf2f(w[i]);
  for (int i = tid; i < C * C; i += kTH * kTW) sm[i / C][i % C] = bf2f(m[i]);
  for (int i = tid; i < C; i += kTH * kTW) {
    ssc[i] = scale[i];
    ssh[i] = shift[i];
    sb[i] = bias[i];
  }
  __syncthreads();

  const int ty = tid / kTW;
  const int tx = tid - ty * kTW;
  const int gy = ty0 + ty;
  const int gx = tx0 + tx;
  if (gy >= H || gx >= W) return;

  float act[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx)
        acc = fmaf(bf2f(tile[c][ty + dy][tx + dx]), sw[dy * 5 + dx][c], acc);
    act[c] = round_bf16(fmaxf(fmaf(acc, ssc[c], ssh[c]), 0.0f));
  }
  bf16* yb = y + (long long)b * C * plane + (long long)gy * W + gx;
#pragma unroll 4
  for (int d = 0; d < C; ++d) {
    float z = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) z = fmaf(sm[c][d], act[c], z);
    yb[d * plane] = __float2bfloat16_rn(z + sb[d]);
  }
}

template <int C>
void launch(const bf16* x, bf16* y, const bf16* w, const float* sc, const float* sh,
            const bf16* m, const float* bias, int B, int H, int W, cudaStream_t s) {
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  dw_block_kernel<C><<<grid, kTH * kTW, 0, s>>>(x, y, w, sc, sh, m, bias, H, W);
}

}  // namespace

// x, y: (B, C, H, W) bf16 contiguous, distinct buffers; w: (5, 5, C) bf16;
// scale, shift, bias: (C,) fp32; m: (C, C) bf16. C in {8, 16, 24, 32}.
ROMA_EXPORT int roma_dw_block(const void* x, void* y, const void* w, const void* scale,
                              const void* shift, const void* m, const void* bias,
                              int B, int C, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || H > 65535 * kTH) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const bf16*>(x);
  auto yo = static_cast<bf16*>(y);
  auto wi = static_cast<const bf16*>(w);
  auto sc = static_cast<const float*>(scale);
  auto sh = static_cast<const float*>(shift);
  auto mi = static_cast<const bf16*>(m);
  auto bi = static_cast<const float*>(bias);
  switch (C) {
    case 8: launch<8>(xi, yo, wi, sc, sh, mi, bi, B, H, W, s); break;
    case 16: launch<16>(xi, yo, wi, sc, sh, mi, bi, B, H, W, s); break;
    case 24: launch<24>(xi, yo, wi, sc, sh, mi, bi, B, H, W, s); break;
    case 32: launch<32>(xi, yo, wi, sc, sh, mi, bi, B, H, W, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
