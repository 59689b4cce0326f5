// Windowed warp gather: zeros-padding bilinear sample of a narrow (C <= 16)
// bf16 map, one block per (image, 8 x 128 output tile), read from one
// 24 x 136 source window staged in shared memory.
//
// Replaces the TPU kernel roma_tpu/ops/pallas/windowed_sample.py
// (grid_sample_smooth -> _kernel_call -> _kernel). Same function as
// roma_torch/ops/windowed_sample.py::windowed_sample_plain: with the plan's
// per-tile window origin (ybase, j0_abs) in the zero-padded frame (2 rows
// above the image, 128 columns left of it), each output pixel takes the
// 2 x 2 taps at frame row ybase + clamp(y0 + 2 - ybase, 0, 22) and frame
// column j0_abs + clamp(x0 + 128 - w - (j0_abs - 128 tx), 0, 6) + (w - 128 tx),
// weighted by the bilinear weights of its unclamped coordinate. Where the
// plan's `ok` holds, that is plain bilinear sampling; elsewhere it is "fast"
// mode's window-clamped result.
//
// Bound on the H100: bytes. About 4 C + 8 bytes of traffic per output pixel
// (feature map read once, grid read, bf16 output written) against ~8 C
// multiply-adds.
// Design: the block stages its 24 x 136 x C window (zeros outside the image)
// from the unpadded NCHW map into shared memory, ~59 KB at C = 9 and ~104 KB
// at C = 16, then each of its 256 threads takes 4 pixels: it recomputes
// the pixel's base and weights from the grid with the plan's float32
// arithmetic (no contraction), clamps the base into the window, and writes
// C channels, coalesced along W. Pixels of the tile padding are computed
// but not stored, so the output needs no slicing copy. The TPU version's
// blocked (B, Yb, Xb, C, 8, 128) relayout, 3 x 3 block DMAs, lane roll and
// (row, column) weight enumeration have no counterpart here.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTH = 8;
constexpr int kTW = 128;
constexpr int kRows = 24;          // window rows (3 blocks of 8)
constexpr int kCols = kTW + 8;     // window columns (128 + E)
constexpr int kPad = 2;            // frame rows above the image
constexpr int kPadX = 128;         // frame columns left of the image
constexpr int kThreads = 256;
constexpr int kMaxC = 16;
constexpr float kCoordLimit = 1048576.0f;  // 2^20, as the plan clamps

__global__ void __launch_bounds__(kThreads)
windowed_sample_kernel(const bf16* __restrict__ feat,    // (B, C, H, W)
                       const float* __restrict__ grid,   // (B, Ho, Wo, 2), tile multiples
                       const int* __restrict__ origin,   // (B, n_ty * n_tx, 2): ybase, j0_abs
                       bf16* __restrict__ out,           // (B, C, Ho0, Wo0)
                       int C, int H, int W, int Ho, int Wo, int Ho0, int Wo0, int Wp) {
  extern __shared__ bf16 win[];  // [C][kRows][kCols]
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int n_tx = gridDim.x;
  const int tid = threadIdx.x;
  const int* o = origin + ((long long)b * gridDim.y * n_tx + (long long)ty * n_tx + tx) * 2;
  const int ybase = o[0];
  const int j0 = o[1];

  const long long plane = (long long)H * W;
  const bf16* fb = feat + (long long)b * C * plane;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < C * kRows * kCols; i += kThreads) {
    const int c = i / (kRows * kCols);
    const int rem = i - c * (kRows * kCols);
    const int rr = rem / kCols;
    const int cc = rem - rr * kCols;
    const int y = ybase + rr - kPad;
    const int x = j0 + cc - kPadX;
    win[i] = (y >= 0 && y < H && x >= 0 && x < W) ? fb[c * plane + (long long)y * W + x] : zero;
  }
  __syncthreads();

  const float hw = 0.5f * (float)W, hh = 0.5f * (float)H;
  const int txo = tx * kTW;
  for (int q = tid; q < kTH * kTW; q += kThreads) {
    const int lh = q / kTW;
    const int lw = q - lh * kTW;
    const int h = ty * kTH + lh;
    const int w = txo + lw;
    const float2 g = reinterpret_cast<const float2*>(grid)[((long long)b * Ho + h) * Wo + w];
    const float gx = __fsub_rn(__fmul_rn(__fadd_rn(g.x, 1.0f), hw), 0.5f);
    const float gy = __fsub_rn(__fmul_rn(__fadd_rn(g.y, 1.0f), hh), 0.5f);
    const float fx0 = floorf(gx), fy0 = floorf(gy);
    const float wx = __fsub_rn(gx, fx0), wy = __fsub_rn(gy, fy0);
    const int x0 = (int)fminf(fmaxf(fx0, -kCoordLimit), kCoordLimit);
    const int y0 = (int)fminf(fmaxf(fy0, -kCoordLimit), kCoordLimit);
    const int x0i = min(max(x0 + kPadX, 0), Wp - 2);
    const int y0i = min(max(y0 + kPad, 0), H + 2 * kPad - 2);
    const int yrel = min(max(y0i - ybase, 0), kRows - 2);
    const int e = min(max(x0i - lw - j0, 0), kCols - kTW - 2);
    if (h >= Ho0 || w >= Wo0) continue;
    const float w00 = __fmul_rn(1.0f - wy, 1.0f - wx);
    const float w01 = __fmul_rn(1.0f - wy, wx);
    const float w10 = __fmul_rn(wy, 1.0f - wx);
    const float w11 = __fmul_rn(wy, wx);
    const bf16* t = win + yrel * kCols + e + lw;
    bf16* op = out + ((long long)b * C * Ho0 + h) * Wo0 + w;
    const long long oplane = (long long)Ho0 * Wo0;
    for (int c = 0; c < C; ++c) {
      const bf16* tc = t + c * (kRows * kCols);
      float v = __fmul_rn(w00, bf2f(tc[0]));
      v = __fadd_rn(v, __fmul_rn(w01, bf2f(tc[1])));
      v = __fadd_rn(v, __fmul_rn(w10, bf2f(tc[kCols])));
      v = __fadd_rn(v, __fmul_rn(w11, bf2f(tc[kCols + 1])));
      op[c * oplane] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// feat (B, C, H, W) bf16; grid (B, Ho, Wo, 2) fp32 with Ho % 8 == 0 and
// Wo % 128 == 0; origin (B, (Ho / 8) * (Wo / 128), 2) int32; out
// (B, C, Ho0, Wo0) bf16 with Ho0 <= Ho, Wo0 <= Wo. All contiguous.
// Wp is the frame width (roma_torch/ops/windowed_sample.py::frame_width).
ROMA_EXPORT int roma_windowed_sample(const void* feat, const void* grid, const void* origin,
                                     void* out, int B, int C, int H, int W, int Ho, int Wo,
                                     int Ho0, int Wo0, int Wp, void* stream) {
  if (C < 1 || C > kMaxC || Ho % kTH || Wo % kTW || Ho0 > Ho || Wo0 > Wo)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Ho0 * Wo0 == 0) return (int)cudaSuccess;
  const int bytes = C * kRows * kCols * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(windowed_sample_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxC * kRows * kCols * (int)sizeof(bf16));
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)(Wo / kTW), (unsigned)(Ho / kTH), (unsigned)B);
  windowed_sample_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(feat), static_cast<const float*>(grid),
      static_cast<const int*>(origin), static_cast<bf16*>(out), C, H, W, Ho, Wo, Ho0, Wo0, Wp);
  return (int)cudaGetLastError();
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
