// Wide-channel depthwise refiner block without its 1x1, on planar NCHW:
//   y[b, c] = relu(dw5x5(x[b, c], w[:, :, c]) * scale[c] + shift[c])
// (zeros padding 2, float32 sums, rounded once to x's type at the end).
//
// Replaces the TPU kernel roma_tpu/ops/pallas/depthwise.py
// (dw5x5_affine_relu -> _pallas_call: _kernel_nhwc, _kernel_ncw). Those
// stage VMEM row slabs with lane padding; neither layout has a counterpart
// here. On the port's main path it runs every non-chained DWBlock of the
// wide refiners (scales 16/8/4/2, C = 1377/1137/569/144): 63 launches per
// match() of 2 pairs.
//
// Bound on the H100: bytes. One read and one write of each element (4 bytes
// in bf16) against ~53 FLOPs, far below the card's FLOP:byte ratio; over
// the 3.49 G elements of one match() that is 13.9 GB, ~4.2 ms at 3.35 TB/s.
// Design (first correct version): one 256-thread block per 16 x 64 output
// tile of one (b, c) plane, on a 1-D grid (B * C * tiles can pass 65535).
// The (16+4) x (64+4) halo is staged in shared memory as float with
// predicated loads (zeros outside the plane), so each input element is read
// from device memory ~1.3 times (halo overlap, mostly L2 hits). The
// channel's 25 taps, scale and shift are block-uniform and live in
// registers. Each thread owns 4 horizontally adjacent outputs and slides a
// register window of 8 inputs (two conflict-free float4 shared loads) per
// tap row. FMAs run in a fixed dy, dx order; `*scale + shift` uses
// __fmul_rn/__fadd_rn so nothing is contracted into an FMA that the plain
// version does not have; __float2bfloat16_rn after the ReLU.

#include "common.cuh"

namespace {

constexpr int kTH = 16;              // output rows per tile
constexpr int kTW = 64;              // output columns per tile
constexpr int kVec = 4;              // outputs per thread (one row)
constexpr int kThreads = kTH * kTW / kVec;
constexpr int kHH = kTH + 4;         // halo rows
constexpr int kHW = kTW + 4;         // halo columns (68 floats: rows stay 16-byte aligned)

__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_affine_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ w,          // (5, 5, C)
                      const float* __restrict__ scale,  // (C,)
                      const float* __restrict__ shift,  // (C,)
                      int C, int H, int W, int tiles_w, int tiles_h) {
  __shared__ __align__(16) float tile[kHH][kHW];

  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int tw = (int)(blk % tiles_w);
  const long long rest = blk / tiles_w;
  const int th = (int)(rest % tiles_h);
  const long long p = rest / tiles_h;  // plane index b * C + c
  const int c = (int)(p % C);
  const long long plane = (long long)H * W;
  const T* xp = x + p * plane;
  T* yp = y + p * plane;
  const int y0 = th * kTH;
  const int x0 = tw * kTW;

  for (int i = tid; i < kHH * kHW; i += kThreads) {
    const int r = i / kHW;
    const int col = i - r * kHW;
    const int gy = y0 - 2 + r;
    const int gx = x0 - 2 + col;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = load_f(xp + (long long)gy * W + gx);
    tile[r][col] = v;
  }
  float wr[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) wr[k] = load_f(w + (long long)k * C + c);
  const float sc = scale[c];
  const float sh = shift[c];
  __syncthreads();

  const int ty = tid / (kTW / kVec);
  const int tx = (tid - ty * (kTW / kVec)) * kVec;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    const float4 a = *reinterpret_cast<const float4*>(&tile[ty + dy][tx]);
    const float4 b = *reinterpret_cast<const float4*>(&tile[ty + dy][tx + 4]);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = fmaf(v[j + dx], wr[dy * 5 + dx], acc[j]);
  }

  const int gy = y0 + ty;
  if (gy >= H) return;
  T* row = yp + (long long)gy * W;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int gx = x0 + tx + j;
    if (gx < W) store_f(row + gx, fmaxf(__fadd_rn(__fmul_rn(acc[j], sc), sh), 0.0f));
  }
}

template <typename T>
int launch(const void* x, void* y, const void* w, const void* scale, const void* shift,
           int B, int C, int H, int W, cudaStream_t s) {
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const long long blocks = (long long)B * C * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dw_affine_relu_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      C, H, W, tiles_w, tiles_h);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, C, H, W) contiguous, distinct buffers, of one type: bf16
// (dtype_code 0) or float32 (1); w: (5, 5, C) contiguous of the same type;
// scale, shift: (C,) float32.
ROMA_EXPORT int roma_dw_affine_relu(const void* x, void* y, const void* w, const void* scale,
                                    const void* shift, int B, int C, int H, int W,
                                    int dtype_code, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return launch<bf16>(x, y, w, scale, shift, B, C, H, W, s);
    case 1: return launch<float>(x, y, w, scale, shift, B, C, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
