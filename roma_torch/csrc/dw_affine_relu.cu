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
// in bf16) against 25 FMAs, below the card's FLOP:byte ratio; over the
// 3.49 G elements of one match() that is 13.9 GB, ~4.2 ms at 3.35 TB/s.
// The FMAs are close behind: 25 per output in a fixed order (the plain
// version's rounding) are ~2.9 ms of the FP32 pipes alone, so every other
// instruction a thread issues per element shows in the time, and so does
// every thread left idle by a tile that fits the plane badly.
//
// Design: a block takes a band of whole rows [y0, y1) of one plane, or 1-8
// whole small planes; kernels/dw_affine_relu.py::band_plan picks the band
// height or plane count for the fewest rounds of 4 x 4 output patches over
// the block's threads. A band plus its 2-row halo above and below is one
// contiguous range of NCHW memory, loaded with 16-byte vector loads (the
// unaligned head and tail element by element), all in flight before the
// block first waits, into zero-padded float rows of width round_up(W, 4) + 4
// in shared memory; no load leaves the range. A vector's row comes from a
// multiply-high, not a divide, and its elements go out (as float pairs where
// W is even) to at most two runs of addresses. The planes' 25 taps, scale
// and shift are read once per block. Each thread computes 4 x 4 output
// patches from 8 rows of 8-float windows (16 float4 shared loads per 16
// outputs) and stores each row of 4 as one 8- or 16-byte vector where
// aligned. FMAs run in a fixed dy, dx order; `*scale + shift` uses
// __fmul_rn/__fadd_rn so nothing is contracted into an FMA that the plain
// version does not have; __float2bfloat16_rn after the ReLU. Persistent
// blocks that load the next band while computing this one (by registers or
// cp.async) measured slower on the card than one band per block (PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 28;  // 25 taps, scale, shift, one float of padding
static_assert(kThreads >= 8 * kTaps, "one tap a thread for up to 8 planes");

__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

// one 16-byte vector of x as floats
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// four outputs at an aligned address
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
dw_affine_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ w,          // (5, 5, C)
                      const float* __restrict__ scale,  // (C,)
                      const float* __restrict__ shift,  // (C,)
                      int C, int H, int W, long long P, int band_rows, int planes, int bands) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  const int ld = round_up4(W) + 4;            // padded row: 2 zero columns left
  const int rows = round_up4(band_rows) + 4;  // band rounded to 4, 2-row halos
  const int tile = rows * ld;
  float* taps = smem + planes * tile;
  const int tid = threadIdx.x;
  const long long p0 = (long long)(blockIdx.x / bands) * planes;
  const int y0 = (blockIdx.x % bands) * band_rows;
  const int y1 = min(y0 + band_rows, H);
  const long long hw = (long long)H * W;
  // rows [ya, yb) of the block's planes are one contiguous range [g0, g1)
  // (several planes only where each is one band, ya = 0 and yb = H): the
  // 16-byte vectors [a0, a1) inside it, the elements at its ends one by one
  const int ya = max(y0 - 2, 0);
  const int yb = min(y1 + 2, H);
  const int span = yb - ya;  // rows of a plane in the range
  const long long g0 = p0 * hw + (long long)ya * W;
  const long long g1 = (min(p0 + planes, P) - 1) * hw + (long long)yb * W;
  const long long a0 = min((g0 + kVec - 1) / kVec * kVec, g1);
  const long long a1 = max(a0, g1 / kVec * kVec);
  float* dst = smem + (ya - y0 + 2) * ld + 2;
  // offsets inside the range fit 32 bits: it fits the block's shared memory
  const int hw32 = (int)min(hw, 0x7fffffffLL);

  // Everything the block reads from device memory is in flight before any
  // of it is waited for: a thread's tap and its first kUnroll vectors of
  // the range (one batch covers a whole band at the main-path shapes).
  float tap = 0.0f;
  if (tid < planes * kTaps) {
    const int q = tid / kTaps, k = tid - q * kTaps;
    if (p0 + q < P && k < 27) {
      const int c = (int)((p0 + q) % C);
      tap = k < 25 ? load_f(w + (long long)k * C + c) : (k == 25 ? scale[c] : shift[c]);
    }
  }
  // the fewer than kVec elements at each end, one a thread
  const int n_head = (int)(a0 - g0);
  long long e_edge = -1;
  if (tid < n_head)
    e_edge = g0 + tid;
  else if (tid - n_head < g1 - a1)
    e_edge = a1 + tid - n_head;
  const float edge = e_edge >= 0 ? load_f(x + e_edge) : 0.0f;
  constexpr int kUnroll = 8;
  constexpr long long kStep = (long long)kThreads * kVec;
  const long long e_first = a0 + (long long)tid * kVec;
  uint4 raw[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (e_first + u * kStep < a1) raw[u] = *reinterpret_cast<const uint4*>(x + e_first + u * kStep);

  float4* z = reinterpret_cast<float4*>(smem);
  for (int i = tid; i < planes * tile / 4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // zeros first, then the range over them
  if (tid < planes * kTaps) taps[tid] = tap;

  if (e_edge >= 0) {
    const int rel = (int)(e_edge - g0);
    const int q = rel / hw32;
    const int rem = rel - q * hw32;
    const int r = rem / W;
    dst[q * tile + r * ld + rem - r * W] = edge;
  }
  // a batch of vectors -> float rows. Where W >= kVec a vector holds at
  // most one row (or plane) change: its row comes from a multiply-high by
  // ceil(2^32 / W) (exact for offsets below 2^32 / W, and the range fits
  // shared memory), and its elements go to one of two runs of addresses.
  // Narrower rows take element-by-element division.
  const bool wide = W >= kVec;
  const bool even = (W & 1) == 0;  // then every vector starts at an even column
  const uint32_t mw = wide ? 0xffffffffu / (uint32_t)W + 1u : 0u;
  const uint32_t ms = span > 1 ? 0xffffffffu / (uint32_t)span + 1u : 0u;
  auto scatter = [&](const uint4 (&batch)[kUnroll], long long e0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + u * kStep >= a1) break;
      float v[kVec];
      unpack16(batch[u], v);
      const int rel = (int)(e0 + u * kStep - g0);
      if (wide) {
        const int R = (int)__umulhi((uint32_t)rel, mw);  // row in the range
        const int col = rel - R * W;
        const int q = planes == 1 ? 0 : span == 1 ? R : (int)__umulhi((uint32_t)R, ms);
        const int r = R - q * span;
        float* run0 = dst + q * tile + r * ld + col;
        float* run1 = run0 + (r + 1 < span ? ld - W : tile - r * ld - W);
        const int k = W - col;  // elements before the row ends
        if (even) {
          // col, k and the float offsets are even: pairs as 8-byte stores
#pragma unroll
          for (int j = 0; j < kVec; j += 2)
            *reinterpret_cast<float2*>((j < k ? run0 : run1) + j) = make_float2(v[j], v[j + 1]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) (j < k ? run0 : run1)[j] = v[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int q = (rel + j) / hw32;
          const int rem = rel + j - q * hw32;
          const int r = rem / W;
          dst[q * tile + r * ld + rem - r * W] = v[j];
        }
      }
    }
  };
  scatter(raw, e_first);
  for (long long e0 = e_first + kUnroll * kStep; e0 < a1; e0 += kUnroll * kStep) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e0 + u * kStep < a1) raw[u] = *reinterpret_cast<const uint4*>(x + e0 + u * kStep);
    scatter(raw, e0);
  }
  __syncthreads();

  // compute: kThreads / planes threads per plane, a 4 x 4 output patch each
  const int per_plane = kThreads / planes;
  const int q = tid / per_plane;
  const int tp = tid - q * per_plane;
  if (q >= planes || p0 + q >= P) return;  // kThreads % planes threads idle
  const float* t = smem + q * tile;
  const float* tq = taps + q * kTaps;
  float wr[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) wr[k] = tq[k];
  const float sc = tq[25];
  const float sh = tq[26];
  T* yp = y + (p0 + q) * hw;
  // y's element offset mod 4 at the start of this plane (x and y are
  // 16-byte aligned): 4 outputs go out as one vector where it is 0
  const int ymod = (int)(((p0 + q) * hw) & 3);
  const int gx = round_up4(W) / 4;
  const int gy = round_up4(y1 - y0) / 4;
  // patches (px, py) in row-major order, tp, tp + per_plane, ...: the step
  // is sy rows and sx columns of patches
  const int sy = per_plane / gx;
  const int sx = per_plane - sy * gx;
  int py = tp / gx;
  int px = tp - py * gx;
  for (; py < gy; py += sy, px += sx) {
    if (px >= gx) {
      px -= gx;
      ++py;
      if (py >= gy) break;
    }
    const int oy0 = py * 4;
    const int ox0 = px * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const float* rp = t + (oy0 + rr) * ld + ox0;
      const float4 a = *reinterpret_cast<const float4*>(rp);
      const float4 b = *reinterpret_cast<const float4*>(rp + 4);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int oy = 0; oy < 4; ++oy) {
        const int dy = rr - oy;
        if (dy < 0 || dy > 4) continue;
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[oy][j] = fmaf(v[j + dx], wr[dy * 5 + dx], acc[oy][j]);
      }
    }
    // the patch's first output and its offset mod 4 (a row moves it by W)
    const int row0 = y0 + oy0;
    T* op = yp + (long long)row0 * W + ox0;
    int amod = (ymod + (row0 & 3) * (W & 3) + ox0) & 3;
    const bool full = ox0 + 3 < W;
#pragma unroll
    for (int oy = 0; oy < 4; ++oy) {
      if (row0 + oy >= y1) break;
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = fmaxf(__fadd_rn(__fmul_rn(acc[oy][j], sc), sh), 0.0f);
      if (full && amod == 0) {
        store4(op, out);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ox0 + j < W) store_f(op + j, out[j]);
      }
      op += W;
      amod = (amod + W) & 3;
    }
  }
}

// shared memory of the band plan (kernels/dw_affine_relu.py::band_plan)
long long plan_bytes(int W, int band_rows, int planes) {
  return 4LL * planes * ((long long)(round_up4(band_rows) + 4) * (round_up4(W) + 4) + kTaps);
}

template <typename T>
int launch(const void* x, void* y, const void* w, const void* scale, const void* shift,
           int B, int C, int H, int W, int band_rows, int planes, int smem_bytes,
           cudaStream_t s) {
  if (band_rows <= 0 || band_rows > H || (planes > 1 && band_rows != H) || planes < 1 ||
      planes > 8)
    return (int)cudaErrorInvalidValue;
  // the plan and this file must agree on the shared memory
  if (plan_bytes(W, band_rows, planes) != smem_bytes) return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * C;
  const int bands = (H + band_rows - 1) / band_rows;
  const long long blocks = (P + planes - 1) / planes * bands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the shared-memory limit is raised once per device and size, not on
  // every launch: at the small planes a launch's host work is as long as
  // the kernel, and stream capture need not see the attribute call
  static int smem_limit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > smem_limit[dev]) {
    err = cudaFuncSetAttribute(dw_affine_relu_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_limit[dev] = smem_bytes;
  }
  dw_affine_relu_kernel<T><<<(unsigned)blocks, kThreads, smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift), C, H, W, P,
      band_rows, planes, bands);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, C, H, W) contiguous, distinct, 16-byte aligned buffers of one
// type: bf16 (dtype_code 0) or float32 (1); w: (5, 5, C) contiguous of the
// same type; scale, shift: (C,) float32. band_rows, planes and smem_bytes
// are the band plan (kernels/dw_affine_relu.py::band_plan).
ROMA_EXPORT int roma_dw_affine_relu(const void* x, void* y, const void* w, const void* scale,
                                    const void* shift, int B, int C, int H, int W,
                                    int band_rows, int planes, int smem_bytes, int dtype_code,
                                    void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return launch<bf16>(x, y, w, scale, shift, B, C, H, W, band_rows, planes, smem_bytes, s);
    case 1: return launch<float>(x, y, w, scale, shift, B, C, H, W, band_rows, planes, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
