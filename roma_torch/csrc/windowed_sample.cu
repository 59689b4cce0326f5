// Windowed warp gather: zeros-padding bilinear sample of a narrow (C <= 16)
// channels-last bf16 or float32 map, one block per (image, 8 x 128 output
// tile), with the tile's plan (window origin, validity) derived inside the
// block.
//
// Replaces the TPU kernel roma_tpu/ops/pallas/windowed_sample.py
// (grid_sample_smooth -> _kernel_call -> _kernel) and its XLA-side plan
// (_plan) and exact-mode lax.cond. The spec is
// roma_torch/ops/windowed_sample.py: `plan` (the per-tile window origin
// (ybase, j0_abs) in the zero-padded frame, 2 rows above the image and 128
// columns left of it, and the whole-batch `ok`), `windowed_sample_plain`
// ("fast": each pixel's 2 x 2 taps at frame row ybase + clamp(y0 + 2 -
// ybase, 0, 22) and frame column j0_abs + clamp(x0 + 128 - w - (j0_abs -
// 128 tx), 0, 6) + (w - 128 tx), weighted by the bilinear weights of its
// unclamped coordinate) and `windowed_exact_plain` ("exact").
//
// Exact mode computes the JAX function. JAX's lax.cond picks between the
// windowed kernel (when `ok` holds for the whole batch) and grid_sample;
// both compute zeros-padded bilinear sampling, and the windowed branch
// equals it exactly whenever `ok` holds. Here each pixel decides for
// itself: where its unclamped window offsets lie in the window (row offset
// in [0, 22], column offset in [0, 6]) it reads its taps from the staged
// window, whose frame positions outside the image hold zeros; the frame
// position there is the pixel's own base (or, for a base clamped to the
// frame's edge, a position whose taps are all outside the image, as the
// base's are); so the taps are the zero-padded bilinear taps. Elsewhere (a
// rough tile, a pixel far out of range) it reads them from device memory
// with zero padding. So the result is bilinear sampling for any flow,
// computed without a host read of `ok` and without a second launch; `ok`
// is still reduced, into a device flag, for callers that audit it.
//
// Bound on the H100: bytes. About 4 C + 8 bytes of traffic per output pixel
// (the map read once, the grid read, the output written) against ~8 C
// multiply-adds. A tile's life is a chain of latencies (its grid, two block
// reductions, its window, its stores); three blocks share an SM (shared
// memory: 62 KB a block at C = 9) and overlap each other's. Per block of
// 256 threads (a warp per tile row, each thread 4 adjacent pixels):
//   1. Each thread reads its pixels' grid values from the unpadded
//      (B, Ho, Wo, 2) grid with the index clamped to the last row and
//      column (what the plan's edge padding does), computes the bases with
//      the plan's float32 arithmetic (no contraction), and keeps them in
//      registers. Two block reductions (warp min, then 8 warps through
//      shared memory) give the minima over the tile's real pixels and then
//      the tile's `ok` and the rows of the window its pixels read; the
//      origins take the plan's clamps, so they equal plan()'s bit for bit.
//      A tile whose pixels are not all valid clears the device flag `ok`
//      (set to 1 by the wrapper).
//   2. Only those rows of the 24 x 136 x C window are staged (a smooth tile
//      reads ~10 of the 24). The map is channels last (the refiner's
//      layout; the wrapper converts any other), so a window row is one span
//      of 136 pixels x C channels of the map's row, staged shifted by its
//      misalignment so that each 16-byte unit of the staged row is a
//      16-byte unit of the map's row: the threads take the rows' units in
//      turn by cp.async, zero-filled outside the image (W x C a multiple of
//      16 bytes keeps each unit inside or outside the image's row). Where
//      it is not, or the map is not 16-byte aligned, element by element.
//      (A warp a row, with a division and 64-bit address arithmetic per
//      row, issued about as many instructions as the sampling; persistent
//      blocks that staged the next tile while computing this one, one
//      512-thread block an SM with two windows, measured slower than
//      independent blocks.)
//   3. Each thread writes C channels of its 4 pixels (NCHW output), one
//      8-byte (bf16) or 16-byte (float32) store per channel where Wo % 4 ==
//      0; a warp stores one whole tile row of a channel at once.
// The TPU version's blocked (B, Yb, Xb, C, 8, 128) relayout, 3 x 3 block
// DMAs, lane roll, (row, column) weight enumeration and its plan's ~25
// passes over the output in XLA have no counterpart here.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int kTH = 8;
constexpr int kTW = 128;
constexpr int kRows = 24;          // window rows (3 blocks of 8)
constexpr int kCols = kTW + 8;     // window columns (128 + E)
constexpr int kPad = 2;            // frame rows above the image
constexpr int kPadX = 128;         // frame columns left of the image
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;            // adjacent pixels a thread
constexpr int kMaxC = 16;
constexpr int kBig = 1 << 29;
constexpr float kCoordLimit = 1048576.0f;  // 2^20, as the plan clamps

// elements of a staged window row: kCols pixels of C channels, with room
// for a shift of up to vec - 1 elements, rounded to whole vec-element units
__host__ __device__ constexpr int row_len_of(int C, int vec) {
  return (kCols * C + 2 * vec - 1) / vec * vec;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(bf16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }

// four adjacent outputs as one store: 8 bytes of bf16, 16 of float32
__device__ __forceinline__ void store4(bf16* p, const float (&v)[kPix]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kPix]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// min over the block of NV ints; every thread gets the results. `red`
// holds kWarps * NV ints; the leading barrier frees it from an earlier use.
template <int NV>
__device__ __forceinline__ void block_min(int (&v)[NV], int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = __reduce_min_sync(0xffffffffu, v[k]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[warp * NV + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    int m = red[k];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = min(m, red[i * NV + k]);
    v[k] = m;
  }
}

// window rows [r0, r0 + nrows) of a tile as rows of `row_len` elements in
// shared memory: pixels x_lo .. x_lo + kCols - 1 (all their channels, as the
// map holds them) from element `sh` on, where sh = (x_lo * C) mod kUnit
// puts each staged unit on a unit of the map's row; units of kUnit
// elements, 16 bytes by cp.async or single elements by plain loads. With
// W * C a multiple of kUnit a unit is all inside or all outside the image's
// row; copies outside the image write zeros. One cp.async group.
template <int kUnit, typename T>
__device__ __forceinline__ void stage_rows(const T* feat, const T* fb, T* win, int H, int W,
                                           int C, int row_len, int y0, int r0, int nrows,
                                           int x_lo, int sh) {
  const int units = (sh + kCols * C + kUnit - 1) / kUnit;  // units of a staged row
  const long long row_elems = (long long)W * C;
  const long long e_lo = (long long)x_lo * C - sh;  // row-relative element of unit 0
  int rr = 0, u = threadIdx.x;
  while (u >= units) {
    u -= units;
    ++rr;
  }
  for (; rr < nrows;) {
    const int y = y0 + rr - kPad;
    const long long e = e_lo + (long long)u * kUnit;
    T* dst = win + (r0 + rr) * row_len + u * kUnit;
    const T* src = fb + y * row_elems + e;
    if (kUnit > 1) {
      const bool valid = y >= 0 && y < H && e >= 0 && e < row_elems;
      cp_async16(dst, valid ? src : feat, valid);
    } else {
      T v;
      from_f(v, 0.0f);
      if (y >= 0 && y < H && e >= 0 && e < row_elems) v = *src;
      *dst = v;
    }
    u += kThreads;
    while (u >= units) {
      u -= units;
      ++rr;
    }
  }
  cp_async_commit();
}

struct Args {
  const float* grid;  // (B, Ho, Wo, 2)
  int* ok;            // () int32, set to 1 by the caller; null: not reported
  int* origins;       // (B, n_ty, n_tx, 2) int32: ybase, j0_abs; null: not reported
  int C, H, W, Ho, Wo, Wp;
  int row_len;        // staged row length in elements (row_len_of)
  int vec_in;         // a map row a multiple of 16 bytes and the map 16-byte aligned
  int vec_out;        // Wo % 4 == 0 and the output aligned for 4-pixel stores
};

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
windowed_sample_kernel(const T* __restrict__ feat,  // (B, H, W, C)
                       T* __restrict__ out,         // (B, C, Ho, Wo); null: plan only
                       const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // [kRows][row_len]
  __shared__ int red[kWarps * 3];
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int H = a.H, W = a.W, Ho = a.Ho, Wo = a.Wo;
  const int txo = tx * kTW;
  const int h = ty * kTH + warp;
  const int lw0 = kPix * lane;  // first local column
  const float hw = 0.5f * (float)W, hh = 0.5f * (float)H;

  // ---- 1. bases from the grid, clamped reads; minima over real pixels
  int x0[kPix], y0[kPix], y0i[kPix], d[kPix];
  float wx[kPix], wy[kPix];
  bool real[kPix], inb[kPix];
  const float2* g2 = reinterpret_cast<const float2*>(a.grid) + (long long)b * Ho * Wo +
                     (long long)min(h, Ho - 1) * Wo;
  int mins[2] = {kBig, kBig};
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int w = txo + lw0 + j;
    real[j] = h < Ho && w < Wo;
    const float2 g = g2[min(w, Wo - 1)];
    const float gx = __fsub_rn(__fmul_rn(__fadd_rn(g.x, 1.0f), hw), 0.5f);
    const float gy = __fsub_rn(__fmul_rn(__fadd_rn(g.y, 1.0f), hh), 0.5f);
    const float fx0 = floorf(gx), fy0 = floorf(gy);
    wx[j] = __fsub_rn(gx, fx0);
    wy[j] = __fsub_rn(gy, fy0);
    x0[j] = (int)fminf(fmaxf(fx0, -kCoordLimit), kCoordLimit);
    y0[j] = (int)fminf(fmaxf(fy0, -kCoordLimit), kCoordLimit);
    inb[j] = x0[j] >= -1 && x0[j] < W && y0[j] >= -1 && y0[j] < H;
    y0i[j] = min(max(y0[j] + kPad, 0), H + 2 * kPad - 2);
    d[j] = min(max(x0[j] + kPadX, 0), a.Wp - 2) - w;  // disparity against the output column
    if (real[j]) {
      mins[0] = min(mins[0], y0i[j]);
      mins[1] = min(mins[1], d[j]);
    }
  }
  block_min(mins, red);
  // every tile holds a real pixel: the padding is narrower than a tile
  const int j0_abs = min(max(mins[1] + txo, 0), a.Wp - 3 * 128);
  const int ybase = min(max(mins[0], 0), H + 2 * kPad - 2) / 8 * 8;
  const int ej = j0_abs - txo;

  // ---- window offsets, validity, the rows read
  int yrel[kPix], e[kPix];
  bool use_win[kPix];
  int box[3] = {kBig, kBig, 1};  // rmin, -rmax, ok
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int yr = y0i[j] - ybase, er = d[j] - ej;
    const bool in_win = yr >= 0 && yr <= kRows - 2 && er >= 0 && er <= kCols - kTW - 2;
    if (real[j] && !(in_win && inb[j])) box[2] = 0;
    use_win[j] = !kExact || in_win;
    yrel[j] = min(max(yr, 0), kRows - 2);
    e[j] = min(max(er, 0), kCols - kTW - 2);
    if (real[j] && use_win[j]) {
      box[0] = min(box[0], yrel[j]);
      box[1] = min(box[1], -(yrel[j] + 1));
    }
  }
  block_min(box, red);
  if (tid == 0) {
    if (a.ok != nullptr && box[2] == 0) *a.ok = 0;  // every writer stores the same 0
    if (a.origins != nullptr) {
      int* o = a.origins + (((long long)b * gridDim.y + ty) * gridDim.x + tx) * 2;
      o[0] = ybase;
      o[1] = j0_abs;
    }
  }
  if (out == nullptr) return;

  // ---- 2. stage rows [rmin, rmax] of the window
  const int C = a.C;
  const T* fb = feat + (long long)b * H * W * C;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int xa = j0_abs - kPadX;  // image column of window column 0
  const int nrows = -box[1] - box[0] + 1;  // < 1: no pixel reads the window
  // shared memory: the element of window row 0, column 0, channel 0, and
  // the step to the next row; the next column is C elements on
  const int sh = a.vec_in ? (xa * C) & (kVec - 1) : 0;
  const int rs = a.row_len;
  if (a.vec_in)
    stage_rows<kVec>(feat, fb, win, H, W, C, rs, ybase + box[0], box[0], nrows, xa, sh);
  else
    stage_rows<1>(feat, fb, win, H, W, C, rs, ybase + box[0], box[0], nrows, xa, 0);
  const long long g_rs = (long long)W * C;  // the map's next row

  // ---- 3. the four taps of each pixel, C channels
  float w00[kPix], w01[kPix], w10[kPix], w11[kPix];
  int off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    w00[j] = __fmul_rn(1.0f - wy[j], 1.0f - wx[j]);
    w01[j] = __fmul_rn(1.0f - wy[j], wx[j]);
    w10[j] = __fmul_rn(wy[j], 1.0f - wx[j]);
    w11[j] = __fmul_rn(wy[j], wx[j]);
    off[j] = yrel[j] * rs + sh + (e[j] + lw0 + j) * C;
  }
  const long long oplane = (long long)Ho * Wo;
  T* op = out + (long long)b * C * oplane + (long long)h * Wo + txo + lw0;
  const bool full = a.vec_out && txo + lw0 < Wo;  // Wo % 4 == 0: all 4 pixels real
  cp_async_wait<0>();
  __syncthreads();  // the window has landed
  if (h >= Ho) return;
  for (int c = 0; c < C; ++c) {
    const T* wc = win + c;
    const T* fc = fb + c;
    float v[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float t00, t01, t10, t11;
      if (use_win[j]) {
        const T* t = wc + off[j];
        t00 = to_f(t[0]);
        t01 = to_f(t[C]);
        t10 = to_f(t[rs]);
        t11 = to_f(t[rs + C]);
      } else {  // exact mode, outside the window: taps from device memory, zeros outside
        const bool xi0 = x0[j] >= 0 && x0[j] < W, xi1 = x0[j] + 1 >= 0 && x0[j] + 1 < W;
        const bool yi0 = y0[j] >= 0 && y0[j] < H, yi1 = y0[j] + 1 >= 0 && y0[j] + 1 < H;
        const T* t = fc + y0[j] * g_rs + (long long)x0[j] * C;
        t00 = yi0 && xi0 ? to_f(t[0]) : 0.0f;
        t01 = yi0 && xi1 ? to_f(t[C]) : 0.0f;
        t10 = yi1 && xi0 ? to_f(t[g_rs]) : 0.0f;
        t11 = yi1 && xi1 ? to_f(t[g_rs + C]) : 0.0f;
      }
      float s = __fmul_rn(w00[j], t00);
      s = __fadd_rn(s, __fmul_rn(w01[j], t01));
      s = __fadd_rn(s, __fmul_rn(w10[j], t10));
      v[j] = __fadd_rn(s, __fmul_rn(w11[j], t11));
    }
    T* o = op + c * oplane;
    if (full) {
      store4(o, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (real[j]) from_f(o[j], v[j]);
    }
  }
}

template <typename T, bool kExact>
int launch(const void* feat, void* out, const Args& a, int B, cudaStream_t s) {
  const int smem = out == nullptr ? 0 : kRows * a.row_len * (int)sizeof(T);
  auto kernel = windowed_sample_kernel<T, kExact>;
  // the limit raised once per device to the most any C needs
  static int raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRows * row_len_of(kMaxC, 16 / (int)sizeof(T)) * (int)sizeof(T));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = 1;
  }
  const dim3 blocks((unsigned)((a.Wo + kTW - 1) / kTW), (unsigned)((a.Ho + kTH - 1) / kTH),
                    (unsigned)B);
  kernel<<<blocks, kThreads, smem, s>>>(static_cast<const T*>(feat), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (B, H, W, C) (a channels-last tensor's memory), bf16 (dtype 0) or
// float32 (dtype 1); grid (B, Ho, Wo, 2)
// float32, 8-byte aligned; out (B, C, Ho, Wo) in feat's dtype, or null to
// compute only `ok` and the origins (then any C); ok: a () int32 the caller
// set to 1, or null; origins: (B, ceil(Ho / 8), ceil(Wo / 128), 2) int32 or
// null. All contiguous in those orders. Wp is the frame width
// (roma_torch/ops/windowed_sample.py::frame_width). exact: 0 "fast", 1 "exact".
ROMA_EXPORT int roma_windowed_sample(const void* feat, const void* grid, void* out, void* ok,
                                     void* origins, int B, int C, int H, int W, int Ho, int Wo,
                                     int Wp, int dtype, int exact, void* stream) {
  if (B < 0 || Ho < 0 || Wo < 0 || H < 1 || W < 1 || dtype < 0 || dtype > 1 ||
      (out != nullptr && (C < 1 || C > kMaxC)) || reinterpret_cast<uintptr_t>(grid) % 8)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Ho * Wo == 0) return (int)cudaSuccess;
  const int esize = dtype == 0 ? 2 : 4;
  Args a{};
  a.grid = static_cast<const float*>(grid);
  a.ok = static_cast<int*>(ok);
  a.origins = static_cast<int*>(origins);
  a.C = C;
  a.H = H;
  a.W = W;
  a.Ho = Ho;
  a.Wo = Wo;
  a.Wp = Wp;
  const int vec = 16 / esize;  // elements a 16-byte unit
  a.row_len = row_len_of(C, vec);
  a.vec_in = (long long)W * C * esize % 16 == 0 &&
             reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  a.vec_out = Wo % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * esize) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return exact ? launch<bf16, true>(feat, out, a, B, s) : launch<bf16, false>(feat, out, a, B, s);
  return exact ? launch<float, true>(feat, out, a, B, s) : launch<float, false>(feat, out, a, B, s);
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
