// Local correlation around a dense warp, bf16 features, fp32 out; a
// float32 entry (roma_local_corr_f32) runs the per-pixel kernel on float32
// features at every radius (the shared-window path is bf16 only).
//
// Replaces the TPU kernel roma_tpu/ops/pallas/block_gather.py
// (local_correlation_dma -> _block_corr -> _kernel). Same function as
// roma_torch/ops/local_corr.py::local_correlation:
//   g[dy][dx] = <bf16(f0[p] / sqrt(C)), f1[y0-r+dy][x0-r+dx]>  (zero outside)
//   out[dy][dx] = w00 g[dy][dx] + w01 g[dy][dx+1] + w10 g[dy+1][dx] + w11 g[dy+1][dx+1]
//
// Bound on the H100: bytes, f0 + f1 + flow + out once each. What holds a
// warp a pixel far above it is re-reading each pixel's (2r+2)^2 window
// rows of C values from L1/L2, when neighbouring pixels' windows overlap.
// Design: the pixels are cut into 8 x 8 tiles, and each tile takes one of
// two paths by a rule on its window box: the bounding box (U pixels) of
// its pixels' windows clipped to the image, against the count of their
// in-range corners; the rule is mirrored by kernels/local_corr.py::
// tile_plan. The kernels run in turn on the caller's stream:
// - pixel_kernel, one warp per pixel, 8 pixels a block (below r = 5 the
//   first version of this kernel, token for token, and the only kernel):
//   the prescaled f0 row lives in the lanes' registers (C/32 values each),
//   a corner is one coalesced 256-byte sweep of an f1 row per 128 channels
//   plus a shuffle reduction, a corner outside the image is skipped, and
//   the (2r+2)^2 corner dots sit in shared memory for the bilinear
//   combine. From r = 5 each warp first reduces its tile's window box over
//   its lanes (two pixels a lane) and leaves if the tile takes the shared
//   path; the warp of each tile's first pixel records the tile's path.
// - box_chunk_kernel, from r = 5, a block per shared tile and 128-pixel
//   chunk of its box (a tile's box is spread over many SMs): the 64 x 128
//   scores of the tile's prescaled f0 rows against the chunk's f1 rows are
//   one GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate), operands staged by cp.async in 64-channel steps (rows
//   outside the tile or the box zero-filled) through a ring of 3 stages and
//   read by ldmatrix. Each score that is one of its pixel's corners goes to
//   that pixel's row of a (B, H, W, (2r+2)^2) score buffer.
// - combine_kernel, from r = 5, a block per shared tile: the bilinear
//   combine from the score buffer, a corner outside the image counting
//   zero; one tile row's (2r+1)^2 x 8 outputs are a contiguous store.
// The box is read once per tile instead of once per pixel and corner; the
// GEMM also computes the box pixels outside a pixel's window, so the rule
// (4 U <= corners) weighs that waste against the gather traffic saved.
// Why the shared path only from r = 5 (coarse scale 16, where a tile's box
// is bounded by the small map and every flow puts the tiles on it), from
// runs on the H100: the main path's scale-8 and scale-4 flows put a few
// scattered tiles on it (14 of 324 at scale 8), whose work comes after the
// per-pixel kernel's as a tail (0.167 -> 0.325 ms with the tiles' boxes
// on one block each); and both paths in one kernel cut the per-pixel path
// to the shared path's occupancy (3 blocks an SM: 3-22% slower, also with
// 16-byte loads and several corners in flight). Products of bf16 values
// are exact in fp32, so only the order of the sums differs from the plain
// version. The TPU kernel's S-shift layout, per-pixel DMA descriptors and
// semaphores have no counterpart here.

#include "hopper.cuh"

#include <limits.h>

#include <algorithm>

namespace {

constexpr int kT = 8;                    // tile side in pixels
constexpr int kP = kT * kT;              // pixels a tile: the GEMM's M
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK2 = 16;               // 2r+2 for r <= 7
constexpr int kUC = 128;                 // box pixels a chunk: the GEMM's N
constexpr int kCC = 64;                  // channels a stage: the GEMM's K step
constexpr int kLDS = kCC + 8;            // staged row (bf16): 144 bytes, ldmatrix conflict-free
constexpr int kStage = (kP + kUC) * kLDS;  // bf16 a stage: f0 rows, then box rows
constexpr int kShareMinR = 5;            // shared path iff r >= kShareMinR and
constexpr int kShareU = 4;               //   kShareU U <= kShareCorners corners
constexpr int kShareCorners = 1;
constexpr int kFar = -(1 << 28);         // window origin of a pixel outside the image

struct Args {
  const bf16* f0;
  const bf16* f1;
  const float* flow;
  float* out;
  int* tile_paths;  // per tile: 1 shared-window, 0 per-pixel
  int B, H, W, r;
  int th, tw;       // tiles down, across
  float scale;
};

// The chunk kernel's geometry: a cp.async ring of 3 stages (83 KB), two
// blocks an SM.
constexpr int kStages = 3;
constexpr int kChunkBlocks = 2;

size_t chunk_smem_bytes() { return kStages * kStage * sizeof(bf16) + (2 * kP + 4) * sizeof(int); }

// A pixel's window origin (x0 - r, y0 - r), x0 and y0 clamped as the plain
// version's corner_coords clamps them, and its bilinear weights.
struct Win {
  int ox, oy;
  float wx, wy;
};

__device__ __forceinline__ Win pixel_window(const float* flow, int H, int W, int r, int b, int x,
                                            int y) {
  // sample position, float32 without contraction (as the plain version)
  const float* fl = flow + 2 * (((long long)b * H + y) * W + x);
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(fl[0], 1.0f), 0.5f * W), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(fl[1], 1.0f), 0.5f * H), 0.5f);
  const float fx0 = floorf(gx), fy0 = floorf(gy);
  const float lim = (float)(2 * r + 4);
  return {(int)fminf(fmaxf(fx0, -lim), (float)W + lim) - r,
          (int)fminf(fmaxf(fy0, -lim), (float)H + lim) - r, __fsub_rn(gx, fx0),
          __fsub_rn(gy, fy0)};
}

// A tile's window box: the bounding box of its pixels' windows clipped to
// the image, and the count of their in-range corners, reduced over the
// warp. Lane l holds tile pixels l and l + 32, whose windows it returns in
// `win` (origin kFar for a pixel outside the image).
struct Box {
  int xa, xb, ya, yb, corners;
};

__device__ __forceinline__ Box tile_box(const float* flow, int H, int W, int r, int b, int tx0,
                                        int ty0, int lane, Win (&win)[2]) {
  const int K2 = 2 * r + 2;
  int xa = INT_MAX, xb = INT_MIN, ya = INT_MAX, yb = INT_MIN;
  unsigned corners = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = lane + 32 * h;
    const int x = tx0 + (q & (kT - 1)), y = ty0 + q / kT;
    win[h] = Win{kFar, kFar, 0.0f, 0.0f};
    if (x < W && y < H) {
      win[h] = pixel_window(flow, H, W, r, b, x, y);
      const int ca = max(win[h].ox, 0), cb = min(win[h].ox + K2 - 1, W - 1);
      const int ra = max(win[h].oy, 0), rb = min(win[h].oy + K2 - 1, H - 1);
      if (ca <= cb && ra <= rb) {
        xa = min(xa, ca);
        xb = max(xb, cb);
        ya = min(ya, ra);
        yb = max(yb, rb);
        corners += (unsigned)((cb - ca + 1) * (rb - ra + 1));
      }
    }
  }
  return Box{__reduce_min_sync(0xffffffffu, xa), __reduce_max_sync(0xffffffffu, xb),
             __reduce_min_sync(0xffffffffu, ya), __reduce_max_sync(0xffffffffu, yb),
             (int)__reduce_add_sync(0xffffffffu, corners)};
}

// the box's pixels U (0 when no corner is in range)
__device__ __forceinline__ int box_pixels(const Box& x) {
  return x.corners > 0 ? (x.xb - x.xa + 1) * (x.yb - x.ya + 1) : 0;
}

__device__ __forceinline__ bool take_shared(const Box& x) {
  const int U = box_pixels(x);
  return U > 0 && kShareU * U <= kShareCorners * x.corners;
}


// bf16(v * scale) for both halves of a packed pair
__device__ __forceinline__ uint32_t prescale_pair(uint32_t u, float scale) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(lo_f(u), scale), __fmul_rn(hi_f(u), scale));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scores of one shared tile's 64 pixels against one chunk of 128 pixels
// of its window box (grid: tiles x chunks), on the tensor cores, each
// score that is one of its pixel's corners stored into that pixel's row of
// `g`, (B, H, W, (2r+2)^2) fp32. Warp w computes rows 16 (w & 3) .. +15 of
// the tile against chunk columns 64 (w >> 2) .. +63. Every in-range corner
// of a shared tile lies in exactly one chunk of its box, so every entry of
// g that the combine reads is written once; corners outside the image are
// never in the box and are not written.
__global__ void __launch_bounds__(kThreads, kChunkBlocks) box_chunk_kernel(const Args a, int C,
                                                                           float* g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  int* ox = reinterpret_cast<int*>(stage + kStages * kStage);  // window origin x0 - r per pixel
  int* oy = ox + kP;
  int* box = oy + kP;  // x min, y min, width, pixels U

  const long long tile = blockIdx.x;
  if (!a.tile_paths[tile]) return;  // a per-pixel tile: the whole block leaves
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, W = a.W, r = a.r, K2 = 2 * r + 2, KK = K2 * K2;
  const int tiles_b = a.th * a.tw;
  const int b = (int)(tile / tiles_b), tyx = (int)(tile - (long long)b * tiles_b);
  const int ty0 = tyx / a.tw * kT, tx0 = (tyx % a.tw) * kT;
  if (tid < 32) {
    Win win[2];
    const Box bx = tile_box(a.flow, H, W, r, b, tx0, ty0, tid, win);
    ox[tid] = win[0].ox;
    oy[tid] = win[0].oy;
    ox[tid + 32] = win[1].ox;
    oy[tid + 32] = win[1].oy;
    if (tid == 0) {
      box[0] = bx.xa;
      box[1] = bx.ya;
      box[2] = bx.xb - bx.xa + 1;
      box[3] = box_pixels(bx);
    }
  }
  __syncthreads();
  const int bx0 = box[0], by0 = box[1], Bx = box[2], U = box[3];
  const int u0 = blockIdx.y * kUC;
  if (u0 >= U) return;  // past the tile's box: the whole block leaves

  constexpr int NS = kStages;
  constexpr int NT = kUC / 16;  // n-tiles of 8 box pixels a warp
  const int steps = C / kCC;
  const bf16* f1b = a.f1 + (long long)b * H * W * C;
  auto load = [&](int s) {
    bf16* sa = stage + (s % NS) * kStage;
    bf16* sb = sa + kP * kLDS;
    for (int i = tid; i < kP * (kCC / 8); i += kThreads) {
      const int row = i / (kCC / 8), piece = i % (kCC / 8);
      const int x = tx0 + (row & (kT - 1)), y = ty0 + row / kT;
      const bool ok = x < W && y < H;
      const bf16* src = a.f0 + (ok ? (((long long)b * H + y) * W + x) * C + s * kCC + piece * 8 : 0);
      cp_async16(sa + row * kLDS + piece * 8, src, ok);
    }
    for (int i = tid; i < kUC * (kCC / 8); i += kThreads) {
      const int row = i / (kCC / 8), piece = i % (kCC / 8);
      const int u = u0 + row;
      const bool ok = u < U;
      long long off = 0;
      if (ok) {
        const int uy = u / Bx;
        off = ((long long)(by0 + uy) * W + bx0 + (u - uy * Bx)) * C + s * kCC + piece * 8;
      }
      cp_async16(sb + row * kLDS + piece * 8, f1b + off, ok);
    }
  };

  const int mt = warp & 3, nh = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  // one commit group a step (empty past the last), NS - 1 steps ahead
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s + NS - 1 < steps) load(s + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();  // stage s has landed for every thread
    const bf16* sa = stage + (s % NS) * kStage;
    const bf16* sb = sa + kP * kLDS;
#pragma unroll
    for (int kp = 0; kp < kCC / 32; ++kp) {
      uint32_t af[2][4];
      const bf16* ap = sa + (mt * 16 + (lane & 15)) * kLDS + kp * 32 + (lane >> 4) * 8;
      ldsm_x4(af[0], ap);
      ldsm_x4(af[1], ap + 16);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) af[h][i] = prescale_pair(af[h][i], a.scale);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bq[4];
        ldsm_x4(bq, sb + (nh * (kUC / 2) + j * 8 + (lane & 7)) * kLDS + kp * 32 + (lane >> 3) * 8);
        mma_bf16(acc[j], af[0], bq[0], bq[1]);
        mma_bf16(acc[j], af[1], bq[2], bq[3]);
      }
    }
    __syncthreads();  // stage s is consumed before it is refilled
  }

  // each score that is a corner of its pixel's window, into g
  const int p0 = mt * 16 + gq, p1 = p0 + 8;
  const int ox0 = ox[p0], oy0 = oy[p0], ox1 = ox[p1], oy1 = oy[p1];
  const long long pix0 = ((long long)b * H + ty0 + p0 / kT) * W + tx0 + (p0 & (kT - 1));
  const long long pix1 = pix0 + (long long)(p1 / kT - p0 / kT) * W;  // same column, one row down
  const int ub = u0 + nh * (kUC / 2) + 2 * tq;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = ub + j * 8 + e;
      if (u < U) {
        const int uy = u / Bx;
        const int X = bx0 + u - uy * Bx, Y = by0 + uy;
        const unsigned dx0 = X - ox0, dy0 = Y - oy0, dx1 = X - ox1, dy1 = Y - oy1;
        if (dx0 < (unsigned)K2 && dy0 < (unsigned)K2) g[pix0 * KK + dy0 * K2 + dx0] = acc[j][e];
        if (dx1 < (unsigned)K2 && dy1 < (unsigned)K2) g[pix1 * KK + dy1 * K2 + dx1] = acc[j][2 + e];
      }
    }
}

// The bilinear combine of a shared tile's pixels from g (a block a tile;
// per-pixel tiles leave): a corner outside the image counts zero. A tile
// row's (2r+1)^2 x 8 outputs are one contiguous range.
__global__ void __launch_bounds__(kThreads) combine_kernel(const Args a, const float* g) {
  __shared__ int ox[kP], oy[kP];
  __shared__ float fwx[kP], fwy[kP];
  const long long tile = blockIdx.x;
  if (!a.tile_paths[tile]) return;
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, r = a.r, K2 = 2 * r + 2, KK = K2 * K2;
  const int tiles_b = a.th * a.tw;
  const int b = (int)(tile / tiles_b), tyx = (int)(tile - (long long)b * tiles_b);
  const int ty0 = tyx / a.tw * kT, tx0 = (tyx % a.tw) * kT;
  if (tid < kP) {
    const int x = tx0 + (tid & (kT - 1)), y = ty0 + tid / kT;
    if (x < W && y < H) {
      const Win w = pixel_window(a.flow, H, W, r, b, x, y);
      ox[tid] = w.ox;
      oy[tid] = w.oy;
      fwx[tid] = w.wx;
      fwy[tid] = w.wy;
    }
  }
  __syncthreads();
  const int k = 2 * r + 1, kk = k * k;
  const int nx = min(kT, W - tx0);
  for (int ty = 0; ty < kT && ty0 + ty < H; ++ty) {
    const long long row = ((long long)b * H + ty0 + ty) * W + tx0;
    float* o = a.out + row * kk;
    for (int j = tid; j < nx * kk; j += kThreads) {
      const int px = j / kk, t = j - px * kk;
      const int dy = t / k, dx = t - dy * k;
      const int p = ty * kT + px;
      const float wx = fwx[p], wy = fwy[p];
      const int X = ox[p] + dx, Y = oy[p] + dy;
      const float* gg = g + (row + px) * KK + dy * K2 + dx;
      const bool x0k = (unsigned)X < (unsigned)W, x1k = (unsigned)(X + 1) < (unsigned)W;
      const bool y0k = (unsigned)Y < (unsigned)H, y1k = (unsigned)(Y + 1) < (unsigned)H;
      const float g00 = x0k && y0k ? gg[0] : 0.0f, g01 = x1k && y0k ? gg[1] : 0.0f;
      const float g10 = x0k && y1k ? gg[K2] : 0.0f, g11 = x1k && y1k ? gg[K2 + 1] : 0.0f;
      const float w00 = __fmul_rn(1.0f - wy, 1.0f - wx), w01 = __fmul_rn(1.0f - wy, wx);
      const float w10 = __fmul_rn(wy, 1.0f - wx), w11 = __fmul_rn(wy, wx);
      o[j] = w00 * g00 + w01 * g01 + w10 * g10 + w11 * g11;
    }
  }
}

// One warp per pixel, 8 consecutive pixels a block: below r = 5 the first
// version of this kernel, token for token. With PLAN (r >= 5) a warp
// whose tile takes the shared path leaves after the tile's box, and the
// warp of each tile's first pixel records the tile's path in tile_paths,
// (B, th, tw), for the shared kernel.
// Four channels of a feature row as floats: one 8-byte load of bf16, one
// 16-byte load of float32.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = bf2f(h[i]);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}
// f0 / sqrt(C) rounded to the features' dtype, as the plain version's
// prescale
__device__ __forceinline__ float prescaled(const bf16*, float v) { return round_bf16(v); }
__device__ __forceinline__ float prescaled(const float*, float v) { return v; }

// T is bf16 or float (the float32 entry: no PLAN, every tile per pixel).
template <int NCH, bool PLAN, typename T = bf16>  // C = 128 * NCH; a lane holds NCH groups of 4
__global__ void __launch_bounds__(kWarps * 32)
pixel_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
             const float* __restrict__ flow, float* __restrict__ out,
             int* __restrict__ tile_paths, int B, int H, int W, int r, float scale) {
  constexpr int C = 128 * NCH;
  __shared__ float g_s[kWarps][kMaxK2 * kMaxK2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_pix = (long long)B * H * W;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= n_pix) return;  // whole warp leaves together; no block barrier below
  const int b = (int)(p / ((long long)H * W));
  if constexpr (PLAN) {
    const int yx = (int)(p - (long long)b * H * W);
    const int y = yx / W, x = yx - y * W;
    Win win[2];
    const bool shared =
        take_shared(tile_box(flow, H, W, r, b, x & ~(kT - 1), y & ~(kT - 1), lane, win));
    const int th = (H + kT - 1) / kT, tw = (W + kT - 1) / kT;
    if (lane == 0 && ((x | y) & (kT - 1)) == 0)
      tile_paths[((long long)b * th + y / kT) * tw + x / kT] = shared;
    if (shared) return;
  }

  // f0 row, prescaled by 1/sqrt(C) and rounded to bf16 like the plain version
  float a[NCH][4];
  const T* f0p = f0 + p * C;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float v[4];
    load4(f0p + (j * 32 + lane) * 4, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[j][i] = prescaled(f0p, __fmul_rn(v[i], scale));
  }

  // sample position, float32 without contraction (matches the plain version)
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(flow[2 * p], 1.0f), 0.5f * W), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(flow[2 * p + 1], 1.0f), 0.5f * H), 0.5f);
  const float fx0 = floorf(gx);
  const float fy0 = floorf(gy);
  const float wx = __fsub_rn(gx, fx0);
  const float wy = __fsub_rn(gy, fy0);
  const float lim = (float)(2 * r + 4);
  const int x0 = (int)fminf(fmaxf(fx0, -lim), (float)W + lim);
  const int y0 = (int)fminf(fmaxf(fy0, -lim), (float)H + lim);

  const int K2 = 2 * r + 2;
  const T* f1b = f1 + (long long)b * H * W * C;
  float* g = g_s[warp];
  for (int dy = 0; dy < K2; ++dy) {
    const int yy = y0 - r + dy;
    const bool yok = yy >= 0 && yy < H;
    for (int dx = 0; dx < K2; ++dx) {
      const int xx = x0 - r + dx;
      float s = 0.0f;
      if (yok && xx >= 0 && xx < W) {  // uniform across the warp
        const T* q = f1b + ((long long)yy * W + xx) * C;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          float v[4];
          load4(q + (j * 32 + lane) * 4, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) s = fmaf(a[j][i], v[i], s);
        }
        s = warp_sum(s);
      }
      if (lane == 0) g[dy * K2 + dx] = s;
    }
  }
  __syncwarp();

  const int k = 2 * r + 1;
  const float w00 = (1.0f - wy) * (1.0f - wx);
  const float w01 = (1.0f - wy) * wx;
  const float w10 = wy * (1.0f - wx);
  const float w11 = wy * wx;
  float* o = out + p * k * k;
  for (int t = lane; t < k * k; t += 32) {
    const int dy = t / k, dx = t - (t / k) * k;
    const float* gg = g + dy * K2 + dx;
    o[t] = w00 * gg[0] + w01 * gg[1] + w10 * gg[K2] + w11 * gg[K2 + 1];
  }
}

// The shared tiles' chunks, then their combine. Chunks a tile: a shared
// tile has 4 U <= corners <= 64 (2r+2)^2, and U <= H W.
int launch_shared(const Args& a, int C, float* g, cudaStream_t stream) {
  static bool allowed = false;  // the chunk kernel's dynamic shared memory is set
  const size_t bytes = chunk_smem_bytes();
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        box_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const long long n_tiles = (long long)a.B * a.th * a.tw;
  const int K2 = 2 * a.r + 2;
  const long long u_max = std::min<long long>((long long)a.H * a.W, 16LL * K2 * K2);
  const dim3 grid((unsigned)n_tiles, (unsigned)((u_max + kUC - 1) / kUC));
  box_chunk_kernel<<<grid, kThreads, bytes, stream>>>(a, C, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(a, g);
  return (int)cudaGetLastError();
}

template <int NCH>
int launch(const Args& a, float* g, cudaStream_t stream) {
  const long long n_pix = (long long)a.B * a.H * a.W;
  const unsigned grid = (unsigned)((n_pix + kWarps - 1) / kWarps);
  if (a.r < kShareMinR) {
    pixel_kernel<NCH, false><<<grid, kThreads, 0, stream>>>(a.f0, a.f1, a.flow, a.out, nullptr,
                                                            a.B, a.H, a.W, a.r, a.scale);
    // no tile takes the shared path; the map only where the caller asks
    if (a.tile_paths != nullptr)
      cudaMemsetAsync(a.tile_paths, 0, (size_t)a.B * a.th * a.tw * sizeof(int), stream);
    return (int)cudaGetLastError();
  }
  pixel_kernel<NCH, true><<<grid, kThreads, 0, stream>>>(a.f0, a.f1, a.flow, a.out, a.tile_paths,
                                                         a.B, a.H, a.W, a.r, a.scale);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_shared(a, 128 * NCH, g, stream);
}

// The float32 entry: the per-pixel kernel at every radius, no shared tiles.
template <int NCH>
int launch_f32(const float* f0, const float* f1, const Args& a, cudaStream_t stream) {
  const long long n_pix = (long long)a.B * a.H * a.W;
  const unsigned grid = (unsigned)((n_pix + kWarps - 1) / kWarps);
  pixel_kernel<NCH, false, float><<<grid, kThreads, 0, stream>>>(f0, f1, a.flow, a.out, nullptr,
                                                                 a.B, a.H, a.W, a.r, a.scale);
  if (a.tile_paths != nullptr)
    cudaMemsetAsync(a.tile_paths, 0, (size_t)a.B * a.th * a.tw * sizeof(int), stream);
  return (int)cudaGetLastError();
}

}  // namespace

// f0, f1: (B, H, W, C) bf16 contiguous, 16-byte aligned; flow: (B, H, W, 2)
// fp32; out: (B, H, W, (2r+1)^2) fp32; tile_paths: one int per 8 x 8 tile,
// (B, ceil(H/8), ceil(W/8)), set to 1 where the tile took the
// shared-window path, 0 where it took the per-pixel path; scores: from
// r = 5, (B, H, W, (2r+2)^2) fp32 room for the shared tiles' corner scores.
// Below r = 5 no tile takes the shared path, tile_paths may be null (else
// it is filled with 0) and scores is not used. C a multiple of 128, at
// most 1024; r <= 7.
ROMA_EXPORT int roma_local_corr(const void* f0, const void* f1, const void* flow, void* out,
                                void* tile_paths, void* scores, int B, int H, int W, int C,
                                int r, float scale, void* stream) {
  if (C % 128 != 0 || C > 1024 || r < 0 || r > 7 ||
      (r >= kShareMinR && (tile_paths == nullptr || scores == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  const Args a{static_cast<const bf16*>(f0), static_cast<const bf16*>(f1),
               static_cast<const float*>(flow), static_cast<float*>(out),
               static_cast<int*>(tile_paths), B, H, W, r, (H + kT - 1) / kT, (W + kT - 1) / kT,
               scale};
  auto g = static_cast<float*>(scores);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C / 128) {
    case 1: return launch<1>(a, g, s);
    case 2: return launch<2>(a, g, s);
    case 3: return launch<3>(a, g, s);
    case 4: return launch<4>(a, g, s);
    case 5: return launch<5>(a, g, s);
    case 6: return launch<6>(a, g, s);
    case 7: return launch<7>(a, g, s);
    case 8: return launch<8>(a, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The float32 entry: f0, f1 (B, H, W, C) float32 contiguous, 16-byte
// aligned; the rest as roma_local_corr, without scores: every tile takes
// the per-pixel path, and tile_paths (may be null) is filled with 0.
ROMA_EXPORT int roma_local_corr_f32(const void* f0, const void* f1, const void* flow, void* out,
                                    void* tile_paths, int B, int H, int W, int C, int r,
                                    float scale, void* stream) {
  if (C % 128 != 0 || C > 1024 || r < 0 || r > 7) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  const Args a{nullptr, nullptr, static_cast<const float*>(flow), static_cast<float*>(out),
               static_cast<int*>(tile_paths), B, H, W, r, (H + kT - 1) / kT, (W + kT - 1) / kT,
               scale};
  auto x0 = static_cast<const float*>(f0);
  auto x1 = static_cast<const float*>(f1);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C / 128) {
    case 1: return launch_f32<1>(x0, x1, a, s);
    case 2: return launch_f32<2>(x0, x1, a, s);
    case 3: return launch_f32<3>(x0, x1, a, s);
    case 4: return launch_f32<4>(x0, x1, a, s);
    case 5: return launch_f32<5>(x0, x1, a, s);
    case 6: return launch_f32<6>(x0, x1, a, s);
    case 7: return launch_f32<7>(x0, x1, a, s);
    case 8: return launch_f32<8>(x0, x1, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
