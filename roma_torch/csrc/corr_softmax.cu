// Streaming global-correlation softmax expectation (Tiny RoMa's coarse warp):
//   warp[b, p] = sum_j softmax_j(<f0[b, p], f1[b, j]> / sqrt(C)) * grid[j]
// features (B, L0, C) and (B, L1, C), fp32 or bf16; grid (L1, 2), out
// (B, L0, 2), fp32.
//
// Replaces the TPU kernel roma_tpu/ops/pallas/corr_softmax.py
// (fused_pos_embed -> _kernel). Same function as
// roma_torch/kernels/corr_softmax.py::fused_pos_embed_plain (corr volume ->
// softmax -> product with the grid), without the (L0, L1) volume.
//
// Bound on the H100: operations. 2 L0 L1 C multiply-adds against
// (L0 + L1) C + 2 L1 + 2 L0 values moved: at L = 4800, C = 64 that is
// ~1,200 operations per byte, far above the card's ratio; and one
// exponential per score, on the special-function units (~3.9e12 a second),
// which at C = 64 take longer than the tensor cores' products.
//
// Two entries, by the features' dtype (the JAX function takes fp32; Tiny
// RoMa's trunk gives bf16):
//
// bf16 (corr_softmax_bf16_kernel): FlashAttention-2 shaped on mma.sync.
// Products of bf16 values are exact in fp32, so this computes the same
// function as the fp32 path on the same values; only the order of the sums
// differs. A 256-thread block owns 128 rows of f0; each warp holds its 16
// rows' A fragments in registers for all of C (C / 16 k-steps) and streams
// f1 in 64-column chunks, double-buffered in shared memory by cp.async (the
// ragged tail zero-filled) and read by ldmatrix. The 16 x 64 scores stay in
// registers: the row max over the quad of lanes sharing a row by two
// shuffles, exp2 with the scale folded in (scale_log2), P . grid as two fp32
// FMAs a score on the CUDA cores (P is not rounded to bf16 for a tensor-core
// product: that would cost ~2^-9 of the coordinates). Columns past L1 are
// masked, rows past L0 are not stored; the quad merges its partial sums
// once at the end.
//
// fp32 (corr_softmax_kernel): fp32 scores on the CUDA cores. A 256-thread
// block owns 128 rows of f0, staged once in shared memory, and loops over
// L1 in 64-column chunks staged in shared memory. Each thread computes an
// 8 x 4 register tile of scores (rows 8 tr .. 8 tr + 7, columns tc + 16 j)
// and keeps, per row, its own running max, denominator and 2-vector
// numerator over the columns it has seen; no reduction runs inside the
// loop. At the end the 16 threads that share a row (a half-warp) merge
// their partial states with shuffles, and one of them writes n / d.
//
// The TPU version's pad-flag channel and its VMEM tile sizes have no
// counterpart here.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int kRows = 128;      // L0 rows per block
constexpr int kCols = 64;       // L1 columns per chunk
constexpr int kThreads = 256;
constexpr int kRT = 8;          // rows per thread
constexpr int kCT = 4;          // columns per thread

template <int C>
constexpr int smem_bytes() {
  return ((kRows + kCols) * (C + 4) + 2 * kCols) * (int)sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
corr_softmax_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                    const float* __restrict__ grid, float* __restrict__ out,
                    int L0, int L1, float scale_log2) {
  constexpr int LD = C + 4;  // padded row: conflict-free float4 reads
  constexpr int C4 = C / 4;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // kRows x LD
  float* b_s = a_s + kRows * LD;                 // kCols x LD
  float* g_s = b_s + kCols * LD;                 // kCols x 2

  const int tid = threadIdx.x;
  const int tc = tid & 15;
  const int tr = tid >> 4;
  const int b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * kRows;
  const float* f0b = f0 + (long long)b * L0 * C;
  const float* f1b = f1 + (long long)b * L1 * C;

  for (int i = tid; i < kRows * C4; i += kThreads) {
    const int r = i / C4;
    const int k4 = i - r * C4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L0) v = *reinterpret_cast<const float4*>(f0b + (row0 + r) * C + k4 * 4);
    *reinterpret_cast<float4*>(a_s + r * LD + k4 * 4) = v;
  }

  float m[kRT], d[kRT], nx[kRT], ny[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = -INFINITY;
    d[i] = 0.f;
    nx[i] = 0.f;
    ny[i] = 0.f;
  }

  for (int c0 = 0; c0 < L1; c0 += kCols) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kCols * C4; i += kThreads) {
      const int cc = i / C4;
      const int k4 = i - cc * C4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + cc < L1) v = *reinterpret_cast<const float4*>(f1b + (long long)(c0 + cc) * C + k4 * 4);
      *reinterpret_cast<float4*>(b_s + cc * LD + k4 * 4) = v;
    }
    if (tid < kCols) {
      const int j = c0 + tid;
      g_s[2 * tid] = j < L1 ? grid[2 * j] : 0.f;
      g_s[2 * tid + 1] = j < L1 ? grid[2 * j + 1] : 0.f;
    }
    __syncthreads();

    float acc[kRT][kCT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) acc[i][j] = 0.f;

#pragma unroll 4
    for (int k = 0; k < C; k += 4) {
      float4 av[kRT], bv[kCT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        av[i] = *reinterpret_cast<const float4*>(a_s + (tr * kRT + i) * LD + k);
#pragma unroll
      for (int j = 0; j < kCT; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b_s + (tc + 16 * j) * LD + k);
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          float s = acc[i][j];
          s = fmaf(av[i].x, bv[j].x, s);
          s = fmaf(av[i].y, bv[j].y, s);
          s = fmaf(av[i].z, bv[j].z, s);
          s = fmaf(av[i].w, bv[j].w, s);
          acc[i][j] = s;
        }
    }

    // online softmax over this thread's columns of the chunk (log2 domain)
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float s[kCT];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        s[j] = (c0 + tc + 16 * j < L1) ? acc[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      if (mx == -INFINITY) continue;  // every column so far masked
      const float alpha = exp2f(m[i] - mx);  // 0 when m was -inf
      float dd = d[i] * alpha, xx = nx[i] * alpha, yy = ny[i] * alpha;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const float p = exp2f(s[j] - mx);
        const int cc = tc + 16 * j;
        dd += p;
        xx = fmaf(p, g_s[2 * cc], xx);
        yy = fmaf(p, g_s[2 * cc + 1], yy);
      }
      m[i] = mx;
      d[i] = dd;
      nx[i] = xx;
      ny[i] = yy;
    }
  }

  // merge the partial states of the 16 threads sharing each row
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    float mi = m[i], di = d[i], xi = nx[i], yi = ny[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mi, off);
      const float dn = __shfl_xor_sync(0xffffffffu, di, off);
      const float xo = __shfl_xor_sync(0xffffffffu, xi, off);
      const float yo = __shfl_xor_sync(0xffffffffu, yi, off);
      const float mn = fmaxf(mi, mo);
      const float sa = mi == -INFINITY ? 0.f : exp2f(mi - mn);
      const float sb = mo == -INFINITY ? 0.f : exp2f(mo - mn);
      di = di * sa + dn * sb;
      xi = xi * sa + xo * sb;
      yi = yi * sa + yo * sb;
      mi = mn;
    }
    const long long row = row0 + tr * kRT + i;
    if (tc == 0 && row < L0) {
      float* o = out + ((long long)b * L0 + row) * 2;
      o[0] = xi / di;
      o[1] = yi / di;
    }
  }
}

template <int C>
int launch(const float* f0, const float* f1, const float* grid, float* out, int B,
           int L0, int L1, float scale_log2, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(corr_softmax_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((L0 + kRows - 1) / kRows), (unsigned)B);
  corr_softmax_kernel<C><<<blocks, kThreads, bytes, stream>>>(f0, f1, grid, out, L0, L1,
                                                              scale_log2);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------- bf16 entry

constexpr int kWarpRows = 16;             // f0 rows a warp
constexpr int kBfRows = 8 * kWarpRows;    // f0 rows a block (8 warps)

template <int C>
constexpr int bf16_smem_bytes() {
  return 2 * (kCols * (C + 8) * (int)sizeof(bf16) + 2 * kCols * (int)sizeof(float));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
corr_softmax_bf16_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                         const float* __restrict__ grid, float* __restrict__ out, int L0, int L1,
                         float scale_log2) {
  constexpr int KS = C / 16;   // k-steps
  constexpr int LD = C + 8;    // staged row (bf16): an odd number of 16-byte units
  constexpr int kPieces = C / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* fs = reinterpret_cast<bf16*>(smem_raw);                 // [2][kCols][LD]
  float* gs = reinterpret_cast<float*>(fs + 2 * kCols * LD);    // [2][kCols][2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y;
  const bf16* f0b = f0 + (long long)b * L0 * C;
  const bf16* f1b = f1 + (long long)b * L1 * C;
  const long long r0 = (long long)blockIdx.x * kBfRows + warp * kWarpRows + gq;
  const long long r1 = r0 + 8;

  // A fragments of the warp's 16 rows, all of C, zeros past L0
  uint32_t af[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = ks * 16 + 2 * tq;
    af[ks][0] = r0 < L0 ? *reinterpret_cast<const uint32_t*>(f0b + r0 * C + k) : 0u;
    af[ks][1] = r1 < L0 ? *reinterpret_cast<const uint32_t*>(f0b + r1 * C + k) : 0u;
    af[ks][2] = r0 < L0 ? *reinterpret_cast<const uint32_t*>(f0b + r0 * C + k + 8) : 0u;
    af[ks][3] = r1 < L0 ? *reinterpret_cast<const uint32_t*>(f0b + r1 * C + k + 8) : 0u;
  }

  const int chunks = (L1 + kCols - 1) / kCols;
  auto load = [&](int ch) {
    bf16* dst = fs + (ch & 1) * kCols * LD;
    float* gdst = gs + (ch & 1) * 2 * kCols;
    const int c0 = ch * kCols;
    for (int i = tid; i < kCols * kPieces; i += kThreads) {
      const int row = i / kPieces, piece = i - row * kPieces;
      const bool ok = c0 + row < L1;
      cp_async16(dst + row * LD + piece * 8, f1b + (ok ? (long long)(c0 + row) * C + piece * 8 : 0), ok);
    }
    if (tid < kCols) {
      const bool ok = c0 + tid < L1;
      cp_async8(gdst + 2 * tid, grid + (ok ? 2 * (c0 + tid) : 0), ok);
    }
    cp_async_commit();
  };

  // per row (gq, gq + 8): running max (log2 domain), denominator, numerator
  float m[2] = {-INFINITY, -INFINITY}, d[2] = {0.f, 0.f}, nx[2] = {0.f, 0.f}, ny[2] = {0.f, 0.f};
  load(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed for every thread
    const bf16* bs = fs + (ch & 1) * kCols * LD;
    const float* g2 = gs + (ch & 1) * 2 * kCols;
    // per pair of k-steps all B fragments first, then the products (the
    // asm statements keep their order as written)
    float acc[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* bp = bs + (lane & 7) * LD;
    if constexpr (KS == 1) {
      uint32_t bq[kCols / 8][2];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) ldsm_x2(bq[j], bp + j * 8 * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) mma_bf16(acc[j], af[0], bq[j][0], bq[j][1]);
    } else {
#pragma unroll
      for (int kp = 0; kp < KS / 2; ++kp) {
        uint32_t bq[kCols / 8][4];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) ldsm_x4(bq[j], bp + j * 8 * LD + kp * 32 + (lane >> 3) * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j)
            mma_bf16(acc[j], af[2 * kp + h], bq[j][2 * h], bq[j][2 * h + 1]);
      }
    }
    // online softmax of the two rows over this chunk's 64 columns
    const int cbase = ch * kCols + 2 * tq;
    const bool tail = ch * kCols + kCols > L1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!tail || cbase + j * 8 + e < L1) mx = fmaxf(mx, acc[j][2 * h + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx * scale_log2);  // finite: chunk 0 has column 0
      const float alpha = exp2f(m[h] - mn);            // 0 while m was -inf
      float dd = d[h] * alpha, xx = nx[h] * alpha, yy = ny[h] * alpha;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = j * 8 + 2 * tq + e;
          const float p = (!tail || cbase + j * 8 + e < L1)
                              ? exp2f(fmaf(acc[j][2 * h + e], scale_log2, -mn)) : 0.f;
          dd += p;
          xx = fmaf(p, g2[2 * cc], xx);
          yy = fmaf(p, g2[2 * cc + 1], yy);
        }
      m[h] = mn;
      d[h] = dd;
      nx[h] = xx;
      ny[h] = yy;
    }
    __syncthreads();  // chunk ch is consumed before its buffer is refilled
  }

  // the quad shares one max per row: sum its partial states and store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float dd = d[h], xx = nx[h], yy = ny[h];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      dd += __shfl_xor_sync(0xffffffffu, dd, o);
      xx += __shfl_xor_sync(0xffffffffu, xx, o);
      yy += __shfl_xor_sync(0xffffffffu, yy, o);
    }
    const long long row = h ? r1 : r0;
    if (tq == 0 && row < L0) {
      float* o = out + ((long long)b * L0 + row) * 2;
      o[0] = xx / dd;
      o[1] = yy / dd;
    }
  }
}

template <int C>
int launch_bf16(const bf16* f0, const bf16* f1, const float* grid, float* out, int B, int L0,
                int L1, float scale_log2, cudaStream_t stream) {
  constexpr int bytes = bf16_smem_bytes<C>();
  const dim3 blocks((unsigned)((L0 + kBfRows - 1) / kBfRows), (unsigned)B);
  corr_softmax_bf16_kernel<C><<<blocks, kThreads, bytes, stream>>>(f0, f1, grid, out, L0, L1,
                                                                   scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// f0 (B, L0, C), f1 (B, L1, C), grid (L1, 2), out (B, L0, 2): fp32,
// contiguous, 16-byte aligned. C in {16, 32, 64}; L1 >= 1.
// scale_log2 = log2(e) / sqrt(C).
ROMA_EXPORT int roma_corr_softmax(const void* f0, const void* f1, const void* grid,
                                  void* out, int B, int L0, int L1, int C,
                                  float scale_log2, void* stream) {
  if (L1 < 1 || B < 0 || L0 < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * L0 == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(f0);
  auto b = static_cast<const float*>(f1);
  auto g = static_cast<const float*>(grid);
  auto o = static_cast<float*>(out);
  switch (C) {
    case 16: return launch<16>(a, b, g, o, B, L0, L1, scale_log2, s);
    case 32: return launch<32>(a, b, g, o, B, L0, L1, scale_log2, s);
    case 64: return launch<64>(a, b, g, o, B, L0, L1, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same on bf16 features: f0 (B, L0, C), f1 (B, L1, C) bf16, contiguous,
// 16-byte aligned; grid (L1, 2) fp32, 8-byte aligned; out (B, L0, 2) fp32.
ROMA_EXPORT int roma_corr_softmax_bf16(const void* f0, const void* f1, const void* grid,
                                       void* out, int B, int L0, int L1, int C,
                                       float scale_log2, void* stream) {
  if (L1 < 1 || B < 0 || L0 < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * L0 == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const bf16*>(f0);
  auto b = static_cast<const bf16*>(f1);
  auto g = static_cast<const float*>(grid);
  auto o = static_cast<float*>(out);
  switch (C) {
    case 16: return launch_bf16<16>(a, b, g, o, B, L0, L1, scale_log2, s);
    case 32: return launch_bf16<32>(a, b, g, o, B, L0, L1, scale_log2, s);
    case 64: return launch_bf16<64>(a, b, g, o, B, L0, L1, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
