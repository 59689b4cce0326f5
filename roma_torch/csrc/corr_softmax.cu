// Streaming global-correlation softmax expectation (Tiny RoMa's coarse warp):
//   warp[b, p] = sum_j softmax_j(<f0[b, p], f1[b, j]> / sqrt(C)) * grid[j]
// fp32 features (B, L0, C) and (B, L1, C), grid (L1, 2), out (B, L0, 2).
//
// Replaces the TPU kernel roma_tpu/ops/pallas/corr_softmax.py
// (fused_pos_embed -> _kernel). Same function as
// roma_torch/kernels/corr_softmax.py::fused_pos_embed_plain (corr volume ->
// softmax -> product with the grid), without the (L0, L1) volume.
//
// Bound on the H100: operations. 2 L0 L1 C multiply-adds against
// (L0 + L1) C + 2 L1 + 2 L0 floats moved: at L = 4800, C = 64 that is
// ~1,200 operations per byte, far above the card's ratio. This first
// version keeps the scores in fp32 on the CUDA cores (the JAX function takes
// arbitrary fp32), so it cannot approach the bf16 tensor-core bound that
// chip_smoke.py reports; moving Q.K^T onto tensor cores is later work.
// Design: flash attention with q = f0, k = f1, v = grid (two columns).
// A 256-thread block owns 128 rows of f0, staged once in shared memory,
// and loops over L1 in 64-column chunks staged in shared memory. Each
// thread computes an 8 x 4 register tile of scores (rows 8 tr .. 8 tr + 7,
// columns tc + 16 j) and keeps, per row, its own running max, denominator
// and 2-vector numerator over the columns it has seen; no reduction runs
// inside the loop. At the end the 16 threads that share a row (a
// half-warp) merge their partial states with shuffles, and one of them
// writes n / d. The ragged L1 tail is masked to -inf, rows past L0 are not
// stored. The TPU version's pad-flag channel and its VMEM tile sizes have
// no counterpart here.

#include "common.cuh"

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

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
