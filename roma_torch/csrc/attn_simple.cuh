// Simple tiled attention kernels in float32 FMA, shared by the forward
// (flash_attn.cu: the float32 entry of K3, with the row log-sum-exp) and
// the backward (flash_attn_bwd.cu: the float32 kernels of K8, dK/dV, and
// K9, dQ).
//
// Layout: q, k, v, dO are (B, N, H, d) with unit stride along d and any
// strides along B, N and H (views of a fused qkv projection are taken as
// they are); outputs are contiguous (B, N, H, d); lse and di are (B, H, N)
// float32. d is 64 or 128.
//
// Tiles: 64 rows of q (or dO) and 64 rows of k (or v) at a time, staged
// in shared memory as float rows of d + 1 (the odd stride puts the 16
// rows a warp reads at one column in 16 banks); 256 threads, thread
// (ty, tx) = (tid / 16, tid % 16) owning rows ty + 16 i (i < 4) and
// columns tx + 16 j of each 64-row product. Rows past N are staged as
// zeros and masked out of every softmax and sum; nothing is stored for
// them. All sums are float32 FMA: these kernels are right first, not fast
// (bf16 takes the wgmma forward and the mma.sync backward).
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace attn {

constexpr int kRows = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLDP = kRows + 1; // a 64 x 64 score tile's row in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// strides (elements) of a (B, N, H, d) tensor along B, N and H
struct Strides {
  long long b, n, h;
};

// rows n0 ... n0 + 63 of head h of image b into a float tile of stride
// D + 1, zeros for rows at or past N; consecutive threads read consecutive
// columns
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides s,
                                          int b, int h, int n0, int N) {
  const float* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int n = n0 + r;
    dst[r * (D + 1) + c] = n < N ? base[(long long)n * s.n + c] : 0.0f;
  }
}

// acc[i][j] = sum_c A[ty + 16 i][c] * Bm[tx + 16 j][c] over the D columns
// of two staged tiles (a 64 x 64 product of rows with rows)
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[4][4], const float* A, const float* Bm,
                                              int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// out[i][j] += sum_r P[row(i)][r] * V[r][tx + 16 j] over the 64 rows r of a
// staged tile, where P is a 64 x 64 score tile of stride kLDP read by row
// (rows ty + 16 i, `by_row`) or by column (P^T: rows of the result are
// P's columns ty + 16 i)
template <int D, bool by_row>
__device__ __forceinline__ void scores_times_tile(float (&out)[4][D / 16], const float* P,
                                                  const float* V, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = by_row ? P[(ty + 16 * i) * kLDP + r] : P[r * kLDP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float v = V[r * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][j] = fmaf(p[i], v, out[i][j]);
    }
  }
}

// write rows ty + 16 i of a 64-row result (times `mul`) to a contiguous
// (B, N, H, D) tensor, rows n0 ... at or past N skipped
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[4][D / 16],
                                           float mul, int b, int h, int n0, int N, int H, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
    float* row = dst + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) row[tx + 16 * j] = acc[i][j] * mul;
  }
}

// shared memory of the forward: q, k, v tiles, the score tile, per-row
// rescale factors and sums
template <int D>
constexpr int fwd_smem_bytes() {
  return 4 * (3 * kRows * (D + 1) + kRows * kLDP + 2 * kRows);
}

// o = softmax(scale q k^T) v for one 64-row q tile of one (b, h) per
// block, online over 64-key tiles; lse (natural log of each row's sum of
// exp(scale q k^T)) written where `lse` is not null
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
           int N, int H, float scale_log2) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * (D + 1);
  float* sV = sK + kRows * (D + 1);
  float* sP = sV + kRows * (D + 1);
  float* sAlpha = sP + kRows * kLDP;
  float* sSum = sAlpha + kRows;
  const int m0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row = tid / 4, part = tid % 4;  // the softmax's 4 threads a row

  load_tile<D>(sQ, q, sq, b, h, m0, N);
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  float m_run = -CUDART_INF_F, l_run = 0.0f;  // the row's max (log2 units) and sum

  for (int n0 = 0; n0 < N; n0 += kRows) {
    __syncthreads();  // the last tile's P V is done with sK, sV, sP
    load_tile<D>(sK, k, sk, b, h, n0, N);
    load_tile<D>(sV, v, sv, b, h, n0, N);
    __syncthreads();
    float s[4][4];
    rows_dot_rows<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kLDP + tx + 16 * j] =
            n0 + tx + 16 * j < N ? s[i][j] * scale_log2 : -CUDART_INF_F;
    __syncthreads();
    // every tile holds a key below N, so the new max is finite
    float* pr = sP + row * kLDP + part * 16;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float p = exp2f(pr[c] - m_new);
      pr[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (part == 0) sAlpha[row] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sAlpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= al;
    }
    scores_times_tile<D, true>(acc, sP, sV, ty, tx);
  }
  if (part == 0) {
    sSum[row] = l_run;
    if (lse != nullptr && m0 + row < N)
      lse[((long long)b * H + h) * N + m0 + row] = (m_run + log2f(l_run)) * kLn2;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = m0 + ty + 16 * i;
    if (n >= N) continue;
    const float inv = 1.0f / sSum[ty + 16 * i];
    float* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
               int H, const long long* st, float scale_log2, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, N, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace attn
