// Flash attention backward, no mask: the two kernels of the TPU flash
// attention's custom_vjp, for bf16 and float32 inputs, d in {64, 128}.
//
// Replaces the TPU kernels of jax.experimental.pallas.ops.tpu.
// flash_attention that the JAX package runs when it differentiates
// roma_tpu/models/transformer.py::_flash_attention (the match decoder in
// train/train.py::make_train_step):
// - K8, dK and dV: _flash_attention_bwd_dkv (flash_attention.py:941,
//   kernel :796);
// - K9, dQ: _flash_attention_bwd_dq (flash_attention.py:1287, kernel :1146).
// With S = scale q k^T, P = exp(S - lse) (lse from the forward, per row),
// di = rowsum(o * dO) (computed by the wrapper, as JAX computes it in XLA),
// dP = dO v^T and dS = P * (dP - di):
//   dV = P^T dO,   dK = scale dS^T q,   dQ = scale dS k.
// K8 gives a block one 64-key tile of one (b, h) and walks the query tiles;
// K9 gives a block one 64-query tile and walks the key tiles. Each output
// element is summed by one thread in a fixed order, with no atomics, so the
// result is deterministic, and the work splits as JAX splits it. Ragged N
// is masked inside: rows past N are staged as zeros, their P is 0, and
// nothing is stored for them. The gradients are written in the input's
// dtype; the sums are float32.
//
// Bound on the H100: operations. At the decoder's training shape (2, 1600,
// 8, 128) one N^2 d product is 1.05e10 FLOPs, 0.0106 ms at the bf16
// tensor-core peak: K8 runs four (0.042 ms) and K9 three (0.032 ms).
// bf16 (the training path): FlashAttention-2-shaped on mma.sync m16n8k16,
// four warps a block, each warp owning 16 rows of the block's tile (keys in
// K8, queries in K9). The block's fixed tiles and the walking tiles are
// staged as bf16 rows of d + 8 (16-byte rows offset by 16 bytes, so
// ldmatrix reads are conflict-free) by cp.async; S (or S^T) and dP (or
// dP^T) come out of the tensor cores as fp32 accumulators, P and dS are
// formed in registers and repacked as bf16 A operands for the next
// products (the accumulator layout of two n8 tiles is the A layout of one
// k16 step), and the operands read along their rows come from ldmatrix
// .trans. P and dS are rounded to bf16 before their products, as in
// FlashAttention-2. Not yet Hopper-shaped (wgmma, TMA, a pipelined ring):
// later work. float32: the simple FMA tiles of attn_simple.cuh.

#include "attn_simple.cuh"
#include "hopper.cuh"

namespace {

using attn::kLDP;
using attn::kRows;
using attn::kThreads;
using attn::Strides;

template <int D>
constexpr int bwd_smem_bytes() {
  // four staged tiles, two score tiles, lse and di of 64 rows
  return 4 * (4 * kRows * (D + 1) + 2 * kRows * kLDP + 2 * kRows);
}

// S and dP of a 64-query x 64-key pair of tiles, then P and dS into sP and
// sdS (rows = queries, columns = keys); rows or columns past N give 0
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sK, const float* sdO,
                                       const float* sV, const float* sLse, const float* sDi,
                                       float* sP, float* sdS, int m0, int n0, int N,
                                       float scale_log2, int ty, int tx) {
  float s[4][4], dp[4][4];
  attn::rows_dot_rows<D>(s, sQ, sK, ty, tx);
  attn::rows_dot_rows<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool q_ok = m0 + r < N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = q_ok && n0 + c < N ? exp2f(fmaf(s[i][j], scale_log2, -sLse[r])) : 0.0f;
      if (sP != nullptr) sP[r * kLDP + c] = p;
      sdS[r * kLDP + c] = p * (dp[i][j] - sDi[r]);
    }
  }
}

// lse (in log2 units) and di of rows n0 ... n0 + 63 of (b, h)
__device__ __forceinline__ void load_rows(float* sLse, float* sDi, const float* __restrict__ lse,
                                          const float* __restrict__ di, int b, int h, int n0,
                                          int N, int H) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int n = n0 + r;
    const long long at = ((long long)b * H + h) * N + n;
    sLse[r] = n < N ? lse[at] * attn::kLog2e : 0.0f;
    sDi[r] = n < N ? di[at] : 0.0f;
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo;
  int N, H;
  float scale, scale_log2;
};

// ---------------------------------------------------------------- float32: FMA tiles

// K8, float32: dK, dV of one 64-key tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kRows * (D + 1);
  float* sQ = sV + kRows * (D + 1);
  float* sdO = sQ + kRows * (D + 1);
  float* sP = sdO + kRows * (D + 1);
  float* sdS = sP + kRows * kLDP;
  float* sLse = sdS + kRows * kLDP;
  float* sDi = sLse + kRows;
  const int n0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = a.N;

  attn::load_tile<D>(sK, static_cast<const float*>(a.k), a.sk, b, h, n0, N);
  attn::load_tile<D>(sV, static_cast<const float*>(a.v), a.sv, b, h, n0, N);
  float dk[4][D / 16], dv[4][D / 16];  // rows: keys ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int m0 = 0; m0 < N; m0 += kRows) {
    __syncthreads();  // the last query tile's sums are done with sQ, sdO, sP, sdS
    attn::load_tile<D>(sQ, static_cast<const float*>(a.q), a.sq, b, h, m0, N);
    attn::load_tile<D>(sdO, static_cast<const float*>(a.dout), a.sdo, b, h, m0, N);
    load_rows(sLse, sDi, a.lse, a.di, b, h, m0, N, a.H);
    __syncthreads();
    scores<D>(sQ, sK, sdO, sV, sLse, sDi, sP, sdS, m0, n0, N, a.scale_log2, ty, tx);
    __syncthreads();
    attn::scores_times_tile<D, false>(dv, sP, sdO, ty, tx);   // dV += P^T dO
    attn::scores_times_tile<D, false>(dk, sdS, sQ, ty, tx);   // dK += dS^T q
  }
  attn::store_rows<D>(static_cast<float*>(a.dk), dk, a.scale, b, h, n0, N, a.H, ty, tx);
  attn::store_rows<D>(static_cast<float*>(a.dv), dv, 1.0f, b, h, n0, N, a.H, ty, tx);
}

// K9, float32: dQ of one 64-query tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kRows * (D + 1);
  float* sK = sdO + kRows * (D + 1);
  float* sV = sK + kRows * (D + 1);
  float* sdS = sV + kRows * (D + 1);
  float* sLse = sdS + 2 * kRows * kLDP;
  float* sDi = sLse + kRows;
  const int m0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = a.N;

  attn::load_tile<D>(sQ, static_cast<const float*>(a.q), a.sq, b, h, m0, N);
  attn::load_tile<D>(sdO, static_cast<const float*>(a.dout), a.sdo, b, h, m0, N);
  load_rows(sLse, sDi, a.lse, a.di, b, h, m0, N, a.H);
  float dq[4][D / 16];  // rows: queries ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq[i][j] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kRows) {
    __syncthreads();  // the last key tile's sums are done with sK, sdS
    attn::load_tile<D>(sK, static_cast<const float*>(a.k), a.sk, b, h, n0, N);
    attn::load_tile<D>(sV, static_cast<const float*>(a.v), a.sv, b, h, n0, N);
    __syncthreads();
    scores<D>(sQ, sK, sdO, sV, sLse, sDi, nullptr, sdS, m0, n0, N, a.scale_log2, ty, tx);
    __syncthreads();
    attn::scores_times_tile<D, true>(dq, sdS, sK, ty, tx);  // dQ += dS k
  }
  attn::store_rows<D>(static_cast<float*>(a.dq), dq, a.scale, b, h, m0, N, a.H, ty, tx);
}

template <int D>
int launch(const Args& a, int B, bool dkv, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  void (*kernel)(const Args) = dkv ? &dkv_kernel<D> : &dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kRows - 1) / kRows, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: mma.sync

constexpr int kMmaThreads = 128;  // four warps, 16 rows of the block's tile each

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;  // bf16 row stride
  static constexpr int kTile = kRows * kLd;
  static constexpr int kBytes = 4 * kTile * 2 + 2 * kRows * 4;  // four tiles, lse and di
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows n0 ... n0 + 63 of head h of image b, bf16, into a tile of stride
// MmaSmem<D>::kLd by cp.async, zeros for rows at or past N
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, Strides s,
                                           int b, int h, int n0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  const bf16* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = n0 + r < N;
    cp_async16(dst + r * MmaSmem<D>::kLd + c, base + (long long)(ok ? n0 + r : 0) * s.n + c, ok);
  }
}

// A operand (16 x 16) at rows r0, columns k0 of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0, int k0,
                                       int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B operands of the n8 tiles n0 and n0 + 8 (b[0..1], b[2..3]), k = k0 ...
// k0 + 15, from a tile stored with n along its rows (B[k][n] = tile[n][k])
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                            int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same from a tile stored with k along its rows (B[k][n] = tile[k][n])
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                            int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + ((lane >> 4) << 3));
}

// acc[8][4] (16 rows x 64 columns) = A rows r0 ... r0 + 15 of `at` times
// the 64 rows of `bt`, over D: S = Q K^T, dP = dO V^T and their transposes
template <int D>
__device__ __forceinline__ void rows_times_rows(float (&acc)[8][4], const bf16* at,
                                                const bf16* bt, int r0, int lane) {
  constexpr int ld = MmaSmem<D>::kLd;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, at, ld, r0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bb[4];
      frag_b_rows(bb, bt, ld, j * 16, kk * 16, lane);
      mma_bf16(acc[2 * j], a, bb[0], bb[1]);
      mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
    }
  }
}

// out[D / 8][4] (16 rows x D) += A (16 x 64, four k16 steps of bf16 A
// operands) times the 64 rows of `bt` (B[k][n] = bt[k][n])
template <int D>
__device__ __forceinline__ void regs_times_tile(float (&out)[D / 8][4], const uint32_t (&a)[4][4],
                                                const bf16* bt, int lane) {
  constexpr int ld = MmaSmem<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t bb[4];
      frag_b_cols(bb, bt, ld, kk * 16, j * 16, lane);
      mma_bf16(out[2 * j], a[kk], bb[0], bb[1]);
      mma_bf16(out[2 * j + 1], a[kk], bb[2], bb[3]);
    }
}

// one 16 x 64 accumulator tile's n8 tile j into the A operand of k16 step
// j / 2 (the accumulator layout of two n8 tiles is the A layout of a k16 step)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], int j, const float (&v)[4]) {
  a[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
  a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// rows ty ... of a 16 x D accumulator (times `mul`) to a contiguous
// (B, N, H, D) bf16 tensor; rows at or past N skipped
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                          float mul, int b, int h, int row0, int N, int H, int g,
                                          int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = row0 + g + 8 * half;
    if (n >= N) continue;
    bf16* row = dst + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// K8, bf16: dK, dV of one 64-key tile; warp w owns keys 16 w ... 16 w + 15
template <int D>
__global__ void __launch_bounds__(kMmaThreads) dkv_mma_kernel(const Args a) {
  using S = MmaSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + S::kTile;
  bf16* sQ = sV + S::kTile;
  bf16* sdO = sQ + S::kTile;
  float* sLse = reinterpret_cast<float*>(sdO + S::kTile);
  float* sDi = sLse + kRows;
  const int n0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kr = (threadIdx.x >> 5) * 16;
  const int N = a.N;
  const bool key_ok[2] = {n0 + kr + g < N, n0 + kr + g + 8 < N};

  stage_tile<D>(sK, static_cast<const bf16*>(a.k), a.sk, b, h, n0, N);
  stage_tile<D>(sV, static_cast<const bf16*>(a.v), a.sv, b, h, n0, N);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  for (int m0 = 0; m0 < N; m0 += kRows) {
    __syncthreads();  // the last query tile's products are done with sQ, sdO
    stage_tile<D>(sQ, static_cast<const bf16*>(a.q), a.sq, b, h, m0, N);
    stage_tile<D>(sdO, static_cast<const bf16*>(a.dout), a.sdo, b, h, m0, N);
    cp_async_commit();
    load_rows(sLse, sDi, a.lse, a.di, b, h, m0, N, a.H);
    cp_async_wait<0>();
    __syncthreads();
    uint32_t pa[4][4], dsa[4][4];  // P^T, dS^T: 16 keys x 64 queries
    {
      float st[8][4], dpt[8][4];
      rows_times_rows<D>(st, sK, sQ, kr, lane);    // S^T / scale
      rows_times_rows<D>(dpt, sV, sdO, kr, lane);  // dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 8 * j + 2 * t + (e & 1);
          p[e] = m0 + q < N && key_ok[e >> 1]
                     ? exp2f(fmaf(st[j][e], a.scale_log2, -sLse[q])) : 0.0f;
          ds[e] = p[e] * (dpt[j][e] - sDi[q]);
        }
        to_a(pa, j, p);
        to_a(dsa, j, ds);
      }
    }
    regs_times_tile<D>(dv, pa, sdO, lane);  // dV += P^T dO
    regs_times_tile<D>(dk, dsa, sQ, lane);  // dK += dS^T q
  }
  store_acc<D>(static_cast<bf16*>(a.dk), dk, a.scale, b, h, n0 + kr, N, a.H, g, t);
  store_acc<D>(static_cast<bf16*>(a.dv), dv, 1.0f, b, h, n0 + kr, N, a.H, g, t);
}

// K9, bf16: dQ of one 64-query tile; warp w owns queries 16 w ... 16 w + 15
template <int D>
__global__ void __launch_bounds__(kMmaThreads) dq_mma_kernel(const Args a) {
  using S = MmaSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + S::kTile;
  bf16* sK = sdO + S::kTile;
  bf16* sV = sK + S::kTile;
  float* sLse = reinterpret_cast<float*>(sV + S::kTile);
  float* sDi = sLse + kRows;
  const int m0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qr = (threadIdx.x >> 5) * 16;
  const int N = a.N;

  stage_tile<D>(sQ, static_cast<const bf16*>(a.q), a.sq, b, h, m0, N);
  stage_tile<D>(sdO, static_cast<const bf16*>(a.dout), a.sdo, b, h, m0, N);
  load_rows(sLse, sDi, a.lse, a.di, b, h, m0, N, a.H);
  const bool q_ok[2] = {m0 + qr + g < N, m0 + qr + g + 8 < N};
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kRows) {
    __syncthreads();  // the last key tile's products are done with sK, sV
    stage_tile<D>(sK, static_cast<const bf16*>(a.k), a.sk, b, h, n0, N);
    stage_tile<D>(sV, static_cast<const bf16*>(a.v), a.sv, b, h, n0, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float lse[2] = {sLse[qr + g], sLse[qr + g + 8]};
    const float di[2] = {sDi[qr + g], sDi[qr + g + 8]};
    uint32_t dsa[4][4];  // dS: 16 queries x 64 keys
    {
      float s[8][4], dp[8][4];
      rows_times_rows<D>(s, sQ, sK, qr, lane);
      rows_times_rows<D>(dp, sdO, sV, qr, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          const float p = n0 + key < N && q_ok[e >> 1]
                              ? exp2f(fmaf(s[j][e], a.scale_log2, -lse[e >> 1])) : 0.0f;
          ds[e] = p * (dp[j][e] - di[e >> 1]);
        }
        to_a(dsa, j, ds);
      }
    }
    regs_times_tile<D>(dq, dsa, sK, lane);  // dQ += dS k
  }
  store_acc<D>(static_cast<bf16*>(a.dq), dq, a.scale, b, h, m0 + qr, N, a.H, g, t);
}

template <int D>
int launch_mma(const Args& a, int B, bool dkv, cudaStream_t stream) {
  constexpr int smem = MmaSmem<D>::kBytes;
  void (*kernel)(const Args) = dkv ? &dkv_mma_kernel<D> : &dq_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kRows - 1) / kRows, a.H, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int B, int D, int dtype, bool dkv, cudaStream_t stream) {
  if (B <= 0 || a.N <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch_mma<64>(a, B, dkv, stream);
  if (dtype == 0 && D == 128) return launch_mma<128>(a, B, dkv, stream);
  if (dtype == 1 && D == 64) return launch<64>(a, B, dkv, stream);
  if (dtype == 1 && D == 128) return launch<128>(a, B, dkv, stream);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dq, void* dk, void* dv, int N, int H,
               const long long* st, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sq = Strides{st[0], st[1], st[2]};
  a.sk = Strides{st[3], st[4], st[5]};
  a.sv = Strides{st[6], st[7], st[8]};
  a.sdo = Strides{st[9], st[10], st[11]};
  a.N = N;
  a.H = H;
  a.scale = scale;
  a.scale_log2 = scale * attn::kLog2e;
  return a;
}

}  // namespace

// q, k, v, dout: (B, N, H, D) with unit stride along D; strides (elements)
// along B, N and H of q, k, v and dout, in that order: 12 values. lse, di:
// (B, H, N) float32. dk, dv (K8) or dq (K9): contiguous (B, N, H, D) of
// the inputs' dtype (0 bf16, 1 float32). scale: the softmax scale.
ROMA_EXPORT int roma_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* di,
                                        void* dk, void* dv, int B, int N, int H, int D,
                                        const long long* strides, float scale, int dtype,
                                        void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, nullptr, dk, dv, N, H, strides, scale);
  return dispatch(a, B, D, dtype, true, static_cast<cudaStream_t>(stream));
}

ROMA_EXPORT int roma_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* di,
                                       void* dq, int B, int N, int H, int D,
                                       const long long* strides, float scale, int dtype,
                                       void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, dq, nullptr, nullptr, N, H, strides, scale);
  return dispatch(a, B, D, dtype, false, static_cast<cudaStream_t>(stream));
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
