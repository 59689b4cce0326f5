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
// With S = scale q k^T, P = exp(S - lse) (lse from the forward, per row,
// natural log; converted to log2 units on load), di = rowsum(o * dO)
// (computed by the wrapper, as JAX computes it in XLA), dP = dO v^T and
// dS = P * (dP - di):
//   dV = P^T dO,   dK = scale dS^T q,   dQ = scale dS k.
// K8 gives a block one tile of keys of one (b, h) and walks the query
// tiles; K9 gives a block one tile of queries and walks the key tiles. Each
// output element is summed by one thread in a fixed order, with no atomics,
// so the result is deterministic, and the work splits as JAX splits it.
// Ragged N is masked inside. The gradients are written in the input's
// dtype; the sums are float32.
//
// Bound on the H100: operations. At the decoder's training shape (2, 1600,
// 8, 128) one N^2 d product is 1.05e10 FLOPs, 0.0106 ms at the bf16
// tensor-core peak: K8 runs four (0.042 ms) and K9 three (0.032 ms).
//
// bf16 (the training path), d = 64 and 128 alike: FlashAttention-3's
// backward shape, on the design of the forward (flash_attn.cu). A block is
// two consumer warpgroups and one producer warpgroup (384 threads). One
// producer thread loads tiles by TMA (cp.async.bulk.tensor, 128-byte
// swizzle; the tensor maps describe strided q/k/v views directly, rows past
// N read as zeros) into a two-stage ring guarded by full/empty mbarriers;
// setmaxnreg gives the producer's registers to the consumers (24 and 240
// a thread: 128 x 24 + 256 x 240 = 384 x 168, the launch's allocation).
// The consumers run every product on wgmma with fp32 accumulators: the
// products of rows with rows (S, dP or their transposes) with both
// operands K-major in shared memory; those with P or dS as the A operand
// in registers (the accumulator layout of a 64-row tile is the A-register
// layout, so P and dS are cast to bf16 where they are formed, as the
// forward casts P) and the walking tile's rows read MN-major straight from
// the swizzled TMA tile, as the forward reads V. P and dS are rounded to
// bf16 before their products, as in FlashAttention-2/3; dS is formed from
// P in fp32.
// - K8: warpgroup w owns keys n0 + 64 w ... + 63 (128 keys a block); K and
//   V are loaded once. The ring carries 64-query Q and dO tiles; with each
//   the producer's first warp stages the tile's 64 lse (log2) and di values
//   (plain loads: N * 4 bytes is no TMA stride), arriving on the stage's
//   full barrier beside the TMA bytes. Per tile: S^T = K Q^T and dP^T =
//   V dO^T (m64n64k16, ss), P^T = exp2(S^T scale_log2 - lse) and dS^T =
//   P^T (dP^T - di) on the accumulators (queries along the columns, lse
//   and di read from the stage), then dV += P^T dO and dK += dS^T Q
//   (m64n{D}k16, rs). Registers: dK and dV 2 x D / 2, S^T and dP^T 2 x 32,
//   P^T and dS^T as bf16 A operands 2 x 16: at d = 128, 224 of the 240.
//   No mask: keys past N are not stored; queries past N have zero Q and dO
//   rows, lse = di = 0, so their P = 1 and dS = 0 add nothing.
// - K9: warpgroup w owns queries m0 + 64 w ... + 63 (128 queries a block);
//   Q and dO are loaded once, each thread's two rows of lse and di come
//   from global memory into registers. The ring carries 128-key K and V
//   tiles. Per tile: S = Q K^T and dP = dO V^T (m64n128k16, ss), P and dS
//   on the accumulators (P set to 0 past N on the ragged last tile only),
//   then dQ += dS K (m64n{D}k16, rs, K MN-major). Registers: dQ D / 2, S
//   and dP 2 x 64, dS 32 as bf16: at d = 128, 224.
// Shared memory (d = 128; d = 64 halves every tile): K8 K + V 64 KB, the
// ring 2 x (Q + dO) 64 KB, lse and di 1 KB: 130 KB; K9 Q + dO 64 KB, the
// ring 2 x (K + V) 128 KB: 194 KB. At the training shape each kernel's
// grid is 13 x 8 x 2 = 208 blocks, one a SM (the registers allow one; K9's
// shared memory too): 208 / 132 = 1.58 waves.
// What holds K8 back (kernel_variants.py ablations, PERF.md): no single
// phase; removing the exponentials, the S^T/dP^T products or the dK/dV
// products saves 17-27% each, and a third ring stage, one arrival a warp,
// turn-taking between the warpgroups, or a persistent schedule of 64-key
// units a warpgroup (one warpgroup alone on an SM in the second wave) each
// moves it 2% or less: each warpgroup's chain of dependent products and
// exponentials is latency-bound, and two warpgroups are all the registers
// allow. Issuing the next tile's S^T/dP^T before waiting on dV/dK needs 32
// more registers than the 240 (ptxas spills and serialises the wgmmas).
//
// float32: the simple FMA tiles of attn_simple.cuh (the correctness path).

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

// ---------------------------------------------------------------- bf16: TMA + wgmma

constexpr int kWG = 2;                        // consumer warpgroups a block
constexpr int kConsumers = 128 * kWG;
constexpr int kWgThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kBlockRows = 64 * kWG;          // a block's keys (K8) or queries (K9)
constexpr int kQueryTile = 64;                // K8's walking query tiles
constexpr int kKeyTile = 128;                 // K9's walking key tiles
constexpr int kStages = 2;                    // ring depth (3 and 4 measured no faster)
constexpr int kRowBytes = 128;                // a swizzled row: 64 bf16 columns of d
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Byte offsets from the 1024-aligned base: the block's fixed tiles, the
// ring of walking tiles, K8's lse and di rows, the mbarriers. A tile of
// d = 128 is two boxes of 64 columns.
template <int D, int kWalkRows>
struct Layout {
  static constexpr int kFixedBox = kBlockRows * kRowBytes;
  static constexpr int kFixed = (D / 64) * kFixedBox;
  static constexpr int kWalkBox = kWalkRows * kRowBytes;
  static constexpr int kWalk = (D / 64) * kWalkBox;
  static constexpr int kFixed0 = 0;                    // K (K8) or Q (K9)
  static constexpr int kFixed1 = kFixed;               // V (K8) or dO (K9)
  static constexpr int kWalk0 = 2 * kFixed;            // ring: Q (K8) or K (K9)
  static constexpr int kWalk1 = kWalk0 + kStages * kWalk;  // ring: dO (K8) or V (K9)
  static constexpr int kRowsF = kWalk1 + kStages * kWalk;  // K8: lse, di a stage
  static constexpr int kBar = kRowsF + kStages * 2 * kQueryTile * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // barriers, alignment slack
};
template <int D>
using DkvLayout = Layout<D, kQueryTile>;
template <int D>
using DqLayout = Layout<D, kKeyTile>;

// 2^x in one MUFU instruction (flush-to-zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (64 x NC) = A (this warpgroup's 64 rows) times the NC rows of B, over
// d: both K-major in swizzled tiles, 16 columns of d a step (box kk / 4,
// 32 bytes a step inside the 128-byte row)
template <int D, int NC>
__device__ __forceinline__ void issue_rows(float (&acc)[NC / 2], uint32_t a, int a_box, uint32_t b,
                                           int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sw128_desc(a + (kk >> 2) * a_box + (kk & 3) * 32, 16);
    const uint64_t db = sw128_desc(b + (kk >> 2) * b_box + (kk & 3) * 32, 16);
    if constexpr (NC == 64)
      wgmma_ss_m64n64k16(acc, da, db, kk > 0);
    else
      wgmma_ss_m64n128k16(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A (64 x KR, bf16 registers) times the KR rows of a
// walking tile read MN-major: 16 rows a step; the next 64 columns of d lie
// one box further on (the leading offset)
template <int D, int KR>
__device__ __forceinline__ void issue_regs(float (&acc)[D / 2], const uint32_t (&a)[KR / 16][4],
                                           uint32_t b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * kRowBytes, b_box);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16(acc, a[kk], db);
    else
      wgmma_rs_m64n128k16(acc, a[kk], db);
  }
}

// the rows of a 64-row accumulator this thread holds (rows g and g + 8 of
// its warp's 16), times `mul`, to a contiguous (B, N, H, D) bf16 tensor;
// rows at or past N skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           float mul, int b, int h, int r0, int N, int H, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = r0 + 8 * half;
    if (n >= N) continue;
    bf16* row = dst + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int k = 0; k < D / 8; ++k)
      *reinterpret_cast<uint32_t*>(row + 8 * k + 2 * t) =
          pack_bf16(acc[4 * k + 2 * half] * mul, acc[4 * k + 2 * half + 1] * mul);
  }
}

// K8, bf16: dK, dV of 128 keys of one (b, h)
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                 const Args a) {
  using L = DkvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms repeat every 1024 bytes
  float* rows_f = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRowsF);
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kStages + s); };
  const int n0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int m_tiles = (N + kQueryTile - 1) / kQueryTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA bytes' arrival and the lse/di warp's 32
      mbar_init(empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread issues the loads, its warp stages lse and di;
    // each empty barrier starts in phase 0, so the first wait (parity 1) passes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int lane = tid - kConsumers;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kFixed);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kFixed0 + c * L::kFixedBox, &mk, kv_full, c * 64, h, n0, b);
        tma_load_4d(base + L::kFixed1 + c * L::kFixedBox, &mv, kv_full, c * 64, h, n0, b);
      }
    }
    const long long row0 = ((long long)b * a.H + h) * N;
    for (int j = 0; j < m_tiles; ++j) {
      const int s = j % kStages;
      const int m0 = j * kQueryTile;
      mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * L::kWalk);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kWalk0 + s * L::kWalk + c * L::kWalkBox, &mq, full(s), c * 64, h,
                      m0, b);
          tma_load_4d(base + L::kWalk1 + s * L::kWalk + c * L::kWalkBox, &mdo, full(s), c * 64,
                      h, m0, b);
        }
      }
      float* sl = rows_f + s * 2 * kQueryTile;
      for (int r = lane; r < kQueryTile; r += 32) {
        const bool ok = m0 + r < N;
        sl[r] = ok ? a.lse[row0 + m0 + r] * attn::kLog2e : 0.0f;
        sl[kQueryTile + r] = ok ? a.di[row0 + m0 + r] : 0.0f;
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // consumer warpgroup wg: keys n0 + 64 wg ...; in the accumulator layout
  // this thread holds rows g and g + 8 of its warp's 16, columns
  // 8 i + 2 t + {0, 1} at index 4 i + {0, 1} / {2, 3}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const uint32_t k_rows = base + L::kFixed0 + wg * 64 * kRowBytes;
  const uint32_t v_rows = base + L::kFixed1 + wg * 64 * kRowBytes;
  const float scale_log2 = a.scale_log2;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  mbar_wait(kv_full, 0);

  for (int j = 0; j < m_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);
    const uint32_t q_t = base + L::kWalk0 + s * L::kWalk;
    const uint32_t do_t = base + L::kWalk1 + s * L::kWalk;
    const float* sl = rows_f + s * 2 * kQueryTile;
    float st[32], dpt[32];  // S^T, dP^T: 64 keys x 64 queries
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    issue_rows<D, 64>(st, k_rows, L::kFixedBox, q_t, L::kWalkBox);
    wgmma_commit();
    issue_rows<D, 64>(dpt, v_rows, L::kFixedBox, do_t, L::kWalkBox);
    wgmma_commit();
    wgmma_wait1();
    fence_regs(st);
    uint32_t pa[4][4], dsa[4][4];  // P^T, dS^T as bf16 A operands (k = queries)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * i + 2 * t);
      st[4 * i] = ex2(fmaf(st[4 * i], scale_log2, -l.x));
      st[4 * i + 1] = ex2(fmaf(st[4 * i + 1], scale_log2, -l.y));
      st[4 * i + 2] = ex2(fmaf(st[4 * i + 2], scale_log2, -l.x));
      st[4 * i + 3] = ex2(fmaf(st[4 * i + 3], scale_log2, -l.y));
      pa[i >> 1][(i & 1) * 2] = pack_bf16(st[4 * i], st[4 * i + 1]);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(st[4 * i + 2], st[4 * i + 3]);
    }
    wgmma_wait0();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 d = *reinterpret_cast<const float2*>(sl + kQueryTile + 8 * i + 2 * t);
      dsa[i >> 1][(i & 1) * 2] =
          pack_bf16(st[4 * i] * (dpt[4 * i] - d.x), st[4 * i + 1] * (dpt[4 * i + 1] - d.y));
      dsa[i >> 1][(i & 1) * 2 + 1] =
          pack_bf16(st[4 * i + 2] * (dpt[4 * i + 2] - d.x), st[4 * i + 3] * (dpt[4 * i + 3] - d.y));
    }
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    issue_regs<D, kQueryTile>(dv, pa, do_t, L::kWalkBox);   // dV += P^T dO
    issue_regs<D, kQueryTile>(dk, dsa, q_t, L::kWalkBox);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    mbar_arrive(empty(s));
  }
  const int r0 = n0 + wg * 64 + warp * 16 + (lane >> 2);
  store_rows<D>(static_cast<bf16*>(a.dk), dk, a.scale, b, h, r0, N, a.H, t);
  store_rows<D>(static_cast<bf16*>(a.dv), dv, 1.0f, b, h, r0, N, a.H, t);
}

// K9, bf16: dQ of 128 queries of one (b, h)
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                const Args a) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  const int m0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_tiles = (N + kKeyTile - 1) / kKeyTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, 2 * L::kFixed);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kFixed0 + c * L::kFixedBox, &mq, q_full, c * 64, h, m0, b);
        tma_load_4d(base + L::kFixed1 + c * L::kFixedBox, &mdo, q_full, c * 64, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kWalk);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kWalk0 + s * L::kWalk + c * L::kWalkBox, &mk, full(s), c * 64, h,
                      j * kKeyTile, b);
          tma_load_4d(base + L::kWalk1 + s * L::kWalk + c * L::kWalkBox, &mv, full(s), c * 64, h,
                      j * kKeyTile, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const uint32_t q_rows = base + L::kFixed0 + wg * 64 * kRowBytes;
  const uint32_t do_rows = base + L::kFixed1 + wg * 64 * kRowBytes;
  const float scale_log2 = a.scale_log2;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const long long row0 = ((long long)b * a.H + h) * N;
  const float l0 = r0 < N ? a.lse[row0 + r0] * attn::kLog2e : 0.0f;
  const float l1 = r0 + 8 < N ? a.lse[row0 + r0 + 8] * attn::kLog2e : 0.0f;
  const float d0 = r0 < N ? a.di[row0 + r0] : 0.0f;
  const float d1 = r0 + 8 < N ? a.di[row0 + r0 + 8] : 0.0f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);
    const uint32_t k_t = base + L::kWalk0 + s * L::kWalk;
    const uint32_t v_t = base + L::kWalk1 + s * L::kWalk;
    float sc[64], dp[64];  // S, dP: 64 queries x 128 keys
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_rows<D, kKeyTile>(sc, q_rows, L::kFixedBox, k_t, L::kWalkBox);
    wgmma_commit();
    issue_rows<D, kKeyTile>(dp, do_rows, L::kFixedBox, v_t, L::kWalkBox);
    wgmma_commit();
    wgmma_wait1();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[4 * i] = ex2(fmaf(sc[4 * i], scale_log2, -l0));
      sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], scale_log2, -l0));
      sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], scale_log2, -l1));
      sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], scale_log2, -l1));
    }
    const int valid = N - j * kKeyTile;
    if (valid < kKeyTile) {  // the ragged last tile only: keys past N
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * i + 2 * t + (e & 1) >= valid) sc[4 * i + e] = 0.0f;
    }
    wgmma_wait0();
    fence_regs(dp);
    uint32_t dsa[kKeyTile / 16][4];  // dS as bf16 A operands (k = keys)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dsa[i >> 1][(i & 1) * 2] =
          pack_bf16(sc[4 * i] * (dp[4 * i] - d0), sc[4 * i + 1] * (dp[4 * i + 1] - d0));
      dsa[i >> 1][(i & 1) * 2 + 1] =
          pack_bf16(sc[4 * i + 2] * (dp[4 * i + 2] - d1), sc[4 * i + 3] * (dp[4 * i + 3] - d1));
    }
    fence_regs(dq);
    fence_regs(dsa);
    wgmma_fence();
    issue_regs<D, kKeyTile>(dq, dsa, k_t, L::kWalkBox);  // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);
    fence_regs(dsa);
    mbar_arrive(empty(s));
  }
  store_rows<D>(static_cast<bf16*>(a.dq), dq, a.scale, b, h, r0, N, a.H, t);
}

template <int D>
int launch_wgmma(const Args& a, int B, bool dkv, cudaStream_t stream) {
  const long long st[12] = {a.sq.b, a.sq.n, a.sq.h, a.sk.b, a.sk.n, a.sk.h,
                            a.sv.b, a.sv.n, a.sv.h, a.sdo.b, a.sdo.n, a.sdo.h};
  const int q_rows = dkv ? kQueryTile : kBlockRows;  // the box rows of q and dO, k and v
  const int kv_rows = dkv ? kBlockRows : kKeyTile;
  CUtensorMap maps[4];
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    const int rc = encode_bnhd_map(&maps[i], ptrs[i], B, a.N, a.H, D,
                                   i == 0 || i == 3 ? q_rows : kv_rows, st + 3 * i);
    if (rc != 0) return rc;
  }
  const dim3 grid((a.N + kBlockRows - 1) / kBlockRows, a.H, B);
  cudaError_t err;
  if (dkv) {
    constexpr int smem = DkvLayout<D>::kBytes;
    err = cudaFuncSetAttribute(dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  } else {
    constexpr int smem = DqLayout<D>::kBytes;
    err = cudaFuncSetAttribute(dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dq_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int B, int D, int dtype, bool dkv, cudaStream_t stream) {
  if (B <= 0 || a.N <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch_wgmma<64>(a, B, dkv, stream);
  if (dtype == 0 && D == 128) return launch_wgmma<128>(a, B, dkv, stream);
  if (dtype == 1 && D == 64) return launch<64>(a, B, dkv, stream);
  if (dtype == 1 && D == 128) return launch<128>(a, B, dkv, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// blocks an SM holds at once of the kernel that `dispatch` launches
template <int D>
int blocks_per_sm(int dtype, bool dkv, int* per_sm) {
  if (dtype == 0)
    return dkv ? occupancy(dkv_wgmma_kernel<D>, kWgThreads, DkvLayout<D>::kBytes, per_sm)
               : occupancy(dq_wgmma_kernel<D>, kWgThreads, DqLayout<D>::kBytes, per_sm);
  return dkv ? occupancy(dkv_kernel<D>, kThreads, bwd_smem_bytes<D>(), per_sm)
             : occupancy(dq_kernel<D>, kThreads, bwd_smem_bytes<D>(), per_sm);
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

// The launch that K8 (dkv != 0) or K9 makes for (B, N, H, D) in `dtype`:
// out[0] its blocks, out[1] the blocks an SM holds at once (the occupancy
// calculator, with the kernel's shared memory), out[2] the card's SMs.
ROMA_EXPORT int roma_flash_attn_bwd_grid(int B, int N, int H, int D, int dtype, int dkv,
                                         int* out) {
  if (B <= 0 || N <= 0 || H <= 0 || (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int rows = dtype == 0 ? kBlockRows : kRows;
  out[0] = (N + rows - 1) / rows * H * B;
  const int rc = D == 64 ? blocks_per_sm<64>(dtype, dkv != 0, &out[1])
                         : blocks_per_sm<128>(dtype, dkv != 0, &out[1]);
  if (rc != 0) return rc;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
