// Flash attention forward, no mask: o = softmax(q k^T / sqrt(d)) v on
// (B, N, H, d) bf16 with fp32 accumulation, d in {64, 128}; with an `lse`
// pointer it also writes each row's log-sum-exp of the scaled logits, the
// residual that the backward kernels (flash_attn_bwd.cu) read. A float32
// entry (roma_flash_attn_f32) runs the simple FMA kernel of
// attn_simple.cuh, with the same optional lse.
//
// Replaces the TPU kernel used by roma_tpu/models/transformer.py
// (_flash_attention -> the Pallas TPU flash_attention library kernel). The
// TPU version padded N to a multiple of 128 and masked the pad with
// segment ids; here TMA's out-of-bounds zero fill covers the ragged tiles,
// the last key tile alone is masked, and rows past N are not stored.
//
// Bound on the H100: operations (4 N^2 d FLOPs per head against 8 N d
// bytes; at N = 1601, d = 64 that is ~400 FLOPs a byte, above the card's
// bf16 ridge of ~295). Only wgmma reaches the tensor cores' full rate, and
// only if the operands arrive without the threads spending instructions on
// them: the previous mma.sync design built every V fragment from four
// scalar 16-bit shared loads and loaded K/V synchronously between two
// __syncthreads per tile, so it was bound by shared-memory instructions.
//
// Design (FlashAttention-3-shaped): persistent blocks, one per SM, each
// walking query tiles of (image, head) pairs: consumer warpgroups of 64
// query rows each (three at d = 64, 192-row tiles; two at d = 128) and a
// producer warpgroup whose registers setmaxnreg hands to the consumers (160
// or 232 a thread: S, P twice and O without spilling or serialising the
// wgmmas). One producer thread loads Q and K/V tiles of 128 keys by TMA
// (cp.async.bulk.tensor, 128-byte swizzle) into a two-stage ring guarded by
// full/empty mbarriers, running ahead into the next query tile while the
// consumers finish the last one. The tensor maps describe the (possibly
// strided) q/k/v views directly as 4-d (d, H, N, B) arrays, 64 columns of
// d per box (d = 128 takes two boxes per tile). Each consumer runs S = Q
// K^T as wgmma m64n128k16 with both operands K-major in shared memory, the
// online softmax on the fp32 accumulators (scale folded into one FFMA
// before a single-instruction exp2, the -inf mask on the last key tile
// only), and O += P V as wgmma with P cast to bf16 in registers (the S
// accumulator layout is the A-register layout) and V read as an MN-major
// operand straight from the swizzled TMA tile: no transpose, no trip
// through shared memory. Each turn issues S_j together with P_{j-1} V_{j-1},
// so the softmax of S_j overlaps that product, and the warpgroups take
// turns at the tensor cores (named barriers, in a ring) so that one's
// softmax runs under the others' products. O stays in registers until the
// end. A third consumer warpgroup pays at d = 64, where the exponentials
// weigh as much as the products; with the softmax or the loads removed the
// two-warpgroup kernel barely sped up, so the number of wgmma streams was
// what bounded it.

#include <math_constants.h>

#include "attn_simple.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 128;                // keys per K/V tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kKSub = kRows * 128;        // one 64-column box of a K/V tile

// Consumer warpgroups of 64 query rows each: three at d = 64, two at
// d = 128, where O alone takes 64 registers a thread. The producer
// warpgroup gives its registers to them with setmaxnreg.
template <int D>
struct Layout {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kWG;  // query rows per tile
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kQSub = kBM * 128;  // one 64-column box of the Q tile
  static constexpr int kQBytes = (D / 64) * kQSub;
  static constexpr int kTileBytes = (D / 64) * kKSub;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 128 + 1024;  // barriers, alignment slack
  // registers a producer / consumer thread after setmaxnreg (all 65,536)
  static constexpr int kProducerRegs = kWG == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
};

// 2^x in one MUFU instruction (flush-to-zero; exp2f adds a denormal path)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one warpgroup: 64 query rows x 128 keys, both K-major
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_base, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of d: box kk / 4, 32-byte step inside the swizzled row
    const uint32_t inner = (kk & 3) * 32;
    wgmma_ss_m64n128k16(sc, sw128_desc(q_base + (kk >> 2) * Layout<D>::kQSub + inner, 16),
                        sw128_desc(kt + (kk >> 2) * kKSub + inner, 16), kk > 0);
  }
}

// O += P V: P from registers, V MN-major straight from its TMA tile
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[kRows / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    // 16 keys = 16 rows of 128 bytes; the next 64 columns of d lie one box
    // further on (the MN-major leading offset)
    const uint64_t dv = sw128_desc(vt + kk * 16 * 128, kKSub);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16(acc, pa[kk], dv);
    else
      wgmma_rs_m64n128k16(acc, pa[kk], dv);
  }
}

// Online softmax of one key tile (`valid` of its 128 keys are real): the
// running max and row sums move on, c0/c1 are the factors for O, and P
// comes out as bf16 pairs in the A-operand layout (keys 16 kk ... 16 kk +
// 15 are accumulator columns 8 (2 kk) ... 8 (2 kk + 1) + 7).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int valid, int t, float scale_log2,
                                             float& mx0, float& mx1, float& sum0, float& sum1,
                                             float& c0, float& c1, uint32_t (&p)[kRows / 16][4]) {
  if (valid < kRows) {  // the ragged last tile only
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i * 8 + t * 2 + (e & 1) >= valid) sc[4 * i + e] = -CUDART_INF_F;
  }
  float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tm0 = fmaxf(tm0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    tm1 = fmaxf(tm1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 1));
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 2));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 1));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 2));
  // every tile holds at least one valid key, so the new max is finite
  const float new0 = fmaxf(mx0, tm0 * scale_log2);
  const float new1 = fmaxf(mx1, tm1 * scale_log2);
  c0 = ex2(mx0 - new0);
  c1 = ex2(mx1 - new1);
  mx0 = new0;
  mx1 = new1;
  sum0 *= c0;
  sum1 *= c1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[4 * i] = ex2(fmaf(sc[4 * i], scale_log2, -new0));
    sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], scale_log2, -new0));
    sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], scale_log2, -new1));
    sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], scale_log2, -new1));
    sum0 += sc[4 * i] + sc[4 * i + 1];
    sum1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    p[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                 float* __restrict__ lse, int N, int H, int B, long long o_sb, long long o_sn,
                 long long o_sh, float scale_log2) {
  using L = Layout<D>;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kWG = L::kWG;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to that
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * kStages + s); };

  auto q_empty = [&] { return q_full + 8u * (1 + 4 * kStages); };

  // persistent: block walks tiles blockIdx.x, + gridDim.x, ...; tile t is
  // query rows (t % q_tiles) * kBM ... of head (t / q_tiles) % H, image
  // t / (q_tiles * H). K/V tiles go through the ring in one running count.
  const int tid = threadIdx.x;
  const int q_tiles = (N + L::kBM - 1) / L::kBM;
  const int n_tiles = (N + kRows - 1) / kRows;  // key tiles per query tile
  const int total = q_tiles * H * B;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty(), kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: its registers go to the consumers (setmaxnreg works on whole
    // warpgroups); one thread issues every load; each empty barrier starts
    // in phase 0, so the first wait on it (parity 1) passes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs) : "memory");
    if (tid == kConsumers) {
      int it = 0;  // K/V tiles issued so far
      for (int tile = blockIdx.x, i = 0; tile < total; tile += gridDim.x, ++i) {
        const int m0 = (tile % q_tiles) * L::kBM;
        const int h = (tile / q_tiles) % H;
        const int b = tile / (q_tiles * H);
        mbar_wait(q_empty(), (i & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQBytes);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sQ + c * L::kQSub, &mq, q_full, c * 64, h, m0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          mbar_wait(k_empty(s), ph ^ 1);
          mbar_expect_tx(k_full(s), L::kTileBytes);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(sK + s * L::kTileBytes + c * kKSub, &mk, k_full(s), c * 64, h,
                        j * kRows, b);
          mbar_wait(v_empty(s), ph ^ 1);
          mbar_expect_tx(v_full(s), L::kTileBytes);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(sV + s * L::kTileBytes + c * kKSub, &mv, v_full(s), c * 64, h,
                        j * kRows, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows m0 + wg * 64 ... + 63 of a tile;
  // in the wgmma accumulator layout this thread holds rows g and g + 8 of
  // its warp's 16, columns 8 i + 2 t + {0, 1} at index 4 i + {0, 1} / {2, 3}
  // S, P twice and O in registers without spilling (and without ptxas
  // serialising the wgmmas for want of registers)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs) : "memory");
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t q_base = sQ + wg * 64 * 128;
  // The warpgroups take turns at the tensor cores in a ring (named
  // barrier 1 + w is warpgroup w's turn): one issues its products while the
  // others run their softmax on the MUFU and FP32 pipes. In each tile the
  // last warpgroup lets warpgroup 0 go first and skips its very last pass,
  // so every arrival is waited for.
  auto my_turn = [&] {
    if (wg == 0)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else if (wg == 1)
      asm volatile("bar.sync 2, 256;\n" ::: "memory");
    else
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
  };
  auto pass_turn = [&] {
    const int next = wg + 1 == kWG ? 0 : wg + 1;
    if (next == 0)
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    else if (next == 1)
      asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    else
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  };

  int it = 0;  // K/V tiles consumed so far
  for (int tile = blockIdx.x, i = 0; tile < total; tile += gridDim.x, ++i) {
    const int m0 = (tile % q_tiles) * L::kBM;
    const int h = (tile / q_tiles) % H;
    const int b = tile / (q_tiles * H);
    if (wg == kWG - 1) pass_turn();

    float acc[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.0f;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;  // running max (log2 units), rows g, g + 8
    float sum0 = 0.0f, sum1 = 0.0f;                  // this thread's share of the row sums
    float sc[64];                                    // S of the newest key tile
    uint32_t pa[kRows / 16][4];                      // P of the tile in the P V product
    float c0, c1;                                    // rescale of O for the newest tile

    // Software pipeline: each turn issues S_j = Q K_j^T together with
    // O += P_{j-1} V_{j-1}; the softmax of S_j runs while the P V product
    // is still on the tensor cores, and O is rescaled once that is done.
    // K/V tile j of this query tile is the ring's tile it + j.
    mbar_wait(q_full, i & 1);
    mbar_wait(k_full(it % kStages), (it / kStages) & 1);
    my_turn();
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, q_base, sK + (it % kStages) * L::kTileBytes);
    wgmma_commit();
    pass_turn();
    wgmma_wait0();
    fence_regs(sc);
    mbar_arrive(k_empty(it % kStages));
    if (n_tiles == 1) mbar_arrive(q_empty());  // the last read of this Q
    softmax_tile(sc, N, t, scale_log2, mx0, mx1, sum0, sum1, c0, c1, pa);

    for (int j = 1; j < n_tiles; ++j) {
      const int s = (it + j) % kStages;
      const int sp = (it + j - 1) % kStages;
      mbar_wait(k_full(s), ((it + j) / kStages) & 1);
      mbar_wait(v_full(sp), ((it + j - 1) / kStages) & 1);
      my_turn();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<D>(sc, q_base, sK + s * L::kTileBytes);
      wgmma_commit();
      issue_pv<D>(acc, pa, sV + sp * L::kTileBytes);
      wgmma_commit();
      pass_turn();
      wgmma_wait1();
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      if (j == n_tiles - 1) mbar_arrive(q_empty());  // the last read of this Q
      uint32_t pn[kRows / 16][4];
      softmax_tile(sc, N - j * kRows, t, scale_log2, mx0, mx1, sum0, sum1, c0, c1, pn);
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(v_empty(sp));
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        acc[4 * k] *= c0;
        acc[4 * k + 1] *= c0;
        acc[4 * k + 2] *= c1;
        acc[4 * k + 3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    }

    const int sl = (it + n_tiles - 1) % kStages;
    mbar_wait(v_full(sl), ((it + n_tiles - 1) / kStages) & 1);
    my_turn();
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<D>(acc, pa, sV + sl * L::kTileBytes);
    wgmma_commit();
    if (wg != kWG - 1) pass_turn();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(v_empty(sl));
    it += n_tiles;

    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.0f / sum0;
    const float inv1 = 1.0f / sum1;
    const int r0 = m0 + wg * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    if (lse != nullptr && t == 0) {  // natural log: (max + log2 sum) ln 2
      float* lrow = lse + ((long long)b * H + h) * N;
      if (r0 < N) lrow[r0] = (mx0 + __log2f(sum0)) * 0.6931471805599453f;
      if (r1 < N) lrow[r1] = (mx1 + __log2f(sum1)) * 0.6931471805599453f;
    }
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const int col = k * 8 + t * 2;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_sn + col) =
            pack_f32(acc[4 * k] * inv0, acc[4 * k + 1] * inv0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_sn + col) =
            pack_f32(acc[4 * k + 2] * inv1, acc[4 * k + 3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, bf16* o, float* lse, int B, int N, int H,
           const long long* st, float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_bnhd_map(&maps[i], ptrs[i], B, N, H, D,
                                   i == 0 ? Layout<D>::kBM : kRows, st + 3 * i);
    if (rc != 0) return rc;
  }
  const int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)((N + Layout<D>::kBM - 1) / Layout<D>::kBM) * H * B;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // one persistent block per SM (its shared memory and registers allow one)
  const int grid = (int)(tiles < sms ? tiles : sms);
  flash_fwd_kernel<D><<<grid, Layout<D>::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], o, lse, N, H, B, st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, d) bf16 with unit stride along d; strides (in
// elements, multiples of 8, 16-byte aligned pointers) are given for the
// B, N and H axes of q, k, v and o, in that order: 12 values. lse: null,
// or (B, H, N) float32 for the rows' log-sum-exp.
ROMA_EXPORT int roma_flash_attn(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int N, int H, int D,
                                const long long* strides, float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto oo = static_cast<bf16*>(o);
  auto ll = static_cast<float*>(lse);
  switch (D) {
    case 64: return launch<64>(q, k, v, oo, ll, B, N, H, strides, scale_log2, s);
    case 128: return launch<128>(q, k, v, oo, ll, B, N, H, strides, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float32 entry: q, k, v (B, N, H, d) float32 with unit stride along
// d, strides of q, k, v (9 values); o contiguous (B, N, H, d) float32;
// lse null or (B, H, N) float32. One block per 64 query rows of one
// (b, h), float32 FMA throughout (attn_simple.cuh).
ROMA_EXPORT int roma_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int H, int D,
                                    const long long* strides, float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ll = static_cast<float*>(lse);
  switch (D) {
    case 64: return attn::launch_fwd<64>(q, k, v, o, ll, B, N, H, strides, scale_log2, s);
    case 128: return attn::launch_fwd<128>(q, k, v, o, ll, B, N, H, strides, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
