// Flash attention forward, no mask: o = softmax(q k^T / sqrt(d)) v on
// (B, N, H, d) bf16 with fp32 accumulation, d in {64, 128}.
//
// Replaces the TPU kernel used by roma_tpu/models/transformer.py
// (_flash_attention -> the Pallas TPU flash_attention library kernel). The
// TPU version padded N to a multiple of 128 and masked the pad with
// segment ids; here the ragged tail of the last key tile is masked in the
// kernel and the last query tile's extra rows are simply not stored.
//
// Bound on the H100: operations (4 N^2 d FLOPs per head against 8 N d
// bytes; at N = 1601, d = 64 that is ~400 FLOPs a byte, above the card's
// bf16 ridge). Design (FlashAttention-2 style, first correct version):
// one 128-thread block per (64-query tile, head, image); each warp owns 16
// query rows, keeps its Q fragments in registers and its output tile and
// running max/sum in fp32 registers. K and V tiles of 64 keys are staged
// in padded shared memory (conflict-free fragment loads) and multiplied
// with mma.sync m16n8k16 bf16 tensor-core instructions; the probabilities
// go from the S accumulators straight into the A fragments of P.V. The
// logits never reach device memory. No double buffering or wgmma yet.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // query rows per block (16 per warp)
constexpr int kBN = 64;  // keys per tile
constexpr int kPad = 8;  // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long sn, int row0,
                                          int N, int tid) {
  constexpr int kLD = D + kPad;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBN * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int n = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) v = *reinterpret_cast<const uint4*>(src + n * sn + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kLD + c * 8) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                 long long q_sb, long long q_sn, long long q_sh,
                 long long k_sb, long long k_sn, long long k_sh,
                 long long v_sb, long long v_sn, long long v_sh,
                 long long o_sb, long long o_sn, long long o_sh,
                 float scale_log2) {
  constexpr int kLD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBM * kLD;
  bf16* sV = sK + kBN * kLD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the 8-row group
  const int t = lane & 3;   // column pair within the quad
  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<D>(sQ, qb, q_sn, m0, N, tid);
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* base = sQ + (warp * 16) * kLD + ks * 16 + t * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(base + g * kLD);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * kLD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(base + g * kLD + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * kLD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;  // running max, rows g and g + 8
  float sum0 = 0.0f, sum1 = 0.0f;          // this thread's share of the row sums

  const int n_tiles = (N + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(sK, kb, k_sn, kt * kBN, N, tid);
    load_tile<D>(sV, vb, v_sn, kt * kBN, N, tid);
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* kp = sK + (nt * 8 + g) * kLD + ks * 16 + t * 2;
        mma_bf16(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kBN + nt * 8 + t * 2 + (e & 1);
        s[nt][e] = col < N ? s[nt][e] * scale_log2 : -CUDART_INF_F;
      }
      tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
      tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
    }
    tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 1));
    tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 2));
    tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 1));
    tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 2));
    // every tile holds at least one valid key, so the new max is finite
    const float new0 = fmaxf(mx0, tm0);
    const float new1 = fmaxf(mx1, tm1);
    const float c0 = exp2f(mx0 - new0);
    const float c1 = exp2f(mx1 - new1);
    mx0 = new0;
    mx1 = new1;
    sum0 *= c0;
    sum1 *= c1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - new0);
      s[nt][1] = exp2f(s[nt][1] - new0);
      s[nt][2] = exp2f(s[nt][2] - new1);
      s[nt][3] = exp2f(s[nt][3] - new1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }

#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
      const bf16* vp = sV + (j * 16 + t * 2) * kLD + g;
#pragma unroll
      for (int ot = 0; ot < D / 8; ++ot) {
        const bf16* vv = vp + ot * 8;
        const uint32_t b0 = pack_bf16(vv[0], vv[kLD]);
        const uint32_t b1 = pack_bf16(vv[8 * kLD], vv[9 * kLD]);
        mma_bf16(acc[ot], a, b0, b1);
      }
    }
  }

  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  const float inv0 = 1.0f / sum0;
  const float inv1 = 1.0f / sum1;
  const int r0 = m0 + warp * 16 + g;
  const int r1 = r0 + 8;
  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int ot = 0; ot < D / 8; ++ot) {
    const int col = ot * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_sn + col) = pack_f32(acc[ot][0] * inv0, acc[ot][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_sn + col) = pack_f32(acc[ot][2] * inv1, acc[ot][3] * inv1);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int H,
           const long long* st, float scale_log2, cudaStream_t stream) {
  const int smem = (kBM + 2 * kBN) * (D + kPad) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<D><<<grid, 128, smem, stream>>>(
      q, k, v, o, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, d) bf16 with unit stride along d; strides (in
// elements, multiples of 8, 16-byte aligned pointers) are given for the
// B, N and H axes of q, k, v and o, in that order: 12 values.
ROMA_EXPORT int roma_flash_attn(const void* q, const void* k, const void* v, void* o,
                                int B, int N, int H, int D, const long long* strides,
                                float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qi = static_cast<const bf16*>(q);
  auto ki = static_cast<const bf16*>(k);
  auto vi = static_cast<const bf16*>(v);
  auto oo = static_cast<bf16*>(o);
  switch (D) {
    case 64: return launch<64>(qi, ki, vi, oo, B, N, H, strides, scale_log2, s);
    case 128: return launch<128>(qi, ki, vi, oo, B, N, H, strides, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
