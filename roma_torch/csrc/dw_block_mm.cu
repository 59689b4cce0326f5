// One whole depthwise-separable refiner block in one launch, planar NCHW
// bf16, C = D <= 160:
//   y = bf16(relu(dw5x5(x) * scale + shift))        (zeros padding 2)
//   z = bf16(M^T y + bias)                           (C x C 1x1 conv)
//
// Replaces the TPU kernel roma_tpu/ops/pallas/depthwise.py
// (dw5x5_affine_relu_mm -> _mm_tpu_path -> _pallas_call_ncw_mm:
// _kernel_ncw_mm), with its two bf16 rounding points. As in the JAX
// package no model path reaches it: the JAX refiner measured and rejected
// it for scale 2 on the TPU, and the port adds no routing the JAX package
// lacks. It is reached from the tests and from chip_smoke.py's kernel
// phase, which times it beside K4 + cuDNN's 1x1 at the same shapes.
//
// Bound on the H100: bytes at C = 24 and 144 (at C = 144 about 2 * 144 +
// 53 FLOPs per element of y against 4 bytes moved per element, under the
// card's bf16 FLOP:byte ratio). Design (first correct version): one
// 256-thread block per 4 x 32 pixel tile (128 pixels) of one image. C is
// padded to Cp, a multiple of 16, with zeros in shared memory.
//   1. For each 16-channel chunk, the (4+4) x (32+4) halo of the chunk's
//      channels is staged in shared memory as float (channel stride skewed
//      by 4 words, so float4 reads are conflict-free); each thread computes
//      8 adjacent pixels of one channel from a sliding register window and
//      writes bf16(relu(...)) into a pixel-major y tile (128 x Cp).
//   2. The Cp x Cp mix runs on the tensor cores: mma.sync m16n8k16 bf16
//      with fp32 accumulation, A = the y tile, B = M^T (the wrapper passes
//      it transposed and zero-padded), both with 8 elements of row padding
//      (conflict-free fragment loads). Each warp owns 16 pixels and walks
//      the output channels 32 at a time; z + bias is rounded to bf16 and
//      stored straight from the accumulators.
// Shared memory at C = 144: M^T 43.8 KB + y 38.9 KB + halo 18.7 KB, above
// the 48 KB default, hence cudaFuncSetAttribute.

#include "common.cuh"

namespace {

constexpr int kTH = 4;
constexpr int kTW = 32;
constexpr int kP = kTH * kTW;        // pixels per block (8 warps x 16)
constexpr int kThreads = 256;
constexpr int kChunk = 16;           // channels per depthwise pass
constexpr int kHH = kTH + 4;
constexpr int kHW = kTW + 4;         // 36 floats: rows stay 16-byte aligned
constexpr int kHCh = kHH * kHW + 4;  // channel stride in floats, skewed by 4 banks
constexpr int kMaxC = 160;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

int smem_bytes(int Cp) {
  return (Cp + kP) * (Cp + 8) * (int)sizeof(bf16) + kChunk * kHCh * (int)sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
dw_block_mm_kernel(const bf16* __restrict__ x, bf16* __restrict__ z,
                   const bf16* __restrict__ w,       // (5, 5, C)
                   const float* __restrict__ scale,  // (C,)
                   const float* __restrict__ shift,  // (C,)
                   const bf16* __restrict__ mt,      // (Cp, Cp): mt[d][c] = m[c][d], zero-padded
                   const float* __restrict__ bias,   // (C,)
                   int C, int Cp, int H, int W, int tiles_w, int tiles_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = Cp + 8;  // bf16 row stride of sM and sY
  bf16* sM = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = sM + Cp * ld;
  float* sH = reinterpret_cast<float*>(sY + kP * ld);

  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int tw = (int)(blk % tiles_w);
  const long long rest = blk / tiles_w;
  const int th = (int)(rest % tiles_h);
  const long long b = rest / tiles_h;
  const int y0 = th * kTH;
  const int x0 = tw * kTW;
  const long long plane = (long long)H * W;
  const bf16* xb = x + b * C * plane;

  const int row_chunks = Cp / 8;  // 16-byte chunks per row of M^T
  for (int i = tid; i < Cp * row_chunks; i += kThreads) {
    const int r = i / row_chunks;
    const int c8 = i - r * row_chunks;
    *reinterpret_cast<uint4*>(sM + r * ld + c8 * 8) =
        *reinterpret_cast<const uint4*>(mt + (long long)r * Cp + c8 * 8);
  }

  // ---- 1. depthwise + affine + ReLU into the bf16 y tile, 16 channels at a time
  const int cc = tid & (kChunk - 1);
  const int pg = tid / kChunk;          // 16 pixel groups of 8
  const int pr = pg >> 2;               // tile row 0..3
  const int pc = (pg & 3) * 8;          // first tile column 0/8/16/24
  for (int c0 = 0; c0 < Cp; c0 += kChunk) {
    __syncthreads();  // the previous chunk's halo is no longer read
    for (int i = tid; i < kChunk * kHH * kHW; i += kThreads) {
      const int ch = i / (kHH * kHW);
      const int rem = i - ch * (kHH * kHW);
      const int r = rem / kHW;
      const int col = rem - r * kHW;
      const int c = c0 + ch;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + col;
      float v = 0.0f;
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = bf2f(xb[c * plane + (long long)gy * W + gx]);
      sH[ch * kHCh + r * kHW + col] = v;
    }
    const int c = c0 + cc;
    float wr[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) wr[k] = c < C ? bf2f(w[k * C + c]) : 0.0f;
    const float sc = c < C ? scale[c] : 0.0f;
    const float sh = c < C ? shift[c] : 0.0f;
    __syncthreads();

    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const float* hr = sH + cc * kHCh + (pr + dy) * kHW + pc;
      const float4 a = *reinterpret_cast<const float4*>(hr);
      const float4 bq = *reinterpret_cast<const float4*>(hr + 4);
      const float4 e = *reinterpret_cast<const float4*>(hr + 8);
      const float v[12] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w, e.x, e.y, e.z, e.w};
#pragma unroll
      for (int dx = 0; dx < 5; ++dx)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(v[j + dx], wr[dy * 5 + dx], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = pr * kTW + pc + j;
      sY[p * ld + c] = __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(acc[j], sc), sh), 0.0f));
    }
  }
  __syncthreads();

  // ---- 2. the 1x1 mix on the tensor cores, z + bias stored as bf16
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = warp * 16;                  // this warp's 16 pixels, one tile row
  const int gy = y0 + m0 / kTW;
  const int gx0 = x0 + (m0 % kTW) + g;
  const int gx1 = gx0 + 8;
  const bool row_ok = gy < H;
  bf16* zr = z + b * C * plane + (long long)gy * W;
  for (int n0 = 0; n0 < Cp; n0 += 32) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int k0 = 0; k0 < Cp; k0 += 16) {
      const bf16* ap = sY + (m0 + g) * ld + k0 + 2 * t;
      const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * ld), lds32(ap + 8), lds32(ap + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8;
        if (n < Cp) {  // warp-uniform
          const bf16* bp = sM + (n + g) * ld + k0 + 2 * t;
          mma_bf16(acc[j], a, lds32(bp), lds32(bp + 8));
        }
      }
    }
    if (!row_ok) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n0 + j * 8 + 2 * t + e;
        if (d >= C) continue;
        const float bb = bias[d];
        if (gx0 < W) zr[d * plane + gx0] = __float2bfloat16_rn(__fadd_rn(acc[j][e], bb));
        if (gx1 < W) zr[d * plane + gx1] = __float2bfloat16_rn(__fadd_rn(acc[j][2 + e], bb));
      }
    }
  }
}

}  // namespace

// x, z: (B, C, H, W) bf16 contiguous, distinct buffers; w: (5, 5, C) bf16;
// scale, shift, bias: (C,) fp32; mt: (Cp, Cp) bf16, 16-byte aligned, with
// mt[d][c] = m[c][d] (z[d] = sum_c m[c][d] y[c]) and zeros past C; Cp is C
// rounded up to a multiple of 16. 1 <= C <= 160.
ROMA_EXPORT int roma_dw_block_mm(const void* x, void* z, const void* w, const void* scale,
                                 const void* shift, const void* mt, const void* bias,
                                 int B, int C, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int Cp = (C + 15) / 16 * 16;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(Cp);
  cudaError_t err = cudaFuncSetAttribute(dw_block_mm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dw_block_mm_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(z), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const bf16*>(mt), static_cast<const float*>(bias), C, Cp, H, W, tiles_w,
      tiles_h);
  return (int)cudaGetLastError();
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
