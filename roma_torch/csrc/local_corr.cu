// Local correlation around a dense warp, bf16 features, fp32 out.
//
// Replaces the TPU kernel roma_tpu/ops/pallas/block_gather.py
// (local_correlation_dma -> _block_corr -> _kernel). Same function as
// roma_torch/ops/local_corr.py::local_correlation:
//   g[dy][dx] = <bf16(f0[p] / sqrt(C)), f1[y0-r+dy][x0-r+dx]>  (zero outside)
//   out[dy][dx] = w00 g[dy][dx] + w01 g[dy][dx+1] + w10 g[dy+1][dx] + w11 g[dy+1][dx+1]
//
// Bound on the H100: bytes. Each pixel reads (2r+2)^2 rows of C bf16 from
// f1, but neighbouring pixels' windows overlap, so the unique traffic is
// f0 + f1 + flow + out, and the repeated window reads are served from L1/L2.
// Design: one warp per output pixel. The prescaled f0 row lives in the
// lanes' registers (C/32 values each); a corner is one coalesced 256-byte
// sweep of an f1 row per 128 channels plus a shuffle reduction; a corner
// outside the image is skipped (its dot is an exact zero). The (2r+2)^2
// corner dots sit in shared memory for the fused bilinear combine, which
// writes the (2r+1)^2 outputs coalesced. The TPU kernel's S-shift layout,
// per-pixel DMA descriptors and semaphores have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // pixels per block
constexpr int kMaxK2 = 16;      // 2r+2 for r <= 7

template <int NCH>  // C = 128 * NCH; each lane holds NCH groups of 4 channels
__global__ void __launch_bounds__(kWarps * 32)
local_corr_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                  const float* __restrict__ flow, float* __restrict__ out,
                  int B, int H, int W, int r, float scale) {
  constexpr int C = 128 * NCH;
  __shared__ float g_s[kWarps][kMaxK2 * kMaxK2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_pix = (long long)B * H * W;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= n_pix) return;  // whole warp leaves together; no block barrier below
  const int b = (int)(p / ((long long)H * W));

  // f0 row, prescaled by 1/sqrt(C) and rounded to bf16 like the plain version
  float a[NCH][4];
  const bf16* f0p = f0 + p * C;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const uint2 raw = *reinterpret_cast<const uint2*>(f0p + (j * 32 + lane) * 4);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[j][i] = round_bf16(__fmul_rn(bf2f(v[i]), scale));
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
  const bf16* f1b = f1 + (long long)b * H * W * C;
  float* g = g_s[warp];
  for (int dy = 0; dy < K2; ++dy) {
    const int yy = y0 - r + dy;
    const bool yok = yy >= 0 && yy < H;
    for (int dx = 0; dx < K2; ++dx) {
      const int xx = x0 - r + dx;
      float s = 0.0f;
      if (yok && xx >= 0 && xx < W) {  // uniform across the warp
        const bf16* q = f1b + ((long long)yy * W + xx) * C;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const uint2 raw = *reinterpret_cast<const uint2*>(q + (j * 32 + lane) * 4);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) s = fmaf(a[j][i], bf2f(v[i]), s);
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

template <int NCH>
void launch(const bf16* f0, const bf16* f1, const float* flow, float* out,
            int B, int H, int W, int r, float scale, cudaStream_t stream) {
  const long long n_pix = (long long)B * H * W;
  const unsigned grid = (unsigned)((n_pix + kWarps - 1) / kWarps);
  local_corr_kernel<NCH><<<grid, kWarps * 32, 0, stream>>>(f0, f1, flow, out, B, H, W, r, scale);
}

}  // namespace

// f0, f1: (B, H, W, C) bf16 contiguous; flow: (B, H, W, 2) fp32;
// out: (B, H, W, (2r+1)^2) fp32. C a multiple of 128, at most 1024; r <= 7.
ROMA_EXPORT int roma_local_corr(const void* f0, const void* f1, const void* flow,
                                void* out, int B, int H, int W, int C, int r,
                                float scale, void* stream) {
  if (C % 128 != 0 || C > 1024 || r < 0 || r > 7) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const bf16*>(f0);
  auto b = static_cast<const bf16*>(f1);
  auto fl = static_cast<const float*>(flow);
  auto o = static_cast<float*>(out);
  switch (C / 128) {
    case 1: launch<1>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 2: launch<2>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 3: launch<3>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 4: launch<4>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 5: launch<5>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 6: launch<6>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 7: launch<7>(a, b, fl, o, B, H, W, r, scale, s); break;
    case 8: launch<8>(a, b, fl, o, B, H, W, r, scale, s); break;
  }
  return (int)cudaGetLastError();
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
