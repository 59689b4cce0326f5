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
// Bound on the H100: bytes. A pixel moves 4 C bytes (x read, z written, in
// bf16) against 25 FMAs per channel on the FP32 pipes and a C x C mix on the
// tensor cores; at C = 144 the depthwise FMAs alone come to ~60% of the
// byte time, so every other instruction per output shows, and so do loads
// that do not overlap the FMAs.
//
// Design: persistent blocks of 256 threads (one an SM at C = 144, three at
// C = 24) walk 8 x 32 pixel tiles, one after another. Cp is C rounded up
// to 16.
//   0. Once per block: M^T (Cp x Cp, zeros past C) is staged in shared
//      memory from m itself, read row by row and written transposed; so are
//      the taps, scale and shift (fp32, 28 a channel) and the bias. No
//      per-call packing on the host.
//   1. A tile's halo goes 16 channels at a time ("chunks"): 12 rows of 48
//      columns (x0 - 8 .. x0 + 39, 16-byte aligned) per channel, by 16-byte cp.async copies, zero-filled outside
//      the plane, into one of two buffers: the next chunk (or the next
//      tile's first) is in flight while this one is computed. Channel
//      planes are an odd number of 16-byte units apart, so 8 threads on 8
//      consecutive channels read 16 bytes each without a bank conflict.
//      Where W % 8 != 0 or a pointer is not 16-byte aligned the threads
//      stage the halo element by element.
//   2. Depthwise: each thread takes one channel of the chunk and one 4 x 4
//      patch (channels fastest; a shorter last chunk packs its items onto
//      the first warps); each of its 8 halo rows is two 16-byte shared loads
//      whose bf16 pairs widen to floats by a shift or a mask; 25 FMAs per
//      output in a fixed dy, dx order, then `* scale + shift` as two
//      separately rounded operations (__fmul_rn, __fadd_rn) as in the plain
//      version, ReLU and one rounding to bf16 into a pixel-major y tile of
//      Cp + 8 bf16 a pixel.
//   3. The mix on the tensor cores, z^T = M^T y^T: warp w holds tile row
//      w's y fragments (32 pixels, 4 n-tiles of 8) for all of Cp in
//      registers (ldmatrix) and walks the 16-channel output tiles: 4 mma.sync m16n8k16 per k-step with M^T fragments by
//      ldmatrix, fp32 accumulation, z = acc + bias rounded once to bf16.
//      Each 16 x 32 z tile goes through a per-warp shared buffer (16-byte
//      units XOR-swizzled by row, no padding) and out along W as 16-byte
//      vectors (64 contiguous bytes a channel), with no block barrier.
// Shared memory at C = 144: halo 36.5 KB, M^T 42.8 KB, y 76 KB, z 8 KB,
// taps 15.8 KB. The first version's per-tile M^T restaging, 2.25x float
// halo of scalar loads and 2-byte z stores are gone. What bounds it now is
// in PERF.md (`kernel_variants.py` times edited copies that leave the
// depthwise, the mix or the halo loads out): no one phase dominates, and
// designs that overlapped them more (a deeper halo ring, twice the warps,
// the mix folded into the chunk loop, 4 x 64 tiles) measured no faster.

#include "dw_block_f32.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;               // tile rows: one a warp in the mix
constexpr int kTW = 32;              // tile columns
constexpr int kPix = kTH * kTW;
constexpr int kPatches = kPix / 16;  // 4 x 4 depthwise patches of a tile
constexpr int kChunk = kThreads / kPatches;  // channels staged at a time: an item a thread
constexpr int kHRows = kTH + 4;      // halo rows
constexpr int kUnits = 6;            // 16-byte units of a halo row: columns x0 - 8 .. x0 + 39
constexpr int kPS = kHRows * kUnits + 1;  // channel plane in units: odd
constexpr int kTaps = 28;            // fp32 per channel: 25 taps, scale, shift, padding
constexpr int kMaxC = 160;

// the shared-memory layout, in order: two halo buffers, M^T, y tile, the
// warps' 16 x 32 z tiles, taps, bias. kernels/dw_block_mm.py::tile_plan
// mirrors it.
template <int Cp>
struct Geo {
  static constexpr int kLDY = Cp + 8;  // M^T and y rows in bf16
  static long long bytes(int C) {
    return 2LL * kChunk * kPS * 16 + 2LL * Cp * kLDY + 2LL * kPix * kLDY +
           2LL * kWarps * 16 * kTW + 4LL * C * kTaps + 4LL * Cp;
  }
};

struct Args {
  const bf16* x;
  bf16* z;
  const bf16* w;       // (5, 5, C)
  const float* scale;  // (C,)
  const float* shift;  // (C,)
  const bf16* m;       // (C, C): z[d] = sum_c m[c][d] y[c]
  const float* bias;   // (C,)
  int C, H, W;
  int tiles_w, tiles_h, tiles;
  int vec;             // 16-byte vectors allowed: W % 8 == 0, x and z 16-byte aligned
};

template <int Cp>
__global__ void __launch_bounds__(kThreads, Cp <= 32 ? 3 : (Cp <= 64 ? 2 : 1))
dw_block_mm_kernel(const Args a) {
  using G = Geo<Cp>;
  constexpr int kLDY = G::kLDY;
  constexpr int KS = Cp / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, H = a.H, W = a.W;
  uint4* halo = reinterpret_cast<uint4*>(smem_raw);                // 2 x kChunk planes of kPS units
  bf16* sM = reinterpret_cast<bf16*>(halo + 2 * kChunk * kPS);    // Cp rows of kLDY: M^T
  bf16* sY = sM + Cp * kLDY;                                       // kPix rows of kLDY
  bf16* sZ = sY + kPix * kLDY;                                     // kWarps x 16 rows of kTW
  float* sT = reinterpret_cast<float*>(sZ + kWarps * 16 * kTW);   // C x kTaps
  float* sB = sT + C * kTaps;                                      // Cp

  const int tid = threadIdx.x;
  const long long hw = (long long)H * W;

  // ---- 0. once per block: M^T, taps, bias; the y tile's padding channels
  for (int i = tid; i < Cp * Cp; i += kThreads) {
    const int c = i / Cp, d = i - (i / Cp) * Cp;  // m read along its rows
    sM[d * kLDY + c] = c < C && d < C ? a.m[c * C + d] : __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < C * kTaps; i += kThreads) {
    const int c = i / kTaps, k = i - (i / kTaps) * kTaps;
    sT[i] = k < 25 ? bf2f(a.w[k * C + c]) : k == 25 ? a.scale[c] : k == 26 ? a.shift[c] : 0.0f;
  }
  for (int i = tid; i < Cp; i += kThreads) sB[i] = i < C ? a.bias[i] : 0.0f;
  if (C < Cp) {
    for (int p = tid; p < kPix; p += kThreads)
      for (int c = C; c < Cp; ++c) sY[p * kLDY + c] = __float2bfloat16_rn(0.0f);
  }

  auto origin = [&](int tile, int& x0, int& y0, int& b) {
    const int tx = tile % a.tiles_w;
    const int rest = tile / a.tiles_w;
    b = rest / a.tiles_h;
    y0 = (rest - b * a.tiles_h) * kTH;
    x0 = tx * kTW;
  };

  // chunk k of a tile's halo into buffer `buf`
  auto stage = [&](int tile, int k, int buf) {
    int x0, y0, b;
    origin(tile, x0, y0, b);
    const int c0 = k * kChunk;
    const int nc = min(kChunk, C - c0);
    const bf16* xb = a.x + ((long long)b * C + c0) * hw;
    uint4* hb = halo + buf * kChunk * kPS;
    if (a.vec) {
      for (int i = tid; i < nc * kHRows * kUnits; i += kThreads) {
        const int ch = i / (kHRows * kUnits);
        const int rem = i - ch * (kHRows * kUnits);
        const int r = rem / kUnits;
        const int u = rem - r * kUnits;
        const int gy = y0 - 2 + r, gx = x0 - 8 + 8 * u;
        const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;  // a unit is all in or out
        cp_async16(hb + ch * kPS + r * kUnits + u,
                   valid ? xb + ch * hw + (long long)gy * W + gx : a.x, valid);
      }
    } else {
      bf16* hs = reinterpret_cast<bf16*>(hb);
      for (int i = tid; i < nc * kHRows * kUnits * 8; i += kThreads) {
        const int ch = i / (kHRows * kUnits * 8);
        const int rem = i - ch * (kHRows * kUnits * 8);
        const int r = rem / (kUnits * 8);
        const int col = rem - r * (kUnits * 8);
        const int gy = y0 - 2 + r, gx = x0 - 8 + col;
        hs[(ch * kPS + r * kUnits) * 8 + col] =
            gy >= 0 && gy < H && gx >= 0 && gx < W ? xb[ch * hw + (long long)gy * W + gx]
                                                   : __float2bfloat16_rn(0.0f);
      }
    }
  };

  // depthwise + affine + ReLU of chunk channel `ch` (channel c) on patch pq
  // from halo buffer `buf` into the y tile; the patch's 8 halo columns start
  // at bf16 6 or 2 of 16-byte unit ub
  auto depthwise = [&](int buf, int ch, int c, int pq) {
    const int py = pq & 1, px = pq >> 1;
    const int ub = (4 * px + 6) >> 3;
    const bool off6 = ((4 * px + 6) & 7) == 6;
    float wr[25], sc, sh;
    {
      const float4* tp = reinterpret_cast<const float4*>(sT + c * kTaps);
      float tv[kTaps];
#pragma unroll
      for (int n = 0; n < kTaps / 4; ++n) {
        const float4 q = tp[n];
        tv[4 * n] = q.x;
        tv[4 * n + 1] = q.y;
        tv[4 * n + 2] = q.z;
        tv[4 * n + 3] = q.w;
      }
#pragma unroll
      for (int n = 0; n < 25; ++n) wr[n] = tv[n];
      sc = tv[25];
      sh = tv[26];
    }
    const uint4* hp = halo + buf * kChunk * kPS + ch * kPS + 4 * py * kUnits + ub;
    float acc[4][4];
#pragma unroll
    for (int oy = 0; oy < 4; ++oy)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[oy][j] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const uint4 q0 = hp[rr * kUnits], q1 = hp[rr * kUnits + 1];
      const uint32_t q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float v[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t u = off6 ? q[3 + n] : q[1 + n];
        v[2 * n] = lo_f(u);
        v[2 * n + 1] = hi_f(u);
      }
#pragma unroll
      for (int oy = 0; oy < 4; ++oy) {
        const int dy = rr - oy;
        if (dy < 0 || dy > 4) continue;
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[oy][j] = fmaf(v[j + dx], wr[dy * 5 + dx], acc[oy][j]);
      }
    }
    bf16* yp = sY + (4 * py * kTW + 4 * px) * kLDY + c;
#pragma unroll
    for (int oy = 0; oy < 4; ++oy)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        yp[(oy * kTW + j) * kLDY] =
            __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(acc[oy][j], sc), sh), 0.0f));
  };

  // this thread's depthwise item in a full chunk: channels fastest (8
  // threads on 8 consecutive channels of a patch); a last chunk of fewer
  // channels packs its items onto the first threads, so that whole warps
  // idle rather than part of every warp
  const int nch = (C + kChunk - 1) / kChunk;
  const int tail = C - (nch - 1) * kChunk;  // channels of the last chunk
  const int ch_full = tid % kChunk, pq_full = tid / kChunk;
  const int ch_tail = tid % tail, pq_tail = tid / tail;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* zw = sZ + warp * 16 * kTW;  // 16 channels x 32 pixels, 16-byte units swizzled by row

  int buf = 0;
  stage(blockIdx.x, 0, 0);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    for (int k = 0; k < nch; ++k) {
      cp_async_wait<0>();
      __syncthreads();  // chunk k staged; buffer buf ^ 1 and (at k = 0) the y tile are free
      {
        const int nk = k + 1 < nch ? k + 1 : 0;
        const int nt = k + 1 < nch ? tile : tile + gridDim.x;
        if (nt < a.tiles) stage(nt, nk, buf ^ 1);
        cp_async_commit();
      }
      if (k + 1 < nch || tail == kChunk)
        depthwise(buf, ch_full, k * kChunk + ch_full, pq_full);
      else if (pq_tail < kPatches)
        depthwise(buf, ch_tail, k * kChunk + ch_tail, pq_tail);
      buf ^= 1;
    }
    __syncthreads();  // y complete

    // ---- the mix: z^T = M^T y^T for this warp's tile row, then z out
    int x0, y0, b;
    origin(tile, x0, y0, b);
    const int gy = y0 + warp;
    bf16* zb = a.z + (long long)b * C * hw + (long long)gy * W;
    uint32_t bfr[4][2 * KS];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* bp = sY + (warp * kTW + nt * 8 + (lane & 7)) * kLDY + (lane >> 3) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        if (ks + 1 < KS)
          ldsm_x4(bfr[nt] + 2 * ks, bp + ks * 16);
        else
          ldsm_x2(bfr[nt] + 2 * ks, bp + ks * 16);
      }
    }
#pragma unroll 1
    for (int mt = 0; mt < KS; ++mt) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, sM + (mt * 16 + (lane & 15)) * kLDY + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], af, bfr[nt][2 * ks], bfr[nt][2 * ks + 1]);
      }
      // z tile row r holds 4 units of 8 pixels; unit q sits at q ^ (r / 2 % 4)
      const float blo = sB[mt * 16 + g], bhi = sB[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s0 = (nt ^ (g >> 1 & 3)) * 8 + 2 * t;
        const int s1 = (nt ^ ((g + 8) >> 1 & 3)) * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(zw + g * kTW + s0) =
            __floats2bfloat162_rn(__fadd_rn(acc[nt][0], blo), __fadd_rn(acc[nt][1], blo));
        *reinterpret_cast<__nv_bfloat162*>(zw + (g + 8) * kTW + s1) =
            __floats2bfloat162_rn(__fadd_rn(acc[nt][2], bhi), __fadd_rn(acc[nt][3], bhi));
      }
      __syncwarp();
      // 16 channels x 4 units of 8 pixels: two units a lane
#pragma unroll
      for (int u = lane; u < 64; u += 32) {
        const int dch = u >> 2, q = u & 3;
        const int d = mt * 16 + dch, gx = x0 + 8 * q;
        if (d >= C || gy >= H || gx >= W) continue;
        const bf16* src = zw + dch * kTW + (q ^ (dch >> 1 & 3)) * 8;
        bf16* dst = zb + d * hw + gx;
        if (a.vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (gx + j < W) dst[j] = src[j];
        }
      }
      __syncwarp();
    }
  }
}

template <int Cp>
int launch(Args a, int B, int smem, cudaStream_t s) {
  if (Geo<Cp>::bytes(a.C) != smem) return (int)cudaErrorInvalidValue;
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.tiles_h = (a.H + kTH - 1) / kTH;
  const long long tiles = (long long)a.tiles_w * a.tiles_h * B;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // per device and shared-memory size, once: the limit raised, all of the
  // SM's unified L1/shared memory as shared, and the resident blocks per SM
  // that size the persistent grid
  static int smem_of[64], blocks_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_of[dev] != smem) {
    err = cudaFuncSetAttribute(dw_block_mm_kernel<Cp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dw_block_mm_kernel<Cp>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_block_mm_kernel<Cp>,
                                                          kThreads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks_of[dev] = per_sm * sms;
    smem_of[dev] = smem;
  }
  const int grid = a.tiles < blocks_of[dev] ? a.tiles : blocks_of[dev];
  dw_block_mm_kernel<Cp><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z: (B, C, H, W) bf16 contiguous, distinct buffers; w: (5, 5, C) bf16;
// scale, shift, bias: (C,) fp32; m: (C, C) bf16 with z[d] = sum_c m[c][d]
// y[c]; all contiguous; 1 <= C <= 160. smem_bytes is the tile plan's
// (kernels/dw_block_mm.py).
ROMA_EXPORT int roma_dw_block_mm(const void* x, void* z, const void* w, const void* scale,
                                 const void* shift, const void* m, const void* bias, int B, int C,
                                 int H, int W, int smem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.z = static_cast<bf16*>(z);
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.m = static_cast<const bf16*>(m);
  a.bias = static_cast<const float*>(bias);
  a.C = C;
  a.H = H;
  a.W = W;
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(z) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16) {
    case 1: return launch<16>(a, B, smem_bytes, s);
    case 2: return launch<32>(a, B, smem_bytes, s);
    case 3: return launch<48>(a, B, smem_bytes, s);
    case 4: return launch<64>(a, B, smem_bytes, s);
    case 5: return launch<80>(a, B, smem_bytes, s);
    case 6: return launch<96>(a, B, smem_bytes, s);
    case 7: return launch<112>(a, B, smem_bytes, s);
    case 8: return launch<128>(a, B, smem_bytes, s);
    case 9: return launch<144>(a, B, smem_bytes, s);
    case 10: return launch<160>(a, B, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shared memory a launch at C channels takes (Geo::bytes), or 0 for a C
// the kernel does not take: what a caller passes as smem_bytes.
ROMA_EXPORT long long roma_dw_block_mm_smem(int C) {
  switch (C < 1 || C > kMaxC ? 0 : (C + 15) / 16) {
    case 1: return Geo<16>::bytes(C);
    case 2: return Geo<32>::bytes(C);
    case 3: return Geo<48>::bytes(C);
    case 4: return Geo<64>::bytes(C);
    case 5: return Geo<80>::bytes(C);
    case 6: return Geo<96>::bytes(C);
    case 7: return Geo<112>::bytes(C);
    case 8: return Geo<128>::bytes(C);
    case 9: return Geo<144>::bytes(C);
    case 10: return Geo<160>::bytes(C);
    default: return 0;
  }
}

// The float32 entry, one whole block: x, z (B, C, H, W) float32; w (5, 5, C),
// scale, shift, bias (C,), m (C, C) float32 (dw_block_f32.cuh).
ROMA_EXPORT int roma_dw_block_mm_f32(const void* x, void* z, const void* w, const void* scale,
                       const void* shift, const void* m, const void* bias, int B, int C,
                       int H, int W, void* stream) {
  return dwf32::launch(x, z, w, scale, shift, m, bias, B, C, H, W,
                       static_cast<cudaStream_t>(stream));
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
