// One fused narrow-channel refiner block, launched once per block of the
// scale-1 refiner's chain (block_in + 8 hidden blocks), on planar NCHW bf16:
//   y = bf16(relu(dw5x5(x) * scale + shift))        (zeros padding 2)
//   z = bf16(M^T y + bias)                           (C x C 1x1 conv)
//
// Replaces the TPU kernel roma_tpu/ops/pallas/depthwise.py
// (dw5x5_mm_chain -> _frame_block -> _kernel_ncw_mm_frame), with its two
// bf16 rounding points: the ReLU output and the block output.
//
// Bound on the H100: bytes. At C = 24 a pixel moves 96 bytes (24 channels
// read and written in bf16) against 25 FMAs per channel and a 24 x 24 mix;
// over one match() (4 images at 560^2 and at 864^2, 9 blocks each) that is
// 0.12 ms per launch pair at 3.35 TB/s, ~1.09 ms for the 18 launches. The
// depthwise FMAs are close behind: 25 per output in a fixed order are
// ~0.8 ms of the FP32 pipes a match, so every other instruction issued per
// output shows in the time, and so does any time the loads and the FMAs
// do not overlap.
//
// Design. Persistent blocks of 384 threads (two per SM at C <= 32) walk
// TH x 32 pixel tiles (TH = 8 for C <= 32, 4 above) of all C channels, one
// tile after another, and prefetch the next tile while computing this one:
//   1. One thread asks TMA for the next tile's halo as one box of 48
//      columns (x0 - 8 .. x0 + 39, 16-byte aligned), TH + 4 rows and all C
//      channels, into a bf16 staging area; TMA writes zeros outside the
//      tensor and completes on an mbarrier. Where W % 8 != 0 or a pointer is
//      not 16-byte aligned the threads stage the halo element by element.
//   2. The staged rows are widened to float rows of 36 (columns x0 - 2 ..
//      x0 + 33), channel planes an odd number of 16-byte units apart, so 8
//      threads on 8 consecutive channels read 16 bytes each without a bank
//      conflict.
//   3. Depthwise: thread t takes (channel, 4 x 4 patch) items t, t + 384,
//      ... with the channel fastest; at C = 24 a thread keeps one channel
//      for its life (384 = 16 x 24), so its 25 taps, scale and shift
//      (packed fp32 by the wrapper, staged in shared memory once) are read
//      into registers once. A patch reads 8 rows of two float4 (one 16-byte
//      shared load per output) and runs the 25 FMAs per output in a fixed
//      dy, dx order; `* scale + shift` are two separately rounded operations
//      (__fmul_rn, __fadd_rn) as in the plain version, then ReLU and one
//      rounding to bf16 into a pixel-major y tile of Cp + 8 bf16 per pixel
//      (Cp = C padded to a multiple of 16 with zero channels).
//   4. The mix on the tensor cores, z^T = M^T y^T: mma.sync m16n8k16 bf16
//      with fp32 accumulation, A = M^T and B = the y tile by ldmatrix (rows
//      padded by 8 bf16: conflict-free), 8 pixels an item. z = acc + bias is
//      rounded to bf16 once; each lane's two adjacent pixels of a channel go
//      as one pair into a channel-major z tile over the dead float rows.
//   5. The z tile goes out along W as 16-byte vectors.
// The phases are separated by block barriers and add up on the card: the
// halo's L2-to-SM traffic (48 columns and TH + 4 rows per TH x 32 outputs)
// overlaps the depthwise FMAs, but the widening, the mix and the store do
// not (PERF.md, PR 6, has the breakdown and the designs that measured
// slower). The TPU version's padded frame and width-major layout have no
// counterpart.

#include "dw_block_f32.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;        // 12 warps
constexpr int kTW = 32;              // tile width, output columns
constexpr int kLD = kTW + 4;         // float halo row: columns x0 - 2 .. x0 + kTW + 1
constexpr int kSLD = kTW + 16;       // staged bf16 row: columns x0 - 8 .. x0 + kTW + 7
constexpr int kTaps = 28;            // fp32 per channel: 25 taps, scale, shift, padding
constexpr int kMaxC = 64;

// geometry of a tile of TH rows and Cp padded channels; the shared-memory
// layout, in order: staging, float halo (the z tile over it once it is
// dead), y tile, M^T, bias, taps, the mbarrier.
// kernels/dw_chain.py::tile_plan mirrors it.
template <int Cp, int TH>
struct Geo {
  static constexpr int kRows = TH + 4;
  // float channel plane: the least >= kRows * kLD whose count of 16-byte
  // units is odd (8 consecutive planes start in 8 distinct bank groups)
  static constexpr int kPS = (kRows * kLD + 3) / 4 % 2 ? (kRows * kLD + 3) / 4 * 4
                                                        : (kRows * kLD + 3) / 4 * 4 + 4;
  static constexpr int kPix = TH * kTW;
  static constexpr int kPatches = (TH / 4) * (kTW / 4);
  static constexpr int kLDY = Cp + 8;    // y tile and M^T rows in bf16
  static constexpr int kZLD = kPix + 8;  // z tile rows in bf16: 4 words mod 32 apart
  // 128 bytes of slack to align the staging area for TMA, the regions,
  // 16 bytes for the mbarrier
  static long long bytes(int C) {
    return 128 + 2LL * C * kRows * kSLD + 4LL * C * kPS + 2LL * kPix * kLDY + 2LL * Cp * kLDY +
           4LL * Cp + 4LL * C * kTaps + 16;
  }
};

struct Args {
  const bf16* x;
  bf16* z;
  const float* taps;  // (C, kTaps)
  const bf16* mt;     // (Cp, Cp): mt[d][c] = m[c][d], zeros past C
  const float* bias;  // (Cp,), zeros past C
  int C, H, W;
  int tiles_w, tiles_h, tiles;
  int vec;            // 16-byte vectors allowed: W % 8 == 0, x and z 16-byte aligned
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int Cp, int TH>
__global__ void __launch_bounds__(kThreads, Cp <= 32 ? 2 : 1)
dw_block_kernel(const Args a, const __grid_constant__ CUtensorMap xmap) {
  using G = Geo<Cp, TH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  const int C = a.C, H = a.H, W = a.W;
  bf16* stage = reinterpret_cast<bf16*>(smem);                // C x kRows rows of kSLD
  float* halo = reinterpret_cast<float*>(stage + C * G::kRows * kSLD);  // C planes of kPS
  bf16* ys = reinterpret_cast<bf16*>(halo + C * G::kPS);      // kPix rows of kLDY
  bf16* ms = ys + G::kPix * G::kLDY;                          // Cp rows of kLDY: M^T
  float* bs = reinterpret_cast<float*>(ms + Cp * G::kLDY);    // Cp
  float* ts = bs + Cp;                                        // C x kTaps
  const uint32_t bar = smem_addr(ts + C * kTaps);             // the staged halo has landed
  bf16* zs = reinterpret_cast<bf16*>(halo);                   // C rows of kZLD, over the halo

  const int tid = threadIdx.x;
  const long long hw = (long long)H * W;

  // tile -> first column, first row, image
  auto origin = [&](int tile, int& x0, int& y0, int& b) {
    const int tx = tile % a.tiles_w;
    const int rest = tile / a.tiles_w;
    const int ty = rest % a.tiles_h;
    b = rest / a.tiles_h;
    x0 = tx * kTW;
    y0 = ty * TH;
  };

  // the halo of a tile into the staging area, C planes of kRows rows of
  // kSLD: one TMA box (zeros outside the tensor) where 16-byte vectors are
  // allowed, else element by element
  auto stage_tile = [&](int tile) {
    int x0, y0, b;
    origin(tile, x0, y0, b);
    if (a.vec) {
      if (tid == 0) {
        mbar_expect_tx(bar, 2u * C * G::kRows * kSLD);
        tma_load_4d(smem_addr(stage), &xmap, bar, x0 - 8, y0 - 2, 0, b);
      }
      return;
    }
    const bf16* xb = a.x + (long long)b * C * hw;
    const int n = C * G::kRows * kSLD;
    for (int i = tid; i < n; i += kThreads) {
      const int c = i / (G::kRows * kSLD);
      const int rem = i - c * (G::kRows * kSLD);
      const int r = rem / kSLD;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 8 + rem - r * kSLD;
      stage[i] = gy >= 0 && gy < H && gx >= 0 && gx < W ? xb[c * hw + (long long)gy * W + gx]
                                                        : __float2bfloat16_rn(0.0f);
    }
  };

  // once per block: M^T, bias and taps into shared memory, the y tile's
  // padding channels [C, Cp) to zeros, the first tile's halo in flight
  for (int i = tid; i < Cp * Cp / 2; i += kThreads) {
    const int r = i / (Cp / 2);
    const int k = i - r * (Cp / 2);
    *reinterpret_cast<uint32_t*>(ms + r * G::kLDY + 2 * k) = ld32(a.mt + r * Cp + 2 * k);
  }
  for (int i = tid; i < Cp; i += kThreads) bs[i] = a.bias[i];
  for (int i = tid; i < C * kTaps; i += kThreads) ts[i] = a.taps[i];
  if (C < Cp) {
    for (int px = tid; px < G::kPix; px += kThreads)
      for (int c = C; c < Cp; ++c) ys[px * G::kLDY + c] = __float2bfloat16_rn(0.0f);
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  stage_tile(blockIdx.x);
  uint32_t phase = 0;

  // this thread's first depthwise item; with kThreads % C == 0 its channel
  // is the same for every item and every tile
  const int c_first = tid % C;
  const int p_first = tid / C;
  const int dc = kThreads % C;
  const int dp = kThreads / C;
  int wc = -1;
  float wr[25], sc = 0.0f, sh = 0.0f;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    if (a.vec) {
      mbar_wait(bar, phase);
      phase ^= 1u;
    }
    __syncthreads();  // staged halo complete; the last tile's z tile is out

    // ---- widen: (channel, row, 4-column unit) items, staging -> float rows
    {
      constexpr int kUnits = kLD / 4;
      const int n = C * G::kRows * kUnits;
#pragma unroll 4
      for (int i = tid; i < n; i += kThreads) {
        const int c = i / (G::kRows * kUnits);
        const int rem = i - c * (G::kRows * kUnits);
        const int r = rem / kUnits;
        const int q = rem - r * kUnits;
        // float column 4q is staged column 4q + 6: bf16 pairs 2q + 3, 2q + 4
        const bf16* sp = stage + (c * G::kRows + r) * kSLD + 4 * q + 6;
        const uint32_t w0 = ld32(sp), w1 = ld32(sp + 2);
        *reinterpret_cast<float4*>(halo + c * G::kPS + r * kLD + 4 * q) =
            make_float4(lo_f(w0), hi_f(w0), lo_f(w1), hi_f(w1));
      }
    }
    __syncthreads();  // float halo ready; staging free
    if (tile + (int)gridDim.x < a.tiles) stage_tile(tile + gridDim.x);

    // ---- depthwise + affine + ReLU into the y tile
    for (int c = c_first, p = p_first; p < G::kPatches;) {
      if (c != wc) {
        const float4* tp = reinterpret_cast<const float4*>(ts + c * kTaps);
        float tv[kTaps];
#pragma unroll
        for (int i = 0; i < kTaps / 4; ++i) {
          const float4 q = tp[i];
          tv[4 * i] = q.x;
          tv[4 * i + 1] = q.y;
          tv[4 * i + 2] = q.z;
          tv[4 * i + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < 25; ++i) wr[i] = tv[i];
        sc = tv[25];
        sh = tv[26];
        wc = c;
      }
      const int oy0 = (p / (kTW / 4)) * 4;
      const int ox0 = (p % (kTW / 4)) * 4;
      const float* hp = halo + c * G::kPS + oy0 * kLD + ox0;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float4 q0 = *reinterpret_cast<const float4*>(hp + rr * kLD);
        const float4 q1 = *reinterpret_cast<const float4*>(hp + rr * kLD + 4);
        const float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
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
      bf16* yp = ys + (oy0 * kTW + ox0) * G::kLDY + c;
#pragma unroll
      for (int oy = 0; oy < 4; ++oy)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yp[(oy * kTW + j) * G::kLDY] =
              __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(acc[oy][j], sc), sh), 0.0f));
      c += dc;
      p += dp;
      if (c >= C) {
        c -= C;
        ++p;
      }
    }
    __syncthreads();  // y complete; the float halo is dead

    // ---- the mix on the tensor cores: z^T = M^T y^T, A = M^T (16 output
    // channels x 16 input channels), B = the y tile (16 input channels x 8
    // pixels), both by ldmatrix; each lane's two adjacent pixels of a
    // channel go as one bf16 pair into the channel-major z tile
    {
      constexpr int KS = Cp / 16;  // k-steps
      constexpr int MT = Cp / 16;  // 16-channel output tiles
      uint32_t af[MT][KS][4];
      float blo[MT], bhi[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(af[mt][ks], ms + (mt * 16 + (lane & 15)) * G::kLDY + ks * 16 + (lane >> 4) * 8);
        blo[mt] = bs[mt * 16 + g];
        bhi[mt] = bs[mt * 16 + g + 8];
      }
      constexpr int kItems = (G::kPix + kThreads / 4 - 1) / (kThreads / 4);
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int n0 = warp * 8 + it * (kThreads / 4);
        if (n0 >= G::kPix) break;  // warp-uniform
        uint32_t bfr[2 * KS];
        const bf16* bp = ys + (n0 + (lane & 7)) * G::kLDY + (lane >> 3) * 8;
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2) {
          if (ks + 1 < KS)
            ldsm_x4(bfr + 2 * ks, bp + ks * 16);
          else
            ldsm_x2(bfr + 2 * ks, bp + ks * 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt * 16 >= C) continue;  // warp-uniform
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) mma_bf16(acc, af[mt][ks], bfr[2 * ks], bfr[2 * ks + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = mt * 16 + g + 8 * h;
            if (d >= C) continue;
            const float bb = h ? bhi[mt] : blo[mt];
            const __nv_bfloat162 pr = __floats2bfloat162_rn(__fadd_rn(acc[2 * h], bb),
                                                            __fadd_rn(acc[2 * h + 1], bb));
            *reinterpret_cast<__nv_bfloat162*>(zs + d * G::kZLD + n0 + 2 * t) = pr;
          }
        }
      }
    }
    __syncthreads();  // z tile complete

    // ---- z out along W: (channel, row, 8-column chunk) items
    {
      int x0, y0, b;
      origin(tile, x0, y0, b);
      constexpr int kChunks = kTW / 8;
      bf16* zb = a.z + (long long)b * C * hw;
      const int n = C * TH * kChunks;
      for (int i = tid; i < n; i += kThreads) {
        const int d = i / (TH * kChunks);
        const int rem = i - d * (TH * kChunks);
        const int r = rem / kChunks;
        const int k = rem - r * kChunks;
        const int gy = y0 + r;
        const int gx = x0 + 8 * k;
        if (gy >= H || gx >= W) continue;
        const bf16* src = zs + d * G::kZLD + r * kTW + 8 * k;
        bf16* dst = zb + d * hw + (long long)gy * W + gx;
        if (a.vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (gx + j < W) dst[j] = src[j];
        }
      }
    }
  }
}

// x as a (W, H, C, B) TMA map whose boxes are one tile's staged halo:
// kSLD columns, TH + 4 rows, all C channels
template <int Cp, int TH>
int encode_map(CUtensorMap* map, const void* x, int B, int C, int H, int W) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * W, 2ull * W * H, 2ull * W * H * C};  // bytes
  const cuuint32_t box[4] = {kSLD, Geo<Cp, TH>::kRows, (cuuint32_t)C, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidPitchValue;
}

template <int Cp, int TH>
int launch(Args a, int B, int smem, cudaStream_t s) {
  using G = Geo<Cp, TH>;
  if (G::bytes(a.C) != smem) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  if (a.vec) {
    const int rc = encode_map<Cp, TH>(&map, a.x, B, a.C, a.H, a.W);
    if (rc != 0) return rc;
  }
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.tiles_h = (a.H + TH - 1) / TH;
  const long long tiles = (long long)a.tiles_w * a.tiles_h * B;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // per device and shared-memory size, once: the limit raised, all of the
  // SM's unified L1/shared memory as shared (two blocks of ~93 KB at C = 24),
  // and the resident blocks per SM that size the persistent grid
  static int smem_of[64], blocks_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_of[dev] != smem) {
    err = cudaFuncSetAttribute(dw_block_kernel<Cp, TH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dw_block_kernel<Cp, TH>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_block_kernel<Cp, TH>,
                                                          kThreads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks_of[dev] = per_sm * sms;
    smem_of[dev] = smem;
  }
  const int grid = a.tiles < blocks_of[dev] ? a.tiles : blocks_of[dev];
  dw_block_kernel<Cp, TH><<<grid, kThreads, smem, s>>>(a, map);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z: (B, C, H, W) bf16 contiguous, distinct buffers; taps: (C, 28) fp32,
// 16-byte aligned (25 taps in dy, dx order, scale, shift, 0); mt: (Cp, Cp)
// bf16 with mt[d][c] = m[c][d] (z[d] = sum_c m[c][d] y[c]) and zeros past
// C; bias: (Cp,) fp32, zeros past C; Cp = C rounded up to a multiple of 16;
// 1 <= C <= 64. smem_bytes is the tile plan's (kernels/dw_chain.py).
ROMA_EXPORT int roma_dw_block(const void* x, void* z, const void* taps, const void* mt,
                              const void* bias, int B, int C, int H, int W, int smem_bytes,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(taps) % 16 || reinterpret_cast<uintptr_t>(mt) % 4)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.z = static_cast<bf16*>(z);
  a.taps = static_cast<const float*>(taps);
  a.mt = static_cast<const bf16*>(mt);
  a.bias = static_cast<const float*>(bias);
  a.C = C;
  a.H = H;
  a.W = W;
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(z) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16) {
    case 1: return launch<16, 8>(a, B, smem_bytes, s);
    case 2: return launch<32, 8>(a, B, smem_bytes, s);
    case 3: return launch<48, 4>(a, B, smem_bytes, s);
    case 4: return launch<64, 4>(a, B, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float32 entry, one block of the scale-1 chain: x, z (B, C, H, W) float32; w (5, 5, C),
// scale, shift, bias (C,), m (C, C) float32 (dw_block_f32.cuh).
ROMA_EXPORT int roma_dw_block_f32(const void* x, void* z, const void* w, const void* scale,
                       const void* shift, const void* m, const void* bias, int B, int C,
                       int H, int W, void* stream) {
  return dwf32::launch(x, z, w, scale, shift, m, bias, B, C, H, W,
                       static_cast<cudaStream_t>(stream));
}

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
