// Gaussian kernel density estimate over match coordinates (balanced
// sampling's spatial weights):
//   density[i] = sum_j exp(-|x_i - x_j|^2 / (2 std^2))
// x (N, D) fp32, D <= 4, contiguous; density (N,) fp32. Every pair is
// evaluated, the self-term included: no symmetry K(i, j) = K(j, i), no
// distance cut-off. Same function as
// roma_torch/kernels/kde.py::kde_plain, summed as the benchmark's reference
// sums it: direct differences sum_d (x_i,d - x_j,d)^2, not the expansion
// |a|^2 + |b|^2 - 2 a.b.
//
// Replaces no TPU kernel: roma_tpu/utils/kde.py is plain jnp (row tiles of
// the N x N distances, fused by XLA). Added because the same plain code on
// the card runs ~9 elementwise passes over each 2,048 x N fp32 tile (328 MB
// at N = 40,000, some 110 GB a KDE), and that was the largest block of
// device time in balanced sampling.
//
// Bound on the H100: operations. N^2 exponentials over the special-function
// units' ~3.9e12 a second: 0.41 ms at N = 40,000, 0.103 ms at N = 20,000.
// Besides the exponential a pair takes 9 fp32 instructions (4 differences,
// a product and 3 multiply-adds for the squared distance, the sum), so the
// issue slots (4 warp instructions a clock an SM) allow about 10 / 32
// clocks a pair an SM partition: ~0.48 ms at N = 40,000 at the boost
// clock. The bytes (N x 16 in, N x 4 out, the partials below) are nothing
// beside either.
//
// Design: a 128-thread block owns 1,024 rows, 8 a thread, held in registers
// for the whole kernel (rows tid + 128 i: coalesced loads and stores), and
// walks its part of the columns in 512-point chunks staged in shared memory
// as float4 (missing dimensions zero). Every thread reads the same column
// point at once (a shared-memory broadcast, no bank conflicts), so one
// 16-byte load serves 8 pairs and no two threads share a row: each keeps its
// 8 row sums in registers, in column order, and no merge is needed. One
// exp2 a pair (ex2.approx.ftz.f32, fp32 precision) of the negated squared
// distance, its signs taken by the multiply-adds' operand negation: the
// factor log2(e) / (2 std^2) is folded into the points as they are loaded,
// each coordinate times its square root, so the pair takes no multiply for
// it. No TF32, bf16 or fp16 anywhere.
// To fill the card at N = 20,000 (20 row blocks) the columns are split into
// S parts too (kernels/kde.py::splits, from N alone): a (N / 1,024) x S
// grid of ~4,000 blocks, several waves on 132 SMs. Each block writes its
// rows' partial sums to row s of an (S, N) scratch, and a second launch sums
// the S partials of each point in order s = 0 .. S - 1: no atomics, so the
// output is bitwise the same run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRT = 8;                   // rows a thread
constexpr int kRows = kThreads * kRT;    // rows a block
constexpr int kChunk = 512;              // column points staged at once (8 KB)
constexpr int kMinBlocks = 8;            // blocks an SM holds: at most 64 registers a thread
constexpr int kSumThreads = 256;

__device__ __forceinline__ float ex2_approx(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

// point i of x (N, d) times s, zero past d
__device__ __forceinline__ float4 load_point(const float* __restrict__ x, long long i, int d,
                                             float s) {
  const float* p = x + i * d;
  return make_float4(s * p[0], d > 1 ? s * p[1] : 0.f, d > 2 ? s * p[2] : 0.f,
                     d > 3 ? s * p[3] : 0.f);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
kde_kernel(const float* __restrict__ x, float* __restrict__ part, int n, int d, int cols,
           float scale) {
  __shared__ float4 cs[kChunk];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows + tid;
  const int c_begin = blockIdx.y * cols;
  const int c_end = min(n, c_begin + cols);

  float4 xr[kRT];
  float acc[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const long long r = row0 + i * kThreads;
    xr[i] = r < n ? load_point(x, r, d, scale) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = 0.f;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    const int m = min(kChunk, c_end - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int j = tid; j < m; j += kThreads) cs[j] = load_point(x, c0 + j, d, scale);
    __syncthreads();
#pragma unroll 1  // 8 independent rows a column; unrolled columns spill at 64 registers
    for (int j = 0; j < m; ++j) {
      const float4 c = cs[j];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const float dx = xr[i].x - c.x;
        const float dy = xr[i].y - c.y;
        const float dz = xr[i].z - c.z;
        const float dw = xr[i].w - c.w;
        float e = -dx * dx;  // -|x_i - x_j|^2 log2(e) / (2 std^2)
        e = fmaf(-dy, dy, e);
        e = fmaf(-dz, dz, e);
        e = fmaf(-dw, dw, e);
        acc[i] += ex2_approx(e);
      }
    }
  }

  float* dst = part + (long long)blockIdx.y * n;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const long long r = row0 + i * kThreads;
    if (r < n) dst[r] = acc[i];
  }
}

// out[i] = sum over s = 0 .. splits - 1 of part[s, i], in that order
__global__ void __launch_bounds__(kSumThreads)
kde_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int splits) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) s += part[(long long)k * n + i];
  out[i] = s;
}

}  // namespace

// x (n, d) fp32, contiguous, 1 <= d <= 4; part (splits, n) fp32 scratch;
// out (n,) fp32. The columns are cut into `splits` parts of
// ceil(n / splits), none empty. scale = sqrt(log2(e) / (2 std^2)).
ROMA_EXPORT int roma_kde(const void* x, void* part, void* out, int n, int d, int splits,
                         float scale, void* stream) {
  if (n < 0 || d < 1 || d > 4 || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int cols = (n + splits - 1) / splits;
  if ((long long)(splits - 1) * cols >= n) return (int)cudaErrorInvalidValue;  // an empty part
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  const dim3 blocks((unsigned)((n + kRows - 1) / kRows), (unsigned)splits);
  kde_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), p, n, d, cols, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kde_sum_kernel<<<(unsigned)((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(
      p, static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

// rows a block of kde_kernel: kernels/kde.py sizes its column split by it
ROMA_EXPORT int roma_kde_rows() { return kRows; }

ROMA_EXPORT const char* roma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
