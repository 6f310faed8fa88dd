// fused_perturb: adv = clip(x + clamp(v @ D, -eps, eps), 0, 1) in one pass.
//
// Replaces the Pallas TPU kernel `fused_perturb` (`_perturb_kernel`) of
// dl_attack_on_imagenet_tpu/ops/pallas_kernels.py. Shapes: v (N, K) codes,
// D (K, M) atoms flat in NHWC pixel order, x and out (N, M), all fp32 and
// contiguous.
//
// Bound on an H100 SXM: at the serving shape N=64, K=100, M=150528 the
// function must move 137 MB (D 60.2 MB, x and out 38.5 MB each, v 25.6 KB),
// about 41 us at 3.35 TB/s, against 1.93 GFLOP of fp32 FMA, about 29 us at
// 67 TFLOP/s. It is memory-bound.
//
// Design. Each block owns a row chunk of ROWS codes and a tile of
// THREADS * COLS pixel columns, and loops over the K atoms. The codes of the
// chunk sit in shared memory, transposed to (K, ROWS) so that one 16-byte
// broadcast load gives four rows; D[k, tile] is read coalesced, COLS values a
// thread, each reused for ROWS FMAs; the ROWS x COLS accumulators live in
// registers. The eps clamp, the image add and the pixel clip happen in
// registers before the single store, so the (N, M) perturbation never goes
// to device memory. blockIdx.x walks the row chunks, so the blocks that read
// the same D tile run together and the re-reads of D hit L2. Only fp32 FMA
// is used (no TF32, no tensor cores): the eps-budget guarantee rests on a
// true fp32 contraction. The ragged edges of N and M are masked, not padded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 16;     // codes per block (a multiple of 4)
constexpr int COLS = 4;      // pixel columns per thread
constexpr int THREADS = 128;
constexpr int TILE = THREADS * COLS;

__global__ void __launch_bounds__(THREADS)
fused_perturb_kernel(const float* __restrict__ v, const float* __restrict__ d,
                     const float* __restrict__ x, float* __restrict__ out,
                     int n, int k, long long m, float eps) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // (k, ROWS), row-fastest

  const int r0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < k * ROWS; i += THREADS) {
    const int kk = i / ROWS;
    const int r = i % ROWS;
    vs[i] = (r0 + r < n) ? v[(long long)(r0 + r) * k + kk] : 0.0f;
  }
  __syncthreads();

  const long long c0 = (long long)blockIdx.y * TILE + threadIdx.x;
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.0f;

  for (int kk = 0; kk < k; ++kk) {
    float dv[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const long long c = c0 + j * THREADS;
      dv[j] = (c < m) ? __ldg(d + (long long)kk * m + c) : 0.0f;
    }
    const float4* vk = smem4 + kk * (ROWS / 4);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const float4 w = vk[q];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        acc[4 * q + 0][j] = fmaf(w.x, dv[j], acc[4 * q + 0][j]);
        acc[4 * q + 1][j] = fmaf(w.y, dv[j], acc[4 * q + 1][j]);
        acc[4 * q + 2][j] = fmaf(w.z, dv[j], acc[4 * q + 2][j]);
        acc[4 * q + 3][j] = fmaf(w.w, dv[j], acc[4 * q + 3][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = (long long)(r0 + r) * m;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const long long c = c0 + j * THREADS;
      if (r0 + r < n && c < m) {
        const float p = fminf(fmaxf(acc[r][j], -eps), eps);
        out[row + c] = fminf(fmaxf(x[row + c] + p, 0.0f), 1.0f);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, types, contiguity and k <= fused_perturb_max_k().
extern "C" int fused_perturb_max_k() { return (48 * 1024) / (ROWS * 4); }

extern "C" int fused_perturb_f32(const void* v, const void* d, const void* x,
                                 void* out, int n, int k, long long m,
                                 float eps, void* stream) {
  const dim3 grid((n + ROWS - 1) / ROWS, (unsigned)((m + TILE - 1) / TILE));
  const size_t smem = (size_t)k * ROWS * sizeof(float);
  fused_perturb_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(x), static_cast<float*>(out), n, k, m, eps);
  return (int)cudaGetLastError();
}
