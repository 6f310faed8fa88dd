// fused_adamw_project: one AdamW step and the clamp to +-clip, in one pass.
//
// Replaces the Pallas TPU kernel `fused_adamw_project` (`_adamw_kernel`) of
// dl_attack_on_imagenet_tpu/ops/pallas_kernels.py. For every element:
//   mu' = b1 mu + (1 - b1) g
//   nu' = b2 nu + (1 - b2) g g
//   p'  = clip(p - lr ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd p), +-clip)
// with b1 = 0.9, b2 = 0.999, eps = 1e-8, wd = 1e-2 fixed, as in the TPU
// kernel, and bc1 = 1 - b1^t, bc2 = 1 - b2^t computed by the caller in fp32.
// p, mu and nu are updated in place; all four arrays are fp32, contiguous,
// of one size n.
//
// Bound on an H100 SXM: the dictionary update (n = 100 * 224 * 224 * 3 =
// 15.05M) reads p, g, mu, nu and writes p, mu, nu, 7 * 60.2 MB = 421 MB,
// about 126 us at 3.35 TB/s, against some 15 flop an element, 0.23 GFLOP,
// about 3 us at 67 TFLOP/s. It is memory-bound by far.
//
// Design. A grid-stride loop over 16-byte float4 loads and stores, so that
// each warp moves 512 contiguous bytes per array per access, with a scalar
// loop for the tail of n % 4 elements; when any pointer is not 16-byte
// aligned the scalar loop takes the whole array. Indices are 64-bit. Each
// operation is rounded on its own (the _rn intrinsics, which the compiler
// never contracts into FMAs, and IEEE division and square root), in the
// order of the plain torch twin, so that no build flag can change how the
// kernel rounds.
#include <cuda_runtime.h>

namespace {

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float C1 = (float)(1.0 - 0.9);    // 1 - b1 as the twin rounds it
constexpr float C2 = (float)(1.0 - 0.999);  // 1 - b2 as the twin rounds it
constexpr float EPS = 1e-8f;
constexpr float WD = 1e-2f;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ void adamw_project(float& p, float g, float& mu,
                                              float& nu, float lr, float bc1,
                                              float bc2, float clip) {
  mu = __fadd_rn(__fmul_rn(B1, mu), __fmul_rn(C1, g));
  nu = __fadd_rn(__fmul_rn(B2, nu), __fmul_rn(__fmul_rn(C2, g), g));
  const float upd = __fdiv_rn(__fdiv_rn(mu, bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), EPS));
  p = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(upd, __fmul_rn(WD, p))));
  p = fminf(fmaxf(p, -clip), clip);
}

__global__ void __launch_bounds__(THREADS)
fused_adamw_project_kernel(float* __restrict__ p, const float* __restrict__ g,
                           float* __restrict__ mu, float* __restrict__ nu,
                           long long n, bool vec4, float lr, float bc1,
                           float bc2, float clip) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* mu4 = reinterpret_cast<float4*>(mu);
    float4* nu4 = reinterpret_cast<float4*>(nu);
    for (long long i = tid; i < n4; i += stride) {
      float4 pv = p4[i];
      const float4 gv = __ldg(g4 + i);
      float4 mv = mu4[i];
      float4 nv = nu4[i];
      adamw_project(pv.x, gv.x, mv.x, nv.x, lr, bc1, bc2, clip);
      adamw_project(pv.y, gv.y, mv.y, nv.y, lr, bc1, bc2, clip);
      adamw_project(pv.z, gv.z, mv.z, nv.z, lr, bc1, bc2, clip);
      adamw_project(pv.w, gv.w, mv.w, nv.w, lr, bc1, bc2, clip);
      p4[i] = pv;
      mu4[i] = mv;
      nu4[i] = nv;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float pv = p[i], mv = mu[i], nv = nu[i];
    adamw_project(pv, __ldg(g + i), mv, nv, lr, bc1, bc2, clip);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success). The caller
// checks sizes, types, devices and contiguity, and launches only for n > 0.
extern "C" int fused_adamw_project_f32(void* p, const void* g, void* mu,
                                       void* nu, long long n, float lr,
                                       float bc1, float bc2, float clip,
                                       void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = ((reinterpret_cast<unsigned long long>(p) |
                      reinterpret_cast<unsigned long long>(g) |
                      reinterpret_cast<unsigned long long>(mu) |
                      reinterpret_cast<unsigned long long>(nu)) & 15ull) == 0;
  const long long work = vec4 ? (n + 3) / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
  fused_adamw_project_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu), n, vec4, lr, bc1, bc2,
      clip);
  return (int)cudaGetLastError();
}
