// resnet_epilogue: what follows each convolution of an fp32 ResNet victim,
// a frozen BatchNorm, the residual add where the block ends, and the ReLU,
// in one pass over the activation, forward and input gradient.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses these elementwise ops
// into the convolutions. On the card, cuDNN's convolution is followed by
// five separate elementwise passes (BatchNorm inference, the add, the ReLU,
// and in the input gradient the ReLU's and BatchNorm's backwards), which
// took a quarter of a ResNet-50 step's device time at near their own
// bandwidth bound: what gains is moving fewer bytes.
//
// Forward, elementwise over a contiguous NCHW map x of C channels and HW
// pixels a channel, with (a_c, b_c) the BatchNorm's per-channel affine
// (gamma / sqrt(var + eps), beta - mean a_c; a folded victim's (1, bias)):
//   none:     y = relu(a_c x + b_c)
//   identity: y = relu(a_c x + b_c + r)                  (r the block's input)
//   affine:   y = relu(a_c x + b_c + (a'_c r + b'_c))    (r the downsample
//             convolution's raw output, (a'_c, b'_c) its BatchNorm's affine)
// y is written over x, which nothing else reads afterwards. A ReLU of NaN is
// NaN, as torch's.
//
// Backward, from the saved output y alone: g' = g where y > 0 (or y is NaN),
// else 0, as torch's threshold_backward; dx = a_c g', and where the pass has
// a residual dr = g' (identity) or a'_c g' (affine).
//
// Bound on an H100 SXM: 8 bytes an element forward without a residual, 12
// with one (16 with the downsample's map); backward 12 (16 with dr). All of
// it at the HBM rate, 3.35 TB/s; the arithmetic is a few operations an
// element.
//
// Design. Loads and stores are float4, four consecutive elements of the flat
// map a thread at a time, two float4 a thread in flight. The channel of each
// element is worked out from its flat index: one division a float4 gives the
// first element's plane and offset in it, and the next three step the
// offset, moving to the next plane (and channel) where it wraps. So a map
// whose HW is not a multiple of 4 (ResNet stage 4's 7x7, 49 pixels) stays on
// the vector path: a float4 may straddle two channels. The per-channel
// affines are read through the read-only cache. The wrapper requires every
// pointer 16-byte aligned and the map under 2^31 elements; the last
// numel mod 4 elements are done one at a time. Three residual modes, each a
// template instance of the forward and of the backward: six small kernels.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // float4s a thread
constexpr int kNone = 0, kIdentity = 1, kAffine = 2;

struct Map {
  unsigned n;   // elements
  unsigned hw;  // pixels a channel
  unsigned c;   // channels
};

// The channel of flat element i, and i's offset in its plane.
__device__ __forceinline__ void locate(unsigned i, const Map& m, unsigned& ch, unsigned& off) {
  unsigned plane = i / m.hw;
  off = i - plane * m.hw;
  ch = plane % m.c;
}

// Steps (ch, off) to the next element.
__device__ __forceinline__ void step(const Map& m, unsigned& ch, unsigned& off) {
  if (++off == m.hw) {
    off = 0;
    ch = (ch + 1 == m.c) ? 0 : ch + 1;
  }
}

__device__ __forceinline__ float relu(float t) { return t <= 0.0f ? 0.0f : t; }

template <int R>
__device__ __forceinline__ float forward_one(float x, float r, unsigned ch, const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             const float* __restrict__ ra,
                                             const float* __restrict__ rb) {
  float t = fmaf(__ldg(a + ch), x, __ldg(b + ch));
  if (R == kIdentity) t += r;
  if (R == kAffine) t += fmaf(__ldg(ra + ch), r, __ldg(rb + ch));
  return relu(t);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    resnet_epilogue_forward_kernel(float* xy, const float* __restrict__ r,
                                   const float* __restrict__ a, const float* __restrict__ b,
                                   const float* __restrict__ ra, const float* __restrict__ rb,
                                   Map m) {
  const unsigned nvec = m.n / 4;
  const unsigned first = blockIdx.x * (kThreads * kVecs) + threadIdx.x;
  float4 xv[kVecs], rv[kVecs] = {};
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    unsigned v = first + k * kThreads;
    if (v < nvec) {
      xv[k] = reinterpret_cast<const float4*>(xy)[v];
      if (R != kNone) rv[k] = __ldg(reinterpret_cast<const float4*>(r) + v);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    unsigned v = first + k * kThreads;
    if (v >= nvec) continue;
    unsigned ch, off;
    locate(4 * v, m, ch, off);
    float4 o;
    o.x = forward_one<R>(xv[k].x, rv[k].x, ch, a, b, ra, rb);
    step(m, ch, off);
    o.y = forward_one<R>(xv[k].y, rv[k].y, ch, a, b, ra, rb);
    step(m, ch, off);
    o.z = forward_one<R>(xv[k].z, rv[k].z, ch, a, b, ra, rb);
    step(m, ch, off);
    o.w = forward_one<R>(xv[k].w, rv[k].w, ch, a, b, ra, rb);
    reinterpret_cast<float4*>(xy)[v] = o;
  }
  if (blockIdx.x == 0 && threadIdx.x < m.n % 4) {  // the last elements, one at a time
    unsigned i = 4 * nvec + threadIdx.x, ch, off;
    locate(i, m, ch, off);
    xy[i] = forward_one<R>(xy[i], R != kNone ? r[i] : 0.0f, ch, a, b, ra, rb);
  }
}

template <int R>
__device__ __forceinline__ void backward_one(float g, float y, unsigned ch,
                                             const float* __restrict__ a,
                                             const float* __restrict__ ra, float& dx, float& dr) {
  float kept = y <= 0.0f ? 0.0f : g;
  dx = __ldg(a + ch) * kept;
  if (R == kIdentity) dr = kept;
  if (R == kAffine) dr = __ldg(ra + ch) * kept;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    resnet_epilogue_backward_kernel(const float* __restrict__ g, const float* __restrict__ y,
                                    const float* __restrict__ a, const float* __restrict__ ra,
                                    float* __restrict__ dx, float* __restrict__ dr, Map m) {
  const unsigned nvec = m.n / 4;
  const unsigned first = blockIdx.x * (kThreads * kVecs) + threadIdx.x;
  float4 gv[kVecs], yv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    unsigned v = first + k * kThreads;
    if (v < nvec) {
      gv[k] = __ldg(reinterpret_cast<const float4*>(g) + v);
      yv[k] = __ldg(reinterpret_cast<const float4*>(y) + v);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    unsigned v = first + k * kThreads;
    if (v >= nvec) continue;
    unsigned ch, off;
    locate(4 * v, m, ch, off);
    float4 ox, orr;
    backward_one<R>(gv[k].x, yv[k].x, ch, a, ra, ox.x, orr.x);
    step(m, ch, off);
    backward_one<R>(gv[k].y, yv[k].y, ch, a, ra, ox.y, orr.y);
    step(m, ch, off);
    backward_one<R>(gv[k].z, yv[k].z, ch, a, ra, ox.z, orr.z);
    step(m, ch, off);
    backward_one<R>(gv[k].w, yv[k].w, ch, a, ra, ox.w, orr.w);
    reinterpret_cast<float4*>(dx)[v] = ox;
    if (R != kNone) reinterpret_cast<float4*>(dr)[v] = orr;
  }
  if (blockIdx.x == 0 && threadIdx.x < m.n % 4) {
    unsigned i = 4 * nvec + threadIdx.x, ch, off;
    locate(i, m, ch, off);
    float ox, orr;
    backward_one<R>(g[i], y[i], ch, a, ra, ox, orr);
    dx[i] = ox;
    if (R != kNone) dr[i] = orr;
  }
}

// Blocks for n elements; at least one, which does the tail of a map under 4.
unsigned grid_for(unsigned n) {
  unsigned per_block = kThreads * kVecs * 4;
  unsigned blocks = (n / 4 * 4 + per_block - 1) / per_block;
  return blocks ? blocks : 1;
}

bool valid(long long n, int hw, int c, int residual) {
  return n > 0 && n < (1LL << 31) && hw > 0 && c > 0 && residual >= kNone && residual <= kAffine;
}

}  // namespace

// x (n elements, NCHW, c channels of hw pixels) is overwritten by y. r, ra
// and rb may be null where the residual mode does not read them. Returns a
// CUDA error code (0 on success).
extern "C" int resnet_epilogue_forward_f32(float* x, const float* r, const float* a,
                                           const float* b, const float* ra, const float* rb,
                                           long long n, int hw, int c, int residual,
                                           cudaStream_t stream) {
  if (!valid(n, hw, c, residual)) return cudaErrorInvalidValue;
  Map m{(unsigned)n, (unsigned)hw, (unsigned)c};
  dim3 grid(grid_for(m.n));
  if (residual == kNone)
    resnet_epilogue_forward_kernel<kNone><<<grid, kThreads, 0, stream>>>(x, r, a, b, ra, rb, m);
  else if (residual == kIdentity)
    resnet_epilogue_forward_kernel<kIdentity><<<grid, kThreads, 0, stream>>>(x, r, a, b, ra, rb, m);
  else
    resnet_epilogue_forward_kernel<kAffine><<<grid, kThreads, 0, stream>>>(x, r, a, b, ra, rb, m);
  return cudaGetLastError();
}

// From the output's gradient g and the saved output y: dx, and dr where the
// residual mode has one (dr and ra may be null otherwise).
extern "C" int resnet_epilogue_backward_f32(const float* g, const float* y, const float* a,
                                            const float* ra, float* dx, float* dr, long long n,
                                            int hw, int c, int residual, cudaStream_t stream) {
  if (!valid(n, hw, c, residual)) return cudaErrorInvalidValue;
  Map m{(unsigned)n, (unsigned)hw, (unsigned)c};
  dim3 grid(grid_for(m.n));
  if (residual == kNone)
    resnet_epilogue_backward_kernel<kNone><<<grid, kThreads, 0, stream>>>(g, y, a, ra, dx, dr, m);
  else if (residual == kIdentity)
    resnet_epilogue_backward_kernel<kIdentity><<<grid, kThreads, 0, stream>>>(g, y, a, ra, dx, dr, m);
  else
    resnet_epilogue_backward_kernel<kAffine><<<grid, kThreads, 0, stream>>>(g, y, a, ra, dx, dr, m);
  return cudaGetLastError();
}
