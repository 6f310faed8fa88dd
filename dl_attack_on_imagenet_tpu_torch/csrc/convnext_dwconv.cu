// convnext_dwconv: the 7x7 depthwise convolution of each ConvNeXt block
// (stride 1, padding 3, one 7x7 filter a channel), fp32 on NCHW maps,
// forward and input gradient. The input gradient takes the residual's
// gradient in the same pass: a block computes z + layer_scale * MLP(dwconv(z)),
// so z's gradient is the convolution's transposed over h's gradient plus the
// gradient the residual add hands straight to z, and this kernel writes
// their sum, where autograd would run a separate add.
//
// Replaces no Pallas kernel: the JAX package has no ConvNeXt. On the card it
// replaces PyTorch's own conv_depthwise2d_* kernels, where fp32 NCHW
// depthwise convolutions go (cuDNN takes only channels_last ones), which
// compute one output a thread over 49 taps, reading every tap from memory:
// a ConvNeXt-B pass at b64 took 23.1 ms both ways against a 1.78 ms bound.
//
//   forward   h[n,c,y,x]  = b[c] + sum_ij w[c,i,j] z[n,c,y+i-3,x+j-3]
//   backward  dz[n,c,y,x] = sum_ij w[c,6-i,6-j] dh[n,c,y+i-3,x+j-3] + dr[n,c,y,x]
// (taps outside the map read 0). The backward is the forward's loop over
// the flipped taps, with no bias and dr added at the write.
//
// Bound on an H100 SXM: bytes. The forward reads z and writes h, 8 B an
// element; the backward reads dh and dr and writes dz, 12 B. Against them
// 49 FMAs an element (98 flop): at b64 a ConvNeXt-B pass moves 2.39 + 3.58
// GB (0.713 + 1.070 ms at 3.35 TB/s) and does 14.6 G FMAs each way (0.44 ms
// at the fp32 rate). So the arithmetic has to run at well over half the
// card's FMA rate for the bytes to set the pace; the inner loop below runs
// at about half of it, so in practice the FMAs and the bytes cost about the
// same.
//
// Design. A block of 128 threads takes whole (n, c) planes, several of them
// where the maps are small: 128 tiles' worth, 2 planes at 56², 8 at 28², 32
// at 14², 128 at 7² (and at 4², where every tap but the centre's reaches past
// the map). In contiguous NCHW a block's planes are one contiguous run of
// memory. It copies them into shared memory with cp.async, consecutive
// threads on consecutive floats (each warp reads 128 contiguous bytes a copy;
// nothing waits on a register), laid out with a zero border of 3 around each
// plane, the border rows and columns shared between neighbours (a row pitch
// of at least W + 3 and a plane stride of at least H + 3 rows), and the
// block's P x 49 taps beside them, flipped for the backward.
//
// Each thread then computes a TxT tile of outputs (T = 7 where 7 divides
// both sides: every ConvNeXt-B map, 56 to 7; else 4, convnext_mini's 16, 8
// and 4) with its 49 taps and its tile in registers: it reads each of the
// (T+6)² input values of its window from shared memory once, 169 reads for
// 2,401 FMAs at T = 7, so shared memory is not the limit it is where one
// output a thread reads once an FMA. The layout comes from the host
// (`convnext_dwconv_geometry` in ops/kernels.py) and takes the least memory:
// padding the pitch and plane stride so that one warp's windows start in
// distinct shared-memory banks moved a ConvNeXt-B pass by 0.2%, either way
// by stage. A map of more than 128 tiles is cut into bands of rows, one a
// block, each read with its 3 rows of neighbours. The outputs go back
// through shared memory (the input's slots, once every thread has read its
// window) and out as consecutive floats, so stores and the backward's reads
// of dr are coalesced too.
//
// The backward's dh arrives channels_last-strided: the block's LayerNorm
// reads h through a permuted view, and its gradient comes back in that
// view's strides. The kernel reads it so where a block's planes are
// channels c0..c0+P-1 of one image and P divides 128: each thread keeps one
// channel and steps over the pixels, so a warp reads runs of P consecutive
// floats. Even at 56² (P = 2) that takes half the time of a copy to NCHW
// followed by the NCHW read.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSide = 7, kTaps = 49, kHalo = 3;
constexpr int kMaxSharedBytes = 232448;  // what a block may use on sm_90

struct Geometry {
  int planes;        // N·C
  int channels;      // C
  int h, w;          // the map
  int band_rows;     // output rows a block's band covers (a multiple of the tile; >= h for whole planes)
  int bands;         // bands a plane (1 where a block takes whole planes)
  int per_block;     // bands a block
  int pitch;         // shared-memory floats a row
  int plane_stride;  // shared-memory floats a band
  int map_floats;    // shared-memory floats of the maps (a multiple of 4); the taps follow
  int channels_last; // the input's strides are channels_last (whole planes; P divides C and 128)
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A walk over consecutive elements of contiguous planes of h x w floats,
// kThreads elements a step, tracking each element's plane, row and column
// without a division a step.
struct Walk {
  int p, y, x, dp, dy, dx, h, w;

  __device__ Walk(int at, int h_, int w_) : h(h_), w(w_) {
    const int hw = h * w;
    p = at / hw;
    const int r = at - p * hw;
    y = r / w;
    x = r - y * w;
    dx = kThreads % w;
    const int rows = kThreads / w;
    dy = rows % h;
    dp = rows / h;
  }

  __device__ __forceinline__ void step() {
    x += dx;
    if (x >= w) {
      x -= w;
      ++y;
    }
    y += dy;
    if (y >= h) {
      y -= h;
      ++p;
    }
    p += dp;
  }
};

template <int T, bool BACKWARD>
__global__ void __launch_bounds__(kThreads, 3)
    dwconv_kernel(const float* __restrict__ in, const float* __restrict__ weight,
                  const float* __restrict__ bias, const float* __restrict__ res,
                  float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  float* taps = smem + g.map_floats;
  const int tid = threadIdx.x;
  const int hw = g.h * g.w;
  const int b0 = blockIdx.x * g.per_block;                  // the block's first band
  const int nb = min(g.per_block, g.planes * g.bands - b0);  // its bands
  const int q0 = b0 / g.bands;                               // its first plane
  const int y0 = (b0 - q0 * g.bands) * g.band_rows;          // its first output row (bands)
  const int rows = min(g.h - y0, g.band_rows);               // output rows a band
  const int ylo = max(0, y0 - kHalo), yhi = min(g.h, y0 + g.band_rows + kHalo);
  const int origin = kHalo * g.pitch + kHalo;  // the slot of (row y0, column 0) of band 0
  const long long first = static_cast<long long>(q0) * hw;
  const int c0 = q0 % g.channels;

  // The border and the padding read 0.
  float4* zero = reinterpret_cast<float4*>(smem);
  for (int i = tid; i < g.map_floats / 4; i += kThreads) zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // The bands' rows (with their neighbours' 3 rows each side), and the taps.
  if (!g.channels_last) {
    const int count = (nb - 1) * hw + (yhi - ylo) * g.w;
    Walk at(ylo * g.w + tid, g.h, g.w);
    const float* src = in + first + ylo * g.w + tid;
    for (int e = tid; e < count; e += kThreads, src += kThreads, at.step())
      copy_async(smem + origin + at.p * g.plane_stride + (at.y - y0) * g.pitch + at.x, src);
  } else {
    // Channels c0.. of one image, from channels_last strides: each thread
    // keeps one channel (nb divides kThreads) and steps over the pixels, so
    // a warp reads runs of nb consecutive floats.
    const int p = tid % nb, step = kThreads / nb;  // pixels a step
    const int dx = step % g.w, dy = step / g.w;
    int pixel = tid / nb, y = pixel / g.w, x = pixel - y * g.w;
    const float* src = in + (first - static_cast<long long>(c0) * hw) + c0 + p +
                       static_cast<long long>(pixel) * g.channels;
    const long long src_step = static_cast<long long>(step) * g.channels;
    float* plane = smem + origin + p * g.plane_stride;
    for (; pixel < hw; pixel += step, src += src_step) {
      copy_async(plane + y * g.pitch + x, src);
      x += dx;
      if (x >= g.w) {
        x -= g.w;
        ++y;
      }
      y += dy;
    }
  }
  for (int i = tid; i < nb * kTaps; i += kThreads) {
    const int p = i / kTaps, k = i - p * kTaps;
    int c = c0 + p;
    while (c >= g.channels) c -= g.channels;
    copy_async(taps + i, weight + c * kTaps + (BACKWARD ? kTaps - 1 - k : k));
  }
  wait_copies();
  __syncthreads();

  // One TxT tile of outputs a thread.
  const int tiles_x = (g.w + T - 1) / T;
  const int per_band = (g.band_rows / T) * tiles_x;
  const bool active = tid < nb * per_band;
  int p = 0, ty = 0, tx = 0;
  float acc[T][T];
  if (active) {
    p = tid / per_band;
    const int r = tid - p * per_band;
    ty = r / tiles_x;
    tx = r - ty * tiles_x;
    float w[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) w[k] = taps[p * kTaps + k];
    float start = 0.f;
    if (!BACKWARD) {
      int c = c0 + p;
      while (c >= g.channels) c -= g.channels;
      start = __ldg(bias + c);
    }
#pragma unroll
    for (int o = 0; o < T; ++o)
#pragma unroll
      for (int x = 0; x < T; ++x) acc[o][x] = start;
    const float* s = smem + origin + p * g.plane_stride + (ty * T - kHalo) * g.pitch +
                     tx * T - kHalo;
#pragma unroll
    for (int r = 0; r < T + 2 * kHalo; ++r) {  // each input row of the window once
      float row[T + 2 * kHalo];
#pragma unroll
      for (int c = 0; c < T + 2 * kHalo; ++c) row[c] = s[r * g.pitch + c];
#pragma unroll
      for (int i = 0; i < kSide; ++i) {  // the filter rows that reach an output row of the tile
        const int o = r - i;
        if (o < 0 || o >= T) continue;
#pragma unroll
        for (int j = 0; j < kSide; ++j)
#pragma unroll
          for (int x = 0; x < T; ++x) acc[o][x] = fmaf(w[i * kSide + j], row[x + j], acc[o][x]);
      }
    }
  }
  __syncthreads();  // every window read: the outputs take the inputs' slots
  if (active) {
#pragma unroll
    for (int o = 0; o < T; ++o) {
      const int y = ty * T + o;
      if (y >= rows) break;
#pragma unroll
      for (int x = 0; x < T; ++x)
        if (tx * T + x < g.w)
          smem[origin + p * g.plane_stride + y * g.pitch + tx * T + x] = acc[o][x];
    }
  }
  __syncthreads();

  {
    const int count = (nb - 1) * hw + rows * g.w;
    Walk at(y0 * g.w + tid, g.h, g.w);
    const long long base = first + static_cast<long long>(y0) * g.w;
#pragma unroll 4
    for (int e = tid; e < count; e += kThreads, at.step()) {
      float v = smem[origin + at.p * g.plane_stride + (at.y - y0) * g.pitch + at.x];
      if (BACKWARD) v += __ldg(res + base + e);
      out[base + e] = v;
    }
  }
}

template <int T, bool BACKWARD>
int launch(const float* in, const float* weight, const float* bias, const float* res, float* out,
           const Geometry& g, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (static_cast<size_t>(g.map_floats) + g.per_block * kTaps);
  if (bytes > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    // Once an instance and device, to the most a block may have: the call
    // costs the host more than the launch.
    static unsigned long long raised = 0;  // a bit a device
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err) return err;
    if (device >= 64 || !(raised >> device & 1)) {
      err = cudaFuncSetAttribute(dwconv_kernel<T, BACKWARD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
      if (err) return err;
      if (device < 64) raised |= 1ull << device;
    }
  }
  const long long blocks = (static_cast<long long>(g.planes) * g.bands + g.per_block - 1) /
                           g.per_block;
  dwconv_kernel<T, BACKWARD><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      in, weight, bias, res, out, g);
  return cudaGetLastError();
}

bool valid(const Geometry& g, int tile) {
  if ((tile != 4 && tile != kSide) || g.planes <= 0 || g.channels <= 0 || g.h <= 0 ||
      g.w <= 0 || g.band_rows <= 0 || g.band_rows % tile || g.bands <= 0 ||
      g.per_block <= 0 || g.map_floats % 4)
    return false;
  const int tiles_x = (g.w + tile - 1) / tile;
  const int band_tiles = g.band_rows / tile;
  if (static_cast<long long>(g.band_rows) * g.bands < g.h || (g.bands > 1 && g.per_block > 1) ||
      static_cast<long long>(g.per_block) * band_tiles * tiles_x > kThreads)
    return false;
  if (g.pitch < g.w + kHalo ||
      (g.bands == 1 && g.per_block > 1 && g.plane_stride < (g.h + kHalo) * g.pitch))
    return false;
  if (g.channels_last &&
      (g.bands > 1 || g.channels % g.per_block || kThreads % g.per_block))
    return false;
  // The last band's window, to its far corner, lies inside the maps' floats.
  const long long last = kHalo * g.pitch + kHalo + static_cast<long long>(g.per_block - 1) *
                         g.plane_stride + static_cast<long long>(band_tiles * tile + kHalo - 1) *
                         g.pitch + tiles_x * tile + kHalo - 1;
  return last < g.map_floats && static_cast<long long>(g.planes) * g.h * g.w < (1LL << 31);
}

}  // namespace

// The forward (backward = 0: out = h from in = z, with the bias; res unread)
// or the input gradient (backward = 1: out = dz from in = dh, plus res = dr;
// bias unread) over planes = N·C h x w maps of `channels` channels: out and
// res contiguous NCHW, in contiguous NCHW or, with channels_last = 1 (the
// backward's dh), channels_last-strided; weight (C, 1, 7, 7) contiguous. The tile (7 or 4) and the
// shared-memory geometry come from the host. Returns a CUDA error code (0 on
// success); cudaErrorInvalidValue for a geometry the kernel cannot take.
extern "C" int convnext_dwconv_f32(const float* in, const float* weight, const float* bias,
                                   const float* res, float* out, int backward, int channels_last,
                                   int planes, int channels, int h, int w, int tile,
                                   int band_rows, int bands, int per_block, int pitch,
                                   int plane_stride, int map_floats, cudaStream_t stream) {
  const Geometry g{planes, channels, h,     w,            band_rows, bands,
                   per_block, pitch, plane_stride, map_floats, channels_last};
  if (!valid(g, tile)) return cudaErrorInvalidValue;
  if (tile == kSide)
    return backward ? launch<kSide, true>(in, weight, bias, res, out, g, stream)
                    : launch<kSide, false>(in, weight, bias, res, out, g, stream);
  return backward ? launch<4, true>(in, weight, bias, res, out, g, stream)
                  : launch<4, false>(in, weight, bias, res, out, g, stream);
}
