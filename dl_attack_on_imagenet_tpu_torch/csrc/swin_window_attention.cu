// swin_window_attention: a Swin block's whole windowed attention between its
// qkv and proj Linears, forward and input gradient, in fp32.
//
// Replaces no Pallas kernel: the JAX package has no Swin. It was added for
// Swin-B, whose attention halves took two thirds of a forward and input
// gradient in plain PyTorch, most of it memory- and latency-bound work
// around the GEMMs: the cyclic roll and window partition and their reverse,
// the q/k/v head layouts, the relative-position bias gathered on every
// pass, the bias and -100 mask adds, softmax, and small batched products
// whose 49x49 score matrices went to device memory and back about 13 times
// a pass.
//
// Forward, for one (window, head) a block: q, k and v of the window's
// tokens are read straight from the (N, H, W, 3C) qkv map, which the qkv
// Linear wrote per token before any roll. Window token t = (ty, tx) of
// window (wy, wx) sits at (wy W + ty, wx W + tx) of the map rolled by
// (-sh, -sw), that is at ((wy W + ty + sh) mod H, (wx W + tx + sw) mod W)
// of the map as it is: the roll and the partition are this indexing, and
// the output goes back to the same place, which undoes both. Then
//   s_ij = (q_i / sqrt(d)) . k_j + (table[rel(i, j), head] + mask_ij)
//   o_i  = softmax_j(s_ij) v_j
// with rel(i, j) = (yi - yj + W - 1)(2W - 1) + xi - xj + W - 1 (the index
// of ``relative_position_index``) and mask_ij = -100 where tokens i and j
// lie in different regions of the rolled map, 0 where they share one (the
// regions of each axis: before its last window, in it up to the cells the
// roll brought round, and those; one region on an axis not rolled). The
// softmax subtracts its row's maximum and multiplies by the reciprocal of
// its row's sum; the forward keeps each row's log-sum-exp (N x windows x
// heads x T floats) for the backward.
//
// Backward, for one (window, head) a block: from q, k, v, the output's
// gradient dO (map order) and the log-sum-exp, it recomputes
// P = exp(S - lse), then dV = P^T dO, dP = dO V^T,
// dS = P o (dP - rowsum(P o dP)), dQ = dS K / sqrt(d) and
// dK = dS^T (Q / sqrt(d)), and writes dQ, dK and dV into the (N, H, W, 3C)
// gradient of the qkv map, each element once (each token lies in one window
// a block), so no atomics. The bias table gets no gradient: the victim is
// frozen, and the wrapper refuses a table that needs one.
//
// Bound on an H100 SXM at Swin-B's shapes (T = 49 tokens, d = 32): per
// token and channel the forward reads q, k and v and writes o, 16 bytes,
// against 4 T = 196 flop; the backward reads q, k, v and dO and writes dq,
// dk and dv, 28 bytes, against 8 T = 392 flop (recomputation not counted).
// At 3.35 TB/s and 67 TFLOP/s both directions are bound by bytes; Swin-B's
// 24 blocks hold 3,110,912 token-channels an image, so a forward and input
// gradient at batch 64 needs at least 2.6 ms. The fp32 FMAs come close
// behind (1.7 ms), so the design keeps the FMA pipes fed as well as the
// bytes few.
//
// Design. One block of 128 threads per (window, head), five blocks an SM
// (registers capped at 96 a thread). The block copies its window's q, k, v
// (and dO) rows once into shared memory, rows padded to d + 4 floats, by
// asynchronous 16-byte copies all in flight together (cp.async), then
// scales q in place; the 49 x 49 scores live in shared memory and
// registers only. Two product shapes do all the work. "Lanes over keys": a
// lane holds the k (or v) rows of keys j and j + 32 in registers and takes
// their dot products with two query rows at a time, broadcast from shared
// memory as float4; it gives the scores and dP, with the softmax's max and
// sum by warp shuffles, the two rows' interleaved. "Lanes over the head
// dimension": a lane holds one column of a T x d operand in registers and
// sums two output rows at a time against float4 runs of the score tile;
// it gives o, dQ, dK and dV. Each float4 read from shared memory feeds four
// to eight FMAs. fp32 FMA only: no TF32, no tensor cores, no fast math
// (expf and logf are the accurate ones). The kernels are instantiated for
// (window, head dim) = (7, 32), Swin-B's every stage, and (4, 8), the
// small test Swin's; other shapes are refused.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 5;  // resident blocks an SM is built for: registers capped at 96
constexpr int kRows = 2;  // query rows a warp takes at once; output rows a lane group sums at once
constexpr float kMasked = -100.0f;

template <int W, int D>
struct Tile {
  static constexpr int T = W * W;               // tokens in a window
  static constexpr int RS = D + 4;              // row stride of q, k, v, dO in shared memory
  static constexpr int PS = (T + 3) / 4 * 4;    // row stride of the T x T score tile
  static constexpr int TB = (2 * W - 1) * (2 * W - 1);  // rows of the bias table
  static constexpr int JL = (T + 31) / 32;      // keys a lane holds (lanes over keys)
  static constexpr int RPI = 32 / D;            // lane groups of a warp (lanes over the head dim)
  static constexpr int V4 = D / 4;              // float4s in a head's row
  static_assert(T <= 64 && 32 % D == 0 && D % 4 == 0, "unsupported window or head dim");
};

struct Geometry {
  int h, w, heads, shift_h, shift_w;
  float scale;  // 1 / sqrt(head dim)
};

// The region of cell i on an axis of n cells rolled by s: 0 before the last
// window, 1 in it up to the cells the roll brought round, 2 for those; all
// 0 on an axis not rolled.
__device__ __forceinline__ int band(int i, int n, int window, int s) {
  return s ? (i >= n - window) + (i >= n - s) : 0;
}

// Where each token of the block's window lies in the map (token index
// (n H + y) W + x), its region, and the block's head's column of the
// bias table.
template <int W, int D>
__device__ void window_tokens(const Geometry& g, const float* __restrict__ table,
                              long long* tok, int* region, float* bias) {
  using S = Tile<W, D>;
  const int nwh = g.h / W, nww = g.w / W;
  const int image = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh, wx = blockIdx.x % nww;
  for (int t = threadIdx.x; t < S::T; t += kThreads) {
    const int r = wy * W + t / W, c = wx * W + t % W;
    int y = r + g.shift_h, x = c + g.shift_w;
    if (y >= g.h) y -= g.h;
    if (x >= g.w) x -= g.w;
    tok[t] = ((long long)image * g.h + y) * g.w + x;
    region[t] = band(r, g.h, W, g.shift_h) * 3 + band(c, g.w, W, g.shift_w);
  }
  for (int u = threadIdx.x; u < S::TB; u += kThreads) bias[u] = table[u * g.heads + blockIdx.y];
}

// dst[t][0:D] = src[tok[t] * stride + offset + 0:D] for each token, by
// asynchronous 16-byte copies: every row of every operand in flight at once.
template <int W, int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src,
                                          const long long* tok, long long stride, int offset) {
  using S = Tile<W, D>;
  for (int e = threadIdx.x; e < S::T * S::V4; e += kThreads) {
    const int t = e / S::V4, c = 4 * (e % S::V4);
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + t * S::RS + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + tok[t] * stride + offset + c)
                 : "memory");
  }
}

// Wait for the copies, then scale q in place (q / sqrt(d), as the twin
// rounds it: one multiply by the reciprocal).
template <int W, int D>
__device__ __forceinline__ void finish_copies(float* qs, float scale) {
  using S = Tile<W, D>;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int e = threadIdx.x; e < S::T * D; e += kThreads) qs[e / D * S::RS + e % D] *= scale;
  __syncthreads();
}

// A lane's key rows j = lane + 32 u in registers, 0 past the window.
template <int W, int D>
__device__ __forceinline__ void key_rows(float (&kr)[Tile<W, D>::JL][D], const float* rows,
                                         int lane) {
  using S = Tile<W, D>;
#pragma unroll
  for (int u = 0; u < S::JL; ++u) {
    const int j = lane + 32 * u;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 v = j < S::T ? *reinterpret_cast<const float4*>(rows + j * S::RS + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      kr[u][d] = v.x;
      kr[u][d + 1] = v.y;
      kr[u][d + 2] = v.z;
      kr[u][d + 3] = v.w;
    }
  }
}

// Lanes over keys: acc[r][u] = a_{i0 + r} . kr[u] for kRows rows of ``a``
// (rows past the window read the last one; their sums are not used).
template <int W, int D>
__device__ __forceinline__ void row_dots(float (&acc)[kRows][Tile<W, D>::JL], const float* a,
                                         const float (&kr)[Tile<W, D>::JL][D], int i0) {
  using S = Tile<W, D>;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int u = 0; u < S::JL; ++u) acc[r][u] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(a + min(i0 + r, S::T - 1) * S::RS + d);
#pragma unroll
      for (int u = 0; u < S::JL; ++u) {
        acc[r][u] = fmaf(q.x, kr[u][d], acc[r][u]);
        acc[r][u] = fmaf(q.y, kr[u][d + 1], acc[r][u]);
        acc[r][u] = fmaf(q.z, kr[u][d + 2], acc[r][u]);
        acc[r][u] = fmaf(q.w, kr[u][d + 3], acc[r][u]);
      }
    }
  }
}

// What a lane needs of its keys j = lane + 32 u for the bias and mask:
// the offset (yj (2W - 1) + xj) that rel(i, j) subtracts, and the region
// (-1 past the window).
template <int W, int D>
struct Keys {
  int offset[Tile<W, D>::JL];
  int region[Tile<W, D>::JL];
  __device__ __forceinline__ Keys(const int* regions, int lane) {
#pragma unroll
    for (int u = 0; u < Tile<W, D>::JL; ++u) {
      const int j = lane + 32 * u;
      offset[u] = j / W * (2 * W - 1) + j % W;
      region[u] = j < Tile<W, D>::T ? regions[j] : -1;
    }
  }
};

// The scores of rows i0..i0+kRows against the lane's keys: the dot
// products plus (bias + mask), -inf past the window.
template <int W, int D>
__device__ __forceinline__ void scores(float (&s)[kRows][Tile<W, D>::JL], const float* qs,
                                       const float (&kr)[Tile<W, D>::JL][D], int i0,
                                       const float* bias, const int* region,
                                       const Keys<W, D>& keys) {
  using S = Tile<W, D>;
  row_dots<W, D>(s, qs, kr, i0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(i0 + r, S::T - 1);
    const int base = (i / W + W - 1) * (2 * W - 1) + i % W + W - 1, ri = region[i];
#pragma unroll
    for (int u = 0; u < S::JL; ++u)
      s[r][u] = keys.region[u] < 0 ? -INFINITY
                                   : s[r][u] + (bias[base - keys.offset[u]] +
                                                (ri == keys.region[u] ? 0.f : kMasked));
  }
}

// Where a product's rows go: row t of the window to dst[tok[t] * stride +
// offset + 0:D], times ``mul``.
struct Rows {
  float* dst;
  const long long* tok;
  long long stride;
  int offset;
  float mul;
  __device__ __forceinline__ void store(int t, int dd, float v) const {
    dst[tok[t] * stride + offset + dd] = v * mul;
  }
};

// Each of kRows values reduced across the warp, the rows' shuffles
// interleaved.
__device__ __forceinline__ void warp_max(float (&v)[kRows]) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
}

__device__ __forceinline__ void warp_sum(float (&v)[kRows]) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// Lanes over the head dim, rows of the score tile: out[i][dd] =
// sum_j A[i][j] X[j][dd], kRows rows i at a time.
template <int W, int D>
__device__ __forceinline__ void tile_rows_times(const float* a, const float* x, int warp,
                                                int lane, const Rows& out) {
  using S = Tile<W, D>;
  const int dd = lane % D, group = lane / D;
  float xr[S::PS];
#pragma unroll
  for (int j = 0; j < S::PS; ++j) xr[j] = j < S::T ? x[j * S::RS + dd] : 0.f;
  for (int i0 = (warp * S::RPI + group) * kRows; i0 < S::T; i0 += kWarps * S::RPI * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll
    for (int j = 0; j < S::PS; j += 4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(a + min(i0 + r, S::T - 1) * S::PS + j);
        acc[r] = fmaf(p.x, xr[j], acc[r]);
        acc[r] = fmaf(p.y, xr[j + 1], acc[r]);
        acc[r] = fmaf(p.z, xr[j + 2], acc[r]);
        acc[r] = fmaf(p.w, xr[j + 3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < S::T) out.store(i0 + r, dd, acc[r]);
  }
}

// Lanes over the head dim, columns of the score tile: out[j][dd] =
// sum_i A[i][j] X[i][dd], four consecutive columns j at a time.
template <int W, int D>
__device__ __forceinline__ void tile_cols_times(const float* a, const float* x, int warp,
                                                int lane, const Rows& out) {
  using S = Tile<W, D>;
  const int dd = lane % D, group = lane / D;
  float xr[S::T];
#pragma unroll
  for (int i = 0; i < S::T; ++i) xr[i] = x[i * S::RS + dd];
  for (int j0 = (warp * S::RPI + group) * 4; j0 < S::T; j0 += kWarps * S::RPI * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < S::T; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(a + i * S::PS + j0);
      acc[0] = fmaf(p.x, xr[i], acc[0]);
      acc[1] = fmaf(p.y, xr[i], acc[1]);
      acc[2] = fmaf(p.z, xr[i], acc[2]);
      acc[3] = fmaf(p.w, xr[i], acc[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < S::T) out.store(j0 + c, dd, acc[c]);
  }
}

template <int W, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
swin_window_attention_forward_kernel(const float* __restrict__ qkv, const float* __restrict__ table,
                                     float* __restrict__ out, float* __restrict__ lse, Geometry g) {
  using S = Tile<W, D>;
  __shared__ __align__(16) float qs[S::T * S::RS];
  __shared__ __align__(16) float ks[S::T * S::RS];
  __shared__ __align__(16) float vs[S::T * S::RS];
  __shared__ __align__(16) float ps[S::T * S::PS];
  __shared__ long long tok[S::T];
  __shared__ int region[S::T];
  __shared__ float bias[S::TB];
  const int c = g.heads * D, head = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  window_tokens<W, D>(g, table, tok, region, bias);
  __syncthreads();
  copy_rows<W, D>(qs, qkv, tok, 3LL * c, head * D);
  copy_rows<W, D>(ks, qkv, tok, 3LL * c, c + head * D);
  copy_rows<W, D>(vs, qkv, tok, 3LL * c, 2 * c + head * D);
  finish_copies<W, D>(qs, g.scale);

  // Scores and softmax, lanes over keys; P into the score tile.
  {
    float kr[S::JL][D];
    key_rows<W, D>(kr, ks, lane);
    const Keys<W, D> keys(region, lane);
    float* lse_rows = lse + ((long long)blockIdx.x * g.heads + head) * S::T;
    for (int i0 = warp * kRows; i0 < S::T; i0 += kWarps * kRows) {
      // Rows past the window repeat the last one and are not stored.
      float s[kRows][S::JL], m[kRows], sum[kRows];
      scores<W, D>(s, qs, kr, i0, bias, region, keys);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        m[r] = s[r][0];
#pragma unroll
        for (int u = 1; u < S::JL; ++u) m[r] = fmaxf(m[r], s[r][u]);
      }
      warp_max(m);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sum[r] = 0.f;
#pragma unroll
        for (int u = 0; u < S::JL; ++u) {
          s[r][u] = expf(s[r][u] - m[r]);
          sum[r] += s[r][u];
        }
      }
      warp_sum(sum);
      float inv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) inv[r] = 1.f / sum[r];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < S::T) {
#pragma unroll
          for (int u = 0; u < S::JL; ++u) {
            const int j = lane + 32 * u;
            if (j < S::PS) ps[i * S::PS + j] = s[r][u] * inv[r];
          }
          if (lane == 0) lse_rows[i] = m[r] + logf(sum[r]);
        }
      }
    }
  }
  __syncthreads();

  // o = P V, lanes over the head dim, stored where the token lies.
  tile_rows_times<W, D>(ps, vs, warp, lane, Rows{out, tok, c, head * D, 1.f});
}

template <int W, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
swin_window_attention_backward_kernel(const float* __restrict__ qkv,
                                      const float* __restrict__ table,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ dout, float* __restrict__ dqkv,
                                      Geometry g) {
  using S = Tile<W, D>;
  __shared__ __align__(16) float qs[S::T * S::RS];
  __shared__ __align__(16) float ks[S::T * S::RS];
  __shared__ __align__(16) float vs[S::T * S::RS];
  __shared__ __align__(16) float dos[S::T * S::RS];
  __shared__ __align__(16) float ps[S::T * S::PS];
  __shared__ long long tok[S::T];
  __shared__ int region[S::T];
  __shared__ float bias[S::TB];
  const int c = g.heads * D, head = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  window_tokens<W, D>(g, table, tok, region, bias);
  __syncthreads();
  copy_rows<W, D>(qs, qkv, tok, 3LL * c, head * D);
  copy_rows<W, D>(ks, qkv, tok, 3LL * c, c + head * D);
  copy_rows<W, D>(vs, qkv, tok, 3LL * c, 2 * c + head * D);
  copy_rows<W, D>(dos, dout, tok, c, head * D);
  finish_copies<W, D>(qs, g.scale);

  // P = exp(S - lse), lanes over keys.
  const float* lse_rows = lse + ((long long)blockIdx.x * g.heads + head) * S::T;
  {
    float kr[S::JL][D];
    key_rows<W, D>(kr, ks, lane);
    const Keys<W, D> keys(region, lane);
    for (int i0 = warp * kRows; i0 < S::T; i0 += kWarps * kRows) {
      float s[kRows][S::JL];
      scores<W, D>(s, qs, kr, i0, bias, region, keys);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < S::T) {
          const float l = lse_rows[i];
#pragma unroll
          for (int u = 0; u < S::JL; ++u) {
            const int j = lane + 32 * u;
            if (j < S::PS) ps[i * S::PS + j] = expf(s[r][u] - l);
          }
        }
      }
    }
  }
  __syncthreads();

  // dV = P^T dO.
  tile_cols_times<W, D>(ps, dos, warp, lane, Rows{dqkv, tok, 3LL * c, 2 * c + head * D, 1.f});
  __syncthreads();

  // dS = P o (dP - rowsum(P o dP)) with dP = dO V^T, lanes over keys; dS
  // replaces P in the score tile, each row by the warp that reads it.
  {
    float vr[S::JL][D];
    key_rows<W, D>(vr, vs, lane);
    for (int i0 = warp * kRows; i0 < S::T; i0 += kWarps * kRows) {
      float dp[kRows][S::JL];
      row_dots<W, D>(dp, dos, vr, i0);
      float p[kRows][S::JL], dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, S::T - 1);
        dot[r] = 0.f;
#pragma unroll
        for (int u = 0; u < S::JL; ++u) {
          const int j = lane + 32 * u;
          p[r][u] = j < S::T ? ps[i * S::PS + j] : 0.f;
          dot[r] = fmaf(p[r][u], dp[r][u], dot[r]);
        }
      }
      warp_sum(dot);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < S::T) {
#pragma unroll
          for (int u = 0; u < S::JL; ++u) {
            const int j = lane + 32 * u;
            if (j < S::PS) ps[i * S::PS + j] = p[r][u] * (dp[r][u] - dot[r]);
          }
        }
      }
    }
  }
  __syncthreads();

  // dQ = dS K / sqrt(d); dK = dS^T (Q / sqrt(d)).
  tile_rows_times<W, D>(ps, ks, warp, lane, Rows{dqkv, tok, 3LL * c, head * D, g.scale});
  tile_cols_times<W, D>(ps, qs, warp, lane, Rows{dqkv, tok, 3LL * c, c + head * D, 1.f});
}

template <int W, int D>
cudaError_t launch_forward(const float* qkv, const float* table, float* out, float* lse, int n,
                           const Geometry& g, cudaStream_t stream) {
  const dim3 grid(n * (g.h / W) * (g.w / W), g.heads);
  swin_window_attention_forward_kernel<W, D><<<grid, kThreads, 0, stream>>>(qkv, table, out, lse,
                                                                            g);
  return cudaGetLastError();
}

template <int W, int D>
cudaError_t launch_backward(const float* qkv, const float* table, const float* lse,
                            const float* dout, float* dqkv, int n, const Geometry& g,
                            cudaStream_t stream) {
  const dim3 grid(n * (g.h / W) * (g.w / W), g.heads);
  swin_window_attention_backward_kernel<W, D><<<grid, kThreads, 0, stream>>>(qkv, table, lse,
                                                                             dout, dqkv, g);
  return cudaGetLastError();
}

Geometry geometry(int h, int w, int heads, int head_dim, int shift_h, int shift_w) {
  return Geometry{h, w, heads, shift_h, shift_w, 1.0f / sqrtf((float)head_dim)};
}

}  // namespace

// The forward: qkv (n, h, w, 3 heads head_dim), table ((2 window - 1)^2,
// heads), out (n, h, w, heads head_dim) and lse (n windows heads window^2),
// all contiguous fp32 on the device, 16-byte aligned. Returns a CUDA error,
// or cudaErrorInvalidValue for a (window, head_dim) it was not built for.
extern "C" int swin_window_attention_forward_f32(const float* qkv, const float* table, float* out,
                                                 float* lse, int n, int h, int w, int heads,
                                                 int window, int head_dim, int shift_h,
                                                 int shift_w, void* stream) {
  const Geometry g = geometry(h, w, heads, head_dim, shift_h, shift_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window == 7 && head_dim == 32) return launch_forward<7, 32>(qkv, table, out, lse, n, g, s);
  if (window == 4 && head_dim == 8) return launch_forward<4, 8>(qkv, table, out, lse, n, g, s);
  return cudaErrorInvalidValue;
}

// The input gradient: dout (n, h, w, heads head_dim) in, dqkv (n, h, w,
// 3 heads head_dim) out, every element written; the rest as the forward.
extern "C" int swin_window_attention_backward_f32(const float* qkv, const float* table,
                                                  const float* lse, const float* dout,
                                                  float* dqkv, int n, int h, int w, int heads,
                                                  int window, int head_dim, int shift_h,
                                                  int shift_w, void* stream) {
  const Geometry g = geometry(h, w, heads, head_dim, shift_h, shift_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window == 7 && head_dim == 32)
    return launch_backward<7, 32>(qkv, table, lse, dout, dqkv, n, g, s);
  if (window == 4 && head_dim == 8)
    return launch_backward<4, 8>(qkv, table, lse, dout, dqkv, n, g, s);
  return cudaErrorInvalidValue;
}
