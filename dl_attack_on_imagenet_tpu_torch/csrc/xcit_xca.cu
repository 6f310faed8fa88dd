// xcit_xca: the core of XCiT's cross-covariance attention (XCA), from the
// output of a block's qkv Linear to the input of its proj Linear, forward
// and input gradient, in fp32.
//
// Replaces no Pallas kernel: the JAX package has no XCiT. It was added for
// XCiT-L12, whose XCA core in plain PyTorch (the q/k/v permute, two
// F.normalize over the tokens on strided views, batched 48 x 196 x 48
// products, the temperature, a 48-wide softmax, the permute and copy back,
// and the backward of each) took about as much of the card as the block's
// qkv and proj GEMMs, far from its bound.
//
// What it computes, for one (image, head) a block, with q, k and v the
// head's D channels over the N tokens (q_i the column of channel i):
//   |q_i| = sqrt(sum_n q_ni^2), nq_i = max(|q_i|, 1e-12), likewise k
//   Ŝ_ij  = (sum_n q_ni k_nj) / (nq_i nk_j)          (q̂_i . k̂_j)
//   A_i   = softmax_j(Ŝ_ij τ_h)                       (row max subtracted)
//   out_ni = sum_j A_ij v_nj, into token row n, channel h D + i
// which is F.normalize's semantics, eps included (the twin is
// models.xcit.xca_reference). The forward saves Ŝ and the norms |q|, |k|
// (D² + 2 D floats a block), not q̂, k̂ or the scores. The backward, from
// the output's gradient dO:
//   dA_ij = sum_n dO_ni v_nj,   dv_nj = sum_i A_ij dO_ni
//   G_ij  = A_ij (dA_ij - sum_j' A_ij' dA_ij') τ_h    (the gradient of Ŝ)
//   c_i   = sum_j G_ij Ŝ_ij,    e_j = sum_i G_ij Ŝ_ij  (q̂_i . dq̂_i, k̂_j . dk̂_j)
//   dq_ni = sum_j G_ij k_nj / (nq_i nk_j) - q_ni c_i / nq_i²
//   dk_nj = sum_i G_ij q_ni / (nq_i nk_j) - k_nj e_j / nk_j²
// where a norm under eps drops its projection term (c or e taken as 0): the
// clamp passes no gradient to the norm there. A is recomputed from the
// saved Ŝ by the forward's own code, so it is the forward's to the bit. The
// temperature gets no gradient: the victim is frozen, and the wrapper
// refuses a temperature that needs one.
//
// Bound on an H100 SXM: per token-channel the forward reads q, k and v and
// writes the output, 16 B, against 4 D flop; the backward reads q, k, v and
// dO and writes dq, dk and dv, 28 B, against 8 D flop. At D = 48, 3.35 TB/s
// and 67 TFLOP/s both directions are bound by bytes: XCiT-L12's 12 blocks of
// 196 tokens x 768 channels need at least 0.552 ms forward and 0.966 ms
// backward a pass at batch 64 (h100bench/metrics/xcit_xca_roofline.py). The
// saved Ŝ and norms add D² + 2 D floats a block each way, about 6%.
//
// Design. One block of 4 D threads per (image, head), two passes over the
// tokens each way, each token row read from device memory once: the tokens
// come in chunks of 32 rows of each operand, copied into shared memory by
// asynchronous 16-byte copies, the next chunk in flight under the current
// one's arithmetic. Everything between the passes is D x D, in shared
// memory. Each thread owns a 4 x D/4 tile of a D x D matrix (rows i0..+3,
// columns j0..+D/4) and belongs to one of four token groups:
//  - a Gram product (a sum over tokens of x_ni y_nj: the forward's q kᵀ, the
//    backward's dA) keeps its tile's D sums in registers and reads, a token,
//    one float4 of x and D/16 float4s of y from shared memory, each shared
//    by the lanes that need it, for D FMAs; the groups' partial tiles are
//    summed through shared memory after the pass;
//  - a matrix-vector product (out = A v, dv = Aᵀ dO, dq, dk) keeps its tile
//    of the matrix in registers and, a token, sums its 4 rows over its D/4
//    columns; the 4 lanes of a quad (one band of rows) then sum their
//    partials by three shuffles, each left with one channel, which it
//    stores: a warp writes 32 consecutive floats of a token row.
// In the backward the groups split the roles, so that every lane does D
// FMAs a token: two groups take dA while two take dv, then two write dq
// while two write dk. fp32 FMA only: no TF32, no tensor cores, no fast math
// (expf, sqrtf and the divisions are the accurate ones). Instantiated for
// D = 48 (XCiT-L12's 16 heads) and D = 16 (the small test XCiT); other head
// dims are refused.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroups = 4;   // token groups a block
constexpr int kChunk = 32;   // token rows a stage holds of each operand
constexpr float kEps = 1e-12f;

template <int D>
struct Head {
  static constexpr int kThreads = kGroups * D;
  static constexpr int kCols = D / 4;             // columns of a thread's tile
  // A D x D matrix in shared memory: rows of D + 4 floats, so that the two
  // bands of tile rows a quarter-warp's float4s reach fall 16 banks apart.
  static constexpr int kPitch = D + 4;
  static constexpr int kMat = D * kPitch;
  static constexpr int kSaved = D * D + 2 * D;    // Ŝ, |q|, |k| a block, in device memory
  static constexpr int kStage = 2 * kChunk * D;   // a stage: two operands' rows
  // Shared memory, floats: two stages, three D x D matrices, the groups'
  // partial squared norms (the backward's projection coefficients), the norms.
  static constexpr int kShared = 2 * kStage + 3 * kMat + kGroups * 2 * D + 2 * D;
  static constexpr int kMinBlocks = D == 48 ? 4 : 8;  // resident blocks an SM is built for
  static_assert(D % 16 == 0, "the head dim must be a multiple of 16");
};

// A thread's place: its token group, and its tile of a D x D matrix: rows
// row0..row0+3 (band = row0 / 4), columns col0..col0+D/4 (quad = its lane in
// the band's 4, which also names the one row it keeps of a product).
template <int D>
struct Lane {
  int group, band, quad, row0, col0;
  __device__ __forceinline__ Lane() {
    const int tile = threadIdx.x % D;
    group = threadIdx.x / D;
    band = tile / 4;
    quad = tile % 4;
    row0 = 4 * band;
    col0 = quad * Head<D>::kCols;
  }
};

// The block's token rows of up to two operands: the first token's row of
// the block's head in each, and the floats between rows.
template <int OPS>
struct Source {
  const float* rows[OPS];
  long long stride[OPS];
};

// Chunk ``chunk``'s rows of every operand of ``s`` into ``stage`` (operand
// o at o kChunk D, row stride D), by asynchronous 16-byte copies, as one
// group.
template <int D, int OPS>
__device__ __forceinline__ void fetch(float* stage, const Source<OPS>& s, int chunk, int n) {
  const int n0 = chunk * kChunk, count = min(kChunk, n - n0);
#pragma unroll
  for (int o = 0; o < OPS; ++o) {
    const float* src = s.rows[o] + n0 * s.stride[o];
    for (int e = threadIdx.x; e < count * (D / 4); e += Head<D>::kThreads) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      const unsigned to = static_cast<unsigned>(
          __cvta_generic_to_shared(stage + o * kChunk * D + r * D + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(src + r * s.stride[o] + c)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One pass over the tokens: body(stage, first token, rows) on each chunk
// with its rows landed, the next chunk's copies in flight meanwhile. The
// first chunk must already be in flight into the first stage (so that its
// copies overlap what comes before the pass); every stage is free again
// when the pass returns.
template <int D, int OPS, typename Body>
__device__ __forceinline__ void stream(float* stages, const Source<OPS>& s, int n, Body body) {
  const int chunks = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      fetch<D, OPS>(stages + ((c + 1) & 1) * Head<D>::kStage, s, c + 1, n);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    body(stages + (c & 1) * Head<D>::kStage, c * kChunk, min(kChunk, n - c * kChunk));
    __syncthreads();
  }
}

template <int D>
using Tile = float[4][D / 4];

// D/4 consecutive floats of a row from ``row`` on (16-byte aligned), as
// float4s, and back.
template <int D>
__device__ __forceinline__ void row_part(float (&y)[D / 4], const float* row) {
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * u);
    y[4 * u] = v.x;
    y[4 * u + 1] = v.y;
    y[4 * u + 2] = v.z;
    y[4 * u + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void store_part(float* row, const float (&y)[D / 4]) {
#pragma unroll
  for (int u = 0; u < D / 16; ++u)
    *reinterpret_cast<float4*>(row + 4 * u) =
        make_float4(y[4 * u], y[4 * u + 1], y[4 * u + 2], y[4 * u + 3]);
}

// Gram product over rows first, first + step, ... < count of x and y (row
// stride D): t[a][b] += x[r][row0 + a] y[r][col0 + b]. With NORMS, also the
// squared norms of the lane's channel of x (row0 + quad) and of y (col0 +
// band): every channel is one lane's of a group.
template <int D, bool NORMS>
__device__ __forceinline__ void gram_rows(Tile<D>& t, const float* xs, const float* ys, int first,
                                          int step, int count, const Lane<D>& l, float& xsq,
                                          float& ysq) {
#pragma unroll 2
  for (int r = first; r < count; r += step) {
    const float4 x = *reinterpret_cast<const float4*>(xs + r * D + l.row0);
    float y[D / 4];
    row_part<D>(y, ys + r * D + l.col0);
#pragma unroll
    for (int b = 0; b < D / 4; ++b) {
      t[0][b] = fmaf(x.x, y[b], t[0][b]);
      t[1][b] = fmaf(x.y, y[b], t[1][b]);
      t[2][b] = fmaf(x.z, y[b], t[2][b]);
      t[3][b] = fmaf(x.w, y[b], t[3][b]);
    }
    if (NORMS) {
      const float xv = xs[r * D + l.row0 + l.quad], yv = ys[r * D + l.col0 + l.band];
      xsq = fmaf(xv, xv, xsq);
      ysq = fmaf(yv, yv, ysq);
    }
  }
}

// The quad's four partial sums p[0..3] of rows row0..row0+3 summed across
// the quad: returns row row0 + quad's total. Every lane of the warp calls it.
__device__ __forceinline__ float quad_sum(const float (&p)[4], int quad) {
  const bool hi = quad & 2, odd = quad & 1;
  const float s0 = __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
  const float s1 = __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
  const float k0 = (hi ? p[2] : p[0]) + s0, k1 = (hi ? p[3] : p[1]) + s1;
  const float s = __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
  return (odd ? k1 : k0) + s;
}

// Matrix-vector product over rows first, first + step, ... < count of y
// (row stride D): for each row r, emit(r, sum_j M[row0 + quad][j] y[r][j])
// with the lane's tile t = M[row0..+3][col0..+D/4]. Every lane of a warp
// runs the same rounds (the rows past ``count`` repeat the last and are not
// emitted), as the shuffles need.
template <int D, typename Emit>
__device__ __forceinline__ void matvec_rows(const Tile<D>& t, const float* ys, int first, int step,
                                            int count, const Lane<D>& l, Emit emit) {
  const int rounds = (count + step - 1) / step;
#pragma unroll 2
  for (int k = 0; k < rounds; ++k) {
    const int r = first + k * step, rr = min(r, count - 1);
    float y[D / 4];
    row_part<D>(y, ys + rr * D + l.col0);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < D / 4; ++b) {
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = fmaf(t[a][b], y[b], p[a]);
    }
    const float total = quad_sum(p, l.quad);
    if (r < count) emit(r, total);
  }
}

// A lane's tile of a D x D matrix m in shared memory (row pitch kPitch),
// by float4s: stored, added, loaded, or loaded from mᵀ (TRANSPOSED: t[a][b]
// = m[col0 + b][row0 + a]).
template <int D>
__device__ __forceinline__ void store_tile(float* m, const Tile<D>& t, const Lane<D>& l) {
#pragma unroll
  for (int a = 0; a < 4; ++a) store_part<D>(m + (l.row0 + a) * Head<D>::kPitch + l.col0, t[a]);
}

template <int D>
__device__ __forceinline__ void add_tile(Tile<D>& t, const float* m, const Lane<D>& l) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float y[D / 4];
    row_part<D>(y, m + (l.row0 + a) * Head<D>::kPitch + l.col0);
#pragma unroll
    for (int b = 0; b < D / 4; ++b) t[a][b] += y[b];
  }
}

template <int D, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(Tile<D>& t, const float* m, const Lane<D>& l) {
  if (TRANSPOSED) {
#pragma unroll
    for (int b = 0; b < D / 4; ++b) {
      const float4 v =
          *reinterpret_cast<const float4*>(m + (l.col0 + b) * Head<D>::kPitch + l.row0);
      t[0][b] = v.x;
      t[1][b] = v.y;
      t[2][b] = v.z;
      t[3][b] = v.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) row_part<D>(t[a], m + (l.row0 + a) * Head<D>::kPitch + l.col0);
  }
}

// Quad sums and maxima: the 4 threads of a matrix row (or column) in the
// row steps between the passes.
__device__ __forceinline__ float quad_add(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A row's part of softmax(Ŝ τ): s holds the thread's D/4 values of Ŝ (its
// row threadIdx.x / 4, its quarter threadIdx.x % 4) and gets the same part
// of A. The forward and the backward both call it, so the backward's A is
// the forward's.
template <int D>
__device__ __forceinline__ void softmax_part(float (&s)[D / 4], float tau) {
  float m = -INFINITY;
#pragma unroll
  for (int b = 0; b < D / 4; ++b) {
    s[b] = s[b] * tau;
    m = fmaxf(m, s[b]);
  }
  m = quad_max(m);
  float sum = 0.f;
#pragma unroll
  for (int b = 0; b < D / 4; ++b) {
    s[b] = expf(s[b] - m);
    sum += s[b];
  }
  sum = quad_add(sum);
#pragma unroll
  for (int b = 0; b < D / 4; ++b) s[b] = s[b] / sum;
}

struct Geometry {
  int n, heads;  // tokens, heads
};

template <int D>
__global__ void __launch_bounds__(Head<D>::kThreads, Head<D>::kMinBlocks)
xcit_xca_forward_kernel(const float* __restrict__ qkv, const float* __restrict__ tau,
                        float* __restrict__ out, float* __restrict__ saved, Geometry g) {
  using H = Head<D>;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;
  float* mats = stages + 2 * H::kStage;   // the groups' partial Grams, then A
  float* sq = mats + 3 * H::kMat;         // partial squared norms: a group's q (D), k (D)
  float* norms = sq + kGroups * 2 * D;    // |q| (D), |k| (D)
  const Lane<D> l;
  const int head = blockIdx.x % g.heads;
  const long long image = blockIdx.x / g.heads, c = static_cast<long long>(g.heads) * D;
  const float* rows = qkv + image * g.n * 3 * c + head * D;
  float* saved_block = saved + static_cast<long long>(blockIdx.x) * H::kSaved;
  const Source<2> qk{{rows, rows + c}, {3 * c, 3 * c}};
  fetch<D, 2>(stages, qk, 0, g.n);

  // Pass 1: the Gram q kᵀ and the squared norms, a token group a lane.
  Tile<D> t;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < D / 4; ++b) t[a][b] = 0.f;
  float qsq = 0.f, ksq = 0.f;
  stream<D, 2>(stages, qk, g.n, [&](const float* st, int, int count) {
    gram_rows<D, true>(t, st, st + kChunk * D, l.group, kGroups, count, l, qsq, ksq);
  });
  const Source<1> vs{{rows + 2 * c}, {3 * c}};
  fetch<D, 1>(stages, vs, 0, g.n);

  // The groups' sums: groups 1..3 put theirs in mats[g - 1]; group 0 adds
  // them in order and leaves the Gram in mats[0].
  if (l.group > 0) store_tile<D>(mats + (l.group - 1) * H::kMat, t, l);
  sq[l.group * 2 * D + l.row0 + l.quad] = qsq;
  sq[l.group * 2 * D + D + l.col0 + l.band] = ksq;
  __syncthreads();
  if (l.group == 0) {
#pragma unroll
    for (int s = 0; s < kGroups - 1; ++s) add_tile<D>(t, mats + s * H::kMat, l);
    store_tile<D>(mats, t, l);
  }
  if (threadIdx.x < 2 * D) {
    float s = 0.f;
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) s += sq[gr * 2 * D + threadIdx.x];
    norms[threadIdx.x] = sqrtf(s);
    saved_block[D * D + threadIdx.x] = norms[threadIdx.x];
  }
  __syncthreads();

  // Ŝ (saved) and A = softmax(Ŝ τ) over the Gram, a quad a row.
  {
    const int i = threadIdx.x / 4, j0 = (threadIdx.x % 4) * H::kCols;
    const float nq = fmaxf(norms[i], kEps);
    float s[D / 4];
    row_part<D>(s, mats + i * H::kPitch + j0);
#pragma unroll
    for (int b = 0; b < D / 4; ++b) s[b] = s[b] / (nq * fmaxf(norms[D + j0 + b], kEps));
    store_part<D>(saved_block + i * D + j0, s);
    softmax_part<D>(s, tau[head]);
    store_part<D>(mats + i * H::kPitch + j0, s);
  }
  __syncthreads();

  // Pass 2: out = A v, each lane's token rows into the output.
  load_tile<D, false>(t, mats, l);
  float* out_rows = out + image * g.n * c + head * D + l.row0 + l.quad;
  stream<D, 1>(stages, vs, g.n, [&](const float* st, int n0, int count) {
    matvec_rows<D>(t, st, l.group, kGroups, count, l,
                   [&](int r, float v) { out_rows[(n0 + r) * c] = v; });
  });
}

template <int D>
__global__ void __launch_bounds__(Head<D>::kThreads, Head<D>::kMinBlocks)
xcit_xca_backward_kernel(const float* __restrict__ qkv, const float* __restrict__ tau,
                         const float* __restrict__ saved, const float* __restrict__ dout,
                         float* __restrict__ dqkv, Geometry g) {
  using H = Head<D>;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;
  float* a_p = stages + 2 * H::kStage;  // A, then P_ij = G_ij / (nq_i nk_j)
  float* hat = a_p + H::kMat;           // Ŝ
  float* grad = hat + H::kMat;          // group 1's partial dA, then dA, then G
  float* coef = grad + H::kMat;         // c_i / nq_i² (D), e_j / nk_j² (D)
  float* norms = coef + kGroups * 2 * D;
  const Lane<D> l;
  const int head = blockIdx.x % g.heads;
  const long long image = blockIdx.x / g.heads, c = static_cast<long long>(g.heads) * D;
  const float* rows = qkv + image * g.n * 3 * c + head * D;
  float* grad_rows = dqkv + image * g.n * 3 * c + head * D + l.row0 + l.quad;
  const float* saved_block = saved + static_cast<long long>(blockIdx.x) * H::kSaved;
  const float t_h = tau[head];
  const Source<2> dov{{dout + image * g.n * c + head * D, rows + 2 * c}, {c, 3 * c}};
  fetch<D, 2>(stages, dov, 0, g.n);

  // Ŝ and the norms back, and A again, by the forward's code.
  for (int e = threadIdx.x; e < H::kSaved / 4; e += H::kThreads) {
    const float4 v = reinterpret_cast<const float4*>(saved_block)[e];
    if (4 * e < D * D) {
      *reinterpret_cast<float4*>(hat + 4 * e / D * H::kPitch + 4 * e % D) = v;
    } else {
      float* dst = norms + 4 * e - D * D;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
  __syncthreads();
  {
    const int i = threadIdx.x / 4, j0 = (threadIdx.x % 4) * H::kCols;
    float s[D / 4];
    row_part<D>(s, hat + i * H::kPitch + j0);
    softmax_part<D>(s, t_h);
    store_part<D>(a_p + i * H::kPitch + j0, s);
  }
  __syncthreads();

  // Pass 1: groups 0 and 1 the Gram dA = dOᵀ v, groups 2 and 3 dv = Aᵀ dO,
  // each pair over every token (the roles split at a warp's edge).
  const bool first_role = l.group < 2;
  Tile<D> t;
  if (first_role) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < D / 4; ++b) t[a][b] = 0.f;
  } else {
    load_tile<D, true>(t, a_p, l);
  }
  stream<D, 2>(stages, dov, g.n, [&](const float* st, int n0, int count) {
    float unused = 0.f;
    if (first_role)
      gram_rows<D, false>(t, st, st + kChunk * D, l.group, 2, count, l, unused, unused);
    else
      matvec_rows<D>(t, st, l.group - 2, 2, count, l,
                     [&](int r, float v) { grad_rows[(n0 + r) * 3 * c + 2 * c] = v; });
  });
  const Source<2> qk{{rows, rows + c}, {3 * c, 3 * c}};
  fetch<D, 2>(stages, qk, 0, g.n);

  // dA: group 1's tile in ``grad``, group 0 adds it and puts dA there.
  if (l.group == 1) store_tile<D>(grad, t, l);
  __syncthreads();
  if (l.group == 0) {
    add_tile<D>(t, grad, l);
    store_tile<D>(grad, t, l);
  }
  __syncthreads();

  // By rows, a quad a row: G = A (dA - rowsum(A dA)) τ over dA, c_i and
  // its coefficient.
  {
    const int i = threadIdx.x / 4, j0 = (threadIdx.x % 4) * H::kCols;
    float a[D / 4], da[D / 4], h[D / 4];
    row_part<D>(a, a_p + i * H::kPitch + j0);
    row_part<D>(da, grad + i * H::kPitch + j0);
    row_part<D>(h, hat + i * H::kPitch + j0);
    float dot = 0.f;
#pragma unroll
    for (int b = 0; b < D / 4; ++b) dot = fmaf(a[b], da[b], dot);
    dot = quad_add(dot);
    float ci = 0.f;
#pragma unroll
    for (int b = 0; b < D / 4; ++b) {
      da[b] = a[b] * (da[b] - dot) * t_h;
      ci = fmaf(da[b], h[b], ci);
    }
    store_part<D>(grad + i * H::kPitch + j0, da);
    ci = quad_add(ci);
    const float nq = fmaxf(norms[i], kEps);
    if (threadIdx.x % 4 == 0) coef[i] = norms[i] >= kEps ? ci / (nq * nq) : 0.f;
  }
  __syncthreads();

  // By columns, a quad a column: e_j and its coefficient, and P over A.
  {
    const int j = threadIdx.x / 4, i0 = (threadIdx.x % 4) * H::kCols;
    const float nk = fmaxf(norms[D + j], kEps);
    float ej = 0.f;
#pragma unroll
    for (int b = 0; b < D / 4; ++b) {
      const int e = (i0 + b) * H::kPitch + j;
      ej = fmaf(grad[e], hat[e], ej);
      a_p[e] = grad[e] / (fmaxf(norms[i0 + b], kEps) * nk);
    }
    ej = quad_add(ej);
    if (threadIdx.x % 4 == 0) coef[D + j] = norms[D + j] >= kEps ? ej / (nk * nk) : 0.f;
  }
  __syncthreads();

  // Pass 2: groups 0 and 1 dq = P k - (c / nq²) q, groups 2 and 3
  // dk = Pᵀ q - (e / nk²) k.
  if (first_role)
    load_tile<D, false>(t, a_p, l);
  else
    load_tile<D, true>(t, a_p, l);
  const float own_coef = coef[(first_role ? 0 : D) + l.row0 + l.quad];
  const long long offset = first_role ? 0 : c;
  stream<D, 2>(stages, qk, g.n, [&](const float* st, int n0, int count) {
    const float* own = first_role ? st : st + kChunk * D;
    const float* other = first_role ? st + kChunk * D : st;
    matvec_rows<D>(t, other, l.group % 2, 2, count, l, [&](int r, float v) {
      grad_rows[(n0 + r) * 3 * c + offset] = v - own_coef * own[r * D + l.row0 + l.quad];
    });
  });
}

// Raises a kernel's dynamic shared memory limit once a device, where it
// needs more than the default 48 KB: the call costs the host more than the
// launch.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, unsigned long long& raised) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err) return err;
  if (device < 64 && (raised >> device & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (!err && device < 64) raised |= 1ull << device;
  return err;
}

template <int D>
cudaError_t launch_forward(const float* qkv, const float* tau, float* out, float* saved, int b,
                           const Geometry& g, cudaStream_t stream) {
  static unsigned long long raised = 0;  // a bit a device
  const size_t bytes = sizeof(float) * Head<D>::kShared;
  cudaError_t err = allow_shared(xcit_xca_forward_kernel<D>, bytes, raised);
  if (err) return err;
  xcit_xca_forward_kernel<D><<<b * g.heads, Head<D>::kThreads, bytes, stream>>>(qkv, tau, out,
                                                                               saved, g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* qkv, const float* tau, const float* saved,
                            const float* dout, float* dqkv, int b, const Geometry& g,
                            cudaStream_t stream) {
  static unsigned long long raised = 0;
  const size_t bytes = sizeof(float) * Head<D>::kShared;
  cudaError_t err = allow_shared(xcit_xca_backward_kernel<D>, bytes, raised);
  if (err) return err;
  xcit_xca_backward_kernel<D><<<b * g.heads, Head<D>::kThreads, bytes, stream>>>(
      qkv, tau, saved, dout, dqkv, g);
  return cudaGetLastError();
}

}  // namespace

// The forward: qkv (b, n, 3 heads head_dim), tau (heads), out (b, n, heads
// head_dim) and saved (b, heads, head_dim² + 2 head_dim), all contiguous
// fp32 on the device, qkv and out 16-byte aligned; b, n >= 1. Returns a CUDA
// error, or cudaErrorInvalidValue for a head_dim it was not built for.
extern "C" int xcit_xca_forward_f32(const float* qkv, const float* tau, float* out, float* saved,
                                    int b, int n, int heads, int head_dim, void* stream) {
  const Geometry g{n, heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 48) return launch_forward<48>(qkv, tau, out, saved, b, g, s);
  if (head_dim == 16) return launch_forward<16>(qkv, tau, out, saved, b, g, s);
  return cudaErrorInvalidValue;
}

// The input gradient: dout (b, n, heads head_dim) in, 16-byte aligned, and
// dqkv (b, n, 3 heads head_dim) out, every element written; saved as the
// forward left it; the rest as the forward.
extern "C" int xcit_xca_backward_f32(const float* qkv, const float* tau, const float* saved,
                                     const float* dout, float* dqkv, int b, int n, int heads,
                                     int head_dim, void* stream) {
  const Geometry g{n, heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 48) return launch_backward<48>(qkv, tau, saved, dout, dqkv, b, g, s);
  if (head_dim == 16) return launch_backward<16>(qkv, tau, saved, dout, dqkv, b, g, s);
  return cudaErrorInvalidValue;
}
