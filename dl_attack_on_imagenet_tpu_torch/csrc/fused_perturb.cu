// fused_perturb: adv = clip(x + clamp(v @ D, -eps, eps), 0, 1) in one pass.
//
// Replaces the Pallas TPU kernel `fused_perturb` (`_perturb_kernel`) of
// dl_attack_on_imagenet_tpu/ops/pallas_kernels.py, which runs one
// (N, K) x (K, 1536) HIGHEST-precision product a grid step and applies the
// clamp, the add and the clip before its store. Shapes: v (N, K) codes,
// D (K, M) atoms flat in NHWC pixel order, x and out (N, M), all fp32 and
// contiguous.
//
// Bound on an H100 SXM: at the serving shape N=64, K=100, M=150528 the
// function must move 137 MB (D 60.2 MB, x and out 38.5 MB each, v 25.6 KB),
// about 41 us at 3.35 TB/s, against 1.93 GFLOP of fp32 FMA, about 29 us at
// 67 TFLOP/s. It is memory-bound, so the design is about keeping HBM busy:
//
// 1. Loads in flight. D and v reach shared memory through a ring of STAGES
//    buffers filled by cp.async: while the block works on atoms
//    [k0, k0 + ATOMS) the copies of the next STAGES - 1 chunks are in the
//    air, with no registers spent on them. The ring runs on across the
//    block's work items, so one item's epilogue overlaps the next item's
//    first loads. Each thread also prefetches its own x values into shared
//    memory when an item starts, so the epilogue does not wait on them.
//    (They go out in one burst, with the item's first stage: spread over
//    the item's stages they measured slower, with fewer bytes in flight.)
// 2. D read once. A block owns all 64 rows of a column tile, so at N <= 64
//    each D element comes from HBM once per launch. For N > 64 the block
//    loops over 64-row chunks of the tile, one work item each; the later
//    chunks read the tile's D again, from L2, where the first chunk just
//    put it.
// 3. 16-byte accesses. D, x and out move as 16-byte cp.async copies and
//    float4 stores when M % 4 == 0 and the three pointers are 16-byte
//    aligned; otherwise a scalar instance of the same kernel copies 4 bytes
//    at a time. v always moves 4 bytes at a time: it is transposed on the
//    way into shared memory, and it is small and lives in L2.
// 4. No partial wave. The grid is persistent: as many blocks as fit on the
//    card at once (SMs x resident blocks per SM), each walking the column
//    tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//
// Each thread keeps a 16-row x 4-column tile of accumulators, reads its 4
// columns of D as one float4 from shared memory and the codes of its 16
// rows as four broadcast float4s from the transposed (ATOMS, 64) v chunk.
// Every output is one fmaf chain in ascending k, with no split over K, and
// only fp32 FMA is used (no TF32, no tensor cores): the eps-budget guarantee
// rests on a true fp32 contraction. The ragged edges of N, K and M are
// zero-filled in shared memory and masked at the store, never padded in
// device memory. eps is a runtime float and +inf works.
//
// The tile sizes below measured fastest at the serving shape among those
// timed on an H100: three 57 KB blocks a SM, and 1176 tiles over 396
// blocks leave no block more than its share. Out stores are marked
// streaming (__stcs) so that they are first to leave L2.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;            // rows of a work item
constexpr int RT = 16;              // rows a thread
constexpr int COLS = 128;           // columns of a work item, a multiple of 128
constexpr int ATOMS = 8;            // atoms a stage
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 3;       // resident blocks a SM asked of the compiler
constexpr int THREADS = (ROWS / RT) * (COLS / 4);
constexpr int SMEM_FLOATS = STAGES * ATOMS * (COLS + ROWS) + ROWS * COLS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
constexpr int MAX_K = 4096;

static_assert(COLS % 128 == 0, "a row group must fill whole warps");
static_assert(STAGES >= 3, "the ring keeps at least two stages in flight");
static_assert((ATOMS * COLS / 4) % THREADS == 0, "D copies split evenly");
static_assert((ATOMS * ROWS) % THREADS == 0, "v copies split evenly");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A position in the block's stream of stages: atom chunk c of row chunk rc
// of column tile `tile`, the chunks innermost.
struct Cursor {
  long long tile;
  int rc, c;
  __device__ void next(int nrc, int nkc) {
    if (++c == nkc) {
      c = 0;
      if (++rc == nrc) {
        rc = 0;
        tile += gridDim.x;
      }
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_perturb_kernel(const float* __restrict__ v, const float* __restrict__ d,
                     const float* __restrict__ x, float* __restrict__ out,
                     int n, int k, long long m, float eps, long long ntiles,
                     int nrc, int nkc) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);  // [STAGES][ATOMS][COLS]
  float* vs = ds + STAGES * ATOMS * COLS;        // [STAGES][ATOMS][ROWS]
  float* xs = vs + STAGES * ATOMS * ROWS;        // [ROWS][COLS]

  const int tid = threadIdx.x;
  const int cq = tid % (COLS / 4);  // this thread's column quad
  const int rg = tid / (COLS / 4);  // its row group, the same across a warp

  // Copies of stage `at` into ring slot `slot`: D[k0:k0+ATOMS, tile] and
  // v[r0:r0+ROWS, k0:k0+ATOMS] transposed.
  auto load_stage = [&](const Cursor& at, int slot) {
    const int k0 = at.c * ATOMS;
    const long long col0 = at.tile * COLS;
    float* dst = ds + slot * ATOMS * COLS;
#pragma unroll
    for (int j = 0; j < ATOMS * COLS / 4 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int kk = i / (COLS / 4);
      const long long col = col0 + 4 * (i % (COLS / 4));
      const bool krow = k0 + kk < k;
      const float* src = d + (long long)(k0 + kk) * m + col;
      if (VEC) {
        copy16(dst + 4 * i, krow && col < m ? src : d, krow && col < m);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          copy4(dst + 4 * i + e, krow && col + e < m ? src + e : d, krow && col + e < m);
      }
    }
    const int r0 = at.rc * ROWS;
    float* vdst = vs + slot * ATOMS * ROWS;
#pragma unroll
    for (int j = 0; j < ATOMS * ROWS / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i % ROWS, kk = i / ROWS;
      const bool ok = r0 + r < n && k0 + kk < k;
      copy4(vdst + i, ok ? v + (long long)(r0 + r) * k + k0 + kk : v, ok);
    }
  };

  // This thread's own 16 x 4 slice of the item's x tile; only it reads it.
  auto load_x = [&](const Cursor& at) {
    const long long col = at.tile * COLS + 4 * cq;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg * RT + i;
      const bool row_ok = at.rc * ROWS + r < n;
      const float* src = x + (long long)(at.rc * ROWS + r) * m + col;
      float* dst = xs + r * COLS + 4 * cq;
      if (VEC) {
        copy16(dst, row_ok && col < m ? src : x, row_ok && col < m);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          copy4(dst + e, row_ok && col + e < m ? src + e : x, row_ok && col + e < m);
      }
    }
  };

  Cursor cons{blockIdx.x, 0, 0};
  Cursor prod = cons;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.tile < ntiles) load_stage(prod, s);
    commit();
    prod.next(nrc, nkc);
  }

  float acc[RT][4];
  for (int s = 0; cons.tile < ntiles; ++s) {
    if (cons.c == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    // Stage s has landed, and every thread is done with stage s - 1, whose
    // slot the copies of stage s + STAGES - 1 now fill.
    wait_pending<STAGES - 2>();
    __syncthreads();
    if (prod.tile < ntiles) load_stage(prod, (s + STAGES - 1) % STAGES);
    if (cons.c == 0) load_x(cons);
    commit();
    prod.next(nrc, nkc);

    const int slot = s % STAGES;
    const float* db = ds + slot * ATOMS * COLS + 4 * cq;
    const float* vb = vs + slot * ATOMS * ROWS + rg * RT;
#pragma unroll
    for (int kk = 0; kk < ATOMS; ++kk) {
      const float4 dq = *reinterpret_cast<const float4*>(db + kk * COLS);
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(vb + kk * ROWS + 4 * q);
        const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * q + i][0] = fmaf(wr[i], dq.x, acc[4 * q + i][0]);
          acc[4 * q + i][1] = fmaf(wr[i], dq.y, acc[4 * q + i][1]);
          acc[4 * q + i][2] = fmaf(wr[i], dq.z, acc[4 * q + i][2]);
          acc[4 * q + i][3] = fmaf(wr[i], dq.w, acc[4 * q + i][3]);
        }
      }
    }

    if (cons.c == nkc - 1) {
      // The x copies went out with group nkc * item + STAGES - 1; the wait
      // at the top of this stage covered it only if nkc >= STAGES.
      if (nkc < STAGES) asm volatile("cp.async.wait_all;\n" ::: "memory");
      const long long col = cons.tile * COLS + 4 * cq;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rg * RT + i;
        const int row = cons.rc * ROWS + r;
        if (row >= n) continue;
        const float4 xq = *reinterpret_cast<const float4*>(xs + r * COLS + 4 * cq);
        float4 o;
        o.x = fminf(fmaxf(xq.x + fminf(fmaxf(acc[i][0], -eps), eps), 0.0f), 1.0f);
        o.y = fminf(fmaxf(xq.y + fminf(fmaxf(acc[i][1], -eps), eps), 0.0f), 1.0f);
        o.z = fminf(fmaxf(xq.z + fminf(fmaxf(acc[i][2], -eps), eps), 0.0f), 1.0f);
        o.w = fminf(fmaxf(xq.w + fminf(fmaxf(acc[i][3], -eps), eps), 0.0f), 1.0f);
        float* dst = out + (long long)row * m + col;
        if (VEC) {
          if (col < m) __stcs(reinterpret_cast<float4*>(dst), o);
        } else {
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < m) dst[e] = ov[e];
        }
      }
    }
    cons.next(nrc, nkc);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The launch of one call: the grid and what decided it.
struct Plan {
  long long grid, blocks_per_sm, sms, tiles, items;
  bool vec;
};

template <bool VEC>
cudaError_t prepare(int* blocks_per_sm) {
  // Per device: the shared-memory opt-in and the occupancy, asked once.
  static int cached[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && cached[device] > 0) {
    *blocks_per_sm = cached[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fused_perturb_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_perturb_kernel<VEC>, THREADS, SMEM_BYTES);
  if (err == cudaSuccess && *blocks_per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && device < 64) cached[device] = *blocks_per_sm;
  return err;
}

cudaError_t plan(int n, long long m, bool vec, Plan* p) {
  int device = 0, sms = 0, bps = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = vec ? prepare<true>(&bps) : prepare<false>(&bps);
  if (err != cudaSuccess) return err;
  p->vec = vec;
  p->sms = sms;
  p->blocks_per_sm = bps;
  p->tiles = (m + COLS - 1) / COLS;
  p->items = p->tiles * ((n + ROWS - 1) / ROWS);
  p->grid = (long long)sms * bps < p->tiles ? (long long)sms * bps : p->tiles;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

}  // namespace

// The largest K the wrapper passes: the ring takes any K, and the card
// tests check the kernel against its twin up to this one.
extern "C" int fused_perturb_max_k() { return MAX_K; }

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, types and contiguity, 0 < k <= fused_perturb_max_k()
// and 0 < m, and launches only for n > 0.
extern "C" int fused_perturb_f32(const void* v, const void* d, const void* x,
                                 void* out, int n, int k, long long m,
                                 float eps, void* stream) {
  const bool vec = m % 4 == 0 && aligned16(d) && aligned16(x) && aligned16(out);
  Plan p;
  const cudaError_t err = plan(n, m, vec, &p);
  if (err != cudaSuccess) return (int)err;
  const int nrc = (n + ROWS - 1) / ROWS, nkc = (k + ATOMS - 1) / ATOMS;
  auto kernel = vec ? fused_perturb_kernel<true> : fused_perturb_kernel<false>;
  kernel<<<(unsigned)p.grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(x), static_cast<float*>(out), n, k, m, eps,
      p.tiles, nrc, nkc);
  return (int)cudaGetLastError();
}

// What a launch at (n, m) would look like, for the record: into info[0..12]
// the grid, resident blocks per SM, SMs, column tiles, work items (tiles x
// 64-row chunks), registers a thread, local (spill) bytes a thread, dynamic
// shared memory a block, threads a block, columns a tile, atoms a stage,
// stages, and 1 if the 16-byte instance would run. `aligned` says whether
// the pointers would be 16-byte aligned. Returns the CUDA error, 0 on success.
extern "C" int fused_perturb_info(int n, long long m, int aligned, long long* info) {
  Plan p;
  const bool vec = m % 4 == 0 && aligned;
  cudaError_t err = plan(n, m, vec, &p);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, vec ? fused_perturb_kernel<true>
                                           : fused_perturb_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  const long long values[13] = {p.grid, p.blocks_per_sm, p.sms, p.tiles, p.items,
                                attr.numRegs, (long long)attr.localSizeBytes,
                                SMEM_BYTES, THREADS, COLS, ATOMS, STAGES, vec};
  for (int i = 0; i < 13; ++i) info[i] = values[i];
  return 0;
}
