// Grouped expert FFN over one d_expert slice, for Hopper (sm_90a).
//
// Replaces repro/kernels/streamed_moe.py::streamed_moe_kernel (the Pallas
// TPU kernel): out[e] = act(xe[e] @ w_g[e], xe[e] @ w_u[e]) @ w_d[e] for
// every expert e, with swiglu / relu2 / gelu (tanh form), fp32
// accumulation, fp32 output, and int8 / fp8-e4m3 weights with
// per-(expert, output-channel) fp32 scales.
//
// Bound: at the serving path's decode and prefill shapes (E=32, C=64,
// d=1024, m=512) every weight byte is read once and used for only C=64
// rows, so the launch is bound by the weight stream (about 100 MB in bf16,
// 34 us at 3.35 TB/s; 50 MB and 19 us with int8 / fp8 weights); the
// tensor-core floor is below that.  At the scoring
// path's C=1280 the 129 GFLOP of the three products bound it (0.13 ms at
// the bf16 tensor-core rate).
//
// What the design does about it: blocks are spread over experts and weight
// tiles, not over token tiles, so all 132 SMs stream disjoint slices of the
// weights at once and each weight tile is read from device memory by one
// block only when C fits one row tile (decode).  Two phases:
//   1. grid (m/BN, C/BM, E): a block streams its BN-column slice of w_g and
//      w_u over d and writes the activated h[e, rows, cols] (rounded to bf16
//      when w_d is bf16) to a scratch (E, C, m);
//   2. grid (d/BN, C/BM, E): a block streams its BN-column slice of w_d over
//      m and writes out[e, rows, cols].
// The expert is the grid's slowest axis, so all blocks of one expert (its
// column tiles, row tile by row tile) run at about the same time, and at
// large C the expert's weight slices are read from device memory about once
// and from L2 by its other row tiles.
//
// The tiles are chosen at launch: each tensor-core path has a table of
// settings (WG_SETTINGS, Q_SETTINGS below; the counterpart of the Pallas
// kernel's token_tile / dmodel_tile / dexpert_tile), the caller passes a
// row of it, and core/autotune.py plans which.  No setting splits K or
// reorders a sum, so every setting gives the same bits.
//
// bf16 activations x bf16 weights (the serving, scoring and training paths)
// run on Hopper's own machinery, warp-specialised.  A block has one
// producer warp, one thread of which keeps TMA loads in flight, and one or
// two consumer warpgroups of 64 rows each that issue wgmma.m64n{BN}k16.  A
// stage of the ring holds the BM x BK activation tile (x in phase 1, the
// bf16 h scratch in phase 2) and each weight matrix's BK x BN tile, all
// 128-byte swizzled by TMA, with a full and an empty mbarrier; the weights
// are N-major, so wgmma takes B transposed.  Tensor maps of (E, rows,
// columns) read each expert's slice in place: rows past C, columns past N
// and k past K arrive as zeros (no bytes are read for them: C = 16 decode
// fills 48 of 64 rows so, and a K of 8 in phase 2 is filled to the
// stage), and the epilogue masks its stores.  A consumer keeps one stage's
// products in flight while it issues the next and releases a stage once
// its products are done.  swiglu keeps the gate and up products in two
// accumulators (BN / 2 floats each a thread); phase 1's epilogue applies
// the activation and writes h in bf16 (exact: it is rounded to bf16 before
// the down product anyway), phase 2's writes out in fp32.  Decode (C <=
// 64) takes one warpgroup of 64 rows and stays bound by the weight bytes,
// which TMA streams without a thread's copy instructions; C = 1024 / 1280
// take two warpgroups of 128 x 128 tiles (the gate and up products make
// the first phase's tile 128 x 256).  The maps are encoded on the host at
// each call (the operands move from call to call; a CUDA graph captures
// them by value with the fixed addresses it replays).  This path takes d
// and m multiples of 8 (16-byte rows).
//
// int8 / fp8-e4m3 weights (bf16 or fp32 activations) run on the
// Ampere-generation mma.sync bf16 tensor cores (csrc/tensor_core.cuh, a
// cp.async ring) with the reference's fp32 accuracy: every 8-bit
// value is exact in bf16, a product of two bf16 values is exact in fp32, and
// the per-(expert, column) scale multiplies the fp32 sum in the epilogue
// (before the activation in phase 1, before the store in phase 2).  The
// weight tiles go through the cp.async ring as raw bytes (half the ring's
// weight bytes of bf16), and the B fragments are built from those bytes in
// registers (prmt, then an exact widening: a magic-number add for int8, cvt
// for e4m3), so a k step needs one barrier and no shared-memory pass; each
// warp owns all 64 rows of its columns, so each byte is widened once a
// block.  (Widening each stage into a bf16 shared tile for ldmatrix took a
// second barrier and pass a step and ran at 0.104 ms against 0.054 here.)
// h is fp32 in the reference and stays exact: phase 1 writes it as three
// bf16 planes, h = hi + mid + lo (24 significant bits), and phase 2 runs
// three mma a k step against one q fragment (hi, and mid + lo, in two fp32
// accumulators).  Planes, not fp32 split on load, because the split would
// be redone by every column block of an expert.  fp32 activations are split
// into planes the same way by a small kernel first.  Rows of d and m bytes
// must be multiples of 16.  Rounding h or x to fewer bits would be a
// different function, so neither is done.
//
// fp32 weights, and bf16 weights with fp32 activations, keep the CUDA-core
// path: each step's global loads for the next tile are issued into
// registers before the current tile is multiplied (two shared-memory
// buffers, one barrier per step), and the products run as fp32 FMAs in
// ascending k (4x4 outputs per thread).  The reference's 2e-5 tolerance
// rules out TF32 for fp32-valued operands; h is an fp32 scratch there.
//
// Plain C interface for ctypes: one launch function that runs both phases
// with the setting it is given on the caller's stream, allocates nothing,
// and returns cudaGetLastError(); and one that reports each setting's
// compiled registers, spills and shared memory, for the planner.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BM = 64;    // rows (capacity slots) per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 32;    // contraction rows per shared-memory step
constexpr int NT = 256;   // threads per block: 16 x 16, 4 x 4 outputs each

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_F8 = 3 };
enum { ACT_SWIGLU = 0, ACT_RELU2 = 1, ACT_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float g, float u) {
  if constexpr (ACT == ACT_SWIGLU) return g / (1.0f + expf(-g)) * u;
  if constexpr (ACT == ACT_RELU2) { float r = fmaxf(u, 0.0f); return r * r; }
  // gelu, tanh approximation (jax.nn.gelu's default)
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return u * (0.5f * (1.0f + tanhf(k * (u + 0.044715f * u * u * u))));
}

// Raw storage of each element type, and its exact conversion to fp32.
template <typename T> struct Elem {
  using raw = T;
  static __device__ __forceinline__ float f32(raw v) { return static_cast<float>(v); }
};
template <> struct Elem<__nv_bfloat16> {
  using raw = unsigned short;
  static __device__ __forceinline__ float f32(raw v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

// Per-thread share of one tile.  Thread t always loads the same tile column
// (weights: t % BN) or the same contraction index (activations: t % BK).
constexpr int W_PER_THREAD = BK * BN / NT;   // weight rows t/BN + 4j
constexpr int X_PER_THREAD = BM * BK / NT;   // activation rows t/BK + 8j
constexpr int X_STRIDE = BM + 4;             // transposed tile row (16-byte aligned)
constexpr int X_TILE = BK * X_STRIDE;        // floats per activation buffer
constexpr int W_TILE = BK * BN;              // floats per weight buffer

// Issue the global loads of a BK x BN weight tile into registers (raw, so the
// loads stay in flight while the previous tile is multiplied).
template <typename TW>
__device__ __forceinline__ void fetch_w(typename Elem<TW>::raw (&reg)[W_PER_THREAD],
                                        const TW* w, int k0, int c0, int K, int N) {
  const auto* wr = reinterpret_cast<const typename Elem<TW>::raw*>(w);
  const int gc = c0 + threadIdx.x % BN;
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j) {
    const int gk = k0 + threadIdx.x / BN + j * (NT / BN);
    reg[j] = (gk < K && gc < N) ? wr[(size_t)gk * N + gc] : typename Elem<TW>::raw(0);
  }
}

// Convert the fetched weight tile to fp32 into shared memory.
template <typename TW>
__device__ __forceinline__ void store_w(float* dst, const typename Elem<TW>::raw (&reg)[W_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j)
    dst[(threadIdx.x / BN + j * (NT / BN)) * BN + threadIdx.x % BN] = Elem<TW>::f32(reg[j]);
}

// Issue the global loads of a BM x BK activation tile of a row-major (R, K).
template <typename TX>
__device__ __forceinline__ void fetch_x(typename Elem<TX>::raw (&reg)[X_PER_THREAD],
                                        const TX* x, int r0, int k0, int R, int K) {
  const auto* xr = reinterpret_cast<const typename Elem<TX>::raw*>(x);
  const int gk = k0 + threadIdx.x % BK;
#pragma unroll
  for (int j = 0; j < X_PER_THREAD; ++j) {
    const int gr = r0 + threadIdx.x / BK + j * (NT / BK);
    reg[j] = (gr < R && gk < K) ? xr[(size_t)gr * K + gk] : typename Elem<TX>::raw(0);
  }
}

// Store the activation tile transposed, dst[k][row], so a thread reads its
// four rows as one contiguous run.
template <typename TX>
__device__ __forceinline__ void store_x(float* dst, const typename Elem<TX>::raw (&reg)[X_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < X_PER_THREAD; ++j)
    dst[(threadIdx.x % BK) * X_STRIDE + threadIdx.x / BK + j * (NT / BK)] = Elem<TX>::f32(reg[j]);
}

// acc[i][j] += x[row i][k] * w[k][col j] over one shared-memory tile, k ascending.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* xs, const float* ws) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[k * X_STRIDE + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ws[k * BN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The same for the gate and up weights at once (one read of x per k).
__device__ __forceinline__ void mma_tile2(float (&acc_u)[4][4], float (&acc_g)[4][4],
                                          const float* xs, const float* us, const float* gs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[k * X_STRIDE + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = us[k * BN + tx + 16 * j];
      c[j] = gs[k * BN + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_u[i][j] = fmaf(a[i], b[j], acc_u[i][j]);
        acc_g[i][j] = fmaf(a[i], c[j], acc_g[i][j]);
      }
  }
}

constexpr int smem_bytes(int n_weights) { return 4 * (2 * X_TILE + 2 * n_weights * W_TILE); }

// Phase 1: h[e, r, c] = act(x[e] @ w_g[e], x[e] @ w_u[e]) for one 64 x 64 tile.
// Double-buffered: the next tile's global loads are in flight while the
// current one is multiplied.
template <typename TX, typename TW, int ACT>
__global__ void __launch_bounds__(NT)
up_kernel(const TX* __restrict__ xe, const TW* __restrict__ wg,
          const TW* __restrict__ wu, float* __restrict__ h, int C, int d, int m) {
  constexpr bool gated = ACT == ACT_SWIGLU;
  extern __shared__ float smem[];
  float* xs = smem;                        // [2][BK][X_STRIDE]
  float* us = smem + 2 * X_TILE;           // [2][BK][BN]
  float* gs = us + 2 * W_TILE;             // [2][BK][BN], swiglu only
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const TX* x = xe + (size_t)e * C * d;
  const TW* u = wu + (size_t)e * d * m;
  const TW* g = gated ? wg + (size_t)e * d * m : nullptr;

  typename Elem<TX>::raw xr[X_PER_THREAD];
  typename Elem<TW>::raw ur[W_PER_THREAD], gr[W_PER_THREAD];
  fetch_x<TX>(xr, x, r0, 0, C, d);
  fetch_w<TW>(ur, u, 0, c0, d, m);
  if constexpr (gated) fetch_w<TW>(gr, g, 0, c0, d, m);
  store_x<TX>(xs, xr);
  store_w<TW>(us, ur);
  if constexpr (gated) store_w<TW>(gs, gr);
  __syncthreads();

  float acc_u[4][4] = {}, acc_g[4][4] = {};
  for (int k0 = 0, buf = 0; k0 < d; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < d;
    if (more) {
      fetch_x<TX>(xr, x, r0, k0 + BK, C, d);
      fetch_w<TW>(ur, u, k0 + BK, c0, d, m);
      if constexpr (gated) fetch_w<TW>(gr, g, k0 + BK, c0, d, m);
    }
    if constexpr (gated)
      mma_tile2(acc_u, acc_g, xs + buf * X_TILE, us + buf * W_TILE, gs + buf * W_TILE);
    else
      mma_tile(acc_u, xs + buf * X_TILE, us + buf * W_TILE);
    if (more) {
      store_x<TX>(xs + (buf ^ 1) * X_TILE, xr);
      store_w<TW>(us + (buf ^ 1) * W_TILE, ur);
      if constexpr (gated) store_w<TW>(gs + (buf ^ 1) * W_TILE, gr);
    }
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= m) continue;
      float v = activate<ACT>(acc_g[i][j], acc_u[i][j]);
      // the Pallas body casts h to w_d's dtype before the down GEMM
      if (std::is_same<TW, __nv_bfloat16>::value) v = __bfloat162float(__float2bfloat16_rn(v));
      h[((size_t)e * C + r) * m + c] = v;
    }
  }
}

// Phase 2: out[e, r, c] = h[e] @ w_d[e] for one 64 x 64 tile, double-buffered.
template <typename TW>
__global__ void __launch_bounds__(NT)
down_kernel(const float* __restrict__ h, const TW* __restrict__ wd, float* __restrict__ out,
            int C, int d, int m) {
  extern __shared__ float smem[];
  float* hs = smem;                        // [2][BK][X_STRIDE]
  float* ws = smem + 2 * X_TILE;           // [2][BK][BN]
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const float* hx = h + (size_t)e * C * m;
  const TW* w = wd + (size_t)e * m * d;

  float hr[X_PER_THREAD];
  typename Elem<TW>::raw wr[W_PER_THREAD];
  fetch_x<float>(hr, hx, r0, 0, C, m);
  fetch_w<TW>(wr, w, 0, c0, m, d);
  store_x<float>(hs, hr);
  store_w<TW>(ws, wr);
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0, buf = 0; k0 < m; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < m;
    if (more) {
      fetch_x<float>(hr, hx, r0, k0 + BK, C, m);
      fetch_w<TW>(wr, w, k0 + BK, c0, m, d);
    }
    mma_tile(acc, hs + buf * X_TILE, ws + buf * W_TILE);
    if (more) {
      store_x<float>(hs + (buf ^ 1) * X_TILE, hr);
      store_w<TW>(ws + (buf ^ 1) * W_TILE, wr);
    }
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) out[((size_t)e * C + r) * d + c] = acc[i][j];
    }
  }
}

// ------------------------------------------ bf16 x bf16: wgmma + TMA

using bf16 = __nv_bfloat16;

// Launch with dynamic shared memory; above the 48 KB default the kernel
// must be allowed more first.
template <typename Kernel, typename... Args>
void launch_dyn(Kernel kernel, int bytes, dim3 grid, int threads, cudaStream_t s,
                Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, threads, bytes, s>>>(args...);
}

// One kernel's compiled resources, as the planner reads them: registers a
// thread, local (spill) bytes a thread, static and dynamic shared bytes a
// block, threads a block.
constexpr int ATTR_FIELDS = 5;
template <typename Kernel>
void kernel_attrs(Kernel kernel, int dyn_smem, int threads, int* out) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = dyn_smem;
  out[4] = threads;
}

// The settings of the bf16 path, one per row: consumer warpgroups (64 rows
// each, so BM = 64 WG rows a block), BN columns a block (64 or 128), BK
// k-rows a stage (64 or 128) and STAGES stages in the TMA ring.  Row i is
// setting i of streamed_moe_forward's `tiles`;
// repro_torch.kernels.streamed_moe.TILE_SETTINGS["bf16"] holds the same rows
// in the same order (a CPU test parses this list).  Rows 0 and 1 are the
// default rule's: 64-row blocks when C <= 64, else 128.  Every setting runs
// the same body and sums each output's k16 products in ascending k into one
// fp32 accumulator, so all give the same bits.
#define WG_SETTINGS(X) \
  X(1, 64, 64, 4)      \
  X(2, 128, 64, 4)     \
  X(1, 128, 64, 4)     \
  X(2, 64, 64, 4)      \
  X(1, 64, 64, 2)      \
  X(1, 128, 64, 2)     \
  X(2, 64, 64, 3)      \
  X(2, 128, 64, 3)

template <int NWG_, int BN_, int BK_, int STAGES_>
struct WgCfg {
  static constexpr int NWG = NWG_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int BM = 64 * NWG;
  static constexpr int NT = 128 * NWG + 32;   // the consumers and one producer warp
  static constexpr int A_BYTES = BM * BK * 2;  // BK / 64 boxes of [BM][64]
  static constexpr int B_BYTES = BK * BN * 2;  // BN / 64 boxes of [BK][64]
  static_assert((NWG == 1 || NWG == 2) && (BN == 64 || BN == 128) && (BK == 64 || BK == 128) &&
                    STAGES >= 2,
                "bad wgmma tile setting");
};

// A stage holds the activation tile and NMAT weight tiles, each 1024-byte
// aligned; the stages' full and empty barriers follow the ring.
template <class Cfg, int NMAT>
struct WgShape {
  static constexpr int STAGE = Cfg::A_BYTES + NMAT * Cfg::B_BYTES;
  static constexpr int BARS = Cfg::STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * Cfg::STAGES + 1024;   // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

// The ring's barriers: full[s] completes when stage s's bytes have landed,
// empty[s] when every consumer warp is done with it.
template <class Cfg, int NMAT>
__device__ __forceinline__ uint64_t* wg_barriers(unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WgShape<Cfg, NMAT>::BARS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&full[Cfg::STAGES + s], 4 * Cfg::NWG);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  return full;
}

// The producer thread: for each k-step, when its stage is free, the BM x BK
// activation tile at (rows r0, k0) of expert e through amap and each
// weight's BK x BN tile at (k0, columns c0) through wmap[mat].  Rows,
// columns and k past the tensor arrive as zeros.
template <class Cfg, int NMAT>
__device__ __forceinline__ void wg_produce(unsigned char* smem, uint64_t* full,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* const (&wmap)[NMAT], int nk, int r0,
                                           int c0, int e) {
  using S = WgShape<Cfg, NMAT>;
  uint64_t* empty = full + Cfg::STAGES;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Cfg::STAGES, k0 = kt * Cfg::BK;
    hop::mbar_wait(&empty[s], ((kt / Cfg::STAGES) & 1) ^ 1);
    hop::mbar_expect_tx(&full[s], S::STAGE);
    unsigned char* st = smem + s * S::STAGE;
    for (int kb = 0; kb < Cfg::BK / 64; ++kb)
      hop::tma_load_3d(st + kb * Cfg::BM * 128, amap, &full[s], k0 + 64 * kb, r0, e);
    for (int mat = 0; mat < NMAT; ++mat)
      for (int nb = 0; nb < Cfg::BN / 64; ++nb)
        hop::tma_load_3d(st + Cfg::A_BYTES + mat * Cfg::B_BYTES + nb * Cfg::BK * 128, wmap[mat],
                         &full[s], c0 + 64 * nb, k0, e);
  }
}

// Consumer warpgroup wg: acc[mat] = its 64 rows of the activation tile times
// weight mat's BN columns, summed over the nk k-steps in ascending k, each
// k16 step one wgmma.m64n{BN}k16 (A K-major, B MN-major, both from shared
// memory).  One step's products stay in flight while the next is issued;
// a stage is released once its products are done.
template <class Cfg, int NMAT>
__device__ __forceinline__ void wg_consume(float (&acc)[NMAT][Cfg::BN / 2],
                                           const unsigned char* smem, uint64_t* full, int nk,
                                           int wg) {
  using S = WgShape<Cfg, NMAT>;
  uint64_t* empty = full + Cfg::STAGES;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < Cfg::BN / 2; ++i) acc[mat][i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Cfg::STAGES;
    hop::mbar_wait(&full[s], (kt / Cfg::STAGES) & 1);
    const unsigned char* st = smem + s * S::STAGE;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) hop::fence_regs(acc[mat]);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < Cfg::BK / 16; ++kk) {
      const uint64_t da = hop::desc_sw128(
          st + (kk / 4) * Cfg::BM * 128 + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat)
        hop::wgmma_ss<Cfg::BN, 1>(
            acc[mat], da,
            hop::desc_sw128(st + Cfg::A_BYTES + mat * Cfg::B_BYTES + kk * 16 * 128,
                            Cfg::BK * 128, 1024),
            1);
    }
    hop::wg_commit();
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) hop::fence_regs(acc[mat]);
    if (kt > 0) {
      hop::wg_wait<1>();   // step kt-1's products are done: free its stage
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[(kt - 1) % Cfg::STAGES]);
    }
  }
  hop::wg_wait<0>();
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) hop::fence_regs(acc[mat]);
}

// Phase 1: h[e, rows, cols] = bf16(act(x w_g, x w_u)).  acc[mat][4j + 2hr +
// q] is row r0 + 64 wg + 16 warp + g + 8 hr, column c0 + 8 j + 2 t + q.
template <class Cfg, int ACT>
__global__ void __launch_bounds__(Cfg::NT)
up_kernel_wg(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap umap,
             const __grid_constant__ CUtensorMap gmap, bf16* __restrict__ h, int C, int d, int m) {
  constexpr int NMAT = ACT == ACT_SWIGLU ? 2 : 1;   // [0] up, [1] gate
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = wg_barriers<Cfg, NMAT>(smem);
  const int e = blockIdx.z, c0 = blockIdx.x * Cfg::BN, r0 = blockIdx.y * Cfg::BM;
  const int nk = (d + Cfg::BK - 1) / Cfg::BK;
  if (threadIdx.x >= 128 * Cfg::NWG) {
    if (threadIdx.x == 128 * Cfg::NWG) {
      const CUtensorMap* w[NMAT];
      w[0] = &umap;
      if constexpr (NMAT == 2) w[1] = &gmap;
      wg_produce<Cfg, NMAT>(smem, full, &xmap, w, nk, r0, c0, e);
    }
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[NMAT][Cfg::BN / 2];
  wg_consume<Cfg, NMAT>(acc, smem, full, nk, wg);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 64 * wg + 16 * warp + lane / 4 + 8 * hr;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < Cfg::BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane % 4);
      if (c >= m) continue;
      const float* u = &acc[0][4 * j + 2 * hr];
      const float* g = &acc[NMAT - 1][4 * j + 2 * hr];
      *reinterpret_cast<__nv_bfloat162*>(h + ((size_t)e * C + r) * m + c) =
          __floats2bfloat162_rn(activate<ACT>(g[0], u[0]), activate<ACT>(g[1], u[1]));
    }
  }
}

// Phase 2: out[e, rows, cols] = h[e] @ w_d[e], fp32.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::NT)
down_kernel_wg(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap dmap,
               float* __restrict__ out, int C, int d, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = wg_barriers<Cfg, 1>(smem);
  const int e = blockIdx.z, c0 = blockIdx.x * Cfg::BN, r0 = blockIdx.y * Cfg::BM;
  const int nk = (m + Cfg::BK - 1) / Cfg::BK;
  if (threadIdx.x >= 128 * Cfg::NWG) {
    if (threadIdx.x == 128 * Cfg::NWG) {
      const CUtensorMap* w[1] = {&dmap};
      wg_produce<Cfg, 1>(smem, full, &hmap, w, nk, r0, c0, e);
    }
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[1][Cfg::BN / 2];
  wg_consume<Cfg, 1>(acc, smem, full, nk, wg);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 64 * wg + 16 * warp + lane / 4 + 8 * hr;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < Cfg::BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane % 4);
      if (c < d)
        *reinterpret_cast<float2*>(out + ((size_t)e * C + r) * d + c) =
            make_float2(acc[0][4 * j + 2 * hr], acc[0][4 * j + 2 * hr + 1]);
    }
  }
}

// The tensor map of a bf16 (E, R, K) tensor, read in boxes of `rows` rows x
// 64 columns of one expert, 128-byte swizzled.
int moe_map(CUtensorMap* map, const void* base, int E, int R, int K, int rows) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)R * K * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return hop::encode_bf16_map(map, base, 3, dims, strides, box);
}

template <class Cfg>
int launch_wg_cfg(const bf16* x, const bf16* g, const bf16* u, const bf16* wd, bf16* h,
                  float* out, int E, int C, int d, int m, int act, cudaStream_t s) {
  // the maps are encoded at every call: the operands' addresses change
  CUtensorMap xm, um, gm, hm, dm;
  if (moe_map(&xm, x, E, C, d, Cfg::BM) || moe_map(&um, u, E, d, m, Cfg::BK) ||
      moe_map(&gm, act == ACT_SWIGLU ? g : u, E, d, m, Cfg::BK) ||
      moe_map(&hm, h, E, C, m, Cfg::BM) || moe_map(&dm, wd, E, m, d, Cfg::BK))
    return -1;
  const dim3 g_up((m + Cfg::BN - 1) / Cfg::BN, (C + Cfg::BM - 1) / Cfg::BM, E);
  const dim3 g_down((d + Cfg::BN - 1) / Cfg::BN, (C + Cfg::BM - 1) / Cfg::BM, E);
  switch (act) {
    case ACT_SWIGLU:
      launch_dyn(up_kernel_wg<Cfg, ACT_SWIGLU>, WgShape<Cfg, 2>::SMEM, g_up, Cfg::NT, s, xm, um,
                 gm, h, C, d, m);
      break;
    case ACT_RELU2:
      launch_dyn(up_kernel_wg<Cfg, ACT_RELU2>, WgShape<Cfg, 1>::SMEM, g_up, Cfg::NT, s, xm, um,
                 gm, h, C, d, m);
      break;
    default:
      launch_dyn(up_kernel_wg<Cfg, ACT_GELU>, WgShape<Cfg, 1>::SMEM, g_up, Cfg::NT, s, xm, um,
                 gm, h, C, d, m);
      break;
  }
  launch_dyn(down_kernel_wg<Cfg>, WgShape<Cfg, 1>::SMEM, g_down, Cfg::NT, s, hm, dm, out, C, d,
             m);
  return 0;
}

// Attributes of a setting's kernels: up swiglu, up relu2, up gelu, down.
template <class Cfg>
void wg_cfg_attrs(int* out) {
  kernel_attrs(up_kernel_wg<Cfg, ACT_SWIGLU>, WgShape<Cfg, 2>::SMEM, Cfg::NT, out);
  kernel_attrs(up_kernel_wg<Cfg, ACT_RELU2>, WgShape<Cfg, 1>::SMEM, Cfg::NT, out + ATTR_FIELDS);
  kernel_attrs(up_kernel_wg<Cfg, ACT_GELU>, WgShape<Cfg, 1>::SMEM, Cfg::NT,
               out + 2 * ATTR_FIELDS);
  kernel_attrs(down_kernel_wg<Cfg>, WgShape<Cfg, 1>::SMEM, Cfg::NT, out + 3 * ATTR_FIELDS);
}

using WgLaunch = int (*)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, float*, int,
                         int, int, int, int, cudaStream_t);
using AttrsFn = void (*)(int*);
#define WG_LAUNCH_ENTRY(...) &launch_wg_cfg<WgCfg<__VA_ARGS__>>,
#define WG_ATTRS_ENTRY(...) &wg_cfg_attrs<WgCfg<__VA_ARGS__>>,
const WgLaunch kWgLaunch[] = {WG_SETTINGS(WG_LAUNCH_ENTRY)};
const AttrsFn kWgAttrs[] = {WG_SETTINGS(WG_ATTRS_ENTRY)};
constexpr int N_WG = sizeof(kWgLaunch) / sizeof(kWgLaunch[0]);

// bf16 x bf16: 16-byte rows and operands and a setting of the table, or
// cudaErrorInvalidValue.
int launch_tc(const void* xe, const void* wg, const void* wu, const void* wd, void* h,
              float* out, int E, int C, int d, int m, int act, int tiles, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(xe) | reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                         reinterpret_cast<uintptr_t>(h);
  if (d % 8 != 0 || m % 8 != 0 || bits % 16 != 0 || tiles < 0 || tiles >= N_WG) return -1;
  return kWgLaunch[tiles](static_cast<const bf16*>(xe), static_cast<const bf16*>(wg),
                          static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
                          static_cast<bf16*>(h), out, E, C, d, m, act, s);
}

// ----------------------------- int8 / fp8 weights on the tensor cores
//
// Every int8 value (|q| <= 127) and every e4m3 value is exact in bf16, and a
// bf16 times a bf16 is exact in fp32, so x q runs on mma.sync bf16 with the
// fp32 accuracy of the reference; the per-(expert, column) scale multiplies
// the fp32 sum in the epilogue.  An fp32 operand (h in the down phase, x
// when the activations are fp32) comes as three bf16 planes, a = hi + mid +
// lo exactly, and each plane meets the same q fragment.

constexpr int Q_BM = 64;          // rows per block; each warp owns all 64 rows of WN columns

// The settings of the 8-bit path, one per row: for phase 1 (up) and then
// phase 2 (down), the columns a block, the columns a warp (16 or 32), the
// k-rows a stage and the ring depth.  Row i is setting i of
// streamed_moe_forward's `tiles`; TILE_SETTINGS["8bit"] in the wrapper holds
// the same rows in the same order.  Row 0 is the default: the fastest of the
// settings timed at (E, C, d, m) = (32, 64, 1024, 512) (PERF.md).
// Phase 1 keeps 64-column blocks, so E m / 64 blocks fill the card, with
// 16-column warps; phase 2 reads three h planes for each k step, so its warps
// take 32 columns (half the activation reads of a block) and its blocks 128
// (half the blocks that re-read an expert's h from L2).  The others are the
// runners-up of that timing.  An output's k16 steps run in ascending k in
// every setting, so all give the same bits.
#define Q_SETTINGS(X)                   \
  X(64, 16, 64, 4, 128, 32, 64, 3)      \
  X(64, 16, 128, 3, 128, 32, 64, 3)     \
  X(64, 16, 64, 4, 128, 16, 64, 3)      \
  X(64, 16, 64, 4, 64, 32, 64, 3)       \
  X(64, 32, 64, 4, 128, 32, 64, 3)      \
  X(128, 16, 64, 4, 128, 32, 64, 4)

template <int UBN, int UWN, int UBK, int UST, int DBN, int DWN, int DBK, int DST>
struct QCfg {
  static constexpr int UP_BN = UBN, UP_WN = UWN, UP_BK = UBK, UP_STAGES = UST;
  static constexpr int DN_BN = DBN, DN_WN = DWN, DN_BK = DBK, DN_STAGES = DST;
};

// A stage holds PARTS bf16 activation tiles (Q_BM x BK) and NMAT 8-bit
// weight tiles (BK x BN bytes, rows padded by 16 bytes so that a warp's
// fragment loads hit distinct banks).
template <int PARTS, int NMAT, int BN_, int WN_, int BK_, int STAGES_>
struct QShape {
  static constexpr int BN = BN_, WN = WN_, BK = BK_, STAGES = STAGES_;
  static constexpr int NJ = WN / 8;                 // n8 tiles a warp
  static constexpr int NT = 32 * BN / WN;
  static constexpr int XS = BK + 8;                 // bf16 tile row stride
  static constexpr int WS = BN + 16;                // weight tile row stride (bytes)
  static constexpr int NACC = PARTS > 1 ? 2 : 1;    // [0] hi, [1] mid + lo
  static constexpr int A_BYTES = PARTS * Q_BM * XS * 2;
  static constexpr int W_BYTES = BK * WS;
  static constexpr int STAGE = A_BYTES + NMAT * W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert((WN == 16 || WN == 32) && BN % WN == 0 && BK % 16 == 0 && STAGES >= 2,
                "bad 8-bit tile setting");
};

// v = hi + mid + lo with each part exact in bf16: hi rounds v to 8 bits, the
// rest (exact in fp32) spans at most 16 bits and its rounding at most 8.
__device__ __forceinline__ void split3(float v, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// p holds bytes {a, b} in its low half: two weights of one column from two
// k rows.  -> the bf16 pair {a, b} (a in the low half), exact.
template <typename TW> __device__ __forceinline__ uint32_t widen2(uint32_t p);
// int8 without I2F (a quarter-rate instruction): byte ^ 0x80 = q + 128 goes
// into the mantissa of 2^23, and subtracting 2^23 + 128 leaves q exactly;
// q has at most 8 significant bits, so the upper half of each float is its
// bf16.
template <> __device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t p) {
  const uint32_t u = p ^ 0x8080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
template <> __device__ __forceinline__ uint32_t widen2<__nv_fp8_e4m3>(uint32_t p) {
  const __half2_raw h2 =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(p & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h2));
  return tc::pack_bf16(f.x, f.y);
}

// WN / 8 bytes of one weight row (the thread's columns), zero-extended.
template <int WN>
__device__ __forceinline__ uint32_t load_row(const unsigned char* p) {
  if constexpr (WN == 32) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const unsigned short*>(p);
}

// acc[0 or 1][mat] += a[r0 : r0+Q_BM, :] @ q[mat][:, c0 : c0+BN] over K,
// unscaled; a is PARTS bf16 planes (R, K), `plane` elements apart, and q an
// 8-bit (K, N).  Warp w owns all Q_BM rows of columns WN w .. WN w + WN-1:
// four m16 tiles from ldmatrix, and NJ = WN / 8 n8 weight tiles built from
// bytes, so each weight byte is widened once a block.  For a k16 step a
// thread reads the NJ bytes at columns NJ g .. NJ g + NJ-1 of rows 2t, 2t+1,
// 2t+8, 2t+9 (g = lane / 4, t = lane % 4) and pairs byte j of two rows into
// n8 tile j, which thus holds the columns NJ n + j: accumulator
// acc[.][.][i][j][2 half + e] is row 16i + 8half + g, column
// WN w + 2 NJ t + NJ e + j.  Rows past R, columns past N and k past K load
// as zeros (K a multiple of 8, N of 16).
template <typename S, typename TW, int PARTS, int NMAT>
__device__ __forceinline__ void q_mainloop(float (&acc)[S::NACC][NMAT][4][S::NJ][4],
                                           unsigned char* smem, const bf16* __restrict__ a,
                                           size_t plane, int R, int K, int r0,
                                           const TW* const (&w)[NMAT], int N, int c0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nk = (K + S::BK - 1) / S::BK;
  auto load = [&](int kt, int stage) {
    unsigned char* st = smem + stage * S::STAGE;
    bf16* as = reinterpret_cast<bf16*>(st);
    const int k0 = kt * S::BK;
    for (int i = tid; i < PARTS * Q_BM * (S::BK / 8); i += S::NT) {
      const int pr = i / (S::BK / 8), c = (i % (S::BK / 8)) * 8;   // pr: part * Q_BM + row
      const int r = pr % Q_BM;
      const bool ok = r0 + r < R && k0 + c < K;
      const bf16* src = a + (pr / Q_BM) * plane + (size_t)(r0 + r) * K + k0 + c;
      tc::cp_async16(as + pr * S::XS + c, ok ? src : a, ok);
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      unsigned char* ws = st + S::A_BYTES + mat * S::W_BYTES;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(w[mat]);
      for (int i = tid; i < S::BK * (S::BN / 16); i += S::NT) {
        const int r = i / (S::BN / 16), c = (i % (S::BN / 16)) * 16;
        const bool ok = k0 + r < K && c0 + c < N;
        tc::cp_async16(ws + r * S::WS + c, ok ? src + (size_t)(k0 + r) * N + c0 + c : src, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<S::STAGES - 2>();   // tile kt has landed (this thread's copies)
    __syncthreads();                       // ... everyone's; stage (kt-1) is free again
    const int next = kt + S::STAGES - 1;
    if (next < nk) load(next, next % S::STAGES);
    tc::cp_async_commit();
    const unsigned char* st = smem + (kt % S::STAGES) * S::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
      uint32_t af[PARTS][4][4];
#pragma unroll
      for (int part = 0; part < PARTS; ++part)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tc::ldmatrix_x4(af[part][i], xs + (part * Q_BM + i * 16 + lane % 16) * S::XS +
                                           kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        const unsigned char* wr = st + S::A_BYTES + mat * S::W_BYTES +
                                  (kk * 16 + 2 * t) * S::WS + warp * S::WN + S::NJ * g;
        const uint32_t w0 = load_row<S::WN>(wr), w1 = load_row<S::WN>(wr + S::WS);
        const uint32_t w8 = load_row<S::WN>(wr + 8 * S::WS), w9 = load_row<S::WN>(wr + 9 * S::WS);
#pragma unroll
        for (int j = 0; j < S::NJ; ++j) {
          const uint32_t sel = j | (4 + j) << 4;   // byte j of two rows
          const uint32_t b0 = widen2<TW>(__byte_perm(w0, w1, sel));
          const uint32_t b1 = widen2<TW>(__byte_perm(w8, w9, sel));
#pragma unroll
          for (int part = 0; part < PARTS; ++part)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tc::mma_bf16(acc[part == 0 ? 0 : 1][mat][i][j], af[part][i], b0, b1);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
}

// The scaled fp32 sum at row 16i + 8half + g, column 2 NJ t + cc of the
// warp's share (cc = NJ e + j).
template <int NACC, int NMAT, int NJ>
__device__ __forceinline__ float q_sum(const float (&acc)[NACC][NMAT][4][NJ][4], int mat, int i,
                                       int half, int cc, float scale) {
  const int j = cc % NJ, k = 2 * half + cc / NJ;
  float v = acc[0][mat][i][j][k];
  if constexpr (NACC == 2) v += acc[1][mat][i][j][k];
  return v * scale;
}

// Phase 1: h = act(s_g (x q_g), s_u (x q_u)) in fp32, written as three bf16
// planes (3, E, C, m).  x is bf16 (PARTS = 1) or three planes of fp32 x.
template <int PARTS, typename TW, int ACT, int BN, int WN, int BK, int STAGES>
__global__ void __launch_bounds__(32 * BN / WN)
up_kernel_q(const bf16* __restrict__ xe, const TW* __restrict__ wg, const TW* __restrict__ wu,
            const float* __restrict__ sg, const float* __restrict__ su, bf16* __restrict__ h,
            int E, int C, int d, int m) {
  constexpr int NMAT = ACT == ACT_SWIGLU ? 2 : 1;   // [0] up, [1] gate
  using S = QShape<PARTS, NMAT, BN, WN, BK, STAGES>;
  constexpr int NC = 2 * S::NJ;                      // a thread's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, r0 = blockIdx.y * Q_BM;
  const TW* w[NMAT];
  w[0] = wu + (size_t)e * d * m;
  if constexpr (NMAT == 2) w[1] = wg + (size_t)e * d * m;
  float acc[S::NACC][NMAT][4][S::NJ][4] = {};
  q_mainloop<S, TW, PARTS, NMAT>(acc, smem_raw, xe + (size_t)e * C * d, (size_t)E * C * d, C, d,
                                 r0, w, m, c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + warp * S::WN + NC * (lane % 4);
  if (c >= m) return;
  float s_u[NC], s_g[NC] = {};
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    s_u[cc] = su[(size_t)e * m + c + cc];
    if constexpr (NMAT == 2) s_g[cc] = sg[(size_t)e * m + c + cc];
  }
  const size_t plane = (size_t)E * C * m;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + i * 16 + half * 8 + lane / 4;
      if (r >= C) continue;
      float p[3][NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float u = q_sum(acc, 0, i, half, cc, s_u[cc]);
        const float gate = NMAT == 2 ? q_sum(acc, NMAT - 1, i, half, cc, s_g[cc]) : 0.0f;
        split3(activate<ACT>(gate, u), p[0][cc], p[1][cc], p[2][cc]);
      }
      bf16* hr = h + ((size_t)e * C + r) * m + c;
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int q = 0; q < NC; q += 4)
          *reinterpret_cast<uint2*>(hr + part * plane + q) =
              make_uint2(tc::pack_bf16(p[part][q], p[part][q + 1]),
                         tc::pack_bf16(p[part][q + 2], p[part][q + 3]));
    }
}

// Phase 2: out = s_d (h q_d), h as its three bf16 planes.
template <typename TW, int BN, int WN, int BK, int STAGES>
__global__ void __launch_bounds__(32 * BN / WN)
down_kernel_q(const bf16* __restrict__ h, const TW* __restrict__ wd,
              const float* __restrict__ sd, float* __restrict__ out, int E, int C, int d, int m) {
  using S = QShape<3, 1, BN, WN, BK, STAGES>;
  constexpr int NC = 2 * S::NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, r0 = blockIdx.y * Q_BM;
  const TW* w[1] = {wd + (size_t)e * m * d};
  float acc[S::NACC][1][4][S::NJ][4] = {};
  q_mainloop<S, TW, 3, 1>(acc, smem_raw, h + (size_t)e * C * m, (size_t)E * C * m, C, m, r0, w,
                          d, c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + warp * S::WN + NC * (lane % 4);
  if (c >= d) return;
  float s[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) s[cc] = sd[(size_t)e * d + c + cc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + i * 16 + half * 8 + lane / 4;
      if (r >= C) continue;
#pragma unroll
      for (int q = 0; q < NC; q += 4)
        *reinterpret_cast<float4*>(out + ((size_t)e * C + r) * d + c + q) = make_float4(
            q_sum(acc, 0, i, half, q, s[q]), q_sum(acc, 0, i, half, q + 1, s[q + 1]),
            q_sum(acc, 0, i, half, q + 2, s[q + 2]), q_sum(acc, 0, i, half, q + 3, s[q + 3]));
    }
}

// fp32 x (n values, n a multiple of 4) -> three bf16 planes n apart.
__global__ void split3_kernel(const float* __restrict__ x, bf16* __restrict__ planes, size_t n) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  const float vs[4] = {v.x, v.y, v.z, v.w};
  float p[3][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) split3(vs[k], p[0][k], p[1][k], p[2][k]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
    *reinterpret_cast<uint2*>(planes + part * n + i) =
        make_uint2(tc::pack_bf16(p[part][0], p[part][1]), tc::pack_bf16(p[part][2], p[part][3]));
}

// Phase 1's kernel of a setting for one activation and its shape; then
// phase 2's.
template <class Cfg, int PARTS, int ACT>
using QUpShape = QShape<PARTS, ACT == ACT_SWIGLU ? 2 : 1, Cfg::UP_BN, Cfg::UP_WN, Cfg::UP_BK,
                        Cfg::UP_STAGES>;
template <class Cfg>
using QDownShape = QShape<3, 1, Cfg::DN_BN, Cfg::DN_WN, Cfg::DN_BK, Cfg::DN_STAGES>;

template <class Cfg, int PARTS, typename TW, int ACT>
void launch_q_up(dim3 grid, cudaStream_t s, const bf16* x, const TW* g, const TW* u,
                 const float* sg, const float* su, bf16* h, int E, int C, int d, int m) {
  using S = QUpShape<Cfg, PARTS, ACT>;
  launch_dyn(up_kernel_q<PARTS, TW, ACT, Cfg::UP_BN, Cfg::UP_WN, Cfg::UP_BK, Cfg::UP_STAGES>,
             S::SMEM, grid, S::NT, s, x, g, u, sg, su, h, E, C, d, m);
}

template <class Cfg, int PARTS, typename TW>
void launch_q_typed(const bf16* x, const void* wg, const void* wu, const void* wd,
                    const float* sg, const float* su, const float* sd, bf16* h, float* out,
                    int E, int C, int d, int m, int act, cudaStream_t s) {
  const dim3 g_up((m + Cfg::UP_BN - 1) / Cfg::UP_BN, (C + Q_BM - 1) / Q_BM, E);
  const dim3 g_down((d + Cfg::DN_BN - 1) / Cfg::DN_BN, (C + Q_BM - 1) / Q_BM, E);
  const TW* g = static_cast<const TW*>(wg);
  const TW* u = static_cast<const TW*>(wu);
  switch (act) {
    case ACT_SWIGLU:
      launch_q_up<Cfg, PARTS, TW, ACT_SWIGLU>(g_up, s, x, g, u, sg, su, h, E, C, d, m);
      break;
    case ACT_RELU2:
      launch_q_up<Cfg, PARTS, TW, ACT_RELU2>(g_up, s, x, g, u, sg, su, h, E, C, d, m);
      break;
    default:
      launch_q_up<Cfg, PARTS, TW, ACT_GELU>(g_up, s, x, g, u, sg, su, h, E, C, d, m);
      break;
  }
  using D = QDownShape<Cfg>;
  launch_dyn(down_kernel_q<TW, Cfg::DN_BN, Cfg::DN_WN, Cfg::DN_BK, Cfg::DN_STAGES>, D::SMEM,
             g_down, D::NT, s, static_cast<const bf16*>(h), static_cast<const TW*>(wd), sd, out,
             E, C, d, m);
}

// Attributes of a setting's kernels: up swiglu, up relu2, up gelu, down.
template <class Cfg, int PARTS, typename TW>
void q_typed_attrs(int* out) {
  constexpr int BN = Cfg::UP_BN, WN = Cfg::UP_WN, BK = Cfg::UP_BK, ST = Cfg::UP_STAGES;
  using S0 = QUpShape<Cfg, PARTS, ACT_SWIGLU>;
  using S1 = QUpShape<Cfg, PARTS, ACT_RELU2>;
  using D = QDownShape<Cfg>;
  kernel_attrs(up_kernel_q<PARTS, TW, ACT_SWIGLU, BN, WN, BK, ST>, S0::SMEM, S0::NT, out);
  kernel_attrs(up_kernel_q<PARTS, TW, ACT_RELU2, BN, WN, BK, ST>, S1::SMEM, S1::NT,
               out + ATTR_FIELDS);
  kernel_attrs(up_kernel_q<PARTS, TW, ACT_GELU, BN, WN, BK, ST>, S1::SMEM, S1::NT,
               out + 2 * ATTR_FIELDS);
  kernel_attrs(down_kernel_q<TW, Cfg::DN_BN, Cfg::DN_WN, Cfg::DN_BK, Cfg::DN_STAGES>, D::SMEM,
               D::NT, out + 3 * ATTR_FIELDS);
}

using QLaunch = void (*)(const bf16*, const void*, const void*, const void*, const float*,
                         const float*, const float*, bf16*, float*, int, int, int, int, int,
                         cudaStream_t);
using QAttrs = void (*)(int*);
// [setting][x fp32][fp8 weights]
#define Q_LAUNCH_ENTRY(...)                                    \
  {{&launch_q_typed<QCfg<__VA_ARGS__>, 1, int8_t>,             \
    &launch_q_typed<QCfg<__VA_ARGS__>, 1, __nv_fp8_e4m3>},     \
   {&launch_q_typed<QCfg<__VA_ARGS__>, 3, int8_t>,             \
    &launch_q_typed<QCfg<__VA_ARGS__>, 3, __nv_fp8_e4m3>}},
#define Q_ATTRS_ENTRY(...)                                     \
  {{&q_typed_attrs<QCfg<__VA_ARGS__>, 1, int8_t>,              \
    &q_typed_attrs<QCfg<__VA_ARGS__>, 1, __nv_fp8_e4m3>},      \
   {&q_typed_attrs<QCfg<__VA_ARGS__>, 3, int8_t>,              \
    &q_typed_attrs<QCfg<__VA_ARGS__>, 3, __nv_fp8_e4m3>}},
const QLaunch kQLaunch[][2][2] = {Q_SETTINGS(Q_LAUNCH_ENTRY)};
const QAttrs kQAttrs[][2][2] = {Q_SETTINGS(Q_ATTRS_ENTRY)};
constexpr int N_Q = sizeof(kQLaunch) / sizeof(kQLaunch[0]);

// 8-bit weights: rows of d and m bytes in 16-byte copies, 16-byte aligned
// operands and a setting of the table, or cudaErrorInvalidValue.  The
// scratch holds h's three planes, then (fp32 x only) x's.
template <typename TX>
int launch_q(int w_dtype, const void* xe, const void* wg, const void* wu, const void* wd,
             const float* sg, const float* su, const float* sd, void* h, float* out, int E,
             int C, int d, int m, int act, int tiles, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(xe) | reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(su) |
                         reinterpret_cast<uintptr_t>(sd) | reinterpret_cast<uintptr_t>(sg);
  if (d % 16 != 0 || m % 16 != 0 || bits % 16 != 0 || tiles < 0 || tiles >= N_Q) return -1;
  bf16* hp = static_cast<bf16*>(h);
  const bf16* x = static_cast<const bf16*>(xe);
  constexpr int X_F32 = std::is_same<TX, float>::value ? 1 : 0;
  if constexpr (X_F32) {
    const size_t n = (size_t)E * C * d;
    bf16* xp = hp + 3 * (size_t)E * C * m;
    split3_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(static_cast<const float*>(xe),
                                                                 xp, n);
    x = xp;
  }
  kQLaunch[tiles][X_F32][w_dtype == DT_F8](x, wg, wu, wd, sg, su, sd, hp, out, E, C, d, m, act,
                                           s);
  return 0;
}

// ------------------------------------------------------ the CUDA-core path
//
// One setting (index 0): 64 x 64 blocks of 256 threads, 4 x 4 outputs each,
// 32-deep double-buffered steps.

template <typename TX, typename TW>
void launch_typed(const void* xe, const void* wg, const void* wu, const void* wd, float* h,
                  float* out, int E, int C, int d, int m, int act, cudaStream_t stream) {
  const dim3 g_up((m + BN - 1) / BN, (C + BM - 1) / BM, E);
  const dim3 g_down((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  const TX* x = static_cast<const TX*>(xe);
  const TW* g = static_cast<const TW*>(wg);
  const TW* u = static_cast<const TW*>(wu);
  switch (act) {
    case ACT_SWIGLU:
      launch_dyn(up_kernel<TX, TW, ACT_SWIGLU>, smem_bytes(2), g_up, NT, stream, x, g, u, h, C,
                 d, m);
      break;
    case ACT_RELU2:
      launch_dyn(up_kernel<TX, TW, ACT_RELU2>, smem_bytes(1), g_up, NT, stream, x, g, u, h, C, d,
                 m);
      break;
    default:
      launch_dyn(up_kernel<TX, TW, ACT_GELU>, smem_bytes(1), g_up, NT, stream, x, g, u, h, C, d,
                 m);
      break;
  }
  launch_dyn(down_kernel<TW>, smem_bytes(1), g_down, NT, stream, static_cast<const float*>(h),
             static_cast<const TW*>(wd), out, C, d, m);
}

template <typename TX, typename TW>
void simt_attrs(int* out) {
  kernel_attrs(up_kernel<TX, TW, ACT_SWIGLU>, smem_bytes(2), NT, out);
  kernel_attrs(up_kernel<TX, TW, ACT_RELU2>, smem_bytes(1), NT, out + ATTR_FIELDS);
  kernel_attrs(up_kernel<TX, TW, ACT_GELU>, smem_bytes(1), NT, out + 2 * ATTR_FIELDS);
  kernel_attrs(down_kernel<TW>, smem_bytes(1), NT, out + 3 * ATTR_FIELDS);
}

template <typename TX>
int launch_w(int w_dtype, const void* xe, const void* wg, const void* wu,
             const void* wd, const float* sg, const float* su, const float* sd,
             void* h, float* out, int E, int C, int d, int m, int act, int tiles,
             cudaStream_t s) {
  float* hf = static_cast<float*>(h);
  constexpr bool X_BF16 = std::is_same<TX, bf16>::value;
  if (w_dtype == DT_I8 || w_dtype == DT_F8)
    return launch_q<TX>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, tiles, s);
  if (w_dtype == DT_BF16 && X_BF16)
    return launch_tc(xe, wg, wu, wd, h, out, E, C, d, m, act, tiles, s);
  if (tiles != 0) return -1;
  if (w_dtype == DT_F32)
    launch_typed<TX, float>(xe, wg, wu, wd, hf, out, E, C, d, m, act, s);
  else if (w_dtype == DT_BF16)
    launch_typed<TX, bf16>(xe, wg, wu, wd, hf, out, E, C, d, m, act, s);
  else
    return -1;
  return 0;
}

}  // namespace

// xe (E,C,d) fp32|bf16; w_g/w_u (E,d,m), w_d (E,m,d) fp32|bf16|int8|fp8;
// s_g/s_u (E,1,m), s_d (E,1,d) fp32 (quantized weights only); h (E,C,m)
// scratch, bf16 when xe and the weights are bf16 (then d and m multiples of
// 8 and every operand 16-byte aligned); with int8 / fp8 weights three bf16
// planes of h (3,E,C,m), then, for fp32 xe, three of xe (3,E,C,d) (d and m
// multiples of 16, every operand 16-byte aligned); else fp32 (E,C,m); out
// (E,C,d) fp32.  `tiles` is a row of the path's settings table: WG_SETTINGS
// (bf16 x bf16), Q_SETTINGS (int8 / fp8 weights), or 0 (the CUDA-core
// path's one setting).  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a dtype, activation, size or setting it does
// not take.
extern "C" int streamed_moe_forward(const void* xe, const void* wg, const void* wu,
                                    const void* wd, const float* sg, const float* su,
                                    const float* sd, void* h, float* out, int E,
                                    int C, int d, int m, int x_dtype, int w_dtype,
                                    int act, int tiles, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || m <= 0 || E > 65535 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (act == ACT_SWIGLU && wg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = w_dtype == DT_I8 || w_dtype == DT_F8;
  if (quant && (su == nullptr || sd == nullptr || (act == ACT_SWIGLU && sg == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (x_dtype == DT_F32)
    rc = launch_w<float>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, tiles,
                         s);
  else if (x_dtype == DT_BF16)
    rc = launch_w<bf16>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, tiles,
                        s);
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The compiled resources of one setting's kernels for operands of these
// dtypes: into out[4 * 5], for up swiglu, up relu2, up gelu and down in
// turn, registers a thread, local (spill) bytes a thread, static shared
// bytes, dynamic shared bytes and threads a block.  The 8-bit path reports
// the kernels of its int8 or fp8 weights and its bf16 or fp32 activations.
// Returns 0, or cudaErrorInvalidValue for dtypes or a setting it does not
// take.
extern "C" int streamed_moe_tile_attrs(int x_dtype, int w_dtype, int tiles, int* out) {
  const bool x_f32 = x_dtype == DT_F32;
  if (!x_f32 && x_dtype != DT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (w_dtype == DT_I8 || w_dtype == DT_F8) {
    if (tiles < 0 || tiles >= N_Q) return static_cast<int>(cudaErrorInvalidValue);
    kQAttrs[tiles][x_f32][w_dtype == DT_F8](out);
  } else if (w_dtype == DT_BF16 && !x_f32) {
    if (tiles < 0 || tiles >= N_WG) return static_cast<int>(cudaErrorInvalidValue);
    kWgAttrs[tiles](out);
  } else if (tiles == 0 && (w_dtype == DT_F32 || w_dtype == DT_BF16)) {
    if (x_f32)
      w_dtype == DT_F32 ? simt_attrs<float, float>(out) : simt_attrs<float, bf16>(out);
    else
      simt_attrs<bf16, float>(out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
