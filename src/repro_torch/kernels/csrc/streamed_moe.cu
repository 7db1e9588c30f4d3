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
//   1. grid (m/64, C/BM, E): a block streams its 64-column slice of w_g and
//      w_u over d and writes the activated h[e, rows, cols] (rounded to bf16
//      when w_d is bf16) to a scratch (E, C, m);
//   2. grid (d/64, C/BM, E): a block streams its 64-column slice of w_d over
//      m and writes out[e, rows, cols].
// The expert is the grid's slowest axis, so all blocks of one expert (its
// column tiles, row tile by row tile) run at about the same time, and at
// large C the expert's weight slices are read from device memory about once
// and from L2 by its other row tiles.
//
// bf16 activations x bf16 weights (the serving and scoring paths) run on the
// tensor cores: mma.sync.m16n8k16 with fp32 accumulation, bf16 tiles read by
// ldmatrix, warps of 32 x 32 outputs (BM = 64 rows, 4 warps; BM = 128 rows,
// 8 warps, when C > 64).  The activation and weight tiles stream through a
// four-stage cp.async ring, three stages (24 KB of weights for swiglu) in
// flight per block while the fourth is multiplied.  h is bf16 here (exact:
// it is rounded to bf16 before the down product anyway).  This path takes
// d and m multiples of 8 (16-byte rows).
//
// int8 / fp8-e4m3 weights (bf16 or fp32 activations) run on the same
// mma.sync bf16 tensor cores with the reference's fp32 accuracy: every 8-bit
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
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------ bf16 x bf16 on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int TC_BN = 64;            // weight columns per block
constexpr int TC_BK = 32;            // contraction rows per stage
constexpr int TC_STAGES = 4;         // cp.async ring depth
constexpr int TC_XS = TC_BK + 8;     // activation tile row stride (80 bytes)
constexpr int TC_WS = TC_BN + 8;     // weight tile row stride (144 bytes)

// A block of BM rows runs (BM / 32) x 2 warps of 32 x 32 outputs; a stage
// holds a BM x TC_BK activation tile and NMAT TC_BK x TC_BN weight tiles.
template <int BM, int NMAT>
struct TcShape {
  static constexpr int NT = BM * 2;
  static constexpr int X_ELEMS = BM * TC_XS;
  static constexpr int W_ELEMS = TC_BK * TC_WS;
  static constexpr int STAGE = X_ELEMS + NMAT * W_ELEMS;
  static constexpr int SMEM = 2 * TC_STAGES * STAGE;
};

// acc[mat] += x[r0 : r0+BM, :] @ w[mat][:, c0 : c0+TC_BN] for row-major
// x (R, K) and w (K, N), each warp keeping its 32 x 32 share: acc[mat][i][j]
// is the m16 tile i, n8 tile j.  Rows past R, columns past N and k past K
// load as zeros (K and N multiples of 8).
template <int BM, int NMAT>
__device__ __forceinline__ void tc_mainloop(float (&acc)[NMAT][2][4][4], bf16* smem,
                                            const bf16* __restrict__ x, int R, int K, int r0,
                                            const bf16* const (&w)[NMAT], int N, int c0) {
  using S = TcShape<BM, NMAT>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int nk = (K + TC_BK - 1) / TC_BK;
  auto load = [&](int kt, int stage) {
    bf16* xs = smem + stage * S::STAGE;
    const int k0 = kt * TC_BK;
    for (int i = tid; i < BM * (TC_BK / 8); i += S::NT) {
      const int r = i / (TC_BK / 8), c = (i % (TC_BK / 8)) * 8;
      const bool ok = r0 + r < R && k0 + c < K;
      tc::cp_async16(xs + r * TC_XS + c, ok ? x + (size_t)(r0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      bf16* ws = xs + S::X_ELEMS + mat * S::W_ELEMS;
      for (int i = tid; i < TC_BK * (TC_BN / 8); i += S::NT) {
        const int r = i / (TC_BN / 8), c = (i % (TC_BN / 8)) * 8;
        const bool ok = k0 + r < K && c0 + c < N;
        tc::cp_async16(ws + r * TC_WS + c, ok ? w[mat] + (size_t)(k0 + r) * N + c0 + c : w[mat],
                       ok);
      }
    }
  };
  // Prologue: stages 0 .. TC_STAGES-2 in flight (a group per stage, empty
  // past the last tile, so the group count stays fixed).
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<TC_STAGES - 2>();   // tile kt has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; stage (kt-1) is free again
    const int next = kt + TC_STAGES - 1;
    if (next < nk) load(next, next % TC_STAGES);
    tc::cp_async_commit();
    const bf16* xs = smem + (kt % TC_STAGES) * S::STAGE;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tc::ldmatrix_x4(a[i], xs + (wm * 32 + i * 16 + lane % 16) * TC_XS + kk * 16 +
                                  (lane / 16) * 8);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        const bf16* ws = xs + S::X_ELEMS + mat * S::W_ELEMS;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, ws + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * TC_WS +
                                       wn * 32 + jp * 16 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tc::mma_bf16(acc[mat][i][2 * jp], a[i], b[0], b[1]);
            tc::mma_bf16(acc[mat][i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();   // only empty groups are left; retire them
}

// Phase 1 on the tensor cores: h[e, rows, cols] = bf16(act(x w_g, x w_u)).
template <int BM, int ACT>
__global__ void __launch_bounds__(BM * 2)
up_kernel_tc(const bf16* __restrict__ xe, const bf16* __restrict__ wg,
             const bf16* __restrict__ wu, bf16* __restrict__ h, int C, int d, int m) {
  constexpr int NMAT = ACT == ACT_SWIGLU ? 2 : 1;   // [0] up, [1] gate
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.x * TC_BN, r0 = blockIdx.y * BM;
  const bf16* w[NMAT];
  w[0] = wu + (size_t)e * d * m;
  if constexpr (NMAT == 2) w[1] = wg + (size_t)e * d * m;
  float acc[NMAT][2][4][4] = {};
  tc_mainloop<BM, NMAT>(acc, reinterpret_cast<bf16*>(smem_raw), xe + (size_t)e * C * d, C, d,
                        r0, w, m, c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = r0 + (warp / 2) * 32 + lane / 4, cw = c0 + (warp % 2) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rw + i * 16 + half * 8, c = cw + j * 8;
        if (r >= C || c >= m) continue;
        const float* u = &acc[0][i][j][2 * half];
        const float* g = &acc[NMAT - 1][i][j][2 * half];
        *reinterpret_cast<__nv_bfloat162*>(h + ((size_t)e * C + r) * m + c) =
            __floats2bfloat162_rn(activate<ACT>(g[0], u[0]), activate<ACT>(g[1], u[1]));
      }
}

// Phase 2 on the tensor cores: out[e, rows, cols] = h[e] @ w_d[e], fp32.
template <int BM>
__global__ void __launch_bounds__(BM * 2)
down_kernel_tc(const bf16* __restrict__ h, const bf16* __restrict__ wd,
               float* __restrict__ out, int C, int d, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.x * TC_BN, r0 = blockIdx.y * BM;
  const bf16* w[1] = {wd + (size_t)e * m * d};
  float acc[1][2][4][4] = {};
  tc_mainloop<BM, 1>(acc, reinterpret_cast<bf16*>(smem_raw), h + (size_t)e * C * m, C, m, r0,
                     w, d, c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = r0 + (warp / 2) * 32 + lane / 4, cw = c0 + (warp % 2) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rw + i * 16 + half * 8, c = cw + j * 8;
        if (r >= C || c >= d) continue;
        *reinterpret_cast<float2*>(out + ((size_t)e * C + r) * d + c) =
            make_float2(acc[0][i][j][2 * half], acc[0][i][j][2 * half + 1]);
      }
}

template <int BM, typename Kernel, typename... Args>
void launch_tc_kernel(Kernel kernel, int bytes, dim3 grid, cudaStream_t s, Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, BM * 2, bytes, s>>>(args...);
}

template <int BM>
void launch_tc_bm(const bf16* x, const bf16* g, const bf16* u, const bf16* wd, bf16* h,
                  float* out, int E, int C, int d, int m, int act, cudaStream_t s) {
  const dim3 g_up((m + TC_BN - 1) / TC_BN, (C + BM - 1) / BM, E);
  const dim3 g_down((d + TC_BN - 1) / TC_BN, (C + BM - 1) / BM, E);
  switch (act) {
    case ACT_SWIGLU:
      launch_tc_kernel<BM>(up_kernel_tc<BM, ACT_SWIGLU>, TcShape<BM, 2>::SMEM, g_up, s, x, g, u,
                           h, C, d, m);
      break;
    case ACT_RELU2:
      launch_tc_kernel<BM>(up_kernel_tc<BM, ACT_RELU2>, TcShape<BM, 1>::SMEM, g_up, s, x, g, u,
                           h, C, d, m);
      break;
    default:
      launch_tc_kernel<BM>(up_kernel_tc<BM, ACT_GELU>, TcShape<BM, 1>::SMEM, g_up, s, x, g, u,
                           h, C, d, m);
      break;
  }
  launch_tc_kernel<BM>(down_kernel_tc<BM>, TcShape<BM, 1>::SMEM, g_down, s,
                       static_cast<const bf16*>(h), wd, out, C, d, m);
}

// bf16 x bf16: 16-byte rows and operands, or cudaErrorInvalidValue.
int launch_tc(const void* xe, const void* wg, const void* wu, const void* wd, void* h,
              float* out, int E, int C, int d, int m, int act, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(xe) | reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                         reinterpret_cast<uintptr_t>(h);
  if (d % 8 != 0 || m % 8 != 0 || bits % 16 != 0) return -1;
  const bf16* x = static_cast<const bf16*>(xe);
  const bf16* g = static_cast<const bf16*>(wg);
  const bf16* u = static_cast<const bf16*>(wu);
  const bf16* w = static_cast<const bf16*>(wd);
  if (C <= 64)
    launch_tc_bm<64>(x, g, u, w, static_cast<bf16*>(h), out, E, C, d, m, act, s);
  else
    launch_tc_bm<128>(x, g, u, w, static_cast<bf16*>(h), out, E, C, d, m, act, s);
  return 0;
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
// Per phase: columns a block, columns a warp, k-rows a stage, ring depth
// (each the fastest of the settings timed at (E, C, d, m) = (32, 64, 1024,
// 512); PERF.md).  Phase 1 keeps 64-column blocks, so E m / 64 blocks fill
// the card, with 16-column warps; phase 2 reads three h planes for each k
// step, so its warps take 32 columns (half the activation reads of a block)
// and its blocks 128 (half the blocks that re-read an expert's h from L2).
constexpr int Q_UP_BN = 64, Q_UP_WN = 16, Q_UP_BK = 64, Q_UP_STAGES = 4;
constexpr int Q_DN_BN = 128, Q_DN_WN = 32, Q_DN_BK = 64, Q_DN_STAGES = 3;

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
template <int PARTS, typename TW, int ACT>
__global__ void __launch_bounds__(32 * Q_UP_BN / Q_UP_WN)
up_kernel_q(const bf16* __restrict__ xe, const TW* __restrict__ wg, const TW* __restrict__ wu,
            const float* __restrict__ sg, const float* __restrict__ su, bf16* __restrict__ h,
            int E, int C, int d, int m) {
  constexpr int NMAT = ACT == ACT_SWIGLU ? 2 : 1;   // [0] up, [1] gate
  using S = QShape<PARTS, NMAT, Q_UP_BN, Q_UP_WN, Q_UP_BK, Q_UP_STAGES>;
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
template <typename TW>
__global__ void __launch_bounds__(32 * Q_DN_BN / Q_DN_WN)
down_kernel_q(const bf16* __restrict__ h, const TW* __restrict__ wd,
              const float* __restrict__ sd, float* __restrict__ out, int E, int C, int d, int m) {
  using S = QShape<3, 1, Q_DN_BN, Q_DN_WN, Q_DN_BK, Q_DN_STAGES>;
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

template <typename Kernel, typename... Args>
void launch_q_kernel(Kernel kernel, int bytes, dim3 grid, int threads, cudaStream_t s,
                     Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, threads, bytes, s>>>(args...);
}

template <int PARTS, typename TW>
void launch_q_typed(const bf16* x, const void* wg, const void* wu, const void* wd,
                    const float* sg, const float* su, const float* sd, bf16* h, float* out,
                    int E, int C, int d, int m, int act, cudaStream_t s) {
  const dim3 g_up((m + Q_UP_BN - 1) / Q_UP_BN, (C + Q_BM - 1) / Q_BM, E);
  const dim3 g_down((d + Q_DN_BN - 1) / Q_DN_BN, (C + Q_BM - 1) / Q_BM, E);
  const TW* g = static_cast<const TW*>(wg);
  const TW* u = static_cast<const TW*>(wu);
  using S1 = QShape<PARTS, 1, Q_UP_BN, Q_UP_WN, Q_UP_BK, Q_UP_STAGES>;
  using S2 = QShape<PARTS, 2, Q_UP_BN, Q_UP_WN, Q_UP_BK, Q_UP_STAGES>;
  switch (act) {
    case ACT_SWIGLU:
      launch_q_kernel(up_kernel_q<PARTS, TW, ACT_SWIGLU>, S2::SMEM, g_up, S2::NT, s, x, g, u, sg,
                      su, h, E, C, d, m);
      break;
    case ACT_RELU2:
      launch_q_kernel(up_kernel_q<PARTS, TW, ACT_RELU2>, S1::SMEM, g_up, S1::NT, s, x, g, u, sg,
                      su, h, E, C, d, m);
      break;
    default:
      launch_q_kernel(up_kernel_q<PARTS, TW, ACT_GELU>, S1::SMEM, g_up, S1::NT, s, x, g, u, sg,
                      su, h, E, C, d, m);
      break;
  }
  using SD = QShape<3, 1, Q_DN_BN, Q_DN_WN, Q_DN_BK, Q_DN_STAGES>;
  launch_q_kernel(down_kernel_q<TW>, SD::SMEM, g_down, SD::NT, s, static_cast<const bf16*>(h),
                  static_cast<const TW*>(wd), sd, out, E, C, d, m);
}

// 8-bit weights: rows of d and m bytes in 16-byte copies and 16-byte aligned
// operands, or cudaErrorInvalidValue.  The scratch holds h's three planes,
// then (fp32 x only) x's.
template <typename TX>
int launch_q(int w_dtype, const void* xe, const void* wg, const void* wu, const void* wd,
             const float* sg, const float* su, const float* sd, void* h, float* out, int E,
             int C, int d, int m, int act, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(xe) | reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(su) |
                         reinterpret_cast<uintptr_t>(sd) | reinterpret_cast<uintptr_t>(sg);
  if (d % 16 != 0 || m % 16 != 0 || bits % 16 != 0) return -1;
  bf16* hp = static_cast<bf16*>(h);
  const bf16* x = static_cast<const bf16*>(xe);
  constexpr int PARTS = std::is_same<TX, float>::value ? 3 : 1;
  if constexpr (PARTS == 3) {
    const size_t n = (size_t)E * C * d;
    bf16* xp = hp + 3 * (size_t)E * C * m;
    split3_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(static_cast<const float*>(xe),
                                                                 xp, n);
    x = xp;
  }
  if (w_dtype == DT_I8)
    launch_q_typed<PARTS, int8_t>(x, wg, wu, wd, sg, su, sd, hp, out, E, C, d, m, act, s);
  else
    launch_q_typed<PARTS, __nv_fp8_e4m3>(x, wg, wu, wd, sg, su, sd, hp, out, E, C, d, m, act, s);
  return 0;
}

// ------------------------------------------------------ the CUDA-core path

// Launch with dynamic shared memory; above the 48 KB default the kernel
// must be allowed more first.
template <typename Kernel, typename... Args>
void launch(Kernel kernel, int bytes, dim3 grid, cudaStream_t s, Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, NT, bytes, s>>>(args...);
}

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
      launch(up_kernel<TX, TW, ACT_SWIGLU>, smem_bytes(2), g_up, stream, x, g, u, h, C, d, m);
      break;
    case ACT_RELU2:
      launch(up_kernel<TX, TW, ACT_RELU2>, smem_bytes(1), g_up, stream, x, g, u, h, C, d, m);
      break;
    default:
      launch(up_kernel<TX, TW, ACT_GELU>, smem_bytes(1), g_up, stream, x, g, u, h, C, d, m);
      break;
  }
  launch(down_kernel<TW>, smem_bytes(1), g_down, stream, static_cast<const float*>(h),
         static_cast<const TW*>(wd), out, C, d, m);
}

template <typename TX>
int launch_w(int w_dtype, const void* xe, const void* wg, const void* wu,
             const void* wd, const float* sg, const float* su, const float* sd,
             void* h, float* out, int E, int C, int d, int m, int act,
             cudaStream_t s) {
  float* hf = static_cast<float*>(h);
  switch (w_dtype) {
    case DT_F32:
      launch_typed<TX, float>(xe, wg, wu, wd, hf, out, E, C, d, m, act, s);
      return 0;
    case DT_BF16:
      if constexpr (std::is_same<TX, bf16>::value) {
        return launch_tc(xe, wg, wu, wd, h, out, E, C, d, m, act, s);
      } else {
        launch_typed<TX, bf16>(xe, wg, wu, wd, hf, out, E, C, d, m, act, s);
        return 0;
      }
    case DT_I8:
    case DT_F8:
      return launch_q<TX>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
    default:
      return -1;
  }
}

}  // namespace

// xe (E,C,d) fp32|bf16; w_g/w_u (E,d,m), w_d (E,m,d) fp32|bf16|int8|fp8;
// s_g/s_u (E,1,m), s_d (E,1,d) fp32 (quantized weights only); h (E,C,m)
// scratch, bf16 when xe and the weights are bf16 (then d and m multiples of
// 8 and every operand 16-byte aligned); with int8 / fp8 weights three bf16
// planes of h (3,E,C,m), then, for fp32 xe, three of xe (3,E,C,d) (d and m
// multiples of 16, every operand 16-byte aligned); else fp32 (E,C,m); out
// (E,C,d) fp32.  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a dtype, activation or size it does not take.
extern "C" int streamed_moe_forward(const void* xe, const void* wg, const void* wu,
                                    const void* wd, const float* sg, const float* su,
                                    const float* sd, void* h, float* out, int E,
                                    int C, int d, int m, int x_dtype, int w_dtype,
                                    int act, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || m <= 0 || E > 65535 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (act == ACT_SWIGLU && wg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = w_dtype == DT_I8 || w_dtype == DT_F8;
  if (quant && (su == nullptr || sd == nullptr || (act == ACT_SWIGLU && sg == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (x_dtype == DT_F32)
    rc = launch_w<float>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
  else if (x_dtype == DT_BF16)
    rc = launch_w<__nv_bfloat16>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m,
                                 act, s);
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
