// Grouped expert FFN over one d_expert slice, for Hopper (sm_90a).
//
// Replaces repro/kernels/streamed_moe.py::streamed_moe_kernel (the Pallas
// TPU kernel): out[e] = act(xe[e] @ w_g[e], xe[e] @ w_u[e]) @ w_d[e] for
// every expert e, with swiglu / relu2 / gelu (tanh form), fp32
// accumulation, fp32 output, and int8 / fp8-e4m3 weights dequantized in
// shared memory with per-(expert, output-channel) fp32 scales.
//
// Bound: at the serving path's decode and prefill shapes (E=32, C=64,
// d=1024, m=512) every weight byte is read once and used for only C=64
// rows, so the launch is bound by the weight stream (about 100 MB in bf16,
// 34 us at 3.35 TB/s); the tensor-core floor is below that.
//
// What the design does about it: blocks are spread over experts and weight
// tiles, not over token tiles, so all 132 SMs stream disjoint slices of the
// weights at once and each weight tile is read from device memory by one
// block only (C fits one row tile at decode).  Two phases:
//   1. grid (m/64, C/64, E): a block streams its 64-column slice of w_g and
//      w_u over d in 32-row steps and writes the activated h[e, rows, cols]
//      (rounded to bf16 when w_d is bf16) to an fp32 scratch (E, C, m);
//   2. grid (d/64, C/64, E): a block streams its 64-column slice of w_d over
//      m and writes out[e, rows, cols].
// Each step's global loads for the next tile are issued into registers
// before the current tile is multiplied (two shared-memory buffers, one
// barrier per step), so the weight stream overlaps the arithmetic.  The
// products run on CUDA cores as fp32 FMAs in ascending k (4x4 outputs per
// thread), which keeps the fp32, int8 and fp8 paths exact to the
// reference's 2e-5 and leaves the kernel well above the byte bound; wgmma,
// TMA and fp8 tensor cores come later.
//
// Plain C interface for ctypes: one launch function that runs both phases
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows (capacity slots) per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 32;    // contraction rows per shared-memory step
constexpr int NT = 256;   // threads per block: 16 x 16, 4 x 4 outputs each

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_F8 = 3 };
enum { ACT_SWIGLU = 0, ACT_RELU2 = 1, ACT_GELU = 2 };

template <typename TW> struct WTraits { static constexpr bool quant = false, bf16 = false; };
template <> struct WTraits<__nv_bfloat16> { static constexpr bool quant = false, bf16 = true; };
template <> struct WTraits<int8_t> { static constexpr bool quant = true, bf16 = false; };
template <> struct WTraits<__nv_fp8_e4m3> { static constexpr bool quant = true, bf16 = false; };

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
template <> struct Elem<__nv_fp8_e4m3> {
  using raw = unsigned char;
  static __device__ __forceinline__ float f32(raw v) {
    __nv_fp8_e4m3 f;
    f.__x = v;
    return static_cast<float>(f);
  }
};

// Per-thread share of one tile.  Thread t always loads the same tile column
// (weights: t % BN) or the same contraction index (activations: t % BK), so
// its dequantization scale is one register for the whole block.
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

// Convert (and dequantize) the fetched weight tile into shared memory.
template <typename TW>
__device__ __forceinline__ void store_w(float* dst, const typename Elem<TW>::raw (&reg)[W_PER_THREAD],
                                        float scale) {
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j) {
    float v = Elem<TW>::f32(reg[j]);
    if (WTraits<TW>::quant) v *= scale;
    dst[(threadIdx.x / BN + j * (NT / BN)) * BN + threadIdx.x % BN] = v;
  }
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
          const TW* __restrict__ wu, const float* __restrict__ sg,
          const float* __restrict__ su, float* __restrict__ h,
          int C, int d, int m) {
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
  const int wc = c0 + threadIdx.x % BN;
  float s_u = 1.0f, s_g = 1.0f;
  if (WTraits<TW>::quant && wc < m) {
    s_u = su[(size_t)e * m + wc];
    if (gated) s_g = sg[(size_t)e * m + wc];
  }

  typename Elem<TX>::raw xr[X_PER_THREAD];
  typename Elem<TW>::raw ur[W_PER_THREAD], gr[W_PER_THREAD];
  fetch_x<TX>(xr, x, r0, 0, C, d);
  fetch_w<TW>(ur, u, 0, c0, d, m);
  if constexpr (gated) fetch_w<TW>(gr, g, 0, c0, d, m);
  store_x<TX>(xs, xr);
  store_w<TW>(us, ur, s_u);
  if constexpr (gated) store_w<TW>(gs, gr, s_g);
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
      store_w<TW>(us + (buf ^ 1) * W_TILE, ur, s_u);
      if constexpr (gated) store_w<TW>(gs + (buf ^ 1) * W_TILE, gr, s_g);
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
      if (WTraits<TW>::bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      h[((size_t)e * C + r) * m + c] = v;
    }
  }
}

// Phase 2: out[e, r, c] = h[e] @ w_d[e] for one 64 x 64 tile, double-buffered.
template <typename TW>
__global__ void __launch_bounds__(NT)
down_kernel(const float* __restrict__ h, const TW* __restrict__ wd,
            const float* __restrict__ sd, float* __restrict__ out,
            int C, int d, int m) {
  extern __shared__ float smem[];
  float* hs = smem;                        // [2][BK][X_STRIDE]
  float* ws = smem + 2 * X_TILE;           // [2][BK][BN]
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const float* hx = h + (size_t)e * C * m;
  const TW* w = wd + (size_t)e * m * d;
  const int wc = c0 + threadIdx.x % BN;
  const float s_d = (WTraits<TW>::quant && wc < d) ? sd[(size_t)e * d + wc] : 1.0f;

  float hr[X_PER_THREAD];
  typename Elem<TW>::raw wr[W_PER_THREAD];
  fetch_x<float>(hr, hx, r0, 0, C, m);
  fetch_w<TW>(wr, w, 0, c0, m, d);
  store_x<float>(hs, hr);
  store_w<TW>(ws, wr, s_d);
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
      store_w<TW>(ws + (buf ^ 1) * W_TILE, wr, s_d);
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

// Launch with dynamic shared memory; above the 48 KB default the kernel
// must be allowed more first.
template <typename Kernel, typename... Args>
void launch(Kernel kernel, int bytes, dim3 grid, cudaStream_t s, Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, NT, bytes, s>>>(args...);
}

template <typename TX, typename TW>
void launch_typed(const void* xe, const void* wg, const void* wu, const void* wd,
                  const float* sg, const float* su, const float* sd, float* h,
                  float* out, int E, int C, int d, int m, int act,
                  cudaStream_t stream) {
  const dim3 g_up((m + BN - 1) / BN, (C + BM - 1) / BM, E);
  const dim3 g_down((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  const TX* x = static_cast<const TX*>(xe);
  const TW* g = static_cast<const TW*>(wg);
  const TW* u = static_cast<const TW*>(wu);
  switch (act) {
    case ACT_SWIGLU:
      launch(up_kernel<TX, TW, ACT_SWIGLU>, smem_bytes(2), g_up, stream, x, g, u, sg, su, h, C, d, m);
      break;
    case ACT_RELU2:
      launch(up_kernel<TX, TW, ACT_RELU2>, smem_bytes(1), g_up, stream, x, g, u, sg, su, h, C, d, m);
      break;
    default:
      launch(up_kernel<TX, TW, ACT_GELU>, smem_bytes(1), g_up, stream, x, g, u, sg, su, h, C, d, m);
      break;
  }
  launch(down_kernel<TW>, smem_bytes(1), g_down, stream, static_cast<const float*>(h),
         static_cast<const TW*>(wd), sd, out, C, d, m);
}

template <typename TX>
int launch_w(int w_dtype, const void* xe, const void* wg, const void* wu,
             const void* wd, const float* sg, const float* su, const float* sd,
             float* h, float* out, int E, int C, int d, int m, int act,
             cudaStream_t s) {
  switch (w_dtype) {
    case DT_F32:
      launch_typed<TX, float>(xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
      return 0;
    case DT_BF16:
      launch_typed<TX, __nv_bfloat16>(xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
      return 0;
    case DT_I8:
      launch_typed<TX, int8_t>(xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
      return 0;
    case DT_F8:
      launch_typed<TX, __nv_fp8_e4m3>(xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

// xe (E,C,d) fp32|bf16; w_g/w_u (E,d,m), w_d (E,m,d) fp32|bf16|int8|fp8;
// s_g/s_u (E,1,m), s_d (E,1,d) fp32 (quantized weights only); h (E,C,m)
// fp32 scratch; out (E,C,d) fp32.  Returns a cudaError_t (0 on success),
// or cudaErrorInvalidValue for a dtype, activation or size it does not take.
extern "C" int streamed_moe_forward(const void* xe, const void* wg, const void* wu,
                                    const void* wd, const float* sg, const float* su,
                                    const float* sd, float* h, float* out, int E,
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
