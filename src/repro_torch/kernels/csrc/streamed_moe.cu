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
// The tiles are chosen at launch: each path has a table of settings
// (WG_SETTINGS, Q_SETTINGS, T_SETTINGS below; the counterpart of the Pallas
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
// int8 / fp8-e4m3 weights (bf16 or fp32 activations) run on wgmma too, with
// the reference's fp32 accuracy: every 8-bit value is exact in bf16, a
// product of two bf16 values is exact in fp32, and the per-(expert, column)
// scale multiplies the fp32 sum in the epilogue (before the activation in
// phase 1, before the store in phase 2).  wgmma takes its B operand only
// from shared memory, in bf16, so the products are transposed: the weights
// are the A operand, from registers, and the activations (x, or h's planes)
// the B operand, TMA tiles of C-tile rows.  The raw 8-bit weight tiles come
// through the same kind of TMA ring (half the bytes of bf16), and each
// thread widens its own A fragment from them (a 2-byte load from each of
// four rows, paired by prmt, then exactly: a magic-number add for int8, cvt
// for e4m3), so no shared-memory pass widens them (on the earlier
// warp-level tensor-core body, one that did ran at 0.104 ms against 0.054
// without).  A consumer warpgroup
// owns 64 weight columns; N, the C tile, is C rounded up to 16 (16 at the
// Yuan2 / Phi-3.5 / Jamba decode steps, 48 at DeepSeek's, 64 at granite's),
// so decode multiplies no padding rows.  h is fp32 in the reference and
// stays exact: phase 1 writes it as three bf16 planes, h = hi + mid + lo
// (24 significant bits), and phase 2 runs three wgmmas a k16 step against
// one widened fragment; fp32 x is split into planes the same way by a
// small kernel first.  The tensor cores' sums truncate, so each 64 k-rows'
// products go into a partial that is then added, rounded to nearest, into
// the thread's fp32 sum; a long K (Jamba's m = 14336) stays within 1e-6 of
// the plain version.  Bound: the weight bytes at decode (0.019 ms at
// granite's (32, 64, 1024, 512), 0.84 ms at Jamba's); the kernel runs at
// 1.3-1.9x it at the Table I and Jamba decode shapes and 2.3x at granite's,
// where the consumers (widening, a wgmma and a wait each k16 step, three h
// planes in phase 2) take most of the time and the weight stream and the
// epilogues the rest (PERF.md).  Phase 2 is a programmatic dependent
// launch: its blocks stream their first weight stages while phase 1
// finishes, and wait for it before they read h.  Rows of d and m bytes
// must be multiples of 16 (TMA's row strides).  Rounding h or x to fewer
// bits would be a different function, so neither is done.
//
// fp32 weights (fp32 or bf16 activations) run on wgmma + TMA too, in split
// TF32 (the section "fp32 operands" below): each fp32 operand is two TF32
// parts and a product three TF32 terms (hi hi + hi lo + lo hi), so the
// reference's 2e-5 (1e-5 against the plain version) holds where one TF32
// product would miss it ~50x.  The products are transposed as on the 8-bit
// path: the weights the A operand, read from the TMA-landed tile into
// registers and split there; x and h the B tiles, already split into
// planes (x by a small kernel before phase 1, h by phase 1's epilogue); N
// the C tile; each 64 k-rows' partial added into an fp32 sum.  Bound at
// granite's (32, 64, 1024, 512) with fp32 weights: 218 MB of bytes, 0.065
// ms, against the split terms' 19.3 GFLOP, 0.039 ms at the 495 TFLOP/s
// TF32 rate (no CUDA-core body goes below the fp32 FMAs' 0.096 ms); at the
// scoring forward's C = 1280, 0.781 ms of split-TF32 operations.
//
// bf16 weights with fp32 activations round h to bf16 before the down
// product.  Their phase 1 runs on CUDA cores, as fp32 FMAs in ascending k,
// the order of the card's fp32 GEMM that the plain version runs, so h and
// its bf16 rounding are the plain version's bit for bit: an h from the
// tensor cores differs from it by ~1e-6 and flips 1e-4 to 1e-3 of the
// roundings, each moving the output by ~2^-8 |h w|, up to 6.3e-4 of its
// max on the card, where the path is held at 1e-5.  Their phase 2 is the
// split-TF32 one with one term (bf16 h and bf16 w_d are exact in TF32).
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

namespace {

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

using hop::launch_dependent;

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

// A ring's barriers, `bars` bytes into shared memory: full[s] (one arrival,
// the producer's expect_tx) completes when stage s's bytes have landed,
// empty[s] = full[stages + s] when each of the nwg consumer warpgroups' four
// warps is done with it.
__device__ __forceinline__ uint64_t* ring_barriers(unsigned char* smem, int bars, int stages,
                                                   int nwg) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&full[stages + s], 4 * nwg);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  return full;
}
template <class Cfg, int NMAT>
__device__ __forceinline__ uint64_t* wg_barriers(unsigned char* smem) {
  return ring_barriers(smem, WgShape<Cfg, NMAT>::BARS, Cfg::STAGES, Cfg::NWG);
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

// ------------------------------ int8 / fp8 weights: wgmma + TMA, A from registers
//
// Every int8 value (|q| <= 127) and every e4m3 value is exact in bf16, and a
// bf16 times a bf16 is exact in fp32, so x q runs on the bf16 wgmma with the
// fp32 accuracy of the reference; the per-(expert, column) scale multiplies
// the fp32 sum in the epilogue.  An fp32 operand (h in the down phase, x
// when the activations are fp32) comes as three bf16 planes, a = hi + mid +
// lo exactly, and each plane meets the same widened weight fragment.
//
// The products are transposed, so that the weights are wgmma's A operand
// (from registers) and the activations its B operand (from shared memory):
// phase 1 computes h^T[e] = w_u^T x^T (M = weight columns, N = the C tile, K
// = d), phase 2 out^T[e] = w_d^T h^T (K = m).  A thread's A fragment of a
// k16 step covers two weight columns at k-rows 2t, 2t+1, 2t+8, 2t+9 (t =
// lane % 4): which accumulator row stands for which column is free, as the
// epilogue reads the scale of, and writes, the column the row stands for, so
// row 16w + g + 8 half of the warpgroup's m64 product (w its warp, g = lane
// / 4) is column 2 (8 w + g) + half of its 64.  The fragment is then four
// 2-byte loads from the raw 8-bit tile that TMA landed, paired and widened
// in registers; the tile's 64 NWG-byte rows are held as boxes of 64 or 128
// bytes, swizzled over their width, so a warp's loads fall in distinct
// banks.  wgmma reads the
// fragment asynchronously, so two are kept: one is built while the other's
// products run.

// Columns a consumer warpgroup owns (one m64 product a weight matrix).
constexpr int Q_WG_COLS = 64;
// k16 steps a tensor-core partial sum runs before it is added into the
// thread's fp32 sum (round to nearest).  The tensor cores' own sums
// truncate, so a long K summed there alone drifts by up to K/16 ulps of the
// sum; in chunks of 64 k-rows the drift stays at a few ulps of a chunk.  A
// fixed chunk, not a stage, so every setting gives the same bits.
constexpr int Q_PROMOTE = 4;

// The settings of the 8-bit path, one per row: for phase 1 (up) and then
// phase 2 (down), the consumer warpgroups of a block (64 weight columns
// each, so 64 NWG columns a block), the k-rows a stage and the ring depth.
// Row i is setting i of streamed_moe_forward's `tiles`; TILE_SETTINGS["8bit"]
// in the wrapper holds the same rows in the same order.  Row 0 is the
// default: the fastest of the settings timed at (E, C, d, m) = (32, 64,
// 1024, 512) (row 5 ties it), and within 3% of the fastest at the Table I
// and Jamba decode shapes (PERF.md).  Two 128-column warpgroups up and four
// down share each activation tile, so the blocks re-read x and h from L2
// the fewest times.  The C tile (wgmma's N) is not a setting: it is C
// rounded up to 16, at most 64 (32 for fp32 x), so decode computes no
// padding rows.  Every setting sums each output's k16 steps in ascending k
// into Q_PROMOTE-step chunks, so all give the same bits.
#define Q_SETTINGS(X)       \
  X(2, 128, 3, 4, 128, 2)   \
  X(2, 128, 3, 2, 128, 2)   \
  X(1, 64, 6, 2, 64, 3)     \
  X(2, 128, 4, 4, 128, 2)   \
  X(2, 64, 6, 4, 64, 4)     \
  X(1, 128, 3, 4, 64, 3)

template <int UWG, int UBK, int UST, int DWG, int DBK, int DST>
struct QCfg {
  static constexpr int UP_WG = UWG, UP_BK = UBK, UP_STAGES = UST;
  static constexpr int DN_WG = DWG, DN_BK = DBK, DN_STAGES = DST;
};

// A stage holds PARTS bf16 activation tiles (N rows of BK, as BK / 64 boxes
// of N x 64, 128-byte swizzled) and NMAT raw 8-bit weight tiles (BK rows of
// BN bytes, as BN / SUB boxes of BK rows x SUB bytes, swizzled over SUB =
// 64 or 128 bytes), each 1024-byte aligned; the stages' full and empty
// barriers follow the ring.
template <int NWG_, int BK_, int STAGES_, int N_, int PARTS_, int NMAT_>
struct QShape {
  static constexpr int NWG = NWG_, BK = BK_, STAGES = STAGES_, N = N_, PARTS = PARTS_,
                       NMAT = NMAT_;
  static constexpr int BN = Q_WG_COLS * NWG;
  static constexpr int SUB = BN < 128 ? BN : 128;
  static constexpr int NT = 128 * NWG;
  static constexpr int B_BYTES = PARTS * (BK / 64) * N * 128;
  static constexpr int W_BYTES = BK * BN;
  static constexpr int STAGE = B_BYTES + NMAT * W_BYTES;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;   // + alignment
  static_assert((NWG == 1 || NWG == 2 || NWG == 4) && (BK == 64 || BK == 128) && STAGES >= 2 &&
                    N % 16 == 0 && N <= 64 && (BK / 16) % Q_PROMOTE == 0,
                "bad 8-bit tile setting");
  static_assert(SMEM <= 232448, "an 8-bit setting over the card's shared memory");
};

// v = hi + mid + lo with each part exact in bf16: hi rounds v to 8 bits, the
// rest (exact in fp32) spans at most 16 bits and its rounding at most 8.
__device__ __forceinline__ void split3(float v, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// Round two floats to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes J0 and J1 of w -> the bf16 pair {w[J0], w[J1]} (w[J0] in the low
// half), exact.  int8 without I2F (a quarter-rate instruction): the byte
// with its top bit flipped (pre-flipped in w), q + 128, goes into the
// mantissa of 2^23, and subtracting 2^23 + 128 leaves q exactly; q has at
// most 8 significant bits, so the upper half of each float is its bf16.
// e4m3 through cvt to f16 (exact), then fp32 and bf16.
template <typename TW, int J0, int J1>
__device__ __forceinline__ uint32_t widen_pair(uint32_t w) {
  if constexpr (std::is_same<TW, int8_t>::value) {
    const float a = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | J0)) - 8388736.0f;
    const float b = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | J1)) - 8388736.0f;
    return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
  } else {
    const __half2_raw h2 = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(__byte_perm(w, 0, J0 | J1 << 4) & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h2));
    return pack_bf16(f.x, f.y);
  }
}

// Two weight rows' 2-byte column pairs -> one word, bytes {c0 r0, c1 r0, c0
// r1, c1 r1}; for int8 with the top bits flipped (widen_pair's offset).
template <typename TW>
__device__ __forceinline__ uint32_t pair_rows(uint32_t r0, uint32_t r1) {
  const uint32_t w = __byte_perm(r0, r1, 0x5410);
  return std::is_same<TW, int8_t>::value ? w ^ 0x80808080u : w;
}

// The byte at (row r, byte c) of a weight tile of BN-byte rows, as TMA
// swizzles it (the 16-byte chunk index XORed with address bits 7 up).
template <int BN>
__device__ __forceinline__ int q_swz(int r, int c) {
  const int a = r * BN + c;
  return a ^ (((a >> 7) & (BN / 16 - 1)) << 4);
}

// k-step kt into stage s: each plane's activation tile at (k0, rows n0) of
// plane p's expert slot p E + e (q_load_a), and each weight's BK x BN tile
// at (columns c0, k0) of expert e (q_load_w); the stage's full barrier
// expects both.  Rows, columns and k past the tensors arrive as zeros.
template <class S>
__device__ __forceinline__ void q_load_a(unsigned char* smem, uint64_t* full, int kt, int s,
                                         const CUtensorMap* amap, int n0, int e, int E) {
  unsigned char* st = smem + s * S::STAGE;
  for (int p = 0; p < S::PARTS; ++p)
    for (int kb = 0; kb < S::BK / 64; ++kb)
      hop::tma_load_3d(st + (p * (S::BK / 64) + kb) * S::N * 128, amap, &full[s],
                       kt * S::BK + 64 * kb, n0, p * E + e);
}
template <class S>
__device__ __forceinline__ void q_load_w(unsigned char* smem, uint64_t* full, int kt, int s,
                                         const CUtensorMap* const (&wmap)[S::NMAT], int c0,
                                         int e) {
  unsigned char* st = smem + s * S::STAGE + S::B_BYTES;
  for (int mat = 0; mat < S::NMAT; ++mat)
    for (int sb = 0; sb < S::BN / S::SUB; ++sb)
      hop::tma_load_3d(st + mat * S::W_BYTES + sb * S::BK * S::SUB, wmap[mat], &full[s],
                       c0 + sb * S::SUB, kt * S::BK, e);
}

// The block's mainloop: acc[mat] = the fp32 sums of its warpgroup's 64
// weight columns of matrix mat (A rows) against the N activation rows (B
// rows), unscaled, over K in ascending k: each k16 step one wgmma.m64nNk16
// a matrix and plane into the partial sum `part`, which every Q_PROMOTE
// steps is added into acc.  Thread 0 also keeps the ring filled: it loads
// the first STAGES steps, then refills a stage once every consumer warp has
// released it (after the next stage's first step, when its products are
// done).  The D register d[4j + 2 half + q] of matrix mat holds
// weight column 2 (8 w + g) + half of the warpgroup's 64, activation row 8 j
// + 2 t + q.
template <class S, typename TW, bool DEPENDENT>
__device__ __forceinline__ void q_mainloop(float (&acc)[S::NMAT][S::N / 2], unsigned char* smem,
                                           uint64_t* full, int K, const CUtensorMap* amap,
                                           const CUtensorMap* const (&wmap)[S::NMAT], int n0,
                                           int c0, int e, int E) {
  uint64_t* empty = full + S::STAGES;
  const int nk = (K + S::BK - 1) / S::BK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (threadIdx.x == 0) {
    // the first stages' weights first: under a dependent launch they stream
    // while the grid this one waits on finishes
    for (int kt = 0; kt < S::STAGES && kt < nk; ++kt) {
      hop::mbar_expect_tx(&full[kt], S::STAGE);
      q_load_w<S>(smem, full, kt, kt, wmap, c0, e);
    }
    if constexpr (DEPENDENT) hop::grid_dependency_wait();
    for (int kt = 0; kt < S::STAGES && kt < nk; ++kt)
      q_load_a<S>(smem, full, kt, kt, amap, n0, e, E);
  }
  // this thread's bytes of a weight tile: rows 2t (+1, +8, +9) of a k16
  // step, 2 bytes at column byte 64 wg + 2 (8 w + g), in box cb / SUB
  const int cb = Q_WG_COLS * wg + 2 * (8 * warp + g);
  const int box = (cb / S::SUB) * S::BK * S::SUB, cs = cb % S::SUB;
  float part[S::NMAT][S::N / 2];
  uint32_t a[2][S::NMAT][4];
#pragma unroll
  for (int mat = 0; mat < S::NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < S::N / 2; ++i) acc[mat][i] = part[mat][i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S::STAGES;
    hop::mbar_wait(&full[s], (kt / S::STAGES) & 1);
    unsigned char* st = smem + s * S::STAGE;
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
      uint32_t(&f)[S::NMAT][4] = a[kk % 2];
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) {
        const unsigned char* w = st + S::B_BYTES + mat * S::W_BYTES + box;
        const int r = 16 * kk + 2 * t;
        const uint32_t r0 = *reinterpret_cast<const unsigned short*>(w + q_swz<S::SUB>(r, cs));
        const uint32_t r1 = *reinterpret_cast<const unsigned short*>(w + q_swz<S::SUB>(r + 1, cs));
        const uint32_t r8 = *reinterpret_cast<const unsigned short*>(w + q_swz<S::SUB>(r + 8, cs));
        const uint32_t r9 = *reinterpret_cast<const unsigned short*>(w + q_swz<S::SUB>(r + 9, cs));
        const uint32_t lo = pair_rows<TW>(r0, r1), hi = pair_rows<TW>(r8, r9);
        f[mat][0] = widen_pair<TW, 0, 2>(lo);   // column half 0, k-rows 2t, 2t+1
        f[mat][1] = widen_pair<TW, 1, 3>(lo);   // column half 1
        f[mat][2] = widen_pair<TW, 0, 2>(hi);   // k-rows 2t+8, 2t+9
        f[mat][3] = widen_pair<TW, 1, 3>(hi);
      }
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) {
        hop::fence_regs(f[mat]);
        hop::fence_regs(part[mat]);
      }
      hop::wg_fence();
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat)
#pragma unroll
        for (int p = 0; p < S::PARTS; ++p)
          hop::wgmma_rs<S::N, 0>(
              part[mat], f[mat],
              hop::desc_sw128(st + (p * (S::BK / 64) + kk / 4) * S::N * 128 + (kk % 4) * 32, 16,
                              1024),
              kk % Q_PROMOTE == 0 && p == 0 ? 0 : 1);
      hop::wg_commit();
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) hop::fence_regs(part[mat]);
      if (kk % Q_PROMOTE == Q_PROMOTE - 1) {
        hop::wg_wait<0>();
#pragma unroll
        for (int mat = 0; mat < S::NMAT; ++mat) {
          hop::fence_regs(part[mat]);
#pragma unroll
          for (int i = 0; i < S::N / 2; ++i) acc[mat][i] += part[mat][i];
        }
      } else {
        hop::wg_wait<1>();   // the other fragment's products are done
      }
      if (kk == 0 && kt > 0) {
        // the previous stage's products are done: release it, and thread 0
        // refills it once every warp has
        const int ps = (kt - 1) % S::STAGES;
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[ps]);
        if (threadIdx.x == 0 && kt - 1 + S::STAGES < nk) {
          hop::mbar_wait(&empty[ps], ((kt - 1) / S::STAGES) & 1);
          hop::mbar_expect_tx(&full[ps], S::STAGE);
          q_load_a<S>(smem, full, kt - 1 + S::STAGES, ps, amap, n0, e, E);
          q_load_w<S>(smem, full, kt - 1 + S::STAGES, ps, wmap, c0, e);
        }
      }
    }
  }
}

// Phase 1: h = act(s_g (x q_g), s_u (x q_u)) in fp32, written as three bf16
// planes (3, E, C, m).  x is bf16 (PARTS = 1) or its three planes (3, E, C,
// d).  ACT is swiglu, or -1 for relu2 / gelu by `act` (one kernel for both).
template <class S, typename TW, int ACT>
__global__ void __launch_bounds__(S::NT)
up_kernel_q(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap umap,
            const __grid_constant__ CUtensorMap gmap, const float* __restrict__ sg,
            const float* __restrict__ su, bf16* __restrict__ h, int E, int C, int d, int m,
            int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = ring_barriers(smem, S::BARS, S::STAGES, S::NWG);
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, n0 = blockIdx.y * S::N;
  const CUtensorMap* w[S::NMAT];
  w[0] = &umap;
  if constexpr (S::NMAT == 2) w[1] = &gmap;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c = c0 + Q_WG_COLS * wg + 2 * (8 * warp + lane / 4);
  // this thread's columns' scales, loaded before the mainloop
  float2 s_u = make_float2(0.0f, 0.0f), s_g = s_u;
  if (c < m) {
    s_u = *reinterpret_cast<const float2*>(su + (size_t)e * m + c);
    if constexpr (S::NMAT == 2) s_g = *reinterpret_cast<const float2*>(sg + (size_t)e * m + c);
  }
  float acc[S::NMAT][S::N / 2];
  // phase 2 may launch (and stream its first weights) once every block of
  // this grid has started
  hop::launch_dependents();
  q_mainloop<S, TW, false>(acc, smem, full, d, &xmap, w, n0, c0, e, E);
  if (c >= m) return;
  // every activation first, then the stores (an activation's expf and
  // division chains overlap one another so)
  float v[S::N / 8][2][2];
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float u = acc[0][4 * j + 2 * half + q] * (half ? s_u.y : s_u.x);
        if constexpr (ACT == ACT_SWIGLU)
          v[j][q][half] =
              activate<ACT_SWIGLU>(acc[1][4 * j + 2 * half + q] * (half ? s_g.y : s_g.x), u);
        else
          v[j][q][half] =
              act == ACT_RELU2 ? activate<ACT_RELU2>(0.0f, u) : activate<ACT_GELU>(0.0f, u);
      }
  const size_t plane = (size_t)E * C * m;
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * j + 2 * (lane % 4) + q;
      float p0[3], p1[3];
      split3(v[j][q][0], p0[0], p0[1], p0[2]);
      split3(v[j][q][1], p1[0], p1[1], p1[2]);
      bf16* hr = h + ((size_t)e * C + n) * m + c;
      if (n < C)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          *reinterpret_cast<uint32_t*>(hr + part * plane) = pack_bf16(p0[part], p1[part]);
    }
}

// Phase 2: out = s_d (h q_d), h as its three bf16 planes.
template <class S, typename TW>
__global__ void __launch_bounds__(S::NT)
down_kernel_q(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap dmap,
              const float* __restrict__ sd, float* __restrict__ out, int E, int C, int d, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = ring_barriers(smem, S::BARS, S::STAGES, S::NWG);
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, n0 = blockIdx.y * S::N;
  const CUtensorMap* w[1] = {&dmap};
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c = c0 + Q_WG_COLS * wg + 2 * (8 * warp + lane / 4);
  const float2 s = c < d ? *reinterpret_cast<const float2*>(sd + (size_t)e * d + c)
                         : make_float2(0.0f, 0.0f);
  float acc[1][S::N / 2];
  q_mainloop<S, TW, true>(acc, smem, full, m, &hmap, w, n0, c0, e, E);
  if (c >= d) return;
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * j + 2 * (lane % 4) + q;
      if (n < C)
        *reinterpret_cast<float2*>(out + ((size_t)e * C + n) * d + c) =
            make_float2(acc[0][4 * j + q] * s.x, acc[0][4 * j + 2 + q] * s.y);
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
        make_uint2(pack_bf16(p[part][0], p[part][1]), pack_bf16(p[part][2], p[part][3]));
}

// The tensor map of an 8-bit (E, K, N) weight tensor, read in boxes of BK
// rows x BN bytes of one expert, swizzled over BN bytes (64 or 128).
int q_weight_map(CUtensorMap* map, const void* base, int E, int K, int N, int bk, int sub) {
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)N, (uint64_t)K * N};
  const uint32_t box[3] = {(uint32_t)sub, (uint32_t)bk, 1};
  return hop::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 3, dims, strides, box,
                         sub == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The C tile a launch takes: C rounded up to 16, at most 64; fp32 x (three
// planes a stage) at 32.
constexpr int q_tile(int C, int parts) {
  return parts == 3 ? 32 : C <= 16 ? 16 : C <= 32 ? 32 : C <= 48 ? 48 : 64;
}

// Phase 1's kernel and shape of a setting, C tile, x planes and activation
// (ACT_SWIGLU, or -1 for relu2 and gelu); then phase 2's.
template <class Cfg, int N, int PARTS, int ACT>
using QUp = QShape<Cfg::UP_WG, Cfg::UP_BK, Cfg::UP_STAGES, N, PARTS, ACT == ACT_SWIGLU ? 2 : 1>;
template <class Cfg, int N>
using QDown = QShape<Cfg::DN_WG, Cfg::DN_BK, Cfg::DN_STAGES, N, 3, 1>;

template <class Cfg, int N, int PARTS, typename TW>
int launch_q_tile(const bf16* x, const void* wg, const void* wu, const void* wd, const float* sg,
                  const float* su, const float* sd, bf16* h, float* out, int E, int C, int d,
                  int m, int act, cudaStream_t s) {
  using U = QUp<Cfg, N, PARTS, ACT_SWIGLU>;
  using D = QDown<Cfg, N>;
  // the maps are encoded at every call: the operands' addresses change
  CUtensorMap xm, um, gm, hm, dm;
  if (moe_map(&xm, x, PARTS * E, C, d, N) ||
      q_weight_map(&um, wu, E, d, m, Cfg::UP_BK, U::SUB) ||
      q_weight_map(&gm, act == ACT_SWIGLU ? wg : wu, E, d, m, Cfg::UP_BK, U::SUB) ||
      moe_map(&hm, h, 3 * E, C, m, N) || q_weight_map(&dm, wd, E, m, d, Cfg::DN_BK, D::SUB))
    return -1;
  const dim3 g_up((m + U::BN - 1) / U::BN, (C + N - 1) / N, E);
  const dim3 g_down((d + D::BN - 1) / D::BN, (C + N - 1) / N, E);
  if (act == ACT_SWIGLU)
    launch_dyn(up_kernel_q<U, TW, ACT_SWIGLU>, U::SMEM, g_up, U::NT, s, xm, um, gm, sg, su, h, E,
               C, d, m, act);
  else
    launch_dyn(up_kernel_q<QUp<Cfg, N, PARTS, -1>, TW, -1>, QUp<Cfg, N, PARTS, -1>::SMEM, g_up,
               U::NT, s, xm, um, gm, sg, su, h, E, C, d, m, act);
  launch_dependent(down_kernel_q<D, TW>, D::SMEM, g_down, D::NT, s, hm, dm, sd, out, E, C, d,
                   m);
  return 0;
}

template <class Cfg, int PARTS, typename TW>
int launch_q_typed(const bf16* x, const void* wg, const void* wu, const void* wd, const float* sg,
                   const float* su, const float* sd, bf16* h, float* out, int E, int C, int d,
                   int m, int act, cudaStream_t s) {
  if constexpr (PARTS == 3)
    return launch_q_tile<Cfg, q_tile(0, 3), 3, TW>(x, wg, wu, wd, sg, su, sd, h, out, E, C, d, m,
                                                   act, s);
  else switch (q_tile(C, 1)) {
    case 16:
      return launch_q_tile<Cfg, 16, 1, TW>(x, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
    case 32:
      return launch_q_tile<Cfg, 32, 1, TW>(x, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
    case 48:
      return launch_q_tile<Cfg, 48, 1, TW>(x, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
    default:
      return launch_q_tile<Cfg, 64, 1, TW>(x, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, s);
  }
}

// Attributes of a setting's kernels at a C tile: up swiglu, up relu2, up
// gelu (one kernel), down.
template <class Cfg, int N, int PARTS, typename TW>
void q_tile_attrs(int* out) {
  using U = QUp<Cfg, N, PARTS, ACT_SWIGLU>;
  using V = QUp<Cfg, N, PARTS, -1>;
  using D = QDown<Cfg, N>;
  kernel_attrs(up_kernel_q<U, TW, ACT_SWIGLU>, U::SMEM, U::NT, out);
  kernel_attrs(up_kernel_q<V, TW, -1>, V::SMEM, V::NT, out + ATTR_FIELDS);
  kernel_attrs(up_kernel_q<V, TW, -1>, V::SMEM, V::NT, out + 2 * ATTR_FIELDS);
  kernel_attrs(down_kernel_q<D, TW>, D::SMEM, D::NT, out + 3 * ATTR_FIELDS);
}

template <class Cfg, int PARTS, typename TW>
void q_typed_attrs(int C, int* out) {
  if constexpr (PARTS == 3) return q_tile_attrs<Cfg, q_tile(0, 3), 3, TW>(out);
  else switch (q_tile(C, 1)) {
    case 16: return q_tile_attrs<Cfg, 16, 1, TW>(out);
    case 32: return q_tile_attrs<Cfg, 32, 1, TW>(out);
    case 48: return q_tile_attrs<Cfg, 48, 1, TW>(out);
    default: return q_tile_attrs<Cfg, 64, 1, TW>(out);
  }
}

using QLaunch = int (*)(const bf16*, const void*, const void*, const void*, const float*,
                        const float*, const float*, bf16*, float*, int, int, int, int, int,
                        cudaStream_t);
using QAttrs = void (*)(int, int*);
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

// 8-bit weights: rows of d and m bytes in multiples of 16 (TMA's row
// strides), 16-byte aligned operands and a setting of the table, or
// cudaErrorInvalidValue.  The scratch holds h's three planes, then (fp32 x
// only) x's.
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
  return kQLaunch[tiles][X_F32][w_dtype == DT_F8](x, wg, wu, wd, sg, su, sd, hp, out, E, C, d, m,
                                                  act, s);
}

// ------------------------- fp32 operands: split TF32 on wgmma + TMA
//
// fp32 weights (with fp32 or bf16 activations), and the down product of
// bf16 weights with fp32 activations (phase 1 of those is the CUDA-core
// simt::up_kernel below).  The reference holds them to fp32 accuracy, so
// each product runs in split TF32 (hopper.cuh): an fp32 operand is two
// TF32 parts, hi + lo, and a product three wgmma.m64nNk8.tf32 terms; an
// operand exact in TF32 (bf16 x, bf16 w_d, h rounded to bf16 for bf16
// w_d) has one part, so its products take two terms, or one.
//
// The products are transposed as on the 8-bit path, for the same reason:
// TF32 wgmma has no transposed shared-memory operand (both must be K-major),
// and the weights are stored N-major, while x and h are rows of K.  So the
// weights are the A operand, from registers: a thread reads its fragment
// straight from the TMA-landed tile (an 8-byte load of two weight columns
// at k-rows t and t + 4 of a k8 step) and splits it in registers; the
// activations are the B operand, K-major tiles of C-tile rows.  Staging
// the weights transposed instead would pass the whole weight stream
// through a shared-memory pass.  x and h reach the tensor cores already
// split: fp32 x is its own hi plane (the tensor cores read its top 19 bits,
// x truncated to TF32) and a small kernel writes its lo plane, x - hi
// rounded to TF32 (bf16 x: one fp32 plane) before phase 1; phase 1 writes
// h as its planes (simt::up_kernel, for bf16 weights, one plane rounded to
// bf16).  So each value
// is split once, not once for every block of weight columns that reads it,
// and TMA lands the planes where wgmma reads them.  N is the C tile (C
// rounded up to 16, at most 64).  The tensor cores' sums truncate: summed
// there alone, a K = 4096 product drifts past 1e-5 of the output (the
// emulation of tests/test_torch_tf32_split.py), so each T_PROMOTE k8
// steps' terms go into a partial that is then added, rounded to nearest,
// into the thread's fp32 sum (within 1e-6 there).  Rows of d and m
// must be 16 bytes (TMA's row strides): multiples of 4 with fp32 weights,
// 8 with bf16 ones (w_d's rows).

// Columns a consumer warpgroup owns (one m64 product a weight matrix).
constexpr int T_WG_COLS = 64;
// k8 steps (64 k-rows) a tensor-core partial runs before it is added into
// the fp32 sum.  A fixed chunk (every setting's stage is one), so every
// setting gives the same bits.
constexpr int T_PROMOTE = 8;

// The settings of the split-TF32 path, one per row, as Q_SETTINGS: for
// phase 1 (up) and then phase 2 (down), the consumer warpgroups of a block
// (64 weight columns each), the k-rows a stage and the ring depth.  Row i
// is setting i of streamed_moe_forward's `tiles`; TILE_SETTINGS["tf32"] in
// the wrapper holds the same rows in the same order.  Row 0 is the
// default.  A stage is one promotion chunk, 64 k-rows: the chunk's first
// and last steps are then known when the kernel is compiled (a stage of
// 32 k-rows made them runtime conditions, the scale-d predicate a value
// computed inside the wgmma pipeline, and ptxas serialized the wgmmas:
// C7513).  Every setting sums each output's k8 steps in ascending k into
// T_PROMOTE-step chunks, so all give the same bits.  With bf16 weights the
// up columns go unused: their phase 1 is simt::up_kernel's one tile.
#define T_SETTINGS(X)     \
  X(2, 64, 2, 4, 64, 2)   \
  X(2, 64, 2, 2, 64, 3)

// A stage holds PARTS fp32 activation planes' tiles (N rows of BK, as BK /
// 32 boxes of N x 32, 128-byte swizzled) and NMAT weight tiles (BK rows of
// BN columns, as BN / 32 boxes of BK rows x 32 columns, swizzled over
// their 128 bytes (fp32) or 64 (bf16)), each box 1024-byte aligned; the
// stages' full and empty barriers follow the ring.
template <int NWG_, int BK_, int STAGES_, int N_, int PARTS_, int NMAT_, typename TW_>
struct TShape {
  static constexpr int NWG = NWG_, BK = BK_, STAGES = STAGES_, N = N_, PARTS = PARTS_,
                       NMAT = NMAT_;
  using TW = TW_;
  static constexpr bool WSPLIT = std::is_same<TW, float>::value;   // weights as hi + lo
  static constexpr int BN = T_WG_COLS * NWG;
  static constexpr int NT = 128 * NWG;
  static constexpr int WROW = 32 * static_cast<int>(sizeof(TW));   // bytes of a box row
  static constexpr int WBOX = BK * WROW;
  static constexpr int B_BYTES = PARTS * (BK / 32) * N * 128;
  static constexpr int W_BYTES = (BN / 32) * WBOX;
  static constexpr int STAGE = B_BYTES + NMAT * W_BYTES;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;   // + alignment
  static_assert((NWG == 1 || NWG == 2 || NWG == 4) && BK == 8 * T_PROMOTE && STAGES >= 2 &&
                    N % 16 == 0 && N <= 64 && (PARTS == 1 || PARTS == 2) &&
                    (WSPLIT || std::is_same<TW, bf16>::value),
                "bad split-TF32 tile setting");
  static_assert(SMEM <= 232448, "a split-TF32 setting over the card's shared memory");
};

// k-step kt into stage s: each activation plane's tile at (k0, rows n0) of
// expert e through that plane's map, and each weight's BK x BN tile at
// (columns c0, k0) of expert e.  Rows, columns and k past the tensors
// arrive as zeros.
template <class S>
__device__ __forceinline__ void t_load_a(unsigned char* smem, uint64_t* full, int kt, int s,
                                         const CUtensorMap* const (&amap)[2], int n0, int e) {
  unsigned char* st = smem + s * S::STAGE;
  for (int p = 0; p < S::PARTS; ++p)
    for (int kb = 0; kb < S::BK / 32; ++kb)
      hop::tma_load_3d(st + (p * (S::BK / 32) + kb) * S::N * 128, amap[p], &full[s],
                       kt * S::BK + 32 * kb, n0, e);
}
template <class S>
__device__ __forceinline__ void t_load_w(unsigned char* smem, uint64_t* full, int kt, int s,
                                         const CUtensorMap* const (&wmap)[S::NMAT], int c0,
                                         int e) {
  unsigned char* st = smem + s * S::STAGE + S::B_BYTES;
  for (int mat = 0; mat < S::NMAT; ++mat)
    for (int sb = 0; sb < S::BN / 32; ++sb)
      hop::tma_load_3d(st + mat * S::W_BYTES + sb * S::WBOX, wmap[mat], &full[s], c0 + 32 * sb,
                       kt * S::BK, e);
}

// The weight columns (col, col + 1) of its warpgroup's 64 that rows g and
// g + 8 of warp w's m64 product stand for (the epilogue writes the columns
// the rows stand for, so the choice is free): a warp owns 16 columns of one
// 32-column box, in the 16-byte chunks whose swizzled positions keep a
// half-warp's 8-byte loads of k-rows t (or t + 4), t < 4, on 32 distinct
// banks.
__device__ __forceinline__ int t_col(int warp, int g) {
  const int chunk = 4 * ((g >> 1) & 1) + (g >> 2) + 2 * (warp & 1);
  return 32 * (warp >> 1) + 4 * chunk + 2 * (g & 1);
}

// Two weights, columns c and c + 1 at k-row r of a swizzled box, as fp32.
template <typename TW>
__device__ __forceinline__ float2 t_pair(const unsigned char* box, int r, int c) {
  if constexpr (std::is_same<TW, float>::value) {
    return *reinterpret_cast<const float2*>(box + q_swz<128>(r, 4 * c));
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(box + q_swz<64>(r, 2 * c));
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
}

// The block's mainloop: acc[mat] = the fp32 sums of its warpgroup's 64
// weight columns of matrix mat (A rows) against the N activation rows (B
// rows) over K in ascending k: each k8 step the split-TF32 terms of every
// matrix (one commit group) into the partial `part`, which every
// T_PROMOTE steps (each stage's last) is added into acc.  Thread 0 keeps
// the ring filled as q_mainloop's does.  The D register d[4j + 2 half + q]
// of matrix mat holds weight column t_col(w, g) + half of the warpgroup's
// 64, activation row 8 j + 2 t + q.
template <class S, bool DEPENDENT>
__device__ __forceinline__ void t_mainloop(float (&acc)[S::NMAT][S::N / 2], unsigned char* smem,
                                           uint64_t* full, int K,
                                           const CUtensorMap* const (&amap)[2],
                                           const CUtensorMap* const (&wmap)[S::NMAT], int n0,
                                           int c0, int e) {
  uint64_t* empty = full + S::STAGES;
  const int nk = (K + S::BK - 1) / S::BK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (threadIdx.x == 0) {
    // the first stages' weights first: under a dependent launch they stream
    // while the grid this one waits on finishes
    for (int kt = 0; kt < S::STAGES && kt < nk; ++kt) {
      hop::mbar_expect_tx(&full[kt], S::STAGE);
      t_load_w<S>(smem, full, kt, kt, wmap, c0, e);
    }
    if constexpr (DEPENDENT) hop::grid_dependency_wait();
    for (int kt = 0; kt < S::STAGES && kt < nk; ++kt)
      t_load_a<S>(smem, full, kt, kt, amap, n0, e);
  }
  // this thread's weight columns: their box (two a warpgroup) and column in it
  const int cl = t_col(warp, g);
  const int box = (2 * wg + cl / 32) * S::WBOX, cc = cl % 32;
  float part[S::NMAT][S::N / 2];
  uint32_t fh[2][S::NMAT][4], fl[2][S::NMAT][4];
#pragma unroll
  for (int mat = 0; mat < S::NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < S::N / 2; ++i) acc[mat][i] = part[mat][i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S::STAGES;
    hop::mbar_wait(&full[s], (kt / S::STAGES) & 1);
    unsigned char* st = smem + s * S::STAGE;
#pragma unroll
    for (int kk = 0; kk < S::BK / 8; ++kk) {
      uint32_t(&h)[S::NMAT][4] = fh[kk % 2];
      uint32_t(&l)[S::NMAT][4] = fl[kk % 2];
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) {
        // A[col][k] = w[k][col]: a[0] = (col, t), a[1] = (col + 1, t), a[2]
        // = (col, t + 4), a[3] = (col + 1, t + 4)
        const unsigned char* w = st + S::B_BYTES + mat * S::W_BYTES + box;
        const float2 v0 = t_pair<typename S::TW>(w, 8 * kk + t, cc);
        const float2 v1 = t_pair<typename S::TW>(w, 8 * kk + t + 4, cc);
        const float v[4] = {v0.x, v0.y, v1.x, v1.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (S::WSPLIT) hop::split(v[i], h[mat][i], l[mat][i]);
          else h[mat][i] = __float_as_uint(v[i]);   // a bf16 value: exact in TF32
        }
        hop::fence_regs(h[mat]);
        if constexpr (S::WSPLIT) hop::fence_regs(l[mat]);
        hop::fence_regs(part[mat]);
      }
      hop::wg_fence();
      const int fresh = kk == 0 ? 0 : 1;   // the chunk's (the stage's) first step sets it
      const unsigned char* b = st + (kk / 4) * S::N * 128 + (kk % 4) * 32;
      const uint64_t b0 = hop::desc_sw128(b, 16, 1024);
      const uint64_t b1 = hop::desc_sw128(b + (S::BK / 32) * S::N * 128, 16, 1024);
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) {
        hop::wgmma_rs_tf32<S::N>(part[mat], h[mat], b0, fresh);
        if constexpr (S::PARTS == 2) hop::wgmma_rs_tf32<S::N>(part[mat], h[mat], b1, 1);
        if constexpr (S::WSPLIT) hop::wgmma_rs_tf32<S::N>(part[mat], l[mat], b0, 1);
      }
      hop::wg_commit();
#pragma unroll
      for (int mat = 0; mat < S::NMAT; ++mat) hop::fence_regs(part[mat]);
      if (kk == S::BK / 8 - 1) {   // the chunk's last step (k past K adds zeros)
        hop::wg_wait<0>();
#pragma unroll
        for (int mat = 0; mat < S::NMAT; ++mat) {
          hop::fence_regs(part[mat]);
#pragma unroll
          for (int i = 0; i < S::N / 2; ++i) acc[mat][i] += part[mat][i];
        }
      } else {
        hop::wg_wait<1>();   // the other fragment's products are done
      }
      if (kk == 0 && kt > 0) {
        // the previous stage's products are done: release it, and thread 0
        // refills it once every warp has
        const int ps = (kt - 1) % S::STAGES;
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[ps]);
        if (threadIdx.x == 0 && kt - 1 + S::STAGES < nk) {
          hop::mbar_wait(&empty[ps], ((kt - 1) / S::STAGES) & 1);
          hop::mbar_expect_tx(&full[ps], S::STAGE);
          t_load_a<S>(smem, full, kt - 1 + S::STAGES, ps, amap, n0, e);
          t_load_w<S>(smem, full, kt - 1 + S::STAGES, ps, wmap, c0, e);
        }
      }
    }
  }
}

// Phase 1 of fp32 weights: h = act(x w_g, x w_u) in fp32, written as its
// hi and lo TF32 planes (2, E, C, m).  x is its planes (PARTS, E, C, d).
// ACT is swiglu, or -1 for relu2 / gelu by `act` (one kernel for both).
template <class S, int ACT>
__global__ void __launch_bounds__(S::NT)
up_kernel_t(const __grid_constant__ CUtensorMap xmap0, const __grid_constant__ CUtensorMap xmap1,
            const __grid_constant__ CUtensorMap umap, const __grid_constant__ CUtensorMap gmap,
            float* __restrict__ h, int E, int C, int d, int m, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = ring_barriers(smem, S::BARS, S::STAGES, S::NWG);
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, n0 = blockIdx.y * S::N;
  const CUtensorMap* w[S::NMAT];
  w[0] = &umap;
  if constexpr (S::NMAT == 2) w[1] = &gmap;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c = c0 + T_WG_COLS * wg + t_col(warp, lane / 4);
  float acc[S::NMAT][S::N / 2];
  // phase 2 may launch (and stream its first weights) once every block of
  // this grid has started
  hop::launch_dependents();
  const CUtensorMap* x[2] = {&xmap0, &xmap1};
  t_mainloop<S, true>(acc, smem, full, d, x, w, n0, c0, e);
  if (c >= m) return;
  // every activation first, then the stores (an activation's expf and
  // division chains overlap one another so)
  float v[S::N / 8][2][2];
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float u = acc[0][4 * j + 2 * half + q];
        if constexpr (ACT == ACT_SWIGLU)
          v[j][q][half] = activate<ACT_SWIGLU>(acc[1][4 * j + 2 * half + q], u);
        else
          v[j][q][half] =
              act == ACT_RELU2 ? activate<ACT_RELU2>(0.0f, u) : activate<ACT_GELU>(0.0f, u);
      }
  const size_t plane = (size_t)E * C * m;
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * j + 2 * (lane % 4) + q;
      if (n >= C) continue;
      float* hr = h + ((size_t)e * C + n) * m + c;
      uint32_t hi0, lo0, hi1, lo1;
      hop::split(v[j][q][0], hi0, lo0);
      hop::split(v[j][q][1], hi1, lo1);
      *reinterpret_cast<float2*>(hr) = make_float2(__uint_as_float(hi0), __uint_as_float(hi1));
      *reinterpret_cast<float2*>(hr + plane) =
          make_float2(__uint_as_float(lo0), __uint_as_float(lo1));
    }
}

// Phase 2: out = h w_d, h as its planes.
template <class S>
__global__ void __launch_bounds__(S::NT)
down_kernel_t(const __grid_constant__ CUtensorMap hmap0, const __grid_constant__ CUtensorMap hmap1,
              const __grid_constant__ CUtensorMap dmap, float* __restrict__ out, int E, int C,
              int d, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = ring_barriers(smem, S::BARS, S::STAGES, S::NWG);
  const int e = blockIdx.z, c0 = blockIdx.x * S::BN, n0 = blockIdx.y * S::N;
  const CUtensorMap* w[1] = {&dmap};
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c = c0 + T_WG_COLS * wg + t_col(warp, lane / 4);
  float acc[1][S::N / 2];
  const CUtensorMap* hp[2] = {&hmap0, &hmap1};
  t_mainloop<S, true>(acc, smem, full, m, hp, w, n0, c0, e);
  if (c >= d) return;
#pragma unroll
  for (int j = 0; j < S::N / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * j + 2 * (lane % 4) + q;
      if (n < C)
        *reinterpret_cast<float2*>(out + ((size_t)e * C + n) * d + c) =
            make_float2(acc[0][4 * j + q], acc[0][4 * j + 2 + q]);
    }
}

// Phase 1 of bf16 weights with fp32 x, on CUDA cores: each thread sums
// 4 x 4 outputs as fp32 FMAs in ascending k (see the header), h rounded
// to bf16 into one fp32 plane (E, C, m) for down_kernel_t.  A block takes
// a 64 x 64 tile of h; each step's global loads for the next BK k-rows are
// issued into registers before the current ones are multiplied (two
// shared-memory buffers, one barrier a step).
namespace simt {

constexpr int BM = 64;    // rows (capacity slots) a block
constexpr int BN = 64;    // h columns a block
constexpr int BK = 32;    // contraction rows a shared-memory step
constexpr int NT = 256;   // threads a block: 16 x 16, 4 x 4 outputs each
// Thread t always loads the same tile column (weights: t % BN) or the same
// contraction index (x: t % BK).
constexpr int W_PER_THREAD = BK * BN / NT;   // weight rows t / BN + 4 j
constexpr int X_PER_THREAD = BM * BK / NT;   // x rows t / BK + 8 j
constexpr int X_STRIDE = BM + 4;             // transposed tile row (16-byte aligned)
constexpr int X_TILE = BK * X_STRIDE;        // floats an x buffer
constexpr int W_TILE = BK * BN;              // floats a weight buffer

constexpr int smem_bytes(int n_weights) { return 4 * (2 * X_TILE + 2 * n_weights * W_TILE); }

// The global loads of a BK x BN tile of bf16 weights (K, N) into registers,
// raw, so they stay in flight while the previous tile is multiplied.
__device__ __forceinline__ void fetch_w(unsigned short (&reg)[W_PER_THREAD], const bf16* w,
                                        int k0, int c0, int K, int N) {
  const auto* wr = reinterpret_cast<const unsigned short*>(w);
  const int gc = c0 + threadIdx.x % BN;
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j) {
    const int gk = k0 + threadIdx.x / BN + j * (NT / BN);
    reg[j] = (gk < K && gc < N) ? wr[(size_t)gk * N + gc] : 0;
  }
}

// The fetched weight tile widened to fp32 (exactly) into shared memory.
__device__ __forceinline__ void store_w(float* dst, const unsigned short (&reg)[W_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j)
    dst[(threadIdx.x / BN + j * (NT / BN)) * BN + threadIdx.x % BN] =
        __uint_as_float(static_cast<unsigned>(reg[j]) << 16);
}

// The global loads of a BM x BK tile of a row-major fp32 (R, K).
__device__ __forceinline__ void fetch_x(float (&reg)[X_PER_THREAD], const float* x, int r0,
                                        int k0, int R, int K) {
  const int gk = k0 + threadIdx.x % BK;
#pragma unroll
  for (int j = 0; j < X_PER_THREAD; ++j) {
    const int gr = r0 + threadIdx.x / BK + j * (NT / BK);
    reg[j] = (gr < R && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
  }
}

// The x tile stored transposed, dst[k][row], so a thread reads its four
// rows as one contiguous run.
__device__ __forceinline__ void store_x(float* dst, const float (&reg)[X_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < X_PER_THREAD; ++j)
    dst[(threadIdx.x % BK) * X_STRIDE + threadIdx.x / BK + j * (NT / BK)] = reg[j];
}

// acc[mat][i][j] += x[row i][k] * w_mat[k][col j] over one shared-memory
// tile, k ascending (one read of x a k for every weight matrix).
template <int NMAT>
__device__ __forceinline__ void mma_tile(float (&acc)[NMAT][4][4], const float* xs,
                                         const float* ws) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[NMAT][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[k * X_STRIDE + ty * 4 + i];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int j = 0; j < 4; ++j) b[mat][j] = ws[mat * 2 * W_TILE + k * BN + tx + 16 * j];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mat][i][j] = fmaf(a[i], b[mat][j], acc[mat][i][j]);
  }
}

// h[e, r, c] = bf16(act(x[e] w_g[e], x[e] w_u[e])) for one 64 x 64 tile.
// ACT is swiglu, or -1 for relu2 / gelu by `act`.  Shared memory: x's two
// buffers, then each weight matrix's two (u, then g).
template <int ACT>
__global__ void __launch_bounds__(NT)
up_kernel(const float* __restrict__ xe, const bf16* __restrict__ wg, const bf16* __restrict__ wu,
          float* __restrict__ h, int C, int d, int m, int act) {
  constexpr int NMAT = ACT == ACT_SWIGLU ? 2 : 1;
  extern __shared__ float smem[];
  float* xs = smem;                     // [2][BK][X_STRIDE]
  float* ws = smem + 2 * X_TILE;        // [NMAT][2][BK][BN]
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const float* x = xe + (size_t)e * C * d;
  const bf16* w[2] = {wu + (size_t)e * d * m, NMAT == 2 ? wg + (size_t)e * d * m : nullptr};

  float xr[X_PER_THREAD];
  unsigned short wr[NMAT][W_PER_THREAD];
  fetch_x(xr, x, r0, 0, C, d);
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) fetch_w(wr[mat], w[mat], 0, c0, d, m);
  store_x(xs, xr);
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) store_w(ws + mat * 2 * W_TILE, wr[mat]);
  __syncthreads();

  float acc[NMAT][4][4] = {};
  for (int k0 = 0, buf = 0; k0 < d; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < d;
    if (more) {
      fetch_x(xr, x, r0, k0 + BK, C, d);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) fetch_w(wr[mat], w[mat], k0 + BK, c0, d, m);
    }
    mma_tile<NMAT>(acc, xs + buf * X_TILE, ws + buf * W_TILE);
    if (more) {
      store_x(xs + (buf ^ 1) * X_TILE, xr);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat)
        store_w(ws + mat * 2 * W_TILE + (buf ^ 1) * W_TILE, wr[mat]);
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
      const float u = acc[0][i][j];
      float v;
      if constexpr (ACT == ACT_SWIGLU)
        v = activate<ACT_SWIGLU>(acc[NMAT - 1][i][j], u);
      else
        v = act == ACT_RELU2 ? activate<ACT_RELU2>(0.0f, u) : activate<ACT_GELU>(0.0f, u);
      // the Pallas body casts h to w_d's dtype before the down GEMM
      h[((size_t)e * C + r) * m + c] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }
}

}  // namespace simt

// x (n values, n a multiple of 4) -> its second plane: fp32 x's lo part
// (hop::tf32_lo: x itself is the hi plane, which the tensor cores read
// truncated), bf16 x as one fp32 plane (exact).  Phase 1, a dependent
// launch, may start (and stream its first weights) once every block here
// has started.
template <typename TX>
__global__ void tf32_planes_kernel(const TX* __restrict__ x, float* __restrict__ planes,
                                   size_t n) {
  hop::launch_dependents();
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  if constexpr (std::is_same<TX, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<uint4*>(planes + i) =
        make_uint4(hop::tf32_lo(v.x), hop::tf32_lo(v.y), hop::tf32_lo(v.z), hop::tf32_lo(v.w));
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(x + i);
    *reinterpret_cast<float4*>(planes + i) =
        make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                    __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
}

// The tensor map of fp32 planes (slots, R, K): boxes of `rows` rows x 32
// columns of one slot, 128-byte swizzled.
int t_act_map(CUtensorMap* map, const float* base, int slots, int R, int K, int rows) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)slots};
  const uint64_t strides[2] = {(uint64_t)K * 4, (uint64_t)R * K * 4};
  const uint32_t box[3] = {32, (uint32_t)rows, 1};
  return hop::encode_f32_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The tensor map of an fp32 or bf16 (E, K, N) weight tensor: boxes of bk
// rows x 32 columns of one expert, swizzled over the box's row (128 or 64
// bytes).
template <typename TW>
int t_weight_map(CUtensorMap* map, const void* base, int E, int K, int N, int bk) {
  constexpr bool F32 = std::is_same<TW, float>::value;
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)N * sizeof(TW), (uint64_t)K * N * sizeof(TW)};
  const uint32_t box[3] = {32, (uint32_t)bk, 1};
  return hop::encode_map(map, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         base, 3, dims, strides, box,
                         F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// Phase 1's kernel shape of a setting, C tile, x planes and activation
// (ACT_SWIGLU, or -1 for relu2 and gelu); then phase 2's, whose activations
// are h's planes: two for fp32 weights, one for bf16.
template <class Cfg, int N, int XP, int ACT, typename TW>
using TUp = TShape<Cfg::UP_WG, Cfg::UP_BK, Cfg::UP_STAGES, N, XP, ACT == ACT_SWIGLU ? 2 : 1, TW>;
template <class Cfg, int N, typename TW>
using TDown = TShape<Cfg::DN_WG, Cfg::DN_BK, Cfg::DN_STAGES, N,
                     std::is_same<TW, float>::value ? 2 : 1, 1, TW>;

// x0, x1: x's two planes (fp32 x itself, its lo plane), or bf16 x's one
// fp32 plane (x1 unused).
template <class Cfg, int N, int XP, typename TW>
int launch_t_tile(const float* x0, const float* x1, const void* wg, const void* wu,
                  const void* wd, float* h, float* out, int E, int C, int d, int m, int act,
                  cudaStream_t s) {
  using D = TDown<Cfg, N, TW>;
  // the maps are encoded at every call: the operands' addresses change
  CUtensorMap hm0, hm1, dm;
  const float* h1 = h + (size_t)E * C * m;
  if (t_act_map(&hm0, h, E, C, m, N) || t_act_map(&hm1, D::PARTS == 2 ? h1 : h, E, C, m, N) ||
      t_weight_map<TW>(&dm, wd, E, m, d, Cfg::DN_BK))
    return -1;
  if constexpr (std::is_same<TW, bf16>::value) {   // fp32 x: phase 1 on CUDA cores
    const dim3 g_up((m + simt::BN - 1) / simt::BN, (C + simt::BM - 1) / simt::BM, E);
    const bf16* g = static_cast<const bf16*>(wg);
    const bf16* u = static_cast<const bf16*>(wu);
    if (act == ACT_SWIGLU)
      launch_dyn(simt::up_kernel<ACT_SWIGLU>, simt::smem_bytes(2), g_up, simt::NT, s, x0, g, u,
                 h, C, d, m, act);
    else
      launch_dyn(simt::up_kernel<-1>, simt::smem_bytes(1), g_up, simt::NT, s, x0, g, u, h, C, d,
                 m, act);
  } else {
    using U = TUp<Cfg, N, XP, ACT_SWIGLU, TW>;
    using V = TUp<Cfg, N, XP, -1, TW>;
    CUtensorMap xm0, xm1, um, gm;
    if (t_act_map(&xm0, x0, E, C, d, N) || t_act_map(&xm1, XP == 2 ? x1 : x0, E, C, d, N) ||
        t_weight_map<TW>(&um, wu, E, d, m, Cfg::UP_BK) ||
        t_weight_map<TW>(&gm, act == ACT_SWIGLU ? wg : wu, E, d, m, Cfg::UP_BK))
      return -1;
    const dim3 g_up((m + U::BN - 1) / U::BN, (C + N - 1) / N, E);
    if (act == ACT_SWIGLU)
      launch_dependent(up_kernel_t<U, ACT_SWIGLU>, U::SMEM, g_up, U::NT, s, xm0, xm1, um, gm, h,
                       E, C, d, m, act);
    else
      launch_dependent(up_kernel_t<V, -1>, V::SMEM, g_up, V::NT, s, xm0, xm1, um, gm, h, E, C,
                       d, m, act);
  }
  const dim3 g_down((d + D::BN - 1) / D::BN, (C + N - 1) / N, E);
  launch_dependent(down_kernel_t<D>, D::SMEM, g_down, D::NT, s, hm0, hm1, dm, out, E, C, d, m);
  return 0;
}

template <class Cfg, int XP, typename TW>
int launch_t_typed(const float* x0, const float* x1, const void* wg, const void* wu,
                   const void* wd, float* h, float* out, int E, int C, int d, int m, int act,
                   cudaStream_t s) {
  switch (q_tile(C, 1)) {
    case 16:
      return launch_t_tile<Cfg, 16, XP, TW>(x0, x1, wg, wu, wd, h, out, E, C, d, m, act, s);
    case 32:
      return launch_t_tile<Cfg, 32, XP, TW>(x0, x1, wg, wu, wd, h, out, E, C, d, m, act, s);
    case 48:
      return launch_t_tile<Cfg, 48, XP, TW>(x0, x1, wg, wu, wd, h, out, E, C, d, m, act, s);
    default:
      return launch_t_tile<Cfg, 64, XP, TW>(x0, x1, wg, wu, wd, h, out, E, C, d, m, act, s);
  }
}

// Attributes of a setting's kernels at a C tile: up swiglu, up relu2, up
// gelu (one kernel), down.
template <class Cfg, int N, int XP, typename TW>
void t_tile_attrs(int* out) {
  using D = TDown<Cfg, N, TW>;
  if constexpr (std::is_same<TW, bf16>::value) {
    kernel_attrs(simt::up_kernel<ACT_SWIGLU>, simt::smem_bytes(2), simt::NT, out);
    kernel_attrs(simt::up_kernel<-1>, simt::smem_bytes(1), simt::NT, out + ATTR_FIELDS);
    kernel_attrs(simt::up_kernel<-1>, simt::smem_bytes(1), simt::NT, out + 2 * ATTR_FIELDS);
  } else {
    using U = TUp<Cfg, N, XP, ACT_SWIGLU, TW>;
    using V = TUp<Cfg, N, XP, -1, TW>;
    kernel_attrs(up_kernel_t<U, ACT_SWIGLU>, U::SMEM, U::NT, out);
    kernel_attrs(up_kernel_t<V, -1>, V::SMEM, V::NT, out + ATTR_FIELDS);
    kernel_attrs(up_kernel_t<V, -1>, V::SMEM, V::NT, out + 2 * ATTR_FIELDS);
  }
  kernel_attrs(down_kernel_t<D>, D::SMEM, D::NT, out + 3 * ATTR_FIELDS);
}

template <class Cfg, int XP, typename TW>
void t_typed_attrs(int C, int* out) {
  switch (q_tile(C, 1)) {
    case 16: return t_tile_attrs<Cfg, 16, XP, TW>(out);
    case 32: return t_tile_attrs<Cfg, 32, XP, TW>(out);
    case 48: return t_tile_attrs<Cfg, 48, XP, TW>(out);
    default: return t_tile_attrs<Cfg, 64, XP, TW>(out);
  }
}

using TLaunch = int (*)(const float*, const float*, const void*, const void*, const void*, float*,
                        float*, int, int, int, int, int, cudaStream_t);
// [setting][x fp32][weights fp32]; bf16 x bf16 takes the bf16 path
#define T_LAUNCH_ENTRY(...)                                                         \
  {{nullptr, &launch_t_typed<QCfg<__VA_ARGS__>, 1, float>},                         \
   {&launch_t_typed<QCfg<__VA_ARGS__>, 2, bf16>, &launch_t_typed<QCfg<__VA_ARGS__>, 2, float>}},
#define T_ATTRS_ENTRY(...)                                                          \
  {{nullptr, &t_typed_attrs<QCfg<__VA_ARGS__>, 1, float>},                          \
   {&t_typed_attrs<QCfg<__VA_ARGS__>, 2, bf16>, &t_typed_attrs<QCfg<__VA_ARGS__>, 2, float>}},
const TLaunch kTLaunch[][2][2] = {T_SETTINGS(T_LAUNCH_ENTRY)};
const QAttrs kTAttrs[][2][2] = {T_SETTINGS(T_ATTRS_ENTRY)};
constexpr int N_T = sizeof(kTLaunch) / sizeof(kTLaunch[0]);

// fp32 weights, or bf16 weights with fp32 x: 16-byte weight rows (d and m
// multiples of 4, or of 8 for bf16 weights), 16-byte aligned operands and a
// setting of the table, or cudaErrorInvalidValue.  The scratch holds h's
// planes (two, or one for bf16 weights), then, for fp32 weights, x's lo
// plane (fp32 x, whose hi plane is x itself) or bf16 x as fp32.
template <typename TX>
int launch_t(int w_dtype, const void* xe, const void* wg, const void* wu, const void* wd,
             void* h, float* out, int E, int C, int d, int m, int act, int tiles,
             cudaStream_t s) {
  constexpr int X_F32 = std::is_same<TX, float>::value ? 1 : 0;
  const int w_f32 = w_dtype == DT_F32 ? 1 : 0;
  const int row = w_f32 ? 4 : 8;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(xe) | reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                         reinterpret_cast<uintptr_t>(h);
  if (d % row != 0 || m % row != 0 || bits % 16 != 0 || tiles < 0 || tiles >= N_T ||
      (!X_F32 && !w_f32))
    return -1;
  float* hp = static_cast<float*>(h);
  float* xp = hp + (size_t)2 * E * C * m;
  if (w_f32) {
    const size_t n = (size_t)E * C * d;
    tf32_planes_kernel<TX><<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
        static_cast<const TX*>(xe), xp, n);
  }
  const float* x0 = X_F32 ? static_cast<const float*>(xe) : xp;
  return kTLaunch[tiles][X_F32][w_f32](x0, xp, wg, wu, wd, hp, out, E, C, d, m, act, s);
}

template <typename TX>
int launch_w(int w_dtype, const void* xe, const void* wg, const void* wu,
             const void* wd, const float* sg, const float* su, const float* sd,
             void* h, float* out, int E, int C, int d, int m, int act, int tiles,
             cudaStream_t s) {
  constexpr bool X_BF16 = std::is_same<TX, bf16>::value;
  if (w_dtype == DT_I8 || w_dtype == DT_F8)
    return launch_q<TX>(w_dtype, xe, wg, wu, wd, sg, su, sd, h, out, E, C, d, m, act, tiles, s);
  if (w_dtype == DT_BF16 && X_BF16)
    return launch_tc(xe, wg, wu, wd, h, out, E, C, d, m, act, tiles, s);
  if (w_dtype == DT_F32 || w_dtype == DT_BF16)
    return launch_t<TX>(w_dtype, xe, wg, wu, wd, h, out, E, C, d, m, act, tiles, s);
  return -1;
}

}  // namespace

// xe (E,C,d) fp32|bf16; w_g/w_u (E,d,m), w_d (E,m,d) fp32|bf16|int8|fp8;
// s_g/s_u (E,1,m), s_d (E,1,d) fp32 (quantized weights only); h (E,C,m)
// scratch, bf16 when xe and the weights are bf16 (then d and m multiples of
// 8 and every operand 16-byte aligned); with int8 / fp8 weights three bf16
// planes of h (3,E,C,m), then, for fp32 xe, three of xe (3,E,C,d) (d and m
// multiples of 16, every operand 16-byte aligned); out
// (E,C,d) fp32.  With fp32 weights (split TF32), a flat fp32 scratch:
// h's hi and lo planes (2,E,C,m), then fp32 xe's lo plane (E,C,d) (bf16
// xe as fp32); with bf16 weights and fp32 xe, h's one plane (E,C,m),
// rounded to bf16; rows of d and m 16 bytes, every operand 16-byte
// aligned.
// `tiles` is a row of the path's settings table: WG_SETTINGS (bf16 x bf16),
// Q_SETTINGS (int8 / fp8 weights) or T_SETTINGS (split TF32).  Returns a
// cudaError_t (0 on success), or
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
extern "C" int streamed_moe_tile_attrs(int x_dtype, int w_dtype, int tiles, int C, int* out) {
  const bool x_f32 = x_dtype == DT_F32;
  if (!x_f32 && x_dtype != DT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (w_dtype == DT_I8 || w_dtype == DT_F8) {
    if (tiles < 0 || tiles >= N_Q) return static_cast<int>(cudaErrorInvalidValue);
    kQAttrs[tiles][x_f32][w_dtype == DT_F8](C, out);
  } else if (w_dtype == DT_BF16 && !x_f32) {
    if (tiles < 0 || tiles >= N_WG) return static_cast<int>(cudaErrorInvalidValue);
    kWgAttrs[tiles](out);
  } else if (w_dtype == DT_F32 || w_dtype == DT_BF16) {
    if (tiles < 0 || tiles >= N_T) return static_cast<int>(cudaErrorInvalidValue);
    kTAttrs[tiles][x_f32][w_dtype == DT_F32](C, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
