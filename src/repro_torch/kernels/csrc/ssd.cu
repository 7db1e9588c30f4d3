// Mamba-2 SSD intra-chunk terms for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd.py::ssd_intra_chunk_kernel (the Pallas TPU
// kernel).  For every (batch, chunk, head), with acum the chunk's cumulative
// decay and B, C the rows of the head's group:
//   Y_diag[i, :] = sum_{j <= i} (C[i] . B[j]) * exp(acum[i] - acum[j]) * x[j, :]
//   state[:, :]  = ((B * exp(acum[-1] - acum)[:, None])^T x)^T        (p, n)
// Inputs xc (b,nc,c,h,p), Bc / Cc (b,nc,c,g,n) with g dividing h (head hi
// reads group hi / (h / g); g = h is the reference's per-head layout),
// A_cumsum (b,h,nc,c), all fp32; both outputs fp32.  The per-step decays Ac,
// which the reference passes too, are not read (nor by the Pallas body).
//
// Bound: at mamba2-370m's shape (b=2, nc=8, c=256, h=32, g=1, p=64, n=128)
// the least work is C B^T once per group (0.13 GFLOP over the causal pairs),
// the causal (G o L) x per head (2.16 GFLOP) and the state product (2.15
// GFLOP): 4.44 GFLOP, 66 us at the 67 TFLOP/s fp32 rate, against 88.5 MB of
// bytes (26 us at 3.35 TB/s).  So it is bound by fp32 operations.  The
// products stay fp32 FMAs: the reference's tolerance is 2e-5, which a single
// TF32 or bf16 product cannot meet (split TF32 could, at three products each;
// it is not tried here).
//
// Design.  C B^T does not depend on the head, so it is computed once per
// (batch*chunk, group) by a first pass and read by the heads from L2, rather
// than by a block looping over its group's heads: with g = 1 that loop would
// leave b*nc*(c/64) = 64 blocks for 132 SMs, and a per-head G tile in shared
// memory would not fit beside the output tiles at c = 256.
//   1. grid (causal 64x64 tile pairs, b*nc*g): G^T[j, i] = B[j] . C[i] for
//      the tiles with i >= j, fp32 FMAs in ascending k, into a scratch
//      (b*nc*g, c, c) (4 MB at the main shape, resident in L2).  Its rows
//      are padded to a multiple of 4 floats for 16-byte copies.
//   2. grid (h, b*nc): a block owns one (batch*chunk, head).  For each tile
//      of RB = 256 output rows (128 at p = 128) it walks 32-row source tiles
//      up to its diagonal.  The tile's rows of G^T and of x stream through a
//      two-stage cp.async ring (the next step's land while this one is
//      multiplied; reading G with plain loads left every step waiting on
//      L2), and (G o L)[i, j] = G[i, j] exp(acum[i] - acum[j]) (0 above the
//      diagonal) is formed in shared memory.  Each thread accumulates 8 rows
//      x 8 columns (RY x 8 at other p) from two float4 reads of each, 64 FMAs
//      per four 16-byte shared loads (4 x 4 tiles take one load per four
//      FMAs).  A warp whose rows all lie above a source tile skips it.  The
//      state joins this block: a last walk over the chunk's x rows (again,
//      from L2) and its B rows, decayed in shared memory, accumulates a
//      (p/16) x 8 share of the (p, n) state per thread, so the state needs
//      no grid of its own.  Registers are capped at 128 so that two blocks
//      share an SM.
// Both products accumulate in fp32 in ascending source order.
//
// Plain C interface for ctypes: one launch function that runs both passes on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads a block, both passes
constexpr int GT = 64;       // G pass: tile rows and columns
constexpr int GS = GT + 4;   // stride of its transposed tiles (16-byte rows)
constexpr int ST = 32;       // output pass: source rows per step
constexpr int NB = 128;      // state columns a block holds (n <= NB)
constexpr int Y_BLOCKS = 2;  // output-pass blocks an SM holds (caps registers at 128)

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// One 64 x 64 tile (rows j, columns i, i-tile >= j-tile) of
// G^T[cell] = B C^T, cell = (batch*chunk)*g + group.
__global__ void __launch_bounds__(NT)
ssd_g_kernel(const float* __restrict__ B, const float* __restrict__ C, float* __restrict__ gt,
             int c, int g, int n) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;            // [n][GS] B rows (j) of the tile, transposed
  float* cs = bs + n * GS;     // [n][GS] C rows (i) of the tile, transposed
  int t = blockIdx.x, ti = 0;  // pair index -> (tj <= ti)
  while (t > ti) t -= ++ti;
  const int j0 = t * GT, i0 = ti * GT;
  const int cell = blockIdx.y, bc = cell / g, grp = cell % g;
  const size_t row = (size_t)g * n;
  const float* Bb = B + (size_t)bc * c * row + (size_t)grp * n;
  const float* Cb = C + (size_t)bc * c * row + (size_t)grp * n;
  for (int i = threadIdx.x; i < GT * n; i += NT) {
    const int r = i / n, k = i % n;
    bs[k * GS + r] = j0 + r < c ? Bb[(size_t)(j0 + r) * row + k] : 0.0f;
    cs[k * GS + r] = i0 + r < c ? Cb[(size_t)(i0 + r) * row + k] : 0.0f;
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(bs + k * GS + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float cv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) cv[q] = cs[k * GS + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], cv[q], acc[r][q]);
  }
  float* gb = gt + (size_t)cell * c * round4(c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r;
    if (j >= c) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + tx + 16 * q;
      if (i < c) gb[(size_t)j * round4(c) + i] = acc[r][q];
    }
  }
}

// The output pass's thread layout for head dim P: TX threads across the P
// columns (8 each: two runs of 4, P/2 apart), TY across the rows (RY each),
// RB rows a tile, WR rows a warp; SP state rows a thread.  A stage of its
// two-stage ring holds ST rows of G^T (RB columns; the state walk puts ST
// rows of B there) and ST rows of x.
template <int P>
struct YShape {
  static constexpr int TX = P / 8;
  static constexpr int TY = NT / TX;
  static constexpr int RY = 256 / TY < 8 ? 256 / TY : 8;
  static constexpr int RB = TY * RY;
  static constexpr int WR = 32 / TX * RY;
  static constexpr int SP = P / 16;
  static constexpr int STAGE = ST * RB + ST * P;   // floats
  static_assert(RB >= NB, "a stage must hold ST rows of B");
  static_assert(ST % WR == 0, "a source tile starts at a warp's first row");
  static size_t smem_bytes(int c) { return 4 * (2 * (size_t)STAGE + 2 * (size_t)round4(c)); }
};

// N consecutive floats of shared memory, in 16- or 8-byte loads.
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Y_diag and the state of one (batch*chunk, head).  Two walks, each through
// a two-stage cp.async ring (the next step's tiles land while this one is
// multiplied): the output walk over (row tile, source tile <= its diagonal)
// and the state walk over the chunk's source tiles.
template <int P>
__global__ void __launch_bounds__(NT, Y_BLOCKS)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ B,
             const float* __restrict__ gt, const float* __restrict__ acum,
             float* __restrict__ y, float* __restrict__ st, int nc, int c, int h, int g, int n) {
  using S = YShape<P>;
  constexpr int RY = S::RY, RB = S::RB, SP = S::SP;
  extern __shared__ __align__(16) float smem[];
  float* ac = smem + 2 * S::STAGE;   // [c] acum of the chunk
  float* dec = ac + round4(c);       // [c] exp(acum[c-1] - acum), the state's decays
  const int hi = blockIdx.x, bc = blockIdx.y;
  const int bi = bc / nc, ci = bc % nc, grp = hi / (h / g);
  const int cs = round4(c);          // row stride of G^T
  const size_t xrow = (size_t)h * P, nrow = (size_t)g * n;
  const float* xb = x + (size_t)bc * c * xrow + (size_t)hi * P;
  const float* Bb = B + (size_t)bc * c * nrow + (size_t)grp * n;
  const float* gb = gt + (size_t)(bc * g + grp) * c * cs;
  const float* ab = acum + ((size_t)(bi * h + hi) * nc + ci) * c;
  const int tid = threadIdx.x, warp = tid / 32;
  const int tx = tid % S::TX, ty = tid / S::TX;
  for (int i = tid; i < c; i += NT) ac[i] = ab[i];
  const float a_last = ab[c - 1];
  for (int i = tid; i < c; i += NT) dec[i] = expf(a_last - ab[i]);

  auto stage = [&](int k) { return smem + (k & 1) * S::STAGE; };
  auto load_x = [&](float* xs, int s0) {
    for (int i = tid; i < ST * P / 4; i += NT) {
      const int jj = i / (P / 4), q = (i % (P / 4)) * 4;
      const bool ok = s0 + jj < c;
      cp_async(xs + jj * P + q, ok ? xb + (size_t)(s0 + jj) * xrow + q : xb, 16, ok);
    }
  };

  // The output walk: step k is source tile s0 of row tile r0.
  const int n_rt = (c + RB - 1) / RB;
  auto y_step = [&](int k, int& r0, int& s0) {
    for (r0 = 0;; r0 += RB) {
      const int n_s = (min(r0 + RB, c) + ST - 1) / ST;
      if (k < n_s) break;
      k -= n_s;
    }
    s0 = k * ST;
  };
  int n_y = 0;
  for (int t = 0; t < n_rt; ++t) n_y += (min((t + 1) * RB, c) + ST - 1) / ST;
  auto y_load = [&](int k) {
    int r0, s0;
    y_step(k, r0, s0);
    float* ps = stage(k);
    for (int i = tid; i < ST * RB / 4; i += NT) {
      const int jj = i / (RB / 4), ii = (i % (RB / 4)) * 4, j = s0 + jj, r = r0 + ii;
      const bool ok = j < c && r + 3 >= j && r < c;   // rows above the source are not read
      cp_async(ps + jj * RB + ii, ok ? gb + (size_t)j * cs + r : gb, 16, ok);
    }
    load_x(ps + ST * RB, s0);
  };

  float acc[RY][8] = {};
  y_load(0);
  cp_async_commit();
  for (int k = 0; k < n_y; ++k) {
    if (k + 1 < n_y) y_load(k + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();   // step k's tiles have landed
    int r0, s0;
    y_step(k, r0, s0);
    float* ps = stage(k);
    const float* xs = ps + ST * RB;
    // (G o L)[i, j] = G[i, j] exp(acum[i] - acum[j]) for i >= j, else 0; rows
    // above s0 belong to warps that skip this tile (WR divides ST): left as is
    const int lo = max(s0 - r0, 0), width = RB - lo;
    for (int i = tid; i < ST * width; i += NT) {
      const int jj = i / width, ii = lo + i % width, j = s0 + jj, r = r0 + ii;
      float& v = ps[jj * RB + ii];
      v = r >= j && r < c ? v * expf(ac[r] - ac[j]) : 0.0f;
    }
    __syncthreads();
    const int r_lo = r0 + warp * S::WR;   // this warp's first row
    if (r_lo + S::WR > s0 && r_lo < c) {  // else no row of this warp reaches the tile
#pragma unroll 4
      for (int jj = 0; jj < ST; ++jj) {
        float a[RY], b0[4], b1[4];
        lds(a, ps + jj * RB + ty * RY);
        lds(b0, xs + jj * P + tx * 4);
        lds(b1, xs + jj * P + P / 2 + tx * 4);
#pragma unroll
        for (int r = 0; r < RY; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][q] = fmaf(a[r], b0[q], acc[r][q]);
            acc[r][4 + q] = fmaf(a[r], b1[q], acc[r][4 + q]);
          }
      }
    }
    if (s0 + ST >= min(r0 + RB, c)) {     // the row tile's last source tile
      float* yb = y + (size_t)bc * c * xrow + (size_t)hi * P;
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int row = r0 + ty * RY + r;
        if (row < c) {
          *reinterpret_cast<float4*>(yb + (size_t)row * xrow + tx * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(yb + (size_t)row * xrow + P / 2 + tx * 4) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
      }
    }
    __syncthreads();   // stage k is consumed before step k + 2 refills it
  }

  // The state walk: st[pp, nn] = sum_j x[j, pp] * (B[j, nn] * dec[j]).
  const int n_s = (c + ST - 1) / ST;
  auto s_load = [&](int k) {
    float* bs = stage(k);
    const int s0 = k * ST;
    for (int i = tid; i < ST * NB; i += NT) {
      const int jj = i / NB, nn = i % NB;
      const bool ok = s0 + jj < c && nn < n;
      cp_async(bs + i, ok ? Bb + (size_t)(s0 + jj) * nrow + nn : Bb, 4, ok);
    }
    load_x(bs + ST * RB, s0);
  };
  const int sx = tid % 16, sy = tid / 16;
  float sacc[SP][8] = {};
  s_load(0);
  cp_async_commit();
  for (int k = 0; k < n_s; ++k) {
    if (k + 1 < n_s) s_load(k + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float* bs = stage(k);
    const float* xs = bs + ST * RB;
    for (int i = tid; i < ST * NB; i += NT) {
      const int j = k * ST + i / NB;
      if (j < c) bs[i] *= dec[j];
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < ST; ++jj) {
      float a[SP], b0[4], b1[4];
      lds(a, xs + jj * P + sy * SP);
      lds(b0, bs + jj * NB + sx * 4);
      lds(b1, bs + jj * NB + NB / 2 + sx * 4);
#pragma unroll
      for (int r = 0; r < SP; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sacc[r][q] = fmaf(a[r], b0[q], sacc[r][q]);
          sacc[r][4 + q] = fmaf(a[r], b1[q], sacc[r][4 + q]);
        }
    }
    __syncthreads();
  }
  float* sb = st + ((size_t)bc * h + hi) * P * n;
#pragma unroll
  for (int r = 0; r < SP; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int nn = (q < 4 ? 0 : NB / 2) + sx * 4 + q % 4;
      if (nn < n) sb[(size_t)(sy * SP + r) * n + nn] = sacc[r][q];
    }
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, size_t bytes, dim3 grid, cudaStream_t s, Args... args) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  kernel<<<grid, NT, bytes, s>>>(args...);
}

template <int P>
int launch_y(const float* x, const float* B, const float* gt, const float* acum, float* y,
             float* st, int b, int nc, int c, int h, int g, int n, cudaStream_t s) {
  const size_t bytes = YShape<P>::smem_bytes(c);
  if (bytes > 227 * 1024) return -1;
  launch(ssd_y_kernel<P>, bytes, dim3(h, b * nc), s, x, B, gt, acum, y, st, nc, c, h, g, n);
  return 0;
}

}  // namespace

// xc (b,nc,c,h,p), Bc / Cc (b,nc,c,g,n) with g dividing h, A_cumsum
// (b,h,nc,c), a scratch G (b*nc*g, c, c rounded up to a multiple of 4),
// Y_diag (b,nc,c,h,p), states (b,nc,h,p,n): contiguous fp32 (x and the
// scratch 16-byte aligned).  p in {16, 32, 64, 128}; n at most 128.
// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for a size
// it does not take.
extern "C" int ssd_intra_chunk_forward(const float* x, const float* B, const float* C,
                                       const float* acum, float* gt, float* y, float* st, int b,
                                       int nc, int c, int h, int g, int p, int n, void* stream) {
  if (b <= 0 || nc <= 0 || c <= 0 || h <= 0 || g <= 0 || h % g != 0 || n <= 0 || n > NB ||
      h > 65535 || (long long)b * nc > 65535 || (long long)b * nc * g > 65535 ||
      (p != 16 && p != 32 && p != 64 && p != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + GT - 1) / GT;
  launch(ssd_g_kernel, (size_t)8 * n * GS, dim3(tiles * (tiles + 1) / 2, b * nc * g), s, B, C,
         gt, c, g, n);
  int rc;
  switch (p) {
    case 16: rc = launch_y<16>(x, B, gt, acum, y, st, b, nc, c, h, g, n, s); break;
    case 32: rc = launch_y<32>(x, B, gt, acum, y, st, b, nc, c, h, g, n, s); break;
    case 64: rc = launch_y<64>(x, B, gt, acum, y, st, b, nc, c, h, g, n, s); break;
    default: rc = launch_y<128>(x, B, gt, acum, y, st, b, nc, c, h, g, n, s); break;
  }
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
