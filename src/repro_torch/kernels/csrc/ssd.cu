// Mamba-2 SSD intra-chunk terms for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd.py::ssd_intra_chunk_kernel (the Pallas TPU
// kernel).  For every (batch, chunk, head), with acum the chunk's cumulative
// decay:
//   Y_diag[i, :] = sum_{j <= i} (C[i] . B[j]) * exp(acum[i] - acum[j]) * x[j, :]
//   state[:, :]  = ((B * exp(acum[-1] - acum)[:, None])^T x)^T        (p, n)
// Inputs xc (b,nc,c,h,p), Bc / Cc (b,nc,c,h,n), A_cumsum (b,h,nc,c), all fp32;
// both outputs fp32.  The per-step decays Ac, which the reference passes too,
// are not read (nor by the Pallas body).
//
// Bound: at mamba2-370m's shape (b=2, nc=8, c=256, h=32, p=64, n=128) the
// causal half of the two intra-chunk products plus the state product is about
// 8.6 GFLOP, 0.13 ms at the 67 TFLOP/s fp32 rate; the bytes (each input read
// once, each output written once) are about 220 MB, 66 us at 3.35 TB/s, of which
// 134 MB are B and C broadcast from one group to 32 heads, a copy the
// reference's interface makes its callers materialise.  So it is bound by fp32
// operations: the products stay in fp32 FMAs because the reference's tolerance
// is 2e-5, which TF32 or bf16 tensor cores cannot meet.  Reading B and C per
// group, (b,l,g,n), would cut the bytes by 60% and is a later change of the
// interface.
//
// Design.  One chunk's fp32 tiles do not fit one block: the (c, c) score matrix
// alone is 256 KB at c = 256.  So the output pass tiles the chunk's rows: a
// block owns (batch*chunk, head, 64 rows), keeps those rows of C in shared
// memory, and loops over 64-row source tiles up to its diagonal, building
// L = exp(acum[i] - acum[j]) (0 above the diagonal) from acum in the kernel,
// as the TPU kernel does, so the mask never touches device memory.  The state
// needs all c rows of one (batch, chunk, head), so it has its own blocks, each
// owning a 64 x 64 tile of the (p, n) state and looping over the chunk's rows.
// Both products accumulate as fp32 FMAs in ascending order.
//
// Plain C interface for ctypes: one launch function that runs both kernels on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BL = 64;       // chunk rows per output block, and source rows per step
constexpr int NT = 256;      // threads: 16 x 16, each 4 rows x (P / 16) or 4 columns
constexpr int TS = BL + 4;   // stride of transposed tiles (16-byte rows)
constexpr int SK = 32;       // chunk rows per step of the state pass

size_t y_smem_bytes(int p, int n) { return 4 * ((size_t)2 * n * TS + BL * p + BL * TS + 2 * BL); }

// Y_diag for one (batch*chunk, head, 64-row tile).
template <int P>
__global__ void __launch_bounds__(NT)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ acum,
             float* __restrict__ y, int nc, int c, int h, int n) {
  constexpr int NC = P / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* cs = smem;            // [n][TS]  C rows of this tile, transposed
  float* bs = cs + n * TS;     // [n][TS]  B rows of the source tile, transposed
  float* xs = bs + n * TS;     // [BL][P]  x rows of the source tile
  float* ps = xs + BL * P;     // [BL][TS] (C B^T) * L, transposed
  float* al = ps + BL * TS;    // [BL]     acum of this tile's rows
  float* as = al + BL;         // [BL]     acum of the source rows
  const int bc = blockIdx.z, hi = blockIdx.y;
  const int bi = bc / nc, ci = bc % nc;
  const int l0 = (gridDim.x - 1 - blockIdx.x) * BL;   // longest loops first
  const size_t xrow = (size_t)h * P, nrow = (size_t)h * n;
  const float* xb = x + (size_t)bc * c * xrow + (size_t)hi * P;
  const float* Bb = B + (size_t)bc * c * nrow + (size_t)hi * n;
  const float* Cb = C + (size_t)bc * c * nrow + (size_t)hi * n;
  const float* ab = acum + ((size_t)(bi * h + hi) * nc + ci) * c;

  for (int i = threadIdx.x; i < BL * n; i += NT) {
    const int r = i / n, k = i % n;
    cs[k * TS + r] = l0 + r < c ? Cb[(size_t)(l0 + r) * nrow + k] : 0.0f;
  }
  if (threadIdx.x < BL) al[threadIdx.x] = l0 + threadIdx.x < c ? ab[l0 + threadIdx.x] : 0.0f;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][NC] = {};
  const int l1 = min(l0 + BL, c);
  for (int s0 = 0; s0 < l1; s0 += BL) {
    __syncthreads();   // the previous source tile is consumed
    for (int i = threadIdx.x; i < BL * n; i += NT) {
      const int r = i / n, k = i % n;
      bs[k * TS + r] = s0 + r < c ? Bb[(size_t)(s0 + r) * nrow + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < BL * P; i += NT) {
      const int r = i / P, d = i % P;
      xs[r * P + d] = s0 + r < c ? xb[(size_t)(s0 + r) * xrow + d] : 0.0f;
    }
    if (threadIdx.x < BL) as[threadIdx.x] = s0 + threadIdx.x < c ? ab[s0 + threadIdx.x] : 0.0f;
    __syncthreads();

    float g[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(cs + k * TS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k * TS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(av[i], bv[j], g[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int li = ty * 4 + i, sj = tx + 16 * j;
        const bool keep = l0 + li >= s0 + sj && s0 + sj < c;
        ps[sj * TS + li] = keep ? g[i][j] * expf(al[li] - as[sj]) : 0.0f;
      }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BL; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ps + kk * TS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float bv = xs[kk * P + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(av[i], bv, acc[i][cc]);
      }
    }
  }

  float* yb = y + (size_t)bc * c * xrow + (size_t)hi * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = l0 + ty * 4 + i;
    if (r >= c) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) yb[(size_t)r * xrow + tx + 16 * cc] = acc[i][cc];
  }
}

// One 64 (p) x 64 (n) tile of the state of one (batch*chunk, head):
// st[pp, nn] = sum_s x[s, pp] * (B[s, nn] * exp(acum[c-1] - acum[s])).
__global__ void __launch_bounds__(NT)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ B,
                 const float* __restrict__ acum, float* __restrict__ st, int nc, int c,
                 int h, int p, int n) {
  __shared__ __align__(16) float xs[SK][TS];   // x rows, this tile's p columns
  __shared__ __align__(16) float bs[SK][TS];   // decayed B rows, this tile's n columns
  const int n0 = blockIdx.x * BL, p0 = blockIdx.y * BL;
  const int bch = blockIdx.z;                  // (batch*chunk)*h + head
  const int bc = bch / h, hi = bch % h;
  const int bi = bc / nc, ci = bc % nc;
  const size_t xrow = (size_t)h * p, nrow = (size_t)h * n;
  const float* xb = x + (size_t)bc * c * xrow + (size_t)hi * p;
  const float* Bb = B + (size_t)bc * c * nrow + (size_t)hi * n;
  const float* ab = acum + ((size_t)(bi * h + hi) * nc + ci) * c;
  const float a_last = ab[c - 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int s0 = 0; s0 < c; s0 += SK) {
    for (int i = threadIdx.x; i < SK * BL; i += NT) {
      const int r = i / BL, col = i % BL;
      const int s = s0 + r;
      xs[r][col] = s < c && p0 + col < p ? xb[(size_t)s * xrow + p0 + col] : 0.0f;
      bs[r][col] = s < c && n0 + col < n
                       ? Bb[(size_t)s * nrow + n0 + col] * expf(a_last - ab[s]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < SK; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = bs[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* sb = st + (size_t)bch * p * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = p0 + ty * 4 + i;
    if (pp >= p) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < n) sb[(size_t)pp * n + nn] = acc[i][j];
    }
  }
}

template <int P>
int launch_y(const float* x, const float* B, const float* C, const float* acum, float* y,
             int b, int nc, int c, int h, int n, cudaStream_t s) {
  const size_t bytes = y_smem_bytes(P, n);
  if (bytes > 227 * 1024) return -1;
  auto kernel = ssd_y_kernel<P>;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  const dim3 grid((c + BL - 1) / BL, h, b * nc);
  kernel<<<grid, NT, bytes, s>>>(x, B, C, acum, y, nc, c, h, n);
  return 0;
}

}  // namespace

// xc (b,nc,c,h,p), Bc / Cc (b,nc,c,h,n), A_cumsum (b,h,nc,c), Y_diag
// (b,nc,c,h,p), states (b,nc,h,p,n): contiguous fp32.  p in {16, 32, 64, 128};
// n at most 128.  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a size it does not take.
extern "C" int ssd_intra_chunk_forward(const float* x, const float* B, const float* C,
                                       const float* acum, float* y, float* st, int b,
                                       int nc, int c, int h, int p, int n, void* stream) {
  if (b <= 0 || nc <= 0 || c <= 0 || h <= 0 || n <= 0 || n > 128 || h > 65535 ||
      (long long)b * nc > 65535 || (long long)b * nc * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (p) {
    case 16: rc = launch_y<16>(x, B, C, acum, y, b, nc, c, h, n, s); break;
    case 32: rc = launch_y<32>(x, B, C, acum, y, b, nc, c, h, n, s); break;
    case 64: rc = launch_y<64>(x, B, C, acum, y, b, nc, c, h, n, s); break;
    case 128: rc = launch_y<128>(x, B, C, acum, y, b, nc, c, h, n, s); break;
    default: rc = -1;
  }
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g_state((n + BL - 1) / BL, (p + BL - 1) / BL, b * nc * h);
  ssd_state_kernel<<<g_state, NT, 0, s>>>(x, B, acum, st, nc, c, h, p, n);
  return static_cast<int>(cudaGetLastError());
}
