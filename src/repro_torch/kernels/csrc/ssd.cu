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
// GFLOP): 4.44 GFLOP, 66 us at the 67 TFLOP/s of fp32 FMAs, against 88.5 MB
// of bytes (26 us at 3.35 TB/s).  On the tensor cores in split TF32 (three
// TF32 products each, 495 TFLOP/s) the same work takes 27 us, at the bytes.
// The serving prefill's c = 8 chunks are bound by bytes (0.4 us).
//
// Split TF32.  The reference holds fp32 to 2e-5, which one TF32 product (10
// mantissa bits) misses by about 50x (4e-4 in the emulation of
// tests/test_torch_ssd_split.py).  Each fp32 operand v is split as hi =
// tf32(v), lo = tf32(v - hi) (to nearest), and a product a b is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo, about 2^-22 of it, is
// dropped): three wgmma.m64nNk8.tf32 on one fp32 accumulator (hop::split,
// hop::split_step, shared with the other kernels' fp32 bodies).  The sums stay
// in the wgmma accumulators, with no promotion into a separate fp32 sum:
// the emulation, with the sums truncated after every k8 step, puts the
// error at 1.5e-6 of max |out| at c = 256, n = 128, and the card measures
// 1.3e-6 against the plain version (PERF.md), 7x inside the 1e-5 hold.
// (Three accumulators, one a term, measured 5.5e-7 but no faster, and the
// registers they take are wanted elsewhere.)
//
// Two bodies behind one entry point; the wrapper (kernels/ssd.py) picks by
// the chunk length: c <= SHORT_MAX runs body 2.
//
// Body 1, long chunks (mamba2-370m's and Jamba's c = 256), on the tensor
// cores, two launches:
//   1. ssd_g_tc, grid (causal 64 x 64 tile pairs, b*nc*g), one warpgroup:
//      G = C B^T for one tile pair of one (batch*chunk, group); M = i, N =
//      j, K = n.  C and B are rows of n, K-major as they land: TMA brings
//      64-row boxes of 32 columns (128-byte swizzle; columns past n arrive
//      as zeros, so K is padded to a multiple of 8 with zeros).  B's tile
//      is split into hi and lo planes in shared memory (elementwise, so
//      TMA's swizzle stays); C's A fragments are split in registers.  The
//      tile is written to a scratch in fragment order ([8][128 threads][4]
//      floats: float4 q of thread t is its D registers 4q .. 4q + 3).  G
//      does not depend on the head, so at g < h this pass computes it once
//      per group (recomputed per head it would add 4.3 GFLOP at the main
//      shape, 26 us of split-TF32 time: as much as the whole bound).  At
//      g = h the same pass runs per head, and its scratch then streams
//      through device memory: half of that shape's time.
//   2. ssd_y_tc<PT>, grid (h * p / PT, b*nc), two warpgroups: Y_diag and
//      the state of one (batch*chunk, head), PT = min(p, 64) of its columns
//      (p = 128 runs as two blocks).  Row tiles go two at a time, one a
//      warpgroup; a step is one 64-row source tile s, walked up to the
//      pair's last row, and the last pair's walk (every source tile) also
//      carries the state, 64 rows of n a warpgroup.  A two-stage TMA /
//      mbarrier ring brings a step's x tile (64 rows of PT, unswizzled), its
//      G tiles (a bulk copy each, as the G pass wrote them) and, for the
//      state, B's 64 x 128 tile.  TF32 has no transposed operand, and x is
//      stored as rows of p (MN-major for both products), so each step stages
//      x^T once for both warpgroups, as hi and lo planes, K-major, 128-byte
//      swizzled; both products read it as their B operand.
//        * Y = (G o L) x: M = i, N = PT, K = j.  A from registers: the G
//          tile's fragment times exp(acum[i] - acum[j]) (0 above the
//          diagonal), then split.  The fragment order fixes K's order
//          within each k8 step: logical k t is source row 2t and t + 4 is
//          2t + 1, as the G pass's D registers hold a row; x^T's columns are
//          staged in that order.
//        * state^T = (B o dec)^T x: M = n, N = PT, K = j, dec = exp(acum[-1]
//          - acum).  A from registers: B's rows read from the swizzled tile,
//          times dec, then split.  The (n, p) accumulator is stored as the
//          (p, n) state.
//      acum is read through L1, so shared memory does not grow with c.
//   What holds it near 0.11 ms at the main shape (PERF.md, PR 26): with
//   no tensor work the pass still takes half its time (TMA waits, the x^T
//   staging, the fragments' exp and splits, two block barriers a step, one
//   block an SM); the wgmmas at full rate would take ~31 us.  Tried and
//   measured slower: one warpgroup a block (18 stagings a head), two row
//   tiles a warpgroup, whole-tile fragments with one commit, a separate
//   state walk, a software-pipelined walk (spills), and multicasting G and
//   B to a cluster of four heads.
//
// Body 2, short chunks (c <= SHORT_MAX: the one-shot serving prefill's c =
// 8, the c = 1 a prompt falls back to), one launch and no scratch:
// ssd_short<P>, grid (h / hb, b*nc), 256 threads, one block for hb heads of
// one group (hb up to HB_MAX, as many as still leave two blocks an SM).
// The block holds its group's B and C rows, computes C B^T once for its
// heads, then per head (G o L), Y_diag and the state, as fp32 FMAs from
// shared memory sized by c.  At c = 8 a head is about 1 MFLOP: latency,
// not arithmetic, sets the time.
//
// Every sum runs in ascending source (or k) order, with no atomics and no
// split K, so a call gives the same bits twice.
//
// Plain C interface for ctypes: one launch function that runs the body it is
// asked for on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TR = 64;        // body 1: rows of a tile (i, j and n alike)
constexpr int NT1 = 128;      // body 1: threads a block (one warpgroup)
constexpr int STAGES = 2;     // body 1: the output pass's TMA ring depth
constexpr int NT2 = 256;      // body 2: threads a block
constexpr int HB_MAX = 8;     // body 2: most heads a block
constexpr int NB = 128;       // largest n
constexpr int SMEM_MAX = 232448;
constexpr int BOX = TR * 32 * 4;   // bytes of one 64-row box of 32 fp32 columns

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The float at (row r, column cc < 32) of a 128-byte-swizzled box of 32-float
// rows, as TMA writes it (the 16-byte chunk index XORed with r % 8).
__device__ __forceinline__ int swz(int r, int cc) {
  return r * 32 + ((((cc >> 2) ^ r) & 7) << 2) + (cc & 3);
}

using hop::split;
using hop::split_step;

// ---------------------------------------------------------------- body 1

// One 64 x 64 tile (rows i of tile r, columns j of tile s <= r) of G = C B^T
// of cell = (batch*chunk)*g + group, into gt[cell * pairs + pair] in
// fragment order: float4 q of thread tid holds its D registers 4q .. 4q + 3.
__global__ void __launch_bounds__(NT1)
ssd_g_tc(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap bmap,
         float4* __restrict__ gt, int g, int n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int nb = (n + 31) / 32;                 // 32-column boxes
  float* cs = reinterpret_cast<float*>(smem);   // [nb] boxes of C's 64 rows
  float* bh = cs + nb * TR * 32;                // B's, split in place into hi
  float* bl = bh + nb * TR * 32;                // and a lo plane
  uint64_t* bar = reinterpret_cast<uint64_t*>(bl + nb * TR * 32);
  int s = blockIdx.x, r = 0;                    // pair index -> (s <= r)
  while (s > r) s -= ++r;
  const int cell = blockIdx.y, bc = cell / g, grp = cell % g;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::fence_barrier_init();
    hop::mbar_expect_tx(bar, 2 * nb * BOX);
    for (int kb = 0; kb < nb; ++kb) {
      hop::tma_load_4d(cs + kb * TR * 32, &cmap, bar, 32 * kb, grp, r * TR, bc);
      hop::tma_load_4d(bh + kb * TR * 32, &bmap, bar, 32 * kb, grp, s * TR, bc);
    }
  }
  __syncthreads();
  hop::mbar_wait(bar, 0);
  for (int i = tid; i < nb * TR * 8; i += NT1) {
    float4 v = reinterpret_cast<float4*>(bh)[i];
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(bh)[i] = h;
    reinterpret_cast<uint4*>(bl)[i] = l;
  }
  hop::fence_proxy_async();
  __syncthreads();
  const int w = tid / 32, gq = (tid % 32) / 4, t = tid % 4, r0 = 16 * w + gq;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  uint32_t ah[2][4], al[2][4];
  const int nk = (n + 7) / 8;
  for (int kk = 0; kk < nk; ++kk) {
    const float* box = cs + (kk / 4) * TR * 32;
    const int cc = 8 * (kk % 4) + t;
    uint32_t(&h)[4] = ah[kk & 1];
    uint32_t(&l)[4] = al[kk & 1];
    split(box[swz(r0, cc)], h[0], l[0]);
    split(box[swz(r0 + 8, cc)], h[1], l[1]);
    split(box[swz(r0, cc + 4)], h[2], l[2]);
    split(box[swz(r0 + 8, cc + 4)], h[3], l[3]);
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    split_step<64>(acc, h, l, hop::desc_sw128(reinterpret_cast<unsigned char*>(bh) + off, 16, 1024),
                   hop::desc_sw128(reinterpret_cast<unsigned char*>(bl) + off, 16, 1024));
    hop::wg_wait<1>();   // the other fragment's group is done
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  float4* out = gt + ((size_t)cell * gridDim.x + blockIdx.x) * 8 * NT1 + tid;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    out[q * NT1] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// The output pass for PT of a head's p columns (PT = p, or 64 of p = 128,
// a block each half): two consumer warpgroups, a group of two output row
// tiles at a time, one a warpgroup.  Shared memory: the ring's stages (B's
// 64 x 128 tile as four swizzled boxes, x's 64 x PT tile, and the two row
// tiles' G tiles as the G pass wrote them) and x^T's hi and lo planes (each
// two swizzled boxes of PT rows); nothing grows with c.
template <int PT>
struct Y1 {
  static constexpr int NT = 256;
  static constexpr int G_BYTES = TR * TR * 4;
  static constexpr int B_BYTES = 4 * BOX;
  static constexpr int X_BYTES = TR * PT * 4;
  static constexpr int STAGE = B_BYTES + X_BYTES + 2 * G_BYTES;
  static constexpr int PLANE = PT * TR * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * PLANE + 8 * STAGES;
  static_assert(SMEM <= SMEM_MAX, "the output pass's shared memory");
};

// Y_diag and the state of one (batch*chunk, head), PT of its columns.  For
// each group of two row tiles, a walk over the source tiles s up to the
// group's last row: each step stages x^T once for both warpgroups, then
// each warpgroup adds the (G o L) x product of its row tile if s is at or
// below it and, in the last group (which walks every source tile), its 64
// rows of state^T.
template <int PT>
__global__ void __launch_bounds__(256, 1)
ssd_y_tc(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
         const float4* __restrict__ gt, const float* __restrict__ acum, float* __restrict__ y,
         float* __restrict__ st, int nc, int c, int h, int g, int p, int n) {
  using S = Y1<PT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* xh = smem + STAGES * S::STAGE;   // x^T hi plane, then lo
  unsigned char* xl = xh + S::PLANE;
  uint64_t* full = reinterpret_cast<uint64_t*>(xl + S::PLANE);
  const int T = (c + TR - 1) / TR;
  const int halves = p / PT, hi = blockIdx.x / halves, c0 = (blockIdx.x % halves) * PT;
  const int bc = blockIdx.y, bi = bc / nc, ci = bc % nc, grp = hi / (h / g);
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const int wl = tw / 32, gq = (tw % 32) / 4, t = tw % 4;
  // acum of the chunk (rows past c take acum[c - 1], so no exp overflows
  // there) and the state's decays exp(acum[c - 1] - acum) (0 past c)
  const float* ab = acum + ((size_t)(bi * h + hi) * nc + ci) * c;
  const float a_last = __ldg(ab + c - 1);
  auto ac = [&](int i) { return __ldg(ab + min(i, c - 1)); };
  auto dec = [&](int j) { return j < c ? expf(a_last - __ldg(ab + j)) : 0.0f; };
  int nsteps = 0;
  for (int g0 = 0; g0 < T; g0 += 2) nsteps += min(g0 + 2, T);
  const int nbox = (n + 31) / 32, pairs = T * (T + 1) / 2;
  const float4* gcell = gt + (size_t)(bc * g + grp) * pairs * (TR * TR / 4);
  // step k -> its group's first row tile g0 and its source tile s
  auto step = [&](int k, int& g0, int& s) {
    for (g0 = 0, s = k; s >= min(g0 + 2, T); g0 += 2) s -= min(g0 + 2, T);
  };
  auto load = [&](int k) {
    int g0, s;
    step(k, g0, s);
    const bool last = g0 + 2 >= T;
    int tiles = 0;
    for (int w = 0; w < 2; ++w) tiles += g0 + w >= s && g0 + w < T;
    unsigned char* stg = smem + (k % STAGES) * S::STAGE;
    uint64_t* bar = &full[k % STAGES];
    hop::mbar_expect_tx(bar, S::X_BYTES + (last ? nbox * BOX : 0) + tiles * S::G_BYTES);
    hop::tma_load_3d(stg + S::B_BYTES, &xmap, bar, hi * p + c0, s * TR, bc);
    if (last)
      for (int bx = 0; bx < nbox; ++bx)
        hop::tma_load_3d(stg + bx * BOX, &bmap, bar, grp * n + 32 * bx, s * TR, bc);
    for (int w = 0; w < 2; ++w) {
      const int r = g0 + w;
      if (r >= s && r < T)
        hop::bulk_load(stg + S::B_BYTES + S::X_BYTES + w * S::G_BYTES,
                       gcell + (size_t)(r * (r + 1) / 2 + s) * (TR * TR / 4), S::G_BYTES, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
    hop::fence_barrier_init();
    for (int k = 0; k < STAGES && k < nsteps; ++k) load(k);
  }
  __syncthreads();

  auto desc = [&](const unsigned char* plane, int kk) {
    return hop::desc_sw128(plane + (kk / 4) * (S::PLANE / 2) + (kk % 4) * 32, 16, 1024);
  };
  // this warpgroup's state rows (n) in the last group: 64 wg .. 64 wg + 63
  const int m0 = 64 * wg + 16 * wl + gq, bx = m0 / 32, cc = m0 % 32;
  const bool has_state = 64 * wg < n;
  float acc[PT / 2], sacc[PT / 2];
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < PT / 2; ++i) sacc[i] = 0.0f;
  int k = 0;
  for (int g0 = 0; g0 < T; g0 += 2) {
    const int r = g0 + wg, i0 = r * TR + 16 * wl + gq, i1 = i0 + 8;
    const bool last = g0 + 2 >= T;
    const float a0 = ac(i0), a1 = ac(i1);
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) acc[i] = 0.0f;
    for (int s = 0; s < min(g0 + 2, T); ++s, ++k) {
      // x^T's planes from the x tile.  Logical column 8q + t of a k8 step q
      // is source row 8q + 2t, and 8q + 4 + t is 8q + 2t + 1 (the order in
      // which the G pass's D registers hold a row): item (pp, q, half) reads
      // rows 8q + 2u + half (u < 4) of column pp and writes one 16-byte
      // chunk of each plane.
      hop::mbar_wait(&full[k % STAGES], (k / STAGES) & 1);
      unsigned char* stg = smem + (k % STAGES) * S::STAGE;
      const float* xr = reinterpret_cast<const float*>(stg + S::B_BYTES);
      for (int it = tid; it < 16 * PT; it += S::NT) {
        const int pp = it % PT, q = it / PT / 2, half = (it / PT) & 1;
        uint4 vh, vl;
        split(xr[(8 * q + half) * PT + pp], vh.x, vl.x);
        split(xr[(8 * q + 2 + half) * PT + pp], vh.y, vl.y);
        split(xr[(8 * q + 4 + half) * PT + pp], vh.z, vl.z);
        split(xr[(8 * q + 6 + half) * PT + pp], vh.w, vl.w);
        const int off = (q / 4) * S::PLANE / 2 + pp * 128 + (((2 * (q % 4) + half) ^ (pp & 7)) << 4);
        *reinterpret_cast<uint4*>(xh + off) = vh;
        *reinterpret_cast<uint4*>(xl + off) = vl;
      }
      hop::fence_proxy_async();
      __syncthreads();
      if (r >= s && r < T) {   // (G o L)[i][j] = G[i][j] exp(acum[i] - acum[j]), j <= i
        const float4* gs =
            reinterpret_cast<const float4*>(stg + S::B_BYTES + S::X_BYTES + wg * S::G_BYTES) + tw;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          // G[i0][j0], G[i0][j1], G[i1][j0], G[i1][j1] -> fragment a0, a2, a1, a3
          const float4 gf = gs[kk * 128];
          const int j0 = s * TR + 8 * kk + 2 * t, j1 = j0 + 1;
          const float b0 = ac(j0), b1 = ac(j1);
          float v0 = gf.x * __expf(a0 - b0), v2 = gf.y * __expf(a0 - b1);
          float v1 = gf.z * __expf(a1 - b0), v3 = gf.w * __expf(a1 - b1);
          if (r == s) {
            v0 = i0 >= j0 ? v0 : 0.0f;
            v2 = i0 >= j1 ? v2 : 0.0f;
            v1 = i1 >= j0 ? v1 : 0.0f;
            v3 = i1 >= j1 ? v3 : 0.0f;
          }
          uint32_t(&fh)[4] = ah[kk & 1];
          uint32_t(&fl)[4] = al[kk & 1];
          split(v0, fh[0], fl[0]);
          split(v1, fh[1], fl[1]);
          split(v2, fh[2], fl[2]);
          split(v3, fh[3], fl[3]);
          split_step<PT>(acc, fh, fl, desc(xh, kk), desc(xl, kk));
          hop::wg_wait<1>();   // the other fragment's group is done
        }
      }
      if (last && has_state) {   // state^T[nn, pp] += sum_j (B[j, nn] dec[j]) x[j, pp]
        const float* bt = reinterpret_cast<const float*>(stg) + bx * TR * 32;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int j0 = 8 * kk + 2 * t, j1 = j0 + 1;
          const float d0 = dec(s * TR + j0), d1 = dec(s * TR + j1);
          uint32_t(&fh)[4] = ah[kk & 1];
          uint32_t(&fl)[4] = al[kk & 1];
          split(bt[swz(j0, cc)] * d0, fh[0], fl[0]);
          split(bt[swz(j0, cc + 8)] * d0, fh[1], fl[1]);
          split(bt[swz(j1, cc)] * d1, fh[2], fl[2]);
          split(bt[swz(j1, cc + 8)] * d1, fh[3], fl[3]);
          split_step<PT>(sacc, fh, fl, desc(xh, kk), desc(xl, kk));
          hop::wg_wait<1>();
        }
      }
      // release the stage and the planes, and refill the stage
      hop::wg_wait<0>();
      __syncthreads();
      if (tid == 0 && k + STAGES < nsteps) load(k + STAGES);
    }
    hop::fence_regs(acc);
    if (r < T) {
      float* yb = y + ((size_t)bc * c * h + hi) * p + c0;
#pragma unroll
      for (int jj = 0; jj < PT / 8; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? i1 : i0;
          if (i < c)
            *reinterpret_cast<float2*>(yb + (size_t)i * h * p + 8 * jj + 2 * t) =
                make_float2(acc[4 * jj + 2 * half], acc[4 * jj + 2 * half + 1]);
        }
    }
  }
  if (!has_state) return;
  hop::fence_regs(sacc);
  float* sb = st + (((size_t)bc * h + hi) * p + c0) * n;
#pragma unroll
  for (int jj = 0; jj < PT / 8; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nn = m0 + 8 * half;
      if (nn < n) {
        const int pp = 8 * jj + 2 * t;
        sb[(size_t)pp * n + nn] = sacc[4 * jj + 2 * half];
        sb[(size_t)(pp + 1) * n + nn] = sacc[4 * jj + 2 * half + 1];
      }
    }
}

// ---------------------------------------------------------------- body 2

// Shared memory of the short body, in floats: B and C rows (stride n
// rounded up to 4, plus 4), C B^T and a head's (G o L) (c x c each), a
// head's x (c x P), acum and the decays.
struct Short {
  int sb, gg, cp;
  __host__ __device__ Short(int c, int n) : sb(round_up(n, 4) + 4), gg(round_up(c * c, 4)), cp(round_up(c, 4)) {}
  __host__ __device__ size_t floats(int c, int P) const {
    return 2 * (size_t)c * sb + 2 * (size_t)gg + (size_t)c * P + 2 * (size_t)cp;
  }
};

template <int P>
__global__ void __launch_bounds__(NT2)
ssd_short(const float* __restrict__ x, const float* __restrict__ B, const float* __restrict__ C,
          const float* __restrict__ acum, float* __restrict__ y, float* __restrict__ st, int nc,
          int c, int h, int g, int n, int hb) {
  extern __shared__ __align__(16) float sm[];
  const Short L(c, n);
  const int sb = L.sb, n4 = sb - 4;
  float* bs = sm;                 // [c][sb] B rows of the group
  float* cs = bs + c * sb;        // [c][sb] C rows
  float* gs = cs + c * sb;        // [c][c] C B^T
  float* as = gs + L.gg;          // [c][c] (G o L) of the head
  float* xs = as + L.gg;          // [c][P] x of the head
  float* ac = xs + c * P;         // [c]
  float* dec = ac + L.cp;         // [c]
  const int tid = threadIdx.x, bc = blockIdx.y, bi = bc / nc, ci = bc % nc;
  const int h0 = blockIdx.x * hb, grp = h0 / (h / g);
  const size_t nrow = (size_t)g * n, xrow = (size_t)h * P;
  const float* Bb = B + (size_t)bc * c * nrow + (size_t)grp * n;
  const float* Cb = C + (size_t)bc * c * nrow + (size_t)grp * n;
  for (int i = tid; i < c * n4; i += NT2) {
    const int r = i / n4, kq = i % n4;
    bs[r * sb + kq] = kq < n ? Bb[(size_t)r * nrow + kq] : 0.0f;
    cs[r * sb + kq] = kq < n ? Cb[(size_t)r * nrow + kq] : 0.0f;
  }
  for (int hh = 0; hh < hb; ++hh) {
    const int hi = h0 + hh;
    const float* ab = acum + ((size_t)(bi * h + hi) * nc + ci) * c;
    const float a_last = ab[c - 1];
    for (int i = tid; i < c; i += NT2) {
      ac[i] = ab[i];
      dec[i] = expf(a_last - ab[i]);
    }
    const float* xb = x + (size_t)bc * c * xrow + (size_t)hi * P;
    for (int i = tid; i < c * P / 4; i += NT2) {
      const int r = i / (P / 4), q = i % (P / 4);
      *reinterpret_cast<float4*>(xs + r * P + 4 * q) =
          *reinterpret_cast<const float4*>(xb + r * xrow + 4 * q);
    }
    __syncthreads();
    if (hh == 0) {   // C B^T over the causal pairs, in ascending k
      for (int o = tid; o < c * c; o += NT2) {
        const int i = o / c, j = o % c;
        float s = 0.0f;
        if (j <= i)
          for (int kq = 0; kq < n4; kq += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + i * sb + kq);
            const float4 bv = *reinterpret_cast<const float4*>(bs + j * sb + kq);
            s = fmaf(cv.x, bv.x, s);
            s = fmaf(cv.y, bv.y, s);
            s = fmaf(cv.z, bv.z, s);
            s = fmaf(cv.w, bv.w, s);
          }
        gs[o] = s;
      }
      __syncthreads();
    }
    for (int o = tid; o < c * c; o += NT2) {
      const int i = o / c, j = o % c;
      as[o] = j <= i ? gs[o] * expf(ac[i] - ac[j]) : 0.0f;
    }
    __syncthreads();
    float* yb = y + (size_t)bc * c * xrow + (size_t)hi * P;
    for (int o = tid; o < c * (P / 4); o += NT2) {
      const int i = o / (P / 4), q = o % (P / 4);
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j <= i; ++j) {
        const float a = as[i * c + j];
        const float4 v = *reinterpret_cast<const float4*>(xs + j * P + 4 * q);
        s.x = fmaf(a, v.x, s.x);
        s.y = fmaf(a, v.y, s.y);
        s.z = fmaf(a, v.z, s.z);
        s.w = fmaf(a, v.w, s.w);
      }
      *reinterpret_cast<float4*>(yb + (size_t)i * xrow + 4 * q) = s;
    }
    // state[pp][nn] = sum_j x[j][pp] (B[j][nn] dec[j]), a 4 x 4 tile a thread
    float* sbh = st + ((size_t)bc * h + hi) * P * n;
    for (int o = tid; o < (P / 4) * (n4 / 4); o += NT2) {
      const int pq = o / (n4 / 4), nq = o % (n4 / 4);
      float s[4][4] = {};
      for (int j = 0; j < c; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + 4 * pq);
        const float4 bv = *reinterpret_cast<const float4*>(bs + j * sb + 4 * nq);
        const float d = dec[j];
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ba[4] = {bv.x * d, bv.y * d, bv.z * d, bv.w * d};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[a][e] = fmaf(ba[e], xa[a], s[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* row = sbh + (size_t)(4 * pq + a) * n + 4 * nq;
        if (n % 4 == 0) {
          *reinterpret_cast<float4*>(row) = make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * nq + e < n) row[e] = s[a][e];
        }
      }
    }
    __syncthreads();   // the head's tiles are consumed before the next one lands
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t bytes, dim3 grid, int threads, cudaStream_t s, Args... args) {
  if (bytes > SMEM_MAX) return -1;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  kernel<<<grid, threads, bytes, s>>>(args...);
  return 0;
}

template <int PT>
int launch_long(const float* x, const float* B, const float* C, const float* acum, float4* gt,
                float* y, float* st, int b, int nc, int c, int h, int g, int p, int n,
                cudaStream_t s) {
  const int T = (c + TR - 1) / TR, nb = (n + 31) / 32;
  const uint64_t bn = (uint64_t)b * nc;
  CUtensorMap cmap, bmap4, xmap, bmap3;
  {   // C and B by group: (n, g, c, b*nc), 64-row boxes of 32 columns
    const uint64_t dims[4] = {(uint64_t)n, (uint64_t)g, (uint64_t)c, bn};
    const uint64_t strides[3] = {4ull * n, 4ull * g * n, 4ull * c * g * n};
    const uint32_t box[4] = {32, 1, TR, 1};
    if (hop::encode_f32_map(&cmap, C, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        hop::encode_f32_map(&bmap4, B, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return -1;
  }
  {   // B as rows of g*n (the state's A rows past n are never stored)
    const uint64_t dims[3] = {(uint64_t)g * n, (uint64_t)c, bn};
    const uint64_t strides[2] = {4ull * g * n, 4ull * c * g * n};
    const uint32_t box[3] = {32, TR, 1};
    if (hop::encode_f32_map(&bmap3, B, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return -1;
  }
  {   // x as rows of h*p, PT columns a box
    const uint64_t dims[3] = {(uint64_t)h * p, (uint64_t)c, bn};
    const uint64_t strides[2] = {4ull * h * p, 4ull * c * h * p};
    const uint32_t box[3] = {PT, TR, 1};
    if (hop::encode_f32_map(&xmap, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -1;
  }
  if (launch(ssd_g_tc, 1024 + 3 * (size_t)nb * BOX + 16, dim3(T * (T + 1) / 2, b * nc * g), NT1,
             s, cmap, bmap4, gt, g, n))
    return -1;
  return launch(ssd_y_tc<PT>, Y1<PT>::SMEM, dim3(h * (p / PT), b * nc), Y1<PT>::NT, s,
                xmap, bmap3, (const float4*)gt, acum, y, st, nc, c, h, g, p, n);
}

template <int P>
int launch_short(const float* x, const float* B, const float* C, const float* acum, float* y,
                 float* st, int b, int nc, int c, int h, int g, int n, cudaStream_t s) {
  // as many heads a block as still leave two blocks for each of 132 SMs
  int hb = 1;
  while (hb * 2 <= HB_MAX && (h / g) % (hb * 2) == 0 && (long long)b * nc * (h / (hb * 2)) >= 264)
    hb *= 2;
  return launch(ssd_short<P>, 4 * Short(c, n).floats(c, P), dim3(h / hb, b * nc), NT2, s, x, B,
                C, acum, y, st, nc, c, h, g, n, hb);
}

}  // namespace

// xc (b,nc,c,h,p), Bc / Cc (b,nc,c,g,n) with g dividing h, A_cumsum
// (b,h,nc,c), Y_diag (b,nc,c,h,p), states (b,nc,h,p,n): contiguous fp32,
// 16-byte aligned.  body 1 (long chunks) takes a scratch G of
// b*nc*g * T(T+1)/2 * 4096 floats, T = ceil(c / 64), and n a multiple of 4;
// body 2 (short chunks) takes no scratch (gt may be null) and any n.  p in
// {16, 32, 64, 128}; n at most 128.  Returns a cudaError_t (0 on success),
// or cudaErrorInvalidValue for a size it does not take.
extern "C" int ssd_intra_chunk_forward(const float* x, const float* B, const float* C,
                                       const float* acum, float* gt, float* y, float* st, int b,
                                       int nc, int c, int h, int g, int p, int n, int body,
                                       void* stream) {
  if (b <= 0 || nc <= 0 || c <= 0 || h <= 0 || g <= 0 || h % g != 0 || n <= 0 || n > NB ||
      h > 65535 || (long long)b * nc > 65535 || (long long)b * nc * g > 65535 ||
      (p != 16 && p != 32 && p != 64 && p != 128) || (body != 1 && body != 2) ||
      (body == 1 && (n % 4 != 0 || gt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* g4 = reinterpret_cast<float4*>(gt);
  int rc;
  if (body == 1) {
    switch (p) {   // p = 128 runs as two blocks of 64 columns
      case 16: rc = launch_long<16>(x, B, C, acum, g4, y, st, b, nc, c, h, g, p, n, s); break;
      case 32: rc = launch_long<32>(x, B, C, acum, g4, y, st, b, nc, c, h, g, p, n, s); break;
      default: rc = launch_long<64>(x, B, C, acum, g4, y, st, b, nc, c, h, g, p, n, s); break;
    }
  } else {
    switch (p) {
      case 16: rc = launch_short<16>(x, B, C, acum, y, st, b, nc, c, h, g, n, s); break;
      case 32: rc = launch_short<32>(x, B, C, acum, y, st, b, nc, c, h, g, n, s); break;
      case 64: rc = launch_short<64>(x, B, C, acum, y, st, b, nc, c, h, g, n, s); break;
      default: rc = launch_short<128>(x, B, C, acum, y, st, b, nc, c, h, g, n, s); break;
    }
  }
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
