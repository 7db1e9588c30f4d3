// Causal flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_kernel (the
// Pallas TPU kernel): o = softmax(q k^T / sqrt(hd), causal) v for q, k, v in
// the (B, S, H, hd) layout with the KV heads already broadcast to H, the
// causal mask right-aligned (key j is visible to query i iff j <= i + Sk - Sq),
// fp32 running max / sum / accumulator, p rounded to v's dtype before the PV
// product, and the output acc / max(l, 1e-30) in q's dtype.
//
// Bound: at the scoring path's shape (B=2, S=2048, H=16, hd=64, bf16) the
// causal half of the two products is about 17 GFLOP, 17 us at the bf16
// tensor-core rate of 989 TFLOP/s; q, k, v read once and o written once are
// about 34 MB, 10 us at 3.35 TB/s.  So it is bound by operations.
//
// Design.  The TPU kernel walks the key tiles as its sequential innermost grid
// axis and keeps m / l / acc in VMEM scratch revisited across grid steps.  On
// the card blocks run in no order, so one block owns one (batch*head, query
// tile) and loops over 64-key tiles itself, up to the tile's diagonal (tiles
// wholly above it are never loaded).  The (B, S, H, hd) layout is read
// in place through its row stride H*hd, and ragged edges are handled in the
// kernel: query rows past Sq are computed and dropped, keys past Sk load as
// zeros and are masked like the causal ones, so nothing is padded.  The
// heaviest query tiles (at the end of the sequence) are scheduled first.
//
// bf16 (the scoring path) runs on the tensor cores: four warps, each owning
// 32 query rows (two m16 tiles, so every K / V fragment serves both; 16 rows
// at hd 128, for registers); a block covers 128 rows (64 at hd 128).  The Q
// tile stays in shared memory for the whole key loop and its fragments are
// read by ldmatrix at each tile, which frees 16 registers a thread.  K and V
// tiles stay bf16 in shared memory (rows padded by 16 bytes, so ldmatrix is
// free of bank conflicts) and arrive through a three-stage cp.async ring:
// the next two tiles' copies are in flight while this one is used, and one
// barrier a tile suffices.  S = Q K^T is mma.sync.m16n8k16 (bf16 in, fp32
// out); the online softmax runs on the accumulator fragments, a row's max
// and sum reduced over the 4 lanes that hold it; p is rounded to bf16 in
// registers and is directly the A operand of the PV mma, with V read by
// ldmatrix.trans.  Each tile's PV starts from zero and is added to acc in
// fp32 (acc * corr + pv, as the plain version adds it, in one fma): the
// tensor cores' fp32 accumulation, which truncates, then spans one 64-key
// tile, not thousands of keys.  Scores are kept in log2 units (the scale
// folded with log2 e, as in the plain version), so p = 2^(s - m) is one
// MUFU.EX2.  A warp whose rows see no key of a tile skips it (an exact
// no-op: 2^(-1e30 - m) == 0).
//
// fp32 keeps the products as fp32 FMAs on CUDA cores, in ascending order
// (64-row blocks, 4 query rows x hd/16 columns a thread; scores in log2
// units, exp2f): the reference's 2e-4 tolerance and the plain version's
// 1e-5 rule out TF32.
//
// Plain C interface for ctypes: one launch function on the caller's stream
// that allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 1 };

// ---------------------------------------------------------------- fp32 ----

constexpr int NT = 256;       // threads: 16 x 16, each 4 rows x (HD / 16) columns
constexpr int TS = BQ + 4;    // stride of the transposed q / k / p tiles (16-byte rows)

constexpr int smem_bytes_f32(int hd) { return 4 * (2 * hd * TS + BKV * hd + BKV * TS); }

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int Sq, int Sk,
              float scale_log2) {
  constexpr int NC = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [HD][TS]  query tile, transposed
  float* ks = qs + HD * TS;     // [HD][TS]  key tile, transposed
  float* vs = ks + HD * TS;     // [BKV][HD] value tile
  float* ps = vs + BKV * HD;    // [BKV][TS] probabilities, transposed
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t row = (size_t)H * HD;   // elements between two positions
  const float* qr = q + (size_t)b * Sq * row + (size_t)h * HD;
  const float* kr = k + (size_t)b * Sk * row + (size_t)h * HD;
  const float* vr = v + (size_t)b * Sk * row + (size_t)h * HD;

  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    qs[d * TS + r] = q0 + r < Sq ? qr[(size_t)(q0 + r) * row + d] : 0.0f;
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int shift = Sk - Sq;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int last = min(q0 + BQ, Sq) - 1 + shift;   // the last key any row here sees
  for (int k0 = 0; k0 <= last; k0 += BKV) {
    __syncthreads();   // the previous tile's k / v / p are consumed
    for (int i = threadIdx.x; i < BKV * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Sk;
      ks[d * TS + r] = in ? kr[(size_t)(k0 + r) * row + d] : 0.0f;
      vs[r * HD + d] = in ? vr[(size_t)(k0 + r) * row + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * TS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ks[d * TS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Online softmax over this tile; a row's 64 scores lie on the 16 lanes
    // that share its ty, so row reductions are xor shuffles inside 16 lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (kpos <= qpos + shift && kpos < Sk) ? __fmul_rn(s[i][j], scale_log2) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        ps[(tx + 16 * j) * TS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ps + kk * TS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float bv = vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(av[i], bv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)b * Sq + r) * row + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------- bf16 ----

using bf16 = __nv_bfloat16;
constexpr int NW = 4;           // warps per block
constexpr int NT_TC = 32 * NW;

// Query rows per warp, in m16 tiles: two up to hd 64 (the K / V fragments
// then serve two tiles), one at hd 128, where two would not fit the
// registers.
__host__ __device__ constexpr int m_tiles(int hd) { return hd <= 64 ? 2 : 1; }
__host__ __device__ constexpr int bq_tc(int hd) { return NW * 16 * m_tiles(hd); }
__host__ __device__ constexpr int stride_tc(int hd) { return hd + 8; }   // +16 bytes a row
constexpr int KV_STAGES = 3;    // the K / V cp.async ring
constexpr int smem_bytes_bf16(int hd) {
  return 2 * (bq_tc(hd) + 2 * KV_STAGES * BKV) * stride_tc(hd);
}

// 2^x as one MUFU.EX2 (flushing results below 2^-126 to zero): for every
// normal result it is what exp2f, and so the plain version's torch.exp2 on
// the card, computes; exp2f would add a denormal fix-up around it.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(NT_TC)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq, int Sk,
               float scale_log2) {
  constexpr int MT = m_tiles(HD);
  constexpr int BQT = bq_tc(HD);  // query rows per block
  constexpr int STR = stride_tc(HD);
  constexpr int CH = HD / 8;      // 16-byte chunks per row
  constexpr int NK = HD / 16;     // k16 steps over hd in S = Q K^T
  constexpr int ND = HD / 8;      // n8 tiles of an output row
  constexpr int NS = BKV / 8;     // n8 tiles of a score row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQT][STR]
  bf16* ks = qs + BQT * STR;                      // [KV_STAGES][BKV][STR]
  bf16* vs = ks + KV_STAGES * BKV * STR;          // [KV_STAGES][BKV][STR]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQT;
  const size_t row = (size_t)H * HD;
  const bf16* qg = q + (size_t)b * Sq * row + (size_t)h * HD;
  const bf16* kg = k + (size_t)b * Sk * row + (size_t)h * HD;
  const bf16* vg = v + (size_t)b * Sk * row + (size_t)h * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int shift = Sk - Sq;

  for (int i = tid; i < BQT * CH; i += NT_TC) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < Sq;
    tc::cp_async16(qs + r * STR + c, in ? qg + (size_t)(q0 + r) * row + c : qg, in);
  }
  auto load_kv = [&](int k0, int buf) {
    for (int i = tid; i < BKV * CH; i += NT_TC) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < Sk;
      const size_t off = (size_t)(k0 + r) * row + c;
      tc::cp_async16(ks + (buf * BKV + r) * STR + c, in ? kg + off : kg, in);
      tc::cp_async16(vs + (buf * BKV + r) * STR + c, in ? vg + off : vg, in);
    }
  };
  // Thread (g, t4) of the warp holds rows rw + 16 mt + g (+ 8) of tile mt.
  const int g = lane / 4, t4 = lane % 4;
  const int rw = q0 + warp * 16 * MT;              // this warp's first query row
  const int warp_last = min(rw + 16 * MT - 1, Sq - 1) + shift;
  const int last = min(q0 + BQT, Sq) - 1 + shift;  // the last key any row here sees
  const int n_tiles = last / BKV + 1;
  load_kv(0, 0);
  tc::cp_async_commit();   // group 0: the Q tile and the first K / V tile
  if (n_tiles > 1) load_kv(BKV, 1);
  tc::cp_async_commit();   // group 1: the second K / V tile (or nothing)

  float acc[MT][ND][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
    m_run[mt][0] = m_run[mt][1] = NEG_INF;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BKV, buf = it % KV_STAGES;
    tc::cp_async_wait<1>();   // this thread's copies of tile `it` (and Q) have landed
    __syncthreads();          // ... everyone's; and tile it-1's buffer is free again
    if (it + 2 < n_tiles) load_kv(k0 + 2 * BKV, (it + 2) % KV_STAGES);
    tc::cp_async_commit();
    if (k0 <= warp_last) {
      // Q's fragments come from shared memory at each tile: held in
      // registers across the loop they would cost 16 more a thread, and
      // registers bound the blocks an SM holds.
      uint32_t qf[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          tc::ldmatrix_x4(qf[mt][kk], qs + (warp * 16 * MT + mt * 16 + lane % 16) * STR +
                                          kk * 16 + (lane / 16) * 8);
      const bf16* kt = ks + buf * BKV * STR;
      const bf16* vt = vs + buf * BKV * STR;
      // S = Q K^T for this tile, from zero (as the plain version's per-tile product).
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kb[4];
          tc::ldmatrix_x4(kb, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * STR + kk * 16 +
                                  ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(s[mt][2 * np], qf[mt][kk], kb[0], kb[1]);
            tc::mma_bf16(s[mt][2 * np + 1], qf[mt][kk], kb[2], kb[3]);
          }
        }
      }

      // Online softmax on the fragments; p rounded to bf16 becomes the A
      // fragments pa of the PV product (keys 16 kt .. 16 kt + 15 each).
      uint32_t pa[MT][BKV / 16][4];
      float corr[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r_lo = rw + mt * 16 + g, r_hi = r_lo + 8;
        // only tiles that cross the diagonal or Sk need the mask
        const bool masked = k0 + BKV - 1 > rw + mt * 16 + shift || k0 + BKV > Sk;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
            const int qpos = e < 2 ? r_lo : r_hi;
            float x = __fmul_rn(s[mt][j][e], scale_log2);
            if (masked && !(kpos <= qpos + shift && kpos < Sk)) x = NEG_INF;
            s[mt][j][e] = x;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], off));
          const float m_new = fmaxf(m_run[mt][hr], mx[hr]);
          corr[mt][hr] = fast_exp2(m_run[mt][hr] - m_new);
          m_run[mt][hr] = m_new;
        }
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][j][e] = fast_exp2(s[mt][j][e] - m_run[mt][e / 2]);
            sum[e / 2] += s[mt][j][e];
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], off);
          l_run[mt][hr] = l_run[mt][hr] * corr[mt][hr] + sum[hr];   // the unrounded p
        }
#pragma unroll
        for (int kt2 = 0; kt2 < BKV / 16; ++kt2) {
          pa[mt][kt2][0] = tc::pack_bf16(s[mt][2 * kt2][0], s[mt][2 * kt2][1]);
          pa[mt][kt2][1] = tc::pack_bf16(s[mt][2 * kt2][2], s[mt][2 * kt2][3]);
          pa[mt][kt2][2] = tc::pack_bf16(s[mt][2 * kt2 + 1][0], s[mt][2 * kt2 + 1][1]);
          pa[mt][kt2][3] = tc::pack_bf16(s[mt][2 * kt2 + 1][2], s[mt][2 * kt2 + 1][3]);
        }
      }

      // acc = acc * corr + P V, 16 output columns at a time.  The tile's
      // PV starts from zero and is added to acc in fp32, as the plain
      // version adds its per-tile product (one fma where it rounds twice):
      // the tensor cores' own accumulation spans one tile, not the keys.
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        float pv[MT][2][4] = {};
#pragma unroll
        for (int kt2 = 0; kt2 < BKV / 16; ++kt2) {
          uint32_t vb[4];
          tc::ldmatrix_x4_trans(vb, vt + (kt2 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * STR +
                                        dp * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(pv[mt][0], pa[mt][kt2], vb[0], vb[1]);
            tc::mma_bf16(pv[mt][1], pa[mt][kt2], vb[2], vb[3]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][2 * dp + jj][e] =
                  fmaf(acc[mt][2 * dp + jj][e], corr[mt][e / 2], pv[mt][jj][e]);
      }
    }
  }
  tc::cp_async_wait<0>();   // only empty groups are left; retire them

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rw + mt * 16 + g + 8 * hr;
      if (r >= Sq) continue;
      const float den = fmaxf(l_run[mt][hr], 1e-30f);
      bf16* orow = o + ((size_t)b * Sq + r) * row + (size_t)h * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) = __floats2bfloat162_rn(
            acc[mt][j][2 * hr] / den, acc[mt][j][2 * hr + 1] / den);
    }
}

// ------------------------------------------------------------- launches ----

template <typename Kernel>
void allow_smem(Kernel kernel, int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int Sk, float scale_log2, cudaStream_t s) {
  if (dtype == DT_F32) {
    const int q_tiles = (Sq + BQ - 1) / BQ;
    if ((long long)B * H > 65535) return -1;
    const int bytes = smem_bytes_f32(HD);
    allow_smem(flash_fwd_f32<HD>, bytes);
    flash_fwd_f32<HD><<<dim3(q_tiles, B * H), NT, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk, scale_log2);
    return 0;
  }
  // (batch*head) fastest, so every head's heaviest query tile goes first
  const int q_tiles_tc = (Sq + bq_tc(HD) - 1) / bq_tc(HD);
  if (q_tiles_tc > 65535) return -1;
  const int bytes = smem_bytes_bf16(HD);
  allow_smem(flash_fwd_bf16<HD>, bytes);
  flash_fwd_bf16<HD><<<dim3(B * H, q_tiles_tc), NT_TC, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Sk, scale_log2);
  return 0;
}

}  // namespace

// q (B,Sq,H,hd), k / v (B,Sk,H,hd), o (B,Sq,H,hd), all contiguous and of one
// dtype (0 fp32, 1 bf16, 16-byte aligned for bf16); Sk >= Sq >= 1; hd in
// {16, 32, 64, 128}.  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Sk, int hd, int dtype,
                                       float scale_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk < Sq || (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (dtype == DT_BF16 && addr_bits % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (hd) {
    case 16: rc = launch<16>(dtype, q, k, v, o, B, H, Sq, Sk, scale_log2, s); break;
    case 32: rc = launch<32>(dtype, q, k, v, o, B, H, Sq, Sk, scale_log2, s); break;
    case 64: rc = launch<64>(dtype, q, k, v, o, B, H, Sq, Sk, scale_log2, s); break;
    case 128: rc = launch<128>(dtype, q, k, v, o, B, H, Sq, Sk, scale_log2, s); break;
    default: break;
  }
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
