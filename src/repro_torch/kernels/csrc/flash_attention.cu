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
// about 34 MB, 10 us at 3.35 TB/s.  At InternVL2's (2, 2304, 16, 128) the
// products are 44 us and the bytes 23 us; at Nemotron-4-340B's (2, 2048,
// 96, 192) 309 GFLOP, 0.313 ms, and 604 MB, 0.180 ms.  So it is bound by
// operations, and only wgmma reaches the tensor cores' full rate.
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
// bf16 at hd 64, 128 and 192 (the scoring paths: granite, InternVL2,
// Nemotron-4-340B) runs on Hopper's own machinery.  A block owns one (batch*head, 128-query-row)
// tile and is two consumer warpgroups of 64 query rows each, 256 threads.
// There is no producer warpgroup: ptxas gives a 288- or 384-thread block
// 168 registers a thread whatever setmaxnreg asks (measured), too few for
// a consumer's accumulators, and then serializes its wgmmas; at 256
// threads a consumer has 255.  One thread of consumer 1 (whose rows see
// every key tile of the block) issues the TMA copies: the Q tile once,
// then K and V tiles of 64 keys through a four-stage ring (three at hd
// 192, whose 48 KB stages would pass 227 KB at four) with a full and
// an empty mbarrier a stage.  It refills a stage once both consumers have
// released it, so the next three tiles' copies are in flight while one is
// used, and no other thread spends an instruction on a copy.  Tensor maps
// read the (B, S, H, hd) layout in place through its row stride H*hd, in
// 64-column boxes that TMA writes 128-byte swizzled; keys past Sk arrive
// as TMA's zeros and are masked like the causal ones, and query rows past
// Sq are computed from zeros and not stored.  S = Q K^T is wgmma m64n64k16
// with both operands in shared memory (hd / 16 steps).  The online
// softmax runs on the accumulator registers: scores in log2 units with the
// scale folded in (the fp32 product by scale_log2, as the plain version),
// one MUFU.EX2 each, a row's max and sum reduced as a tree over the 16
// values a thread holds and then over the four lanes that hold the row.
// p is rounded to bf16 in registers and is the register A operand of wgmma
// P V (m64n{hd}k16, four steps), with V a transposed (MN-major) B from
// shared memory.  Each tile's PV starts from zero (scale-d 0 on its first
// step) and is added to acc in fp32 as acc * corr + pv in one fma, as the
// plain version adds it; l sums the unrounded p; the output is acc /
// max(l, 1e-30).  The tensor cores' own accumulation thus spans one
// 64-key tile, not thousands of keys.  A consumer issues the next tile's S
// before it runs this tile's softmax, so the tensor cores work while the
// exponentials run; at hd 64 it also waits for the previous tile's P V
// only after the softmax (at hd 128 that would pass 255 registers).  At hd
// 192 a P V over all of hd would hold 96 floats beside acc's 96 and two S
// tiles, past 255 registers, so it runs as three m64n64k16 chains, one
// 64-column chunk of hd each, each folded into acc as acc * corr + pv
// (element by element the whole product's sum and fold) while the next
// chunk's product runs: chunks 0 and 2 land in a 32-float pv, chunk 1 in
// the tile's spent scores; the next tile's S is issued after the softmax,
// into those scores once chunk 1 is folded (wg_step_chunked, no spill;
// with the S issued before the softmax, as at hd 128, ptxas spilled and
// the kernel ran slower).  Tiles
// that cross neither the diagonal nor Sk skip the mask.  A consumer whose
// rows see no key of a tile skips it (it still waits for the tile and
// releases it), and the heaviest query tiles are scheduled first.
//
// bf16 at hd 16 and 32 (the configs' reduced widths and the edge cases,
// no full-width path) keeps the Ampere-generation body: four warps of 32
// query rows, mma.sync.m16n8k16 on ldmatrix fragments, K / V through a
// three-stage cp.async ring, the same arithmetic as above.
//
// fp32 at hd 64, 128 and 192 (the scoring paths in fp32: granite's hd 64,
// InternVL2's hd 128, Nemotron-4-340B's hd 192) runs on the tensor cores
// too, in split TF32 (three
// TF32 wgmmas a product, hopper.cuh): one TF32 product would miss the
// reference's 2e-4 and the plain version's 1e-5, the split meets both.  The
// block is the bf16 body's; K's lo plane (K is its own hi plane) and V^T's
// hi and lo planes (no transposed TF32 operand) come from a small kernel
// before it; at hd 192 K and V^T stream through rings of their own.  The
// section "fp32, split TF32" says how, and why.  fp32 at hd 16 and 32 (reduced
// widths only, no full-width path) keeps the products as fp32 FMAs on CUDA
// cores, in ascending order (64-row blocks, 4 query rows x hd/16 columns a
// thread; scores in log2 units, exp2f), as bf16 keeps mma.sync there.
//
// Bound in fp32 at the scoring shape: 0.257 ms as fp32 FMAs, 0.104 ms in
// split TF32 (three TF32 products at 495 TFLOP/s); InternVL2's 0.649 /
// 0.264 ms; Nemotron-4-340B's 4.61 / 1.874 ms.
//
// Plain C interface for ctypes: one launch function on the caller's stream
// that allocates nothing (the tensor maps are encoded on the host at each
// call; fp32 at hd 64 / 128 / 192 takes its planes' scratch from the caller) and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 1 };

// ------------------------------------------------- fp32 at hd 16 / 32 ----

constexpr int NT = 256;       // threads: 16 x 16, each 4 rows x (HD / 16) columns
constexpr int TS = BQ + 4;    // stride of the transposed q / k / p tiles (16-byte rows)

constexpr int smem_bytes_f32(int hd) { return 4 * (2 * hd * TS + BKV * hd + BKV * TS); }

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int Sq, int Sk,
              float scale_log2) {
  static_assert(HD <= 32, "fp32 at hd 64 and 128 takes flash_fwd_tf32");
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

// hd 16 and 32: each warp owns two m16 tiles of query rows (the K / V
// fragments then serve both), so a block covers 128 rows.
constexpr int MT_TC = 2;
constexpr int BQ_TC = NW * 16 * MT_TC;
__host__ __device__ constexpr int stride_tc(int hd) { return hd + 8; }   // +16 bytes a row
constexpr int KV_STAGES = 3;    // the K / V cp.async ring
constexpr int smem_bytes_bf16(int hd) {
  return 2 * (BQ_TC + 2 * KV_STAGES * BKV) * stride_tc(hd);
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
  static_assert(HD <= 32, "hd 64 and 128 take flash_fwd_wg");
  constexpr int MT = MT_TC;
  constexpr int BQT = BQ_TC;      // query rows per block
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

// ------------------------------------------------- bf16, wgmma + TMA ----

template <typename Kernel>
void allow_smem(Kernel kernel, int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int WG_BQ = 128;           // query rows a block: two consumers of 64
constexpr int WG_THREADS = 256;      // consumer warpgroups 0 and 1
constexpr int WG_CONSUMER_WARPS = 8; // each arrives once on a stage's empty barrier
constexpr int TILE_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 swizzled box

template <int HD>
struct WgSmem {
  static constexpr int CH = HD / 64;                 // 64-column boxes across hd
  static constexpr int KV = CH * TILE_BYTES;         // a K or V tile: [CH][64 keys][64]
  static constexpr int Q = 2 * KV;                   // [consumer][CH][64 rows][64]
  // the K / V ring: four stages, three at hd 192 (four would be 240 KB)
  static constexpr int STAGES = HD <= 128 ? 4 : 3;
  static constexpr int K_OFF = Q;
  static constexpr int V_OFF = Q + STAGES * KV;
  static constexpr int BARS = Q + 2 * STAGES * KV;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;   // + alignment
  static_assert(BYTES <= 232448, "the bf16 flash ring over the card's shared memory");
};

// The columns of hd a P V product spans: all of hd up to 128; 64 at a time
// at hd 192, whose two accumulators of 96 floats would not fit 255
// registers beside the scores.
template <int HD>
constexpr int kPvN = HD <= 128 ? HD : 64;

// S = Q K^T of one key tile (hd / 16 steps), from zero, issued and
// committed; qs and ks are the consumer's Q rows and the tile's K.
template <int HD>
__device__ __forceinline__ void wg_issue_s(float (&sc)[BKV / 2], const unsigned char* qs,
                                           const unsigned char* ks) {
  hop::fence_regs(sc);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
    hop::wgmma_ss<BKV, 0>(sc, hop::desc_sw128(qs + off, 16, 1024),
                          hop::desc_sw128(ks + off, 16, 1024), kk > 0);
  }
  hop::wg_commit();
}

// pv = P V of one key tile from zero over N columns of hd (four steps, P
// from registers, V transposed from shared memory, vs its first 64-column
// box), issued and committed.
template <int N>
__device__ __forceinline__ void wg_issue_pv(float (&pv)[N / 2], uint32_t (&pa)[BKV / 16][4],
                                            const unsigned char* vs) {
  hop::fence_regs(pv);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) hop::fence_regs(pa[kk]);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    hop::wgmma_rs<N, 1>(pv, pa[kk], hop::desc_sw128(vs + kk * 16 * 128, TILE_BYTES, 1024),
                        kk > 0);
  hop::wg_commit();
}

// The max (MAX) or sum of the 16 values of row hr a thread holds in sc
// (sc[4j + 2hr + e]), as a balanced tree.
template <bool MAX>
__device__ __forceinline__ float row_reduce(const float (&sc)[BKV / 2], int hr) {
  float t[BKV / 8];
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
    t[j] = MAX ? fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1])
               : sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
#pragma unroll
  for (int w = BKV / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = MAX ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// The online softmax of one tile on its scores sc (sc[4j + e]: row
// rw + g + 8 (e / 2), key k0 + 8j + 2 t4 + e % 2): scores in log2 units,
// masked keys at NEG_INF, the running max and sum, and p rounded to bf16
// into the A fragments of the PV steps (keys 16 kk .. + 15).
__device__ __forceinline__ void wg_softmax(float (&sc)[BKV / 2], uint32_t (&pa)[BKV / 16][4],
                                           float (&corr)[2], float (&m_run)[2],
                                           float (&l_run)[2], int k0, int rw, int g, int t4,
                                           int shift, int Sk, float scale_log2) {
  if (k0 + BKV - 1 > rw + shift || k0 + BKV > Sk) {   // crosses the diagonal or Sk
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int kpos = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const int qpos = rw + g + 8 * ((i / 2) & 1);
      sc[i] = kpos <= qpos + shift && kpos < Sk ? __fmul_rn(sc[i], scale_log2) : NEG_INF;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
  }
  // a row's 16 values a thread reduced as a tree (short dependency chains)
  float mx[2] = {row_reduce<true>(sc, 0), row_reduce<true>(sc, 1)};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m_run[hr], mx[hr]);
    corr[hr] = fast_exp2(m_run[hr] - m_new);
    m_run[hr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = fast_exp2(sc[i] - m_run[(i / 2) & 1]);
  float sum[2] = {row_reduce<false>(sc, 0), row_reduce<false>(sc, 1)};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    l_run[hr] = l_run[hr] * corr[hr] + sum[hr];   // the unrounded p
  }
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = tc::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// What the thread that issues the copies needs.
struct WgLoads {
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int h, b, n_tiles;
};

// Tile `it`'s K and V into stage it % STAGES.
template <int HD>
__device__ __forceinline__ void wg_load_kv(const WgLoads& ld, int it) {
  using L = WgSmem<HD>;
  const int s = it % L::STAGES;
  hop::mbar_expect_tx(&ld.full[s], 2 * L::KV);
#pragma unroll
  for (int ch = 0; ch < L::CH; ++ch) {
    hop::tma_load_4d(ld.smem + L::K_OFF + s * L::KV + ch * TILE_BYTES, ld.kmap, &ld.full[s],
                     ch * 64, ld.h, it * BKV, ld.b);
    hop::tma_load_4d(ld.smem + L::V_OFF + s * L::KV + ch * TILE_BYTES, ld.vmap, &ld.full[s],
                     ch * 64, ld.h, it * BKV, ld.b);
  }
}

// Once this thread has released tile `done`: the issuing thread waits for
// the other consumer to release it too and refills its stage with tile
// done + STAGES.
template <int HD>
__device__ __forceinline__ void wg_refill(const WgLoads& ld, bool issuer, int done) {
  constexpr int STAGES = WgSmem<HD>::STAGES;
  if (issuer && done + STAGES < ld.n_tiles) {
    hop::mbar_wait(&ld.empty[done % STAGES], (done / STAGES) & 1);
    wg_load_kv<HD>(ld, done + STAGES);
  }
}

// A consumer warpgroup's state across its key tiles.
template <int HD>
struct WgConsumer {
  float acc[HD / 2];
  float pv[kPvN<HD> / 2];   // a tile's P V (over kPvN of hd's columns)
  float corr_prev[2];       // the correction of the tile whose P V is in flight
  float m_run[2], l_run[2];
};

// acc = acc * corr + pv, the plain version's per-tile update, in one fma.
template <int HD>
__device__ __forceinline__ void wg_fold(WgConsumer<HD>& st, const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) st.acc[i] = fmaf(st.acc[i], corr[(i / 2) & 1], st.pv[i]);
}

// acc's 64-column chunk nc of hd = acc * corr + pv, the chunk's P V.
template <int HD>
__device__ __forceinline__ void wg_fold_chunk(float (&acc)[HD / 2], int nc, const float (&corr)[2],
                                              const float (&pv)[BKV / 2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[32 * nc + i] = fmaf(acc[32 * nc + i], corr[(i / 2) & 1], pv[i]);
}

__device__ __forceinline__ void wg_release(uint64_t* empty, int it, int stages) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hop::mbar_arrive(&empty[it % stages]);   // this warp is done
}

// Whether a consumer leaves a tile's P V in flight through the next tile's
// softmax: at hd 64; at hd 128 the two accumulators, two S tiles and the p
// fragments would pass 255 registers (measured: 860 bytes spilled), so the
// P V is waited for at once there.
template <int HD>
constexpr bool kDeferPv = HD <= 64;

// Tile `it` of a consumer, its S complete in cur.  MORE: issue the next
// tile's S into nxt first, so it runs on the tensor cores during this
// tile's softmax.  With kDeferPv the previous tile's P V (none when FIRST)
// is waited for only after the softmax, then folded into acc (acc * corr +
// pv, as the plain version adds it) and its stage released, and this
// tile's P V is issued and left in flight; else this tile's P V is issued,
// waited for and folded at once.  hd 64 and 128; hd 192 takes
// wg_step_chunked.
template <int HD, bool FIRST, bool MORE>
__device__ __forceinline__ void wg_step(WgConsumer<HD>& st, float (&cur)[BKV / 2],
                                        float (&nxt)[BKV / 2], int it, const WgLoads& ld,
                                        bool issuer, const unsigned char* qs, int rw, int g,
                                        int t4, int shift, int Sk, float scale_log2) {
  using L = WgSmem<HD>;
  constexpr int STAGES = L::STAGES;
  unsigned char* smem = ld.smem;
  uint64_t* full = ld.full;
  uint64_t* empty = ld.empty;
  if constexpr (MORE) {
    const int s = (it + 1) % STAGES;
    hop::mbar_wait(&full[s], ((it + 1) / STAGES) & 1);
    wg_issue_s<HD>(nxt, qs, smem + L::K_OFF + s * L::KV);
  }
  uint32_t pa[BKV / 16][4];
  float corr[2];
  wg_softmax(cur, pa, corr, st.m_run, st.l_run, it * BKV, rw, g, t4, shift, Sk, scale_log2);
  const unsigned char* vs = smem + L::V_OFF + (it % STAGES) * L::KV;
  if constexpr (kDeferPv<HD>) {
    if constexpr (!FIRST) {
      if constexpr (MORE) hop::wg_wait<1>();   // the previous P V (committed before the next S)
      else hop::wg_wait<0>();
      hop::fence_regs(st.pv);
      wg_fold<HD>(st, st.corr_prev);
      wg_release(empty, it - 1, STAGES);
      wg_refill<HD>(ld, issuer, it - 1);
    }
    wg_issue_pv<HD>(st.pv, pa, vs);
    if constexpr (MORE) {
      hop::wg_wait<1>();   // the next tile's S
      hop::fence_regs(nxt);
    }
    st.corr_prev[0] = corr[0];
    st.corr_prev[1] = corr[1];
  } else {
    wg_issue_pv<HD>(st.pv, pa, vs);
    hop::wg_wait<0>();
    if constexpr (MORE) hop::fence_regs(nxt);
    hop::fence_regs(st.pv);
    wg_fold<HD>(st, corr);
    wg_release(empty, it, STAGES);
    wg_refill<HD>(ld, issuer, it);
  }
}

// Tile `it` of a consumer at hd 192, its S complete in sc.  P V runs as
// three 64-column chunks of hd, each from zero and folded into acc as acc
// * corr + pv (element by element the whole product's sum and fold).
// sc's scores are spent once p is in pa, so chunk 1 lands in sc, and each
// chunk's fold runs while the next chunk's product does; then (MORE) the
// next tile's S is issued into sc and runs during chunk 2's fold.  There
// is no S in flight through the softmax, as wg_step keeps at hd <= 128:
// acc's 96 floats and a second S tile would pass 255 registers.
template <int HD>
__device__ __forceinline__ void wg_step_chunked(WgConsumer<HD>& st, float (&sc)[BKV / 2], int it,
                                                bool more, const WgLoads& ld, bool issuer,
                                                const unsigned char* qs, int rw, int g, int t4,
                                                int shift, int Sk, float scale_log2) {
  using L = WgSmem<HD>;
  constexpr int STAGES = L::STAGES;
  static_assert(HD == 3 * 64, "P V in three 64-column chunks");
  uint32_t pa[BKV / 16][4];
  float corr[2];
  wg_softmax(sc, pa, corr, st.m_run, st.l_run, it * BKV, rw, g, t4, shift, Sk, scale_log2);
  const unsigned char* vs = ld.smem + L::V_OFF + (it % STAGES) * L::KV;
  wg_issue_pv<64>(st.pv, pa, vs);
  wg_issue_pv<64>(sc, pa, vs + TILE_BYTES);
  hop::wg_wait<1>();   // chunk 0
  hop::fence_regs(st.pv);
  wg_fold_chunk<HD>(st.acc, 0, corr, st.pv);
  wg_issue_pv<64>(st.pv, pa, vs + 2 * TILE_BYTES);
  hop::wg_wait<1>();   // chunk 1
  hop::fence_regs(sc);
  wg_fold_chunk<HD>(st.acc, 1, corr, sc);
  if (more) {
    const int s = (it + 1) % STAGES;
    hop::mbar_wait(&ld.full[s], ((it + 1) / STAGES) & 1);
    wg_issue_s<HD>(sc, qs, ld.smem + L::K_OFF + s * L::KV);
    hop::wg_wait<1>();   // chunk 2; the next tile's S runs on
  } else {
    hop::wg_wait<0>();   // chunk 2
  }
  hop::fence_regs(st.pv);
  wg_fold_chunk<HD>(st.acc, 2, corr, st.pv);
  wg_release(ld.empty, it, STAGES);
  wg_refill<HD>(ld, issuer, it);
  if (more) {
    hop::wg_wait<0>();   // the next tile's S
    hop::fence_regs(sc);
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wg(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int H, int Sq,
             int Sk, float scale_log2) {
  using L = WgSmem<HD>;
  constexpr int CH = L::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;              // [STAGES]
  uint64_t* empty = full + L::STAGES;       // [STAGES]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  const int shift = Sk - Sq;
  const int n_tiles = (min(q0 + WG_BQ, Sq) - 1 + shift) / BKV + 1;
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // consumer c: query rows q0 + 64 c .. + 63; warp w of it rows 16 w .. + 15
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = q0 + 64 * c + 16 * warp;   // the warp's first row
  // these rows see keys up to tile n_my - 1; later tiles are only waited
  // for and released.  Consumer 1 sees every tile of the block, so one of
  // its threads issues the copies.
  const int n_my = (min(q0 + 64 * c + 63, Sq - 1) + shift) / BKV + 1;
  const bool issuer = threadIdx.x == 128;
  const WgLoads ld{&kmap, &vmap, smem, full, empty, h, b, n_tiles};
  if (issuer) {
    hop::prefetch_map(&qmap);
    hop::prefetch_map(&kmap);
    hop::prefetch_map(&vmap);
    hop::mbar_expect_tx(q_full, L::Q);
    for (int cc = 0; cc < 2; ++cc)
      for (int ch = 0; ch < CH; ++ch)
        hop::tma_load_4d(smem + (cc * CH + ch) * TILE_BYTES, &qmap, q_full, ch * 64, h,
                         q0 + 64 * cc, b);
    for (int it = 0; it < min(L::STAGES, n_tiles); ++it) wg_load_kv<HD>(ld, it);
  }
  const unsigned char* qs = smem + c * CH * TILE_BYTES;
  WgConsumer<HD> st;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) st.acc[i] = 0.0f;
  st.m_run[0] = st.m_run[1] = NEG_INF;
  st.l_run[0] = st.l_run[1] = 0.0f;

  hop::mbar_wait(q_full, 0);
  hop::mbar_wait(&full[0], 0);
  float s0[BKV / 2], s1[BKV / 2];
  wg_issue_s<HD>(s0, qs, smem + L::K_OFF);
  hop::wg_wait<0>();
  hop::fence_regs(s0);
#define WG_STEP(FIRST, MORE, CUR, NXT, IT) \
  wg_step<HD, FIRST, MORE>(st, CUR, NXT, IT, ld, issuer, qs, rw, g, t4, shift, Sk, scale_log2)
  if constexpr (kPvN<HD> != HD) {   // hd 192: every tile's S in s0
    for (int it = 0; it < n_my; ++it)
      wg_step_chunked<HD>(st, s0, it, it + 1 < n_my, ld, issuer, qs, rw, g, t4, shift, Sk,
                          scale_log2);
  } else if (n_my == 1) {   // S of tile it is in s0 for even it, s1 for odd it
    WG_STEP(true, false, s0, s1, 0);
  } else {
    WG_STEP(true, true, s0, s1, 0);
    int it = 1;
    for (; it + 2 < n_my; it += 2) {
      WG_STEP(false, true, s1, s0, it);
      WG_STEP(false, true, s0, s1, it + 1);
    }
    if (it + 2 == n_my) {
      WG_STEP(false, true, s1, s0, it);
      WG_STEP(false, false, s0, s1, it + 1);
    } else {
      WG_STEP(false, false, s1, s0, it);
    }
  }
#undef WG_STEP
  if constexpr (kDeferPv<HD>) {
    hop::wg_wait<0>();   // the last tile's P V
    hop::fence_regs(st.pv);
    wg_fold<HD>(st, st.corr_prev);
    wg_release(empty, n_my - 1, L::STAGES);
  }
  for (int it = n_my; it < n_tiles; ++it) {   // consumer 0 only
    hop::mbar_wait(&full[it % L::STAGES], (it / L::STAGES) & 1);
    wg_release(empty, it, L::STAGES);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rw + g + 8 * hr;
    if (r >= Sq) continue;
    const float den = fmaxf(st.l_run[hr], 1e-30f);
    bf16* orow = o + ((size_t)b * Sq + r) * H * HD + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) = __floats2bfloat162_rn(
          st.acc[4 * j + 2 * hr] / den, st.acc[4 * j + 2 * hr + 1] / den);
  }
}

// The tensor map of q, k or v (B, S, H, hd) bf16: 64 x 64 boxes of one
// (batch, head), 128-byte swizzled.
int flash_map(CUtensorMap* map, const void* base, int B, int S, int H, int hd) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)H * hd * 2, (uint64_t)S * H * hd * 2};
  const uint32_t box[4] = {64, 1, 64, 1};
  return hop::encode_bf16_map(map, base, 4, dims, strides, box);
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
              float scale_log2, cudaStream_t s) {
  const int q_tiles = (Sq + WG_BQ - 1) / WG_BQ;
  if (q_tiles > 65535) return -1;
  CUtensorMap qm, km, vm;
  if (flash_map(&qm, q, B, Sq, H, HD) || flash_map(&km, k, B, Sk, H, HD) ||
      flash_map(&vm, v, B, Sk, H, HD))
    return -1;
  constexpr int bytes = WgSmem<HD>::BYTES;
  allow_smem(flash_fwd_wg<HD>, bytes);
  // (batch*head) fastest, so every head's heaviest query tile goes first
  flash_fwd_wg<HD><<<dim3(B * H, q_tiles), WG_THREADS, bytes, s>>>(
      qm, km, vm, static_cast<bf16*>(o), H, Sq, Sk, scale_log2);
  return 0;
}

// ------------------------------------------- fp32, split TF32 on wgmma ----
//
// hd 64, 128 and 192.  The block is the bf16 body's: one (batch*head, 128 query
// rows), two consumer warpgroups of 64 rows, thread 128 issuing the TMA
// copies, K and V tiles through a ring with a full and an empty mbarrier a
// stage.  Every product is split TF32 (hopper.cuh): three TF32 wgmmas a k8
// step on one fp32 accumulator.  TF32 wgmma reads a shared-memory operand
// only K-major and never transposed, so:
//   * S = Q K^T (M = 64 query rows, N = the key tile, K = hd): Q is the A
//     operand from registers, a thread's fragment read from the raw Q tile
//     (TMA-landed, 128-byte swizzled boxes of 32 columns, four conflict-free
//     loads a k8 step) and split there at each key tile (held across the
//     walk it would take 64-128 registers); K, rows of hd, is K-major: K
//     itself (which the tensor cores read truncated to TF32) and its lo
//     plane are the B tiles.
//   * acc += P V (M = 64 rows, N = 64 of hd's columns, K = the key tile): P
//     is the A operand from the S accumulator, split in registers.  A k8
//     step's fragment columns (t, t + 4) are not the accumulator's (2t, 2t
//     + 1), so the key order within each k8 step is taken as the
//     accumulator holds it (logical t is key 2t, t + 4 is key 2t + 1) and V
//     is staged to match: V^T's hi and lo planes, K-major, each 8 keys'
//     columns in that order.  No shuffle.
// The planes of K and V^T are written by a small kernel before the
// attention (flash_kv_planes, one pass over K and V; K and V are their own
// hi planes, which the tensor cores read truncated, so K's lo plane and V^T
// are written), so TMA lands them where wgmma reads them,
// and no block splits or transposes a tile in shared memory or stops both
// consumers at a block barrier to do so; the attention kernel is a
// programmatic dependent launch that loads its Q tile first.  A tile's P V
// starts from zero and is added to acc as acc * corr + pv in one fma (hd
// 128 in two 64-column halves, to keep within 255 registers), scores are in
// log2 units with the scale folded in (the fp32 product by scale_log2), p
// = exp2(s - m), l sums the unrounded p, and the output is acc / max(l,
// 1e-30): the plain version's order.  The tensor cores' truncated sums
// span hd (8 or 16 k8 steps) for S and one key tile for P V, which the
// emulation (tests/test_torch_tf32_split.py) puts within 1e-6 of the plain
// version.  Shared memory: both consumers' raw Q rows and a ring of
// stages, each the tile's K and V^T hi and lo planes: at hd 64, 64-key
// tiles and 3 stages (224 KB); at hd 128, 32-key tiles and 2 stages (192
// KB), since a 64-key stage there would be 128 KB; at hd 192, 32-key tiles
// with K and V^T in rings of their own (flash_fwd_tf32_ring below).
//
// Bound at the scoring shape (2, 2048, 16, 64): the causal pairs' 17.2
// GFLOP are 0.257 ms as fp32 FMAs and 0.104 ms as three TF32 products at
// 495 TFLOP/s; the bytes 0.010 ms.  InternVL2's (2, 2304, 16, 128): 0.649 /
// 0.264 ms.  Nemotron-4-340B's (2, 2048, 96, 192): 4.61 / 1.874 ms.

template <int HD>
struct TfShape {
  static constexpr int BKV = HD == 64 ? 64 : 32;       // keys a tile
  static constexpr int STAGES = HD == 64 ? 3 : 2;      // the K / V ring
  static constexpr int QB = HD / 32;                    // 32-column boxes across hd
  static constexpr int BOX_Q = 64 * 128;                // 64 rows of one box
  static constexpr int Q_CONS = QB * BOX_Q;             // a consumer's raw Q rows
  static constexpr int KPLANE = QB * BKV * 128;         // a tile's K plane: [QB][BKV][32]
  static constexpr int VPLANE = (BKV / 32) * HD * 128;  // a tile's V^T plane: [BKV / 32][HD][32]
  static constexpr int STAGE = 2 * KPLANE + 2 * VPLANE; // K hi, K lo, V^T hi, V^T lo
  static constexpr int K_OFF = 2 * Q_CONS;
  static constexpr int BARS = K_OFF + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;   // + alignment
  static_assert(BYTES <= 232448, "the fp32 flash ring over the card's shared memory");
};

// The float at (row r, column c < 32) of a 128-byte-swizzled box of 32-float
// rows, as TMA writes it (the 16-byte chunk index XORed with r % 8).
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// The max (MAX) or sum of the values of row hr a thread holds in sc
// (sc[4j + 2hr + e]), as a balanced tree.
template <bool MAX, int NS>
__device__ __forceinline__ float tf_row_reduce(const float (&sc)[NS], int hr) {
  float t[NS / 4];
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
    t[j] = MAX ? fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1])
               : sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
#pragma unroll
  for (int w = NS / 8; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = MAX ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// The online softmax of one tile of BK keys on its scores sc (sc[4j + e]:
// row rw + g + 8 (e / 2), key k0 + 8j + 2 t4 + e % 2), as wg_softmax, p left
// in sc in fp32.
template <int BK>
__device__ __forceinline__ void tf_softmax(float (&sc)[BK / 2], float (&corr)[2],
                                           float (&m_run)[2], float (&l_run)[2], int k0, int rw,
                                           int g, int t4, int shift, int Sk, float scale_log2) {
  if (k0 + BK - 1 > rw + shift || k0 + BK > Sk) {   // crosses the diagonal or Sk
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const int qpos = rw + g + 8 * ((i / 2) & 1);
      sc[i] = kpos <= qpos + shift && kpos < Sk ? __fmul_rn(sc[i], scale_log2) : NEG_INF;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
  }
  float mx[2] = {tf_row_reduce<true>(sc, 0), tf_row_reduce<true>(sc, 1)};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m_run[hr], mx[hr]);
    corr[hr] = fast_exp2(m_run[hr] - m_new);
    m_run[hr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = fast_exp2(sc[i] - m_run[(i / 2) & 1]);
  float sum[2] = {tf_row_reduce<false>(sc, 0), tf_row_reduce<false>(sc, 1)};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    l_run[hr] = l_run[hr] * corr[hr] + sum[hr];   // the unrounded p
  }
}

// Q's A fragment of k8 step kk (rows r0 and r0 + 8 of the consumer's 64,
// columns 8 kk + t and + 4), read from the raw Q rows qs (TMA-landed
// 128-byte swizzled boxes of 32 columns, 64 rows a box) and split into
// TF32 hi and lo.
__device__ __forceinline__ void tf_q_fragment(const float* qs, int kk, int r0, int t4,
                                              uint32_t (&fh)[4], uint32_t (&fl)[4]) {
  const float* qb = qs + (kk / 4) * 64 * 32;
  const int cc = 8 * (kk % 4) + t4;
  hop::split(qb[swz32(r0, cc)], fh[0], fl[0]);
  hop::split(qb[swz32(r0 + 8, cc)], fh[1], fl[1]);
  hop::split(qb[swz32(r0, cc + 4)], fh[2], fl[2]);
  hop::split(qb[swz32(r0 + 8, cc + 4)], fh[3], fl[3]);
}

// A consumer's rows of o = acc / max(l, 1e-30) (rows past Sq not stored).
template <int HD>
__device__ __forceinline__ void tf_store(float* __restrict__ o, const float (&acc)[HD / 2],
                                         const float (&l_run)[2], int b, int h, int H, int Sq,
                                         int rw, int g, int t4) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rw + g + 8 * hr;
    if (r >= Sq) continue;
    const float den = fmaxf(l_run[hr], 1e-30f);
    float* orow = o + ((size_t)b * Sq + r) * H * HD + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * t4) =
          make_float2(acc[4 * j + 2 * hr] / den, acc[4 * j + 2 * hr + 1] / den);
  }
}

// acc = acc * corr + P V for one tile of BK keys, its p in sc (split into
// TF32 fragments here), V^T's hi plane at vt and its lo plane VPLANE bytes
// on ([BK / 32][HD][32] each), 64 of hd's columns at a time.
template <int HD, int BK, int VPLANE>
__device__ __forceinline__ void tf_pv(float (&acc)[HD / 2], const float (&sc)[BK / 2],
                                      const float (&corr)[2], const unsigned char* vt) {
  // P's fragments: k8 step j's logical key t is key 8j + 2t, t + 4 is 8j +
  // 2t + 1 (as the accumulator holds them; V^T's columns follow)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    hop::split(sc[4 * j], ph[j][0], pl[j][0]);
    hop::split(sc[4 * j + 2], ph[j][1], pl[j][1]);
    hop::split(sc[4 * j + 1], ph[j][2], pl[j][2]);
    hop::split(sc[4 * j + 3], ph[j][3], pl[j][3]);
    hop::fence_regs(ph[j]);
    hop::fence_regs(pl[j]);
  }
#pragma unroll
  for (int nh = 0; nh < HD / 64; ++nh) {
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pv[i] = 0.0f;
    hop::fence_regs(pv);
    hop::wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const unsigned char* vb = vt + (j / 4) * HD * 128 + nh * 64 * 128 + (j % 4) * 32;
      const uint64_t vh = hop::desc_sw128(vb, 16, 1024);
      const uint64_t vl = hop::desc_sw128(vb + VPLANE, 16, 1024);
      hop::wgmma_rs_tf32<64>(pv, ph[j], vh, 1);
      hop::wgmma_rs_tf32<64>(pv, ph[j], vl, 1);
      hop::wgmma_rs_tf32<64>(pv, pl[j], vh, 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[32 * nh + i] = fmaf(acc[32 * nh + i], corr[(i / 2) & 1], pv[i]);
  }
}

// Tile `it`'s K and V^T planes into stage it % STAGES: K's hi plane (K
// itself) and lo plane, each (B, Sk, H, hd), V^T's (2, B*H, hd, Skp); keys
// past them arrive as zeros.
template <int HD>
__device__ __forceinline__ void tf_load_kv(const CUtensorMap* const (&kmap)[2],
                                           const CUtensorMap* vmap, unsigned char* smem,
                                           uint64_t* full, int it, int b, int h, int B, int H) {
  using L = TfShape<HD>;
  const int s = it % L::STAGES;
  unsigned char* st = smem + L::K_OFF + s * L::STAGE;
  hop::mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int ch = 0; ch < L::QB; ++ch)
      hop::tma_load_4d(st + p * L::KPLANE + ch * L::BKV * 128, kmap[p], &full[s], 32 * ch, h,
                       it * L::BKV, b);
#pragma unroll
    for (int kb = 0; kb < L::BKV / 32; ++kb)
      hop::tma_load_3d(st + 2 * L::KPLANE + p * L::VPLANE + kb * HD * 128, vmap, &full[s],
                       it * L::BKV + 32 * kb, 0, (p * B + b) * H + h);
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap klmap, const __grid_constant__ CUtensorMap vmap,
               float* __restrict__ o, int H, int Sq, int Sk, float scale_log2) {
  using L = TfShape<HD>;
  constexpr int BK = L::BKV, STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;          // [STAGES]
  uint64_t* empty = full + STAGES;      // [STAGES]
  const int B = gridDim.x / H, b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  const int shift = Sk - Sq;
  const int n_tiles = (min(q0 + WG_BQ, Sq) - 1 + shift) / BK + 1;
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // consumer c: query rows q0 + 64 c .. + 63; warp w of it rows 16 w .. + 15
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = q0 + 64 * c + 16 * warp;   // the warp's first row
  // these rows see keys up to tile n_my - 1; later tiles are only waited
  // for and released.  Consumer 1 sees every tile of the block, so one of
  // its threads issues the copies.
  const int n_my = (min(q0 + 64 * c + 63, Sq - 1) + shift) / BK + 1;
  const bool issuer = threadIdx.x == 128;
  const CUtensorMap* km[2] = {&kmap, &klmap};
  if (issuer) {
    hop::prefetch_map(&qmap);
    hop::prefetch_map(&kmap);
    hop::prefetch_map(&klmap);
    hop::prefetch_map(&vmap);
    hop::mbar_expect_tx(q_full, 2 * L::Q_CONS);
    for (int cc = 0; cc < 2; ++cc)
      for (int ch = 0; ch < L::QB; ++ch)
        hop::tma_load_4d(smem + (cc * L::QB + ch) * L::BOX_Q, &qmap, q_full, 32 * ch, h,
                         q0 + 64 * cc, b);
    hop::grid_dependency_wait();   // the planes of K and V^T are written
    for (int it = 0; it < min(STAGES, n_tiles); ++it)
      tf_load_kv<HD>(km, &vmap, smem, full, it, b, h, B, H);
  }
  const float* qs = reinterpret_cast<const float*>(smem + c * L::Q_CONS);
  const int r0 = 16 * warp + g;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};
  hop::mbar_wait(q_full, 0);

  for (int it = 0; it < n_my; ++it) {
    const int s = it % STAGES;
    hop::mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* st = smem + L::K_OFF + s * L::STAGE;
    // S = Q K^T: per k8 step, Q's fragment split in registers (two buffers,
    // one built while the other's products run) against K's planes
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    uint32_t qh[2][4], ql[2][4];
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t(&fh)[4] = qh[kk & 1];
      uint32_t(&fl)[4] = ql[kk & 1];
      tf_q_fragment(qs, kk, r0, t4, fh, fl);
      const int off = (kk / 4) * BK * 128 + (kk % 4) * 32;
      hop::split_step<BK>(sc, fh, fl, hop::desc_sw128(st + off, 16, 1024),
                          hop::desc_sw128(st + L::KPLANE + off, 16, 1024));
      hop::wg_wait<1>();   // the other fragment's products are done
    }
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    float corr[2];
    tf_softmax<BK>(sc, corr, m_run, l_run, it * BK, rw, g, t4, shift, Sk, scale_log2);
    tf_pv<HD, BK, L::VPLANE>(acc, sc, corr, st + 2 * L::KPLANE);
    wg_release(empty, it, STAGES);
    if (issuer && it + STAGES < n_tiles) {
      hop::mbar_wait(&empty[s], (it / STAGES) & 1);
      tf_load_kv<HD>(km, &vmap, smem, full, it + STAGES, b, h, B, H);
    }
  }
  for (int it = n_my; it < n_tiles; ++it) {   // consumer 0 only
    hop::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    wg_release(empty, it, STAGES);
  }

  tf_store<HD>(o, acc, l_run, b, h, H, Sq, rw, g, t4);
}

// hd 192.  There a 32-key stage of K's and V^T's planes is 96 KB, and two
// stages (the fewest that overlap a copy with the products) beside both
// consumers' raw Q rows (96 KB) pass the 227 KB a block may have; a block
// of one consumer would still take 240 KB, and 16-key tiles would halve the
// products a wait.  So K and V^T get rings of their own: S = Q K^T
// accumulates over hd's k8 steps and reads one 32-column box of K at a
// time, so K streams through a four-stage ring of boxes (its hi and lo
// planes, 8 KB a stage) that a consumer releases box by box, and V^T's
// planes (48 KB a tile) through two stages.  Q, the products, the softmax
// and the order of every sum are flash_fwd_tf32's.
template <int HD>
struct TfRing {
  static constexpr int BKV = 32;                        // keys a tile
  static constexpr int QB = HD / 32;                    // 32-column boxes across hd
  static constexpr int BOX_Q = 64 * 128;                // 64 rows of one box
  static constexpr int Q_CONS = QB * BOX_Q;             // a consumer's raw Q rows
  static constexpr int KBOX = BKV * 128;                // a box of a K plane: [BKV][32]
  static constexpr int KSTAGES = 4;                     // K's ring: a box's hi and lo
  static constexpr int VPLANE = (BKV / 32) * HD * 128;  // a tile's V^T plane: [HD][32]
  static constexpr int VSTAGES = 2;                     // V^T's ring: a tile's hi and lo
  static constexpr int V_OFF = 2 * Q_CONS;
  static constexpr int K_OFF = V_OFF + VSTAGES * 2 * VPLANE;
  static constexpr int BARS = K_OFF + KSTAGES * 2 * KBOX;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * VSTAGES + 2 * KSTAGES) + 1024;
  static_assert(BYTES <= 232448, "the fp32 flash rings over the card's shared memory");
};

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_tf32_ring(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap klmap,
                    const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int H,
                    int Sq, int Sk, float scale_log2) {
  using L = TfRing<HD>;
  constexpr int BK = L::BKV, QB = L::QB, KST = L::KSTAGES, VST = L::VSTAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* vfull = q_full + 1;      // [VST]
  uint64_t* vempty = vfull + VST;    // [VST]
  uint64_t* kfull = vempty + VST;    // [KST]
  uint64_t* kempty = kfull + KST;    // [KST]
  unsigned char* vring = smem + L::V_OFF;
  unsigned char* kring = smem + L::K_OFF;
  const int B = gridDim.x / H, b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  const int shift = Sk - Sq;
  const int n_tiles = (min(q0 + WG_BQ, Sq) - 1 + shift) / BK + 1;
  const int n_boxes = n_tiles * QB;   // box j: tile j / QB, hd's columns 32 (j % QB) ..
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < VST; ++s) {
      hop::mbar_init(&vfull[s], 1);
      hop::mbar_init(&vempty[s], WG_CONSUMER_WARPS);
    }
    for (int s = 0; s < KST; ++s) {
      hop::mbar_init(&kfull[s], 1);
      hop::mbar_init(&kempty[s], WG_CONSUMER_WARPS);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // consumer c: query rows q0 + 64 c .. + 63; warp w of it rows 16 w .. + 15
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = q0 + 64 * c + 16 * warp;   // the warp's first row
  // these rows see keys up to tile n_my - 1; later tiles are only waited
  // for and released.  Consumer 1 sees every tile of the block, so one of
  // its threads issues the copies.
  const int n_my = (min(q0 + 64 * c + 63, Sq - 1) + shift) / BK + 1;
  const bool issuer = threadIdx.x == 128;
  const CUtensorMap* km = &kmap;
  const CUtensorMap* klm = &klmap;
  const CUtensorMap* vm = &vmap;
  auto load_k = [&](int box) {   // box's K hi and lo planes into stage box % KST
    const int s = box % KST, it = box / QB, col = 32 * (box % QB);
    unsigned char* dst = kring + s * 2 * L::KBOX;
    hop::mbar_expect_tx(&kfull[s], 2 * L::KBOX);
    hop::tma_load_4d(dst, km, &kfull[s], col, h, it * BK, b);
    hop::tma_load_4d(dst + L::KBOX, klm, &kfull[s], col, h, it * BK, b);
  };
  auto load_v = [&](int it) {    // tile it's V^T hi and lo planes into stage it % VST
    const int s = it % VST;
    unsigned char* dst = vring + s * 2 * L::VPLANE;
    hop::mbar_expect_tx(&vfull[s], 2 * L::VPLANE);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int kb = 0; kb < BK / 32; ++kb)
        hop::tma_load_3d(dst + p * L::VPLANE + kb * HD * 128, vm, &vfull[s], it * BK + 32 * kb,
                         0, (p * B + b) * H + h);
  };
  // This warp is done with K box `box` (V^T tile `it`); the issuing thread
  // waits for the other consumer to be done with it too and refills its
  // stage.
  auto done_k = [&](int box) {
    wg_release(kempty, box, KST);
    if (issuer && box + KST < n_boxes) {
      hop::mbar_wait(&kempty[box % KST], (box / KST) & 1);
      load_k(box + KST);
    }
  };
  auto done_v = [&](int it) {
    wg_release(vempty, it, VST);
    if (issuer && it + VST < n_tiles) {
      hop::mbar_wait(&vempty[it % VST], (it / VST) & 1);
      load_v(it + VST);
    }
  };
  if (issuer) {
    hop::prefetch_map(&qmap);
    hop::prefetch_map(km);
    hop::prefetch_map(klm);
    hop::prefetch_map(vm);
    hop::mbar_expect_tx(q_full, 2 * L::Q_CONS);
    for (int cc = 0; cc < 2; ++cc)
      for (int ch = 0; ch < QB; ++ch)
        hop::tma_load_4d(smem + (cc * QB + ch) * L::BOX_Q, &qmap, q_full, 32 * ch, h,
                         q0 + 64 * cc, b);
    hop::grid_dependency_wait();   // the planes of K and V^T are written
    for (int box = 0; box < min(KST, n_boxes); ++box) load_k(box);
    for (int it = 0; it < min(VST, n_tiles); ++it) load_v(it);
  }
  const float* qs = reinterpret_cast<const float*>(smem + c * L::Q_CONS);
  const int r0 = 16 * warp + g;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};
  hop::mbar_wait(q_full, 0);

  for (int it = 0; it < n_my; ++it) {
    // S = Q K^T as flash_fwd_tf32's, K a box at a time: a box is released
    // once the products of its last k8 step are done (waited for in the
    // next step)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    uint32_t qh[2][4], ql[2][4];
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int box = it * QB + kk / 4;
      if (kk % 4 == 0) hop::mbar_wait(&kfull[box % KST], (box / KST) & 1);
      uint32_t(&fh)[4] = qh[kk & 1];
      uint32_t(&fl)[4] = ql[kk & 1];
      tf_q_fragment(qs, kk, r0, t4, fh, fl);
      const unsigned char* kb = kring + (box % KST) * 2 * L::KBOX + (kk % 4) * 32;
      hop::split_step<BK>(sc, fh, fl, hop::desc_sw128(kb, 16, 1024),
                          hop::desc_sw128(kb + L::KBOX, 16, 1024));
      hop::wg_wait<1>();   // the other fragment's products are done
      if (kk % 4 == 0 && kk > 0) done_k(box - 1);
    }
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    done_k(it * QB + QB - 1);
    float corr[2];
    tf_softmax<BK>(sc, corr, m_run, l_run, it * BK, rw, g, t4, shift, Sk, scale_log2);
    hop::mbar_wait(&vfull[it % VST], (it / VST) & 1);
    tf_pv<HD, BK, L::VPLANE>(acc, sc, corr, vring + (it % VST) * 2 * L::VPLANE);
    done_v(it);
  }
  for (int it = n_my; it < n_tiles; ++it) {   // consumer 0 only
    for (int ch = 0; ch < QB; ++ch) {
      const int box = it * QB + ch;
      hop::mbar_wait(&kfull[box % KST], (box / KST) & 1);
      wg_release(kempty, box, KST);
    }
    hop::mbar_wait(&vfull[it % VST], (it / VST) & 1);
    wg_release(vempty, it, VST);
  }

  tf_store<HD>(o, acc, l_run, b, h, H, Sq, rw, g, t4);
}

// K (B, Sk, H, hd) -> its lo TF32 plane in its layout (hop::tf32_lo: K
// itself is the hi plane, which the tensor cores read truncated), and V ->
// the hi and lo planes of V^T (B*H, hd, Skp), Skp = Sk rounded up to 32,
// keys past Sk zero, each 8 keys' columns in the order flash_fwd_tf32's P
// fragments take them (column 8j + p is key 8j + 2p for p < 4, 8j + 2(p -
// 4) + 1 else); V^T's hi plane is V itself, as K's.  A block is KT keys of
// one (batch, head), read and written 16 bytes a thread; V goes through
// shared memory to be transposed.
template <int HD>
constexpr int kPlaneKeys = HD <= 128 ? 64 : 32;   // 64 keys of hd 192 pass 48 KB of static smem

template <int HD>
__global__ void __launch_bounds__(256)
flash_kv_planes(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ klo,
                float* __restrict__ vtp, int B, int H, int Sk, int Skp) {
  constexpr int KT = kPlaneKeys<HD>;
  __shared__ float tile[KT][HD + 1];
  hop::launch_dependents();
  const int k0 = blockIdx.x * KT, bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int Q4 = HD / 4;   // 16-byte pieces of a key's row
  for (int i = threadIdx.x; i < KT * Q4; i += 256) {
    const int r = i / Q4, c = 4 * (i % Q4), key = k0 + r;
    float4 vv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (key < Sk) {
      const size_t off = (((size_t)b * Sk + key) * H + h) * HD + c;
      const float4 kv = *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<uint4*>(klo + off) =
          make_uint4(hop::tf32_lo(kv.x), hop::tf32_lo(kv.y), hop::tf32_lo(kv.z), hop::tf32_lo(kv.w));
      vv = *reinterpret_cast<const float4*>(v + off);
    }
    tile[r][c] = vv.x;
    tile[r][c + 1] = vv.y;
    tile[r][c + 2] = vv.z;
    tile[r][c + 3] = vv.w;
  }
  __syncthreads();
  // V^T's row d, logical columns 4j .. 4j + 3: keys 8 (j / 2) + (j odd ? 1,
  // 3, 5, 7 : 0, 2, 4, 6)
  const size_t vplane = (size_t)B * H * HD * Skp;
  for (int i = threadIdx.x; i < HD * (KT / 4); i += 256) {
    const int d = i / (KT / 4), j = i % (KT / 4), col = k0 + 4 * j;
    if (col >= Skp) continue;
    const int r = 8 * (j / 2) + (j & 1);
    const float4 a = make_float4(tile[r][d], tile[r + 2][d], tile[r + 4][d], tile[r + 6][d]);
    const size_t off = ((size_t)bh * HD + d) * Skp + col;
    *reinterpret_cast<float4*>(vtp + off) = a;
    *reinterpret_cast<uint4*>(vtp + vplane + off) =
        make_uint4(hop::tf32_lo(a.x), hop::tf32_lo(a.y), hop::tf32_lo(a.z), hop::tf32_lo(a.w));
  }
}

// The tensor map of fp32 (B, S, H, hd) rows (q, or K's planes with B
// counting both): boxes of 32 columns x `rows` positions of one (batch,
// head), 128-byte swizzled.
int flash_map_f32(CUtensorMap* map, const void* base, int B, int S, int H, int hd, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)hd * 4, (uint64_t)H * hd * 4, (uint64_t)S * H * hd * 4};
  const uint32_t box[4] = {32, 1, (uint32_t)rows, 1};
  return hop::encode_f32_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch_tf32(const float* q, const float* k, const float* v, float* o, float* scratch, int B,
                int H, int Sq, int Sk, float scale_log2, cudaStream_t s) {
  constexpr bool RING = HD > 128;   // flash_fwd_tf32_ring, else flash_fwd_tf32
  int bkv;
  if constexpr (RING) bkv = TfRing<HD>::BKV;
  else bkv = TfShape<HD>::BKV;
  const int q_tiles = (Sq + WG_BQ - 1) / WG_BQ;
  const int skp = (Sk + 31) / 32 * 32;
  if (q_tiles > 65535 || (long long)B * H > 65535 || skp / 32 > 65535) return -1;
  float* klo = scratch;
  float* vtp = scratch + (size_t)B * Sk * H * HD;
  CUtensorMap qm, km, klm, vm;
  const uint64_t vdims[3] = {(uint64_t)skp, (uint64_t)HD, 2ull * B * H};
  const uint64_t vstrides[2] = {(uint64_t)skp * 4, (uint64_t)HD * skp * 4};
  const uint32_t vbox[3] = {32, HD, 1};
  if (flash_map_f32(&qm, q, B, Sq, H, HD, 64) || flash_map_f32(&km, k, B, Sk, H, HD, bkv) ||
      flash_map_f32(&klm, klo, B, Sk, H, HD, bkv) ||
      hop::encode_f32_map(&vm, vtp, 3, vdims, vstrides, vbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return -1;
  constexpr int KT = kPlaneKeys<HD>;
  flash_kv_planes<HD><<<dim3((skp + KT - 1) / KT, B * H), 256, 0, s>>>(k, v, klo, vtp, B, H, Sk,
                                                                      skp);
  // (batch*head) fastest, so every head's heaviest query tile goes first
  if constexpr (RING)
    hop::launch_dependent(flash_fwd_tf32_ring<HD>, TfRing<HD>::BYTES, dim3(B * H, q_tiles),
                          WG_THREADS, s, qm, km, klm, vm, o, H, Sq, Sk, scale_log2);
  else
    hop::launch_dependent(flash_fwd_tf32<HD>, TfShape<HD>::BYTES, dim3(B * H, q_tiles),
                          WG_THREADS, s, qm, km, klm, vm, o, H, Sq, Sk, scale_log2);
  return 0;
}

// ------------------------------------------------------------- launches ----

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch, int B,
           int H, int Sq, int Sk, float scale_log2, cudaStream_t s) {
  if (dtype == DT_F32) {
    if constexpr (HD >= 64) {
      return launch_tf32<HD>(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<float*>(o),
                             static_cast<float*>(scratch), B, H, Sq, Sk, scale_log2, s);
    } else {
      const int q_tiles = (Sq + BQ - 1) / BQ;
      if ((long long)B * H > 65535) return -1;
      const int bytes = smem_bytes_f32(HD);
      allow_smem(flash_fwd_f32<HD>, bytes);
      flash_fwd_f32<HD><<<dim3(q_tiles, B * H), NT, bytes, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk, scale_log2);
      return 0;
    }
  }
  if constexpr (HD >= 64) {
    return launch_wg<HD>(q, k, v, o, B, H, Sq, Sk, scale_log2, s);
  } else {
    // (batch*head) fastest, so every head's heaviest query tile goes first
    const int q_tiles_tc = (Sq + BQ_TC - 1) / BQ_TC;
    if (q_tiles_tc > 65535) return -1;
    const int bytes = smem_bytes_bf16(HD);
    allow_smem(flash_fwd_bf16<HD>, bytes);
    flash_fwd_bf16<HD><<<dim3(B * H, q_tiles_tc), NT_TC, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), H, Sq, Sk, scale_log2);
    return 0;
  }
}

}  // namespace

// q (B,Sq,H,hd), k / v (B,Sk,H,hd), o (B,Sq,H,hd), all contiguous and of one
// dtype (0 fp32, 1 bf16), 16-byte aligned but for fp32 at hd 16 / 32; Sk >=
// Sq >= 1; hd in {16, 32, 64, 128, 192}.  fp32 at hd 64 / 128 / 192 takes
// a scratch of B Sk H hd + 2 B H hd Skp floats, Skp = Sk rounded up to 32
// (K's lo plane and V^T's two), 16-byte aligned; else it may be null.  Returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for what it does not
// take.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       void* scratch, int B, int H, int Sq, int Sk, int hd,
                                       int dtype, float scale_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk < Sq || (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                              reinterpret_cast<uintptr_t>(scratch);
  const bool tma = dtype == DT_BF16 || hd >= 64;
  if (tma && addr_bits % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32 && hd >= 64 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (hd) {
    case 16: rc = launch<16>(dtype, q, k, v, o, scratch, B, H, Sq, Sk, scale_log2, s); break;
    case 32: rc = launch<32>(dtype, q, k, v, o, scratch, B, H, Sq, Sk, scale_log2, s); break;
    case 64: rc = launch<64>(dtype, q, k, v, o, scratch, B, H, Sq, Sk, scale_log2, s); break;
    case 128: rc = launch<128>(dtype, q, k, v, o, scratch, B, H, Sq, Sk, scale_log2, s); break;
    case 192: rc = launch<192>(dtype, q, k, v, o, scratch, B, H, Sq, Sk, scale_log2, s); break;
    default: break;
  }
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
