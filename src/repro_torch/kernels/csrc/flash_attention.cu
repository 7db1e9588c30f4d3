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
// the card blocks run in no order, so one block owns one (batch*head, 64-row
// query tile) and loops over the key tiles itself, up to the tile's diagonal
// (tiles wholly above it are never loaded); m / l / acc live in registers,
// 4 query rows x (hd / 16) columns per thread.  The (B, S, H, hd) layout is
// read in place through its row stride H*hd, and ragged edges are masked in
// the kernel: query rows past Sq are computed and dropped, keys past Sk load
// as zeros and are masked like the causal ones, so nothing is padded.  The
// heaviest query tiles (at the end of the sequence) are scheduled first.  The
// products run as fp32 FMAs on CUDA cores, in ascending order, so the fp32
// path stays within the reference's 2e-4 tolerance; that leaves the kernel
// far above its tensor-core bound.  mma / wgmma with TMA-fed tiles are the
// next step.
//
// Plain C interface for ctypes: one launch function on the caller's stream
// that allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int NT = 256;       // threads: 16 x 16, each 4 rows x (HD / 16) columns
constexpr int TS = BQ + 4;    // stride of the transposed q / k / p tiles (16-byte rows)
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> struct Elem {
  using raw = float;
  static __device__ __forceinline__ float f32(raw v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ T out(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  using raw = unsigned short;
  static __device__ __forceinline__ float f32(raw v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) { return __float2bfloat16_rn(v); }
};

constexpr int smem_bytes(int hd) { return 4 * (2 * hd * TS + BKV * hd + BKV * TS); }

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int Sq, int Sk, float scale) {
  constexpr int NC = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [HD][TS]  query tile, transposed
  float* ks = qs + HD * TS;     // [HD][TS]  key tile, transposed
  float* vs = ks + HD * TS;     // [BKV][HD] value tile
  float* ps = vs + BKV * HD;    // [BKV][TS] probabilities, transposed
  using raw = typename Elem<T>::raw;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t row = (size_t)H * HD;   // elements between two positions
  const raw* qr = reinterpret_cast<const raw*>(q) + (size_t)b * Sq * row + (size_t)h * HD;
  const raw* kr = reinterpret_cast<const raw*>(k) + (size_t)b * Sk * row + (size_t)h * HD;
  const raw* vr = reinterpret_cast<const raw*>(v) + (size_t)b * Sk * row + (size_t)h * HD;

  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    qs[d * TS + r] = q0 + r < Sq ? Elem<T>::f32(qr[(size_t)(q0 + r) * row + d]) : 0.0f;
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
      ks[d * TS + r] = in ? Elem<T>::f32(kr[(size_t)(k0 + r) * row + d]) : 0.0f;
      vs[r * HD + d] = in ? Elem<T>::f32(vr[(size_t)(k0 + r) * row + d]) : 0.0f;
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
        s[i][j] = (kpos <= qpos + shift && kpos < Sk) ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(tx + 16 * j) * TS + ty * 4 + i] = Elem<T>::round(p);
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
    T* orow = o + ((size_t)b * Sq + r) * row + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = Elem<T>::out(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
           int Sk, float scale, cudaStream_t s) {
  const int bytes = smem_bytes(HD);
  auto kernel = flash_fwd<T, HD>;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, bytes, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk,
                                 scale);
  return 0;
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
              int Sq, int Sk, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Sq, Sk, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, scale, s);
    default: return -1;
  }
}

}  // namespace

// q (B,Sq,H,hd), k / v (B,Sk,H,hd), o (B,Sq,H,hd), all contiguous and of one
// dtype (0 fp32, 1 bf16); Sk >= Sq >= 1; hd in {16, 32, 64, 128}.  Returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Sk, int hd, int dtype,
                                       float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk < Sq || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == DT_F32)
    rc = launch_hd<float>(hd, q, k, v, o, B, H, Sq, Sk, scale, s);
  else if (dtype == DT_BF16)
    rc = launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Sq, Sk, scale, s);
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
