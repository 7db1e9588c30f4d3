// Capacity dispatch and combine of the MoE block for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference moves token rows into the (E, C, d)
// capacity buffer and back with XLA's one-hot einsums (repro/models/moe.py:
// "tec,td->ecd" and the combine's product), which multiply by zeros to move
// T k rows: O(T E C d) work.  On the card those products ran as a CUDA-core
// fp32 SGEMM and fp32 mask copies, ~270 of a 297 ms granite scoring call
// (PERF.md).  These two kernels move the rows themselves, from the
// tables that models/moe.py's dispatch_tables builds:
//
//   moe_gather_rows   xe[r, :] = x[idx[r], :] for the E*C capacity rows r,
//                     a zero row where idx[r] == T (an empty row).  A
//                     straight copy, so the bits are the one-hot einsum's,
//                     whose one non-zero term is x * 1.  The copy does not
//                     read the dtype: a row is moved as words of 16 bytes
//                     where the row width and both pointers allow, else of 8,
//                     4 or 2 bytes.
//   moe_combine_rows  out[t, :] = dtype(sum_i ye[rows[t, i], :] * w[t, i]),
//                     token t's k choices in the ascending expert order of
//                     the tables, each product rounded, then added from zero
//                     in that order (__fmul_rn / __fadd_rn, so nvcc cannot
//                     contract them into an FMA), the fp32 sum rounded once
//                     to the model dtype (bf16 or fp32).  Row E*C marks a
//                     choice past capacity: it adds 0 * w, as the plain
//                     version (kernels/moe_dispatch.py::scatter_combine) does,
//                     so the output is that version's bits.  No atomics: a
//                     token's bits depend only on its own k choices, never on
//                     its capacity rows or on who shares the batch (the batch
//                     invariance the engine's drop-free serving needs).
//
// Bound: both are far below the ~295 FLOP a byte where the tensor cores would
// limit, so bytes bound them.  At the scoring shape (T 4096, E 32, C 1280,
// k 8, d 1024, bf16) a layer's gather reads at most 67 MB and writes 84 MB
// (~45 us at 3.35 TB/s), the combine reads 134 MB of fp32 rows and writes
// 8 MB (~42 us).  Design: one 128-thread block a stripe of rows (the gather:
// 4 capacity rows, the combine: 1 token) by 128 words of columns, every
// thread's loads issued before its stores or adds, so each thread keeps
// 4 (gather) or k (combine) loads in flight; neighbouring threads on
// neighbouring words.  Launched on the caller's stream with no host sync,
// so the serving segments capture them into their CUDA graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // threads a block: words of a row stripe
constexpr int GATHER_ROWS = 4; // capacity rows a gather block copies

template <typename VT>
__global__ void __launch_bounds__(THREADS)
    moe_gather_rows(const VT* __restrict__ x, const int64_t* __restrict__ idx,
                    VT* __restrict__ xe, long long rows, long long T, int words) {
  const int w = blockIdx.y * THREADS + threadIdx.x;
  if (w >= words) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * GATHER_ROWS;
  VT v[GATHER_ROWS];
#pragma unroll
  for (int i = 0; i < GATHER_ROWS; ++i) {
    v[i] = VT{};
    const long long r = r0 + i;
    if (r < rows) {
      const int64_t t = idx[r];
      if (t >= 0 && t < T) v[i] = x[t * words + w];
    }
  }
#pragma unroll
  for (int i = 0; i < GATHER_ROWS; ++i)
    if (r0 + i < rows) xe[(r0 + i) * words + w] = v[i];
}

template <int N>
struct Floats;
template <>
struct Floats<4> {
  using T = float4;
  static __device__ void add(float* acc, const float4& v, float w) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(v.x, w));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(v.y, w));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(v.z, w));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(v.w, w));
  }
};
template <>
struct Floats<1> {
  using T = float;
  static __device__ void add(float* acc, float v, float w) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(v, w));
  }
};

template <int N>
__device__ inline void store(float* out, const float* acc) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    out[0] = acc[0];
}

template <int N>
__device__ inline void store(__nv_bfloat16* out, const float* acc) {
  if constexpr (N == 4) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
    o[0] = __floats2bfloat162_rn(acc[0], acc[1]);
    o[1] = __floats2bfloat162_rn(acc[2], acc[3]);
  } else {
    out[0] = __float2bfloat16_rn(acc[0]);
  }
}

// N fp32 columns a thread (4: float4 loads where d and ye allow, else 1).
template <int N, typename OutT>
__global__ void __launch_bounds__(THREADS)
    moe_combine_rows(const float* __restrict__ ye, const int64_t* __restrict__ rows,
                     const float* __restrict__ wts, OutT* __restrict__ out, int k,
                     long long EC, int d) {
  using VT = typename Floats<N>::T;
  const int w = blockIdx.y * THREADS + threadIdx.x;
  if (w * N >= d) return;
  const long long t = blockIdx.x;
  const int64_t* rt = rows + t * k;
  const float* wt = wts + t * k;
  const VT* y = reinterpret_cast<const VT*>(ye);
  const long long words = d / N;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  int i = 0;
  for (; i + 4 <= k; i += 4) {   // four choices' loads in flight, then their adds
    VT v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = rt[i + j];
      v[j] = (r >= 0 && r < EC) ? y[r * words + w] : VT{};
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Floats<N>::add(acc, v[j], wt[i + j]);
  }
  for (; i < k; ++i) {
    const int64_t r = rt[i];
    const VT v = (r >= 0 && r < EC) ? y[r * words + w] : VT{};
    Floats<N>::add(acc, v, wt[i]);
  }
  store<N>(out + t * d + static_cast<long long>(w) * N, acc);
}

template <typename VT>
int launch_gather(const void* x, const int64_t* idx, void* xe, long long rows, long long T,
                  long long row_bytes, cudaStream_t s) {
  const long long words = row_bytes / static_cast<long long>(sizeof(VT));
  const long long gx = (rows + GATHER_ROWS - 1) / GATHER_ROWS;
  const long long gy = (words + THREADS - 1) / THREADS;
  if (gx > 2147483647LL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  moe_gather_rows<VT><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), THREADS, 0,
                        s>>>(static_cast<const VT*>(x), idx, static_cast<VT*>(xe), rows, T,
                             static_cast<int>(words));
  return 0;
}

template <int N, typename OutT>
int launch_combine(const float* ye, const int64_t* rows, const float* w, void* out, int T, int k,
                   long long EC, int d, cudaStream_t s) {
  const long long gy = (d / N + THREADS - 1) / THREADS;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  moe_combine_rows<N, OutT><<<dim3(T, static_cast<unsigned>(gy)), THREADS, 0, s>>>(
      ye, rows, w, static_cast<OutT*>(out), k, EC, d);
  return 0;
}

bool aligned(const void* p, long long n) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(n) == 0;
}

}  // namespace

// xe (rows, row_bytes) from x (T, row_bytes) through idx (rows) int64; any
// element type (the wrapper passes bf16 or fp32 rows).
extern "C" int moe_gather_rows_forward(const void* x, const int64_t* idx, void* xe,
                                       long long rows, long long T, long long row_bytes,
                                       void* stream) {
  if (rows < 0 || T < 0 || row_bytes < 0 || row_bytes % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (row_bytes % 16 == 0 && aligned(x, 16) && aligned(xe, 16))
    rc = launch_gather<uint4>(x, idx, xe, rows, T, row_bytes, s);
  else if (row_bytes % 8 == 0 && aligned(x, 8) && aligned(xe, 8))
    rc = launch_gather<uint2>(x, idx, xe, rows, T, row_bytes, s);
  else if (row_bytes % 4 == 0 && aligned(x, 4) && aligned(xe, 4))
    rc = launch_gather<uint32_t>(x, idx, xe, rows, T, row_bytes, s);
  else
    rc = launch_gather<uint16_t>(x, idx, xe, rows, T, row_bytes, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// out (T, d) in out_dtype (0 fp32, 1 bf16) from ye (EC, d) fp32 through rows
// (T, k) int64 and weights w (T, k) fp32.
extern "C" int moe_combine_rows_forward(const float* ye, const int64_t* rows, const float* w,
                                        void* out, int T, int k, long long EC, int d,
                                        int out_dtype, void* stream) {
  if (T < 0 || k < 0 || EC < 0 || d < 0 || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out_bytes = out_dtype == 0 ? 4 : 2;
  const bool vec = d % 4 == 0 && aligned(ye, 16) && aligned(out, 4 * out_bytes);
  int rc;
  if (out_dtype == 0)
    rc = vec ? launch_combine<4, float>(ye, rows, w, out, T, k, EC, d, s)
             : launch_combine<1, float>(ye, rows, w, out, T, k, EC, d, s);
  else
    rc = vec ? launch_combine<4, __nv_bfloat16>(ye, rows, w, out, T, k, EC, d, s)
             : launch_combine<1, __nv_bfloat16>(ye, rows, w, out, T, k, EC, d, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
