// bf16 tensor-core building blocks shared by the kernels' bf16 paths:
// cp.async copies into shared memory (16 bytes a thread, zero-filled when
// the source lies outside the tensor), ldmatrix loads of 8x8 bf16 tiles
// into mma fragments, and mma.sync.m16n8k16 with fp32 accumulation.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), with g = lane / 4
// and t = lane % 4:
//   A (16 x 16, row-major):  a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                            a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9]
//   B (16 x 8, k x n):       b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..+9][g]
//   C (16 x 8, fp32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// Two bf16 values share a 32-bit register, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without passing through registers; when
// !valid nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i.
// Plain: thread gets row lane/4, columns 2(lane%4)..+1 of each tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// Transposed: thread gets rows 2(lane%4)..+1 of column lane/4 of each tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on one 16 x 8 x 16 tile, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round two floats to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
