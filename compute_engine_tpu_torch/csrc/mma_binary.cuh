// Tensor-core building blocks shared by the binary kernels (sm_80+ PTX,
// built for sm_90a). No PyTorch header: a source that includes this builds
// in seconds.
//
// A binary dot product on the tensor cores, exact in int32: mma_b1_and is
// mma.sync m16n8k256 on single-bit operands, AND + popcount. The
// xor-popcount that the binary layers are defined by follows from
//   popc(a ^ b) = popc(a) + popc(b) - 2 * popc(a & b),
// so a kernel adds the popcounts of its rows and columns in the epilogue;
// both come from the same unit, as products with an all-ones operand
// (mma_chunk, mma_column_popcounts). Padding bits are 0 in both operands and
// add nothing to any of the three terms: no pad correction. (ptxas for
// sm_90a still takes .xor.popc, but emits two AND MMAs for it.) On an H100
// this MMA does eight times the binary multiply-adds per second of the int8
// one, before the cost of expanding bits to bytes is counted; csrc/mma_rate.cu
// measures both.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k256"; the int8
// m16n8k32 has the same one), with g = lane / 4 and t = lane % 4; "unit" is
// one 32-bit register: 32 bits (one packed word) of K:
//   A (16 x 8 units, row-major):  a0 = A[g][t]      a1 = A[g + 8][t]
//                                 a2 = A[g][t + 4]  a3 = A[g + 8][t + 4]
//   B (8 units x 8, column-major): b0 = B[t][g]     b1 = B[t + 4][g]
//   C (16 x 8 int32): c0 = C[g][2t]      c1 = C[g][2t + 1]
//                     c2 = C[g + 8][2t]  c3 = C[g + 8][2t + 1]

#pragma once

#include <stdint.h>

namespace ce {

// c += popc(A & B) over 256 bits of K.
__device__ __forceinline__ void mma_b1_and(int (&c)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 256-bit step of K for a warp tile of MT x NT MMA tiles: acc += A & B
// popcounts, and pa += row popcounts of A (a product with all-ones columns:
// every column of pa[i] holds the popcount of the row, so a thread finds
// those of its own rows g and g + 8 in pa[i][0] and pa[i][2]).
template <int MT, int NT>
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][NT][4],
                                          int (&pa)[MT][4],
                                          const uint32_t (&a)[MT][4],
                                          const uint32_t (&b)[NT][2]) {
  const uint32_t ones[2] = {~0u, ~0u};
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    mma_b1_and(pa[i], a[i], ones);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_b1_and(acc[i][j], a[i], b[j]);
  }
}

// pb += column popcounts of the B tiles [first, first + NB) of b (a product
// with all-ones rows: pb[jj][0] and pb[jj][1] hold the popcounts of columns
// 2t and 2t + 1 of that tile). `first` is uniform across the warp.
template <int NB, int NT>
__device__ __forceinline__ void mma_column_popcounts(
    int (&pb)[NB][4], const uint32_t (&b)[NT][2], int first) {
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j / NB == first / NB) mma_b1_and(pb[j % NB], ones, b[j]);
}

// 16-byte asynchronous copy global -> shared of which only the first `bytes`
// (0, 4, 8, 12 or 16) are read and the rest is filled with zeros, and the
// plain 4-byte form. Both addresses of the 16-byte form are 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ce
