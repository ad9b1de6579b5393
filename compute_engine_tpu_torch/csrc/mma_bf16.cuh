// bf16 tensor-core building blocks of the float kernels (the stem's and the
// transitions'): mma.sync m16n8k16 with float32 accumulators and the
// ldmatrix loads of its fragments from shared memory; the warpgroup MMA
// (wgmma) and its shared-memory descriptors. No PyTorch header.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4, each register two bf16 values of K:
//   A (16 x 16, row-major):  a0 = A[g][2t..]      a1 = A[g + 8][2t..]
//                            a2 = A[g][2t + 8..]  a3 = A[g + 8][2t + 8..]
//   B (16 x 8, column-major): b0 = B[2t..][g]     b1 = B[2t + 8..][g]
//   C (16 x 8 float32): c0, c1 = C[g][2t], C[g][2t + 1]
//                       c2, c3 = C[g + 8][2t], C[g + 8][2t + 1]

#pragma once

#include <stdint.h>

namespace ce {

// d += a * b on one m16n8k16 tile: bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values from shared memory, each lane giving
// the address of one matrix row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Warpgroup MMA (wgmma, sm_90a): the four warps of a warpgroup multiply a
// 64 x 16 bf16 tile of A by a 16 x N tile of B, both read from shared memory
// through matrix descriptors, into a 64 x N float32 tile in registers, and
// return at once: the product runs while the warps go on. Each warp holds
// rows 16 w .. 16 w + 15 of D in the m16n8 accumulator layout above, one
// n8 tile after the other: d[4 i + 0..1] = D[g][8 i + 2t..],
// d[4 i + 2..3] = D[g + 8][8 i + 2t..].
//
// smem_descriptor: a K-major operand in the 128-byte swizzle (rows of 64
// bf16 values, 128 bytes, each 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), in atoms of 8 rows, 1024 bytes apart, from a 1024-byte
// aligned base). A step of 16 along K moves the start by 32 bytes.
__device__ __forceinline__ uint64_t smem_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |  // start address
         (uint64_t)1 << 16 |                    // leading offset (unused)
         (uint64_t)(1024 >> 4) << 32 |          // 8-row atoms 1024 B apart
         (uint64_t)1 << 62;                     // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The generic proxy's writes to shared memory (cp.async's among them) made
// visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Tells the compiler that the register may have changed here, so that no
// read of an accumulator moves above the wait for the product.
__device__ __forceinline__ void register_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (+)= A * B for a 64 x (16 NT) tile: d = A * B where scale_d is 0.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[8 * NT], uint64_t a,
                                           uint64_t b, int scale_d);

// The wgmma's accumulator operands, eight at a time.
#define CE_P8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define CE_P8_1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define CE_P8_2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define CE_P8_3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define CE_P8_4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define CE_P8_5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define CE_P8_6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define CE_P8_7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define CE_P8_8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define CE_F8(i)                                                     \
  "+f"(d[8 * (i)]), "+f"(d[8 * (i) + 1]), "+f"(d[8 * (i) + 2]),      \
      "+f"(d[8 * (i) + 3]), "+f"(d[8 * (i) + 4]), "+f"(d[8 * (i) + 5]), \
      "+f"(d[8 * (i) + 6]), "+f"(d[8 * (i) + 7])

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[8], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      CE_P8_0
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[16], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float (&d)[24], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[32], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<5>(float (&d)[40], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3 ", "
      CE_P8_4
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3), CE_F8(4)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<6>(float (&d)[48], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3 ", "
      CE_P8_4 ", "
      CE_P8_5
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3), CE_F8(4), CE_F8(5)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<7>(float (&d)[56], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3 ", "
      CE_P8_4 ", "
      CE_P8_5 ", "
      CE_P8_6
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3), CE_F8(4), CE_F8(5), CE_F8(6)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3 ", "
      CE_P8_4 ", "
      CE_P8_5 ", "
      CE_P8_6 ", "
      CE_P8_7
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3), CE_F8(4), CE_F8(5), CE_F8(6),
        CE_F8(7)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<9>(float (&d)[72], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      CE_P8_0 ", "
      CE_P8_1 ", "
      CE_P8_2 ", "
      CE_P8_3 ", "
      CE_P8_4 ", "
      CE_P8_5 ", "
      CE_P8_6 ", "
      CE_P8_7 ", "
      CE_P8_8
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : CE_F8(0), CE_F8(1), CE_F8(2), CE_F8(3), CE_F8(4), CE_F8(5), CE_F8(6),
        CE_F8(7), CE_F8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef CE_F8
#undef CE_P8_0
#undef CE_P8_1
#undef CE_P8_2
#undef CE_P8_3
#undef CE_P8_4
#undef CE_P8_5
#undef CE_P8_6
#undef CE_P8_7
#undef CE_P8_8

}  // namespace ce
