// Rate of the tensor cores at a binary dot product on this card, in binary
// multiply-adds per second: the measurement that the binary kernels' choice
// of the one-bit MMA, and the peak their bound is reckoned against, rest on
// (chip_smoke.py prints it in every run).
//
//  kind 0  int8 mma.sync m16n8k32, operands in registers: the rate of the
//          unit whose peak the data sheet gives, and the most a route that
//          expands bits to +-1 bytes could reach
//  kind 1  one-bit mma.sync m16n8k256 and.popc, operands in registers
//  kind 2  one-bit route as a kernel runs it: a 64 x 64 warp tile, packed
//          words read from shared memory, 32 MMAs per 256 bits of K
//
// Every warp of every block runs the same loop; 8 warps a block, one block
// an SM by default. The accumulators are written out so that nothing is
// optimised away.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_binary.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4096;  // shared-memory words the tile loops read

// c += A * B over 32 int8 values of K.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
rate_kernel(int iters, int* __restrict__ sink) {
  __shared__ uint32_t words[kWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < kWords; i += kThreads)
    words[i] = 0x9E3779B9u * (i + 1) ^ (blockIdx.x << 7);
  __syncthreads();

  int acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  if constexpr (KIND == 0 || KIND == 1) {
    uint32_t a[4], b[2];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = words[tid + 256 * r];
    b[0] = words[tid + 1024];
    b[1] = words[tid + 1280];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (KIND == 0) mma_s8(acc[i][j], a, b);
          else ce::mma_b1_and(acc[i][j], a, b);
        }
    }
  } else {
    // Per 256 bits of K: rows of 8 words; a thread reads words t and t + 4.
    for (int it = 0; it < iters; ++it) {
      const int base = (it * 1024) & (kWords - 1);
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* r0 = words + ((base + (16 * i + g) * 8) & (kWords - 1));
        const uint32_t* r1 = r0 + 64;
        a[i][0] = r0[t];
        a[i][1] = r1[t];
        a[i][2] = r0[t + 4];
        a[i][3] = r1[t + 4];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* c =
            words + ((base + 512 + (8 * j + g) * 8) & (kWords - 1));
        b[j][0] = c[t];
        b[j][1] = c[t + 4];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) ce::mma_b1_and(acc[i][j], a[i], b[j]);
    }
  }

  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s += acc[i][j][r];
  sink[blockIdx.x * kThreads + tid] = s;
}

template <int KIND>
int run(int iters, int blocks, int* sink, float* ms, cudaStream_t s) {
  cudaEvent_t t0, t1;
  cudaError_t e = cudaEventCreate(&t0);
  if (e != cudaSuccess) return (int)e;
  e = cudaEventCreate(&t1);
  if (e != cudaSuccess) return (int)e;
  rate_kernel<KIND><<<blocks, kThreads, 0, s>>>(iters / 8 + 1, sink);  // warm
  cudaEventRecord(t0, s);
  rate_kernel<KIND><<<blocks, kThreads, 0, s>>>(iters, sink);
  cudaEventRecord(t1, s);
  e = cudaEventSynchronize(t1);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventElapsedTime(ms, t0, t1);
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  return (int)e;
}

}  // namespace

// Runs `iters` loop steps (32 MMAs each) in every warp of `blocks` blocks of
// 8 warps and writes the time of that launch to *ms. sink: blocks * 256
// int32 of device scratch. Binary multiply-adds of the launch:
// blocks * 8 * iters * 32 * 16 * 8 * (32 for kind 0, 256 for kinds 1 and 2).
// Returns a cudaError_t value (0 = success).
extern "C" int ce_mma_rate(int kind, int iters, int blocks, void* sink,
                           float* ms, void* stream) {
  if (iters <= 0 || blocks <= 0 || sink == nullptr || ms == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  switch (kind) {
    case 0: return run<0>(iters, blocks, out, ms, s);
    case 1: return run<1>(iters, blocks, out, ms, s);
    case 2: return run<2>(iters, blocks, out, ms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
