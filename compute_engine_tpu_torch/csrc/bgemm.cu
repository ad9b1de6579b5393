// Binary GEMM on packed words with a fused output transform, for Hopper
// (sm_90a):
//   accum[m][n] = sum_k popcount(A[m][k] ^ B[k][n])
// then, by output kind: raw int32 accumulators; float
// clip(2 * accum, cmin, cmax) * mul[n] + bias[n]; that value rounded half away
// from zero and clipped to int8; or bitpacked words, bit n set where
// accum > thr[n].
//
// Replaces: compute_engine_tpu/kernels/bgemm.py::_bgemm_kernel (one pass over
// K) and ::_bgemm_kernel_bigk (K split across grid steps into an accumulator).
// The Pallas kernels unpack the words to +-1 int8 planes and contract them on
// the MXU; their K-major LHS, the weight strip unpacked once per N strip and
// the f32 lane-pack matmuls of the bitpacked epilogue are TPU layout choices
// and are not copied.
//
// What bounds it on this card: counted as 2 * M * N * 32 * KW int8-equivalent
// operations, BinaryAlexNet's GEMMs are bound by operations on the tensor
// cores, not by bytes (the operands are 32x compressed). This first design
// runs on the CUDA cores instead: one 32-bit popcount stands for 32
// multiply-adds, and the popcount unit (16 results per clock per SM) is what
// limits it. Binary tensor-core products are later work.
//
// Design:
//  * A block computes a 64 x 64 output tile with 256 threads; warp w owns
//    rows 8w .. 8w + 7 of the tile and lane l the columns l and 32 + l, so
//    each thread keeps 8 x 2 int32 accumulators in registers and the 32
//    lanes of a warp always hold 32 consecutive output channels of a row.
//  * K is staged through shared memory 32 words at a time: the A tile as
//    [row][word] (a warp reads one word of one row: a broadcast), the B tile
//    as [word][column] (a warp reads 32 consecutive columns), each padded by
//    one word so that the transposing stores hit 32 different banks. B is
//    read either as (KW, N) or, without a copy, as the (N, KW) filter itself.
//  * Words beyond K, rows beyond M and columns beyond N load as 0. Padding
//    bits are 0 in both operands, so a zero word pair adds nothing: no pad
//    correction is needed, unlike the +-1 planes of the Pallas kernel.
//  * Epilogue: __fmul_rn then __fadd_rn (no FMA contraction), so the float
//    and int8 outputs equal the plain PyTorch version bit for bit. The
//    bitpacked word of 32 channels is __ballot_sync(~0u, accum > thr): lane l
//    is bit l, LSB first, and channels n >= N vote 0.
//  * Split-K: when KW exceeds the caller's block depth, blockIdx.z takes one
//    block of K (the last one ragged) and writes int32 partial sums; a
//    second kernel adds them in a fixed order, exactly, and runs the same
//    epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;              // rows per thread
constexpr int kTN = 2;              // 32-column groups per thread
constexpr int kBM = kWarps * kTM;   // 64 rows per block
constexpr int kBN = 32 * kTN;       // 64 columns per block
constexpr int kBK = 32;             // words per shared-memory stage

enum Kind { kAccum = 0, kFloat = 1, kInt8 = 2, kBitpacked = 3, kPartial = 4 };

struct Epilogue {
  const float* mul;
  const float* bias;
  const int* thr;
  void* out;
  int M, N, cmin, cmax;
};

// One output of row m, channel n32 + lane. The 32 lanes of a warp call it
// together with the same m and n32 (the bitpacked form votes).
template <int KIND>
__device__ __forceinline__ void store(const Epilogue& e, int acc, int m,
                                      int n32, int lane) {
  const int n = n32 + lane;
  const bool ok = m < e.M && n < e.N;
  if constexpr (KIND == kBitpacked) {
    const unsigned word = __ballot_sync(0xffffffffu, ok && acc > e.thr[n]);
    if (lane == 0 && m < e.M && n32 < e.N) {
      const int words = (e.N + 31) / 32;
      static_cast<uint32_t*>(e.out)[(size_t)m * words + n32 / 32] = word;
    }
    return;
  }
  if (!ok) return;
  const size_t idx = (size_t)m * e.N + n;
  if constexpr (KIND == kAccum) {
    static_cast<int*>(e.out)[idx] = acc;
    return;
  }
  const int a2 = min(max(2 * acc, e.cmin), e.cmax);
  const float y = __fadd_rn(__fmul_rn((float)a2, e.mul[n]), e.bias[n]);
  if constexpr (KIND == kFloat) {
    static_cast<float*>(e.out)[idx] = y;
  } else {
    float r = y >= 0.f ? floorf(__fadd_rn(y, 0.5f))
                       : ceilf(__fsub_rn(y, 0.5f));
    r = fminf(fmaxf(r, -128.f), 127.f);
    static_cast<int8_t*>(e.out)[idx] = (int8_t)(int)r;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
bgemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
             int M, int N, int KW, int block_kw, int b_n_major, Epilogue e,
             int* __restrict__ partial) {
  __shared__ uint32_t sA[kBM][kBK + 1];
  __shared__ uint32_t sB[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * block_kw;
  const int k_end = min(KW, k_begin + block_kw);

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // A tile: a warp loads 32 consecutive words of one row.
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      sA[r][c] = (m < M && k < k_end) ? A[(size_t)m * KW + k] : 0u;
    }
    if (b_n_major) {
      // B is the (N, KW) filter: a warp loads 32 words of one column.
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int n = n0 + r, k = k0 + c;
        sB[c][r] = (n < N && k < k_end) ? B[(size_t)n * KW + k] : 0u;
      }
    } else {
      // B is (KW, N): a warp loads 32 consecutive columns of one word row.
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int c = i / kBN, r = i % kBN;
        const int n = n0 + r, k = k0 + c;
        sB[c][r] = (n < N && k < k_end) ? B[(size_t)k * N + n] : 0u;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      uint32_t a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = sA[warp * kTM + i][c];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = sB[c][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + warp * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n32 = n0 + 32 * j;
      if constexpr (KIND == kPartial) {
        const int n = n32 + lane;
        if (m < M && n < N)
          partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      } else {
        store<KIND>(e, acc[i][j], m, n32, lane);
      }
    }
  }
}

// Split-K second pass: warp w takes row m and 32 channels, adds the
// num_k partial sums of each channel in order and runs the epilogue.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const int* __restrict__ partial, int num_k, Epilogue e) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int groups = (e.N + 31) / 32;
  if (gw >= (long long)e.M * groups) return;  // uniform across the warp
  const int m = (int)(gw / groups);
  const int n32 = (int)(gw % groups) * 32;
  const int n = n32 + lane;
  int acc = 0;
  if (n < e.N)
    for (int z = 0; z < num_k; ++z)
      acc += partial[((size_t)z * e.M + m) * e.N + n];
  store<KIND>(e, acc, m, n32, lane);
}

template <int KIND>
int launch(const uint32_t* A, const uint32_t* B, int M, int N, int KW,
           int block_kw, int b_n_major, const Epilogue& e, int* partial,
           cudaStream_t s) {
  const int num_k = (KW + block_kw - 1) / block_kw;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, num_k);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (num_k == 1) {
    bgemm_kernel<KIND><<<grid, kThreads, 0, s>>>(A, B, M, N, KW, block_kw,
                                                 b_n_major, e, nullptr);
    return (int)cudaGetLastError();
  }
  if (partial == nullptr) return (int)cudaErrorInvalidValue;
  bgemm_kernel<kPartial><<<grid, kThreads, 0, s>>>(A, B, M, N, KW, block_kw,
                                                   b_n_major, e, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)M * ((N + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  splitk_reduce_kernel<KIND><<<(unsigned)blocks, kThreads, 0, s>>>(
      partial, num_k, e);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 accum (int32 out), 1 float (float32 out), 2 int8, 3 bitpacked
// (int32 words, (m, ceil(n / 32))). b_n_major: b is (n, kw) instead of
// (kw, n). partial: num_k * m * n int32 scratch, needed when kw > block_kw.
// Returns a cudaError_t value (0 = success).
extern "C" int ce_bgemm(const void* a, const void* b, const void* mul,
                        const void* bias, const void* thr, void* out,
                        void* partial, int m, int n, int kw, int block_kw,
                        int b_n_major, int kind, int clamp_min, int clamp_max,
                        void* stream) {
  if (m < 0 || n < 0 || kw <= 0 || block_kw <= 0 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  if ((kind == kFloat || kind == kInt8) && (mul == nullptr || bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == kBitpacked && thr == nullptr) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const Epilogue e{static_cast<const float*>(mul),
                   static_cast<const float*>(bias),
                   static_cast<const int*>(thr), out, m, n, clamp_min,
                   clamp_max};
  const uint32_t* A = static_cast<const uint32_t*>(a);
  const uint32_t* B = static_cast<const uint32_t*>(b);
  int* P = static_cast<int*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kAccum:
      return launch<kAccum>(A, B, m, n, kw, block_kw, b_n_major, e, P, s);
    case kFloat:
      return launch<kFloat>(A, B, m, n, kw, block_kw, b_n_major, e, P, s);
    case kInt8:
      return launch<kInt8>(A, B, m, n, kw, block_kw, b_n_major, e, P, s);
    default:
      return launch<kBitpacked>(A, B, m, n, kw, block_kw, b_n_major, e, P, s);
  }
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
