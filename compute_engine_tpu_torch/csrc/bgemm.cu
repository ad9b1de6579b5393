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
// What bounds it on this card: the operands are 32x compressed and the
// work is 2 * M * N * 32 * KW operations, which the tensor cores take as
// single-bit products: the one-bit mma.sync.m16n8k256.and.popc runs at
// 5.2e15 binary multiply-adds per second on an H100 (csrc/mma_rate.cu),
// eight times the int8 MMA, which is the most a route that expands the
// words to +-1 bytes could reach. So this kernel keeps the words packed all
// the way into the MMA. At that rate BinaryAlexNet's shapes are bound by
// their bytes or close to it (conv3 and conv4 by operations, narrowly), and
// the products take less time than bringing the tiles from L2 into shared
// memory (K is short: 72 to 288 words), which is what sets the kernel's
// time.
//
// Design:
//  * Inner loop (mma_binary.cuh): T = sum_k popc(A & B) on the tensor cores,
//    exact in int32, and accum = popc(A row) + popc(B column) - 2 T. The two
//    popcounts come from the same unit as products with an all-ones operand:
//    every warp adds those of its own rows, the warps share out the columns
//    and exchange them through shared memory. Padding bits and zero-filled
//    words are 0 in both operands and add nothing to any term.
//  * A block of 4 warps computes a (64 MT) x (8 NT) tile, a warp 16 MT rows
//    of it by all 8 NT columns: 128 x 64 (MT = 2, NT = 8), or 64 x 32 where
//    the larger tile would start fewer blocks than the card has SMs (M = 128:
//    the dense layers).
//  * K runs through a ring of two shared-memory stages of 32 words, filled
//    with cp.async while the MMAs work on the stage before; registers are
//    capped so that three blocks fit an SM. Rows are 36 words apart, so the
//    fragment loads of a warp (8 rows x 4 words) hit 32 banks.
//    Rows are copied 16 bytes at a time whatever KW is (75, 77 and 3 words
//    are not 16-byte multiples): each copy starts at a 16-byte aligned
//    address, the row's words then begin 0 to 3 words into the stage's row,
//    and a thread adds that shift to its fragment addresses. What such copies
//    bring beyond the row's last word belongs to the next row, so fragments
//    are masked beyond K; rows beyond M and columns beyond N are zeros. B is
//    read either as (KW, N), by 4-byte copies, or, without a copy of its
//    own, as the (N, KW) filter, like A.
//  * Blocks that share a tile of A are neighbours in the grid (the N tiles
//    run fastest), so A comes from device memory once.
//  * Epilogue from the MMA fragment (a thread holds channels 2t, 2t + 1 of
//    rows g and g + 8 of every 8-column tile): __fmul_rn then __fadd_rn (no
//    FMA contraction), so the float and int8 outputs equal the plain PyTorch
//    version bit for bit. The bitpacked word of 32 channels is the OR, over
//    the four lanes of a quad, of the bits each holds of four neighbouring
//    tiles (two shuffles), LSB first; channels n >= N vote 0.
//  * Split-K: when KW exceeds the caller's block depth, blockIdx.z takes one
//    block of K (the last one ragged) and writes int32 partial sums; a
//    second kernel adds them in a fixed order, exactly, and runs the same
//    epilogue.
//  * Debug build (-DCE_DEBUG_CHECKS, debug_checks.cuh): the invariants of
//    the Pallas kernels' pl.debug_check, as bits of an error word: every
//    output's +-1 sum is bounded by the bits swept (bgemm.py:225-228); a
//    block of K's, and the reduced sum's, by theirs (the big-K pad count,
//    :284-287); no bit is set at or beyond N in a bitpacked word (the
//    port's analogue of the lane-pack's uint16 range, :173-177, since the
//    words here are ORed, not summed by a matmul). The default build
//    compiles none of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "debug_checks.cuh"
#include "mma_binary.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;            // words of K per shared-memory stage
constexpr int kStride = kBK + 4;   // words between rows of a stage
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;      // blocks an SM should hold (register cap)
constexpr int kColPad = 8;         // (KW, N) operand: pad of a row of columns
constexpr int kMaxDevices = 64;    // cards a process may launch on

enum Kind { kAccum = 0, kFloat = 1, kInt8 = 2, kBitpacked = 3, kPartial = 4 };

struct Epilogue {
  const float* mul;
  const float* bias;
  const int* thr;
  void* out;
  int M, N, cmin, cmax;
#ifdef CE_DEBUG_CHECKS
  int kw;  // words of K, for the reduced sum's bound
#endif
};

// The float transform of one accumulator of channel n.
__device__ __forceinline__ float transform(const Epilogue& e, int acc, int n) {
  const int a2 = min(max(2 * acc, e.cmin), e.cmax);
  return __fadd_rn(__fmul_rn((float)a2, e.mul[n]), e.bias[n]);
}

// One accum / float / int8 output at row m < M, channel n < N.
template <int KIND>
__device__ __forceinline__ void store_one(const Epilogue& e, int acc, int m,
                                          int n) {
  const size_t idx = (size_t)m * e.N + n;
  if constexpr (KIND == kAccum) {
    static_cast<int*>(e.out)[idx] = acc;
  } else if constexpr (KIND == kFloat) {
    static_cast<float*>(e.out)[idx] = transform(e, acc, n);
  } else {
    const float y = transform(e, acc, n);
    float r = y >= 0.f ? floorf(__fadd_rn(y, 0.5f))
                       : ceilf(__fsub_rn(y, 0.5f));
    r = fminf(fmaxf(r, -128.f), 127.f);
    static_cast<int8_t*>(e.out)[idx] = (int8_t)(int)r;
  }
}

__host__ __device__ constexpr int stage_words(int BM, int BN) {
  const int b_n_major = BN * kStride;
  const int b_k_major = kBK * (BN + kColPad);
  return BM * kStride + (b_n_major > b_k_major ? b_n_major : b_k_major);
}

// Rows [row0, row0 + ROWS) of a (rows, KW) operand, words [k0, k0 + kBK),
// into dst[ROWS][kStride] by 4-byte copies (for an operand that is not
// 16-byte aligned); rows >= nrows and words >= k_end become 0.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t* dst, const uint32_t* src,
                                          int row0, int nrows, int KW, int k0,
                                          int k_end, int tid) {
  for (int i = tid; i < ROWS * kBK; i += kThreads) {
    const int r = i / kBK, k = k0 + i % kBK;
    const int row = row0 + r;
    uint32_t* to = dst + r * kStride + (k - k0);
    if (row < nrows && k < k_end)
      ce::cp_async_4(to, src + (size_t)row * KW + k);
    else
      *to = 0u;
  }
}

// Rows [row0, row0 + ROWS) of an (nrows, KW) operand, words from k0 on,
// into dst[ROWS][kStride] by 16-byte copies from 16-byte aligned addresses
// (src is 16-byte aligned): word k of row r lands at
// dst[r * kStride + ((row * KW + k0) & 3) + k - k0], for k - k0 < kBK. Rows
// >= nrows and words beyond the operand's end become 0; the words of the
// copies that lie outside [k0, k_end) of the row are not the row's.
template <int ROWS>
__device__ __forceinline__ void load_rows_shifted(uint32_t* dst,
                                                  const uint32_t* src,
                                                  int row0, int nrows, int KW,
                                                  int k0, int tid) {
  constexpr int kSegs = kStride / 4;
  const long long total = (long long)nrows * KW;
  for (int i = tid; i < ROWS * kSegs; i += kThreads) {
    const int r = i / kSegs, seg = i % kSegs;
    const int row = row0 + r;
    const long long start = (((long long)row * KW + k0) & ~3LL) + 4 * seg;
    const int words =
        row < nrows ? (int)min(max(total - start, 0LL), 4LL) : 0;
    ce::cp_async_16(dst + r * kStride + 4 * seg, words ? src + start : src,
                    4 * words);
  }
}

// Columns [n0, n0 + BN) of a (KW, N) operand, words [k0, k0 + kBK), into
// dst[kBK][BN + kColPad].
template <int BN>
__device__ __forceinline__ void load_columns(uint32_t* dst,
                                             const uint32_t* src, int n0,
                                             int N, int k0, int k_end,
                                             int tid) {
  for (int i = tid; i < kBK * BN; i += kThreads) {
    const int c = i / BN, k = k0 + c, n = n0 + i % BN;
    uint32_t* to = dst + c * (BN + kColPad) + i % BN;
    if (n < N && k < k_end) ce::cp_async_4(to, src + (size_t)k * N + n);
    else *to = 0u;
  }
}

template <int MT, int NT, int KIND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bgemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
             int M, int N, int KW, int block_kw, int b_n_major, int a_vec,
             int b_vec, Epilogue e, int* __restrict__ partial) {
  constexpr int BM = 16 * MT * kWarps, BN = 8 * NT;
  constexpr int NB = NT / kWarps;  // column tiles whose popcounts a warp adds
  constexpr int kStage = stage_words(BM, BN);
  static_assert(NT % 4 == 0 && NB >= 1, "a warp packs words of 32 channels");
  static_assert(kBK % 8 == 0 && kStride == kBK + 4, "whole MMAs; shifted rows");
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int col_pop[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Neighbouring blocks share a tile of A: the N tiles run fastest.
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * BM;
  const int n0 = blockIdx.x % n_tiles * BN;
  const int k_begin = blockIdx.z * block_kw;
  const int k_end = min(KW, k_begin + block_kw);
  const int stages = (k_end - k_begin + kBK - 1) / kBK;

  auto load_stage = [&](int s) {
    uint32_t* sA = smem + (s % kStages) * kStage;
    uint32_t* sB = sA + BM * kStride;
    const int k0 = k_begin + s * kBK;
    if (a_vec) load_rows_shifted<BM>(sA, A, m0, M, KW, k0, tid);
    else load_rows<BM>(sA, A, m0, M, KW, k0, k_end, tid);
    if (!b_n_major) load_columns<BN>(sB, B, n0, N, k0, k_end, tid);
    else if (b_vec) load_rows_shifted<BN>(sB, B, n0, N, KW, k0, tid);
    else load_rows<BN>(sB, B, n0, N, KW, k0, k_end, tid);
  };

  int acc[MT][NT][4], pa[MT][4], pb[NB][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      pa[i][r] = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][r] = 0;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) pb[j][r] = 0;
  }

  // Words into a stage's row at which this thread's rows of A and columns
  // of B begin, after shifted copies. Rows 8 apart share it: 8 KW % 4 == 0.
  const int a_shift =
      a_vec ? ((m0 + warp * 16 * MT + g) * KW + k_begin) & 3 : 0;
  const int b_shift =
      b_n_major && b_vec ? ((n0 + g) * KW + k_begin) & 3 : 0;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load_stage(s);
    ce::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    ce::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is free to refill
    if (s + kStages - 1 < stages) load_stage(s + kStages - 1);
    ce::cp_async_commit();

    const uint32_t* sA = smem + (s % kStages) * kStage;
    const uint32_t* sB = sA + BM * kStride;
    const int left = k_end - k_begin - s * kBK;  // words of K from here on
    const int chunks = min(kBK / 8, (left + 7) / 8);
    for (int c = 0; c < chunks; ++c) {
      uint32_t a[MT][4], b[NT][2];
      const bool lo = 8 * c + t < left, hi = 8 * c + 4 + t < left;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t* r0 = sA + (warp * 16 * MT + 16 * i + g) * kStride +
            a_shift + 8 * c + t;
        a[i][0] = lo ? r0[0] : 0u;
        a[i][1] = lo ? r0[8 * kStride] : 0u;
        a[i][2] = hi ? r0[4] : 0u;
        a[i][3] = hi ? r0[8 * kStride + 4] : 0u;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (b_n_major) {
          const uint32_t* c0 =
              sB + (8 * j + g) * kStride + b_shift + 8 * c + t;
          b[j][0] = lo ? c0[0] : 0u;
          b[j][1] = hi ? c0[4] : 0u;
        } else {
          const uint32_t* c0 = sB + (8 * c + t) * (BN + kColPad) + 8 * j + g;
          b[j][0] = c0[0];
          b[j][1] = c0[4 * (BN + kColPad)];
        }
      }
      ce::mma_chunk<MT, NT>(acc, pa, a, b);
      ce::mma_column_popcounts<NB, NT>(pb, b, warp * NB);
    }
  }

  // Column popcounts: lanes of group 0 hold those of columns 2t, 2t + 1.
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      col_pop[8 * (warp * NB + j) + 2 * t] = pb[j][0];
      col_pop[8 * (warp * NB + j) + 2 * t + 1] = pb[j][1];
    }
  }
  __syncthreads();

  // acc[i][j][r] -> accum of row m0 + 16 (warp MT + i) + g + 8 (r / 2),
  // channel n0 + 8 j + 2 t + (r & 1).
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * (warp * MT + i) + g + 8 * h;
      const int row_pop = pa[i][2 * h];
      if constexpr (KIND == kBitpacked) {
#pragma unroll
        for (int w = 0; w < NT / 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int col = 8 * (4 * w + jj) + 2 * t + q;
              const int n = n0 + col;
              const int x =
                  row_pop + col_pop[col] - 2 * acc[i][4 * w + jj][2 * h + q];
#ifdef CE_DEBUG_CHECKS
              if (m < M && n < N)
                ce_debug::check_bound(x, 32 * KW, ce_debug::kGemmBound);
              if (n < ce_debug::votes_up_to(N) && x > e.thr[min(n, N - 1)])
                word |= 1u << (8 * jj + 2 * t + q);
#else
              if (n < N && x > e.thr[n]) word |= 1u << (8 * jj + 2 * t + q);
#endif
            }
          }
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
#ifdef CE_DEBUG_CHECKS
          const int valid = N - (n0 + 32 * w);  // channels of this word < N
          if (t == 0 && m < M && valid > 0 && valid < 32 && (word >> valid))
            ce_debug::fail(ce_debug::kPaddingBits);
#endif
          if (t == 0 && m < M && n0 + 32 * w < N)
            static_cast<uint32_t*>(e.out)[(size_t)m * ((N + 31) / 32) +
                                          n0 / 32 + w] = word;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 8 * j + 2 * t + q;
            const int n = n0 + col;
            if (m >= M || n >= N) continue;
            const int x = row_pop + col_pop[col] - 2 * acc[i][j][2 * h + q];
#ifdef CE_DEBUG_CHECKS
            if constexpr (KIND == kPartial)
              ce_debug::check_bound(x, 32 * (k_end - k_begin),
                                    ce_debug::kSplitKBound);
            else
              ce_debug::check_bound(x, 32 * KW, ce_debug::kGemmBound);
#endif
            if constexpr (KIND == kPartial)
              partial[((size_t)blockIdx.z * M + m) * N + n] = x;
            else
              store_one<KIND>(e, x, m, n);
          }
        }
      }
    }
  }
}

// Split-K second pass: a warp takes row m and 32 channels, adds the num_k
// partial sums of each channel in order and runs the epilogue; the 32 lanes
// hold 32 consecutive channels, so the bitpacked word is a ballot.
template <int KIND>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const int* __restrict__ partial, int num_k, Epilogue e) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int groups = (e.N + 31) / 32;
  if (gw >= (long long)e.M * groups) return;  // uniform across the warp
  const int m = (int)(gw / groups);
  const int n32 = (int)(gw % groups) * 32;
  const int n = n32 + lane;
  int acc = 0;
  if (n < e.N)
    for (int z = 0; z < num_k; ++z)
      acc += partial[((size_t)z * e.M + m) * e.N + n];
#ifdef CE_DEBUG_CHECKS
  if (n < e.N) ce_debug::check_bound(acc, 32 * e.kw, ce_debug::kSplitKBound);
#endif
  if constexpr (KIND == kBitpacked) {
#ifdef CE_DEBUG_CHECKS
    const unsigned word = __ballot_sync(
        0xffffffffu,
        n < ce_debug::votes_up_to(e.N) && acc > e.thr[min(n, e.N - 1)]);
    const int valid = e.N - n32;
    if (lane == 0 && valid < 32 && (word >> valid))
      ce_debug::fail(ce_debug::kPaddingBits);
#else
    const unsigned word =
        __ballot_sync(0xffffffffu, n < e.N && acc > e.thr[n]);
#endif
    if (lane == 0)
      static_cast<uint32_t*>(e.out)[(size_t)m * groups + n32 / 32] = word;
  } else {
    if (n < e.N) store_one<KIND>(e, acc, m, n);
  }
}

template <int MT, int NT, int KIND>
int launch_tile(const uint32_t* A, const uint32_t* B, int M, int N, int KW,
                int block_kw, int b_n_major, long long plan_blocks,
                int plan_smem_bytes, const Epilogue& e, int* partial,
                cudaStream_t s) {
  constexpr int BM = 16 * MT * kWarps, BN = 8 * NT;
  constexpr int smem = kStages * stage_words(BM, BN) * (int)sizeof(uint32_t);
  const int num_k = (KW + block_kw - 1) / block_kw;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  // The caller owns the launch plan (and holds it to the grid's limits); it
  // must be the one this tile needs.
  if (tiles * num_k != plan_blocks || smem != plan_smem_bytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, num_k);
  // 16-byte copies need a 16-byte aligned operand.
  const int a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int b_vec = reinterpret_cast<uintptr_t>(B) % 16 == 0;
  auto kernel = bgemm_kernel<MT, NT, KIND>;
  // Once per instantiation and device: the attribute is the current
  // device's.
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && !configured[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  kernel<<<grid, kThreads, smem, s>>>(A, B, M, N, KW, block_kw, b_n_major,
                                      a_vec, b_vec, e, partial);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch(const uint32_t* A, const uint32_t* B, int M, int N, int KW,
           int block_kw, int b_n_major, int small_tile, long long blocks,
           int smem_bytes, const Epilogue& e, int* partial, cudaStream_t s) {
  const int num_k = (KW + block_kw - 1) / block_kw;
  if (num_k == 1)
    return small_tile
        ? launch_tile<1, 4, KIND>(A, B, M, N, KW, block_kw, b_n_major, blocks,
                                  smem_bytes, e, nullptr, s)
        : launch_tile<2, 8, KIND>(A, B, M, N, KW, block_kw, b_n_major, blocks,
                                  smem_bytes, e, nullptr, s);
  if (partial == nullptr) return (int)cudaErrorInvalidValue;
  const int err = small_tile
      ? launch_tile<1, 4, kPartial>(A, B, M, N, KW, block_kw, b_n_major, blocks,
                                    smem_bytes, e, partial, s)
      : launch_tile<2, 8, kPartial>(A, B, M, N, KW, block_kw, b_n_major, blocks,
                                    smem_bytes, e, partial, s);
  if (err != 0) return err;
  const long long warps = (long long)M * ((N + 31) / 32);
  const long long reduce_blocks = (warps + 7) / 8;
  if (reduce_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  splitk_reduce_kernel<KIND><<<(unsigned)reduce_blocks, 256, 0, s>>>(
      partial, num_k, e);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 accum (int32 out), 1 float (float32 out), 2 int8, 3 bitpacked
// (int32 words, (m, ceil(n / 32))). b_n_major: b is (n, kw) instead of
// (kw, n). The launch plan is the caller's (kernels/bgemm.py::plan_bgemm):
// small_tile, 64 x 32 output tiles instead of 128 x 64, and the number of
// blocks and the shared-memory bytes that follow, which must be what the
// tile needs. partial: num_k * m * n int32 scratch, needed when
// kw > block_kw.
// Returns a cudaError_t value (0 = success).
extern "C" int ce_bgemm(const void* a, const void* b, const void* mul,
                        const void* bias, const void* thr, void* out,
                        void* partial, int m, int n, int kw, int block_kw,
                        int b_n_major, int small_tile, long long blocks,
                        int smem_bytes, int kind, int clamp_min,
                        int clamp_max, void* stream) {
  if (m < 0 || n < 0 || kw <= 0 || block_kw <= 0 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  if ((kind == kFloat || kind == kInt8) && (mul == nullptr || bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == kBitpacked && thr == nullptr) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  Epilogue e{static_cast<const float*>(mul), static_cast<const float*>(bias),
             static_cast<const int*>(thr), out, m, n, clamp_min, clamp_max};
#ifdef CE_DEBUG_CHECKS
  e.kw = kw;
#endif
  const uint32_t* A = static_cast<const uint32_t*>(a);
  const uint32_t* B = static_cast<const uint32_t*>(b);
  int* P = static_cast<int*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kAccum:
      return launch<kAccum>(A, B, m, n, kw, block_kw, b_n_major, small_tile,
                            blocks, smem_bytes, e, P, s);
    case kFloat:
      return launch<kFloat>(A, B, m, n, kw, block_kw, b_n_major, small_tile,
                            blocks, smem_bytes, e, P, s);
    case kInt8:
      return launch<kInt8>(A, B, m, n, kw, block_kw, b_n_major, small_tile,
                           blocks, smem_bytes, e, P, s);
    default:
      return launch<kBitpacked>(A, B, m, n, kw, block_kw, b_n_major,
                                small_tile, blocks, smem_bytes, e, P, s);
  }
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
