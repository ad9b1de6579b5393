// Debug checks of the binary kernels: the counterpart of the Pallas
// kernels' pl.debug_check invariants (compute_engine_tpu/kernels/bgemm.py
// and residual.py), which are compiled out unless pl.enable_debug_checks()
// is on. Here they exist only in a build with -DCE_DEBUG_CHECKS (a library
// of its own, kernels/_build.py); the default build compiles none of this.
//
// No device-side assert: a failed assert leaves the CUDA context unusable,
// so every later call of the process fails. A broken invariant sets its bit
// in an int32 error word in device memory (atomicOr); the wrapper reads and
// clears the word after the launch (ce_debug_end) and raises, naming each
// invariant whose bit is set (kernels/debug.py).
//
// The overrides stand for the accounting bugs the checks guard against, so
// that a test can trip each check on purpose: a declared bit count K (the
// GEMM's total_bits, the block's 9 C) that is not what the kernel swept, and
// a channel count for the bitpacked epilogue's votes that runs past N.

#pragma once

#ifdef CE_DEBUG_CHECKS

#include <cuda_runtime.h>

namespace ce_debug {

enum Bit {
  kGemmBound = 1,      // |t| <= total_bits, t the +-1 sum of one GEMM output
  kSplitKBound = 2,    // the same for a block of K, and for the reduced sum
  kPaddingBits = 4,    // no bit at or beyond N in a bitpacked output word
  kResidualBound = 8,  // |t| <= K = 9 C in the residual block
};

__device__ int error_word;
__device__ int declared_bits;  // 0: the bits the kernel swept
__device__ int vote_n;         // 0: the kernel's own N

__device__ __forceinline__ void fail(int bit) { atomicOr(&error_word, bit); }

// |swept - 2 popc| <= declared (swept by default): the +-1 sum of `swept`
// bits whose xor-popcount is `popc`.
__device__ __forceinline__ void check_bound(int popc, int swept, int bit) {
  const int declared = declared_bits ? declared_bits : swept;
  const int t = swept - 2 * popc;
  if (t > declared || -t > declared) fail(bit);
}

// The N that the bitpacked epilogue votes up to.
__device__ __forceinline__ int votes_up_to(int n) {
  return vote_n ? vote_n : n;
}

}  // namespace ce_debug

// Clears the error word and sets the overrides (0 = none), on `stream`.
extern "C" int ce_debug_begin(int declared_bits, int vote_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int zero = 0;
  cudaError_t e = cudaMemcpyToSymbolAsync(ce_debug::error_word, &zero,
                                          sizeof(int), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(ce_debug::declared_bits, &declared_bits,
                                sizeof(int), 0, cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(ce_debug::vote_n, &vote_n, sizeof(int), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  return (int)e;
}

// Waits for `stream`, returns the error word in *word and clears it and the
// overrides.
extern "C" int ce_debug_end(void* stream, int* word) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyFromSymbolAsync(word, ce_debug::error_word,
                                            sizeof(int), 0,
                                            cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  if (e == cudaSuccess) e = (cudaError_t)ce_debug_begin(0, 0, stream);
  return (int)e;
}

#endif  // CE_DEBUG_CHECKS
