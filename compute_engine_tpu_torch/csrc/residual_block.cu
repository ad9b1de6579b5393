// Fused binary residual block for Hopper (sm_90a):
//   out = x + cast(clip(2 * acc, cmin, cmax) * mul + bias)
// where acc is the xor-popcount accumulator of the 3x3, stride-1, one-padded
// binary convolution of sign(x) (sign(0) = +1) with a bitpacked filter.
//
// Replaces: compute_engine_tpu/kernels/residual.py::_block_kernel (a Pallas
// TPU kernel that signs the tile in VMEM, builds the 9-tap matrix and
// contracts +-1 int8 operands on the MXU).
//
// What bounds it on this card: at QuickNet's shapes the block moves the bf16
// activation in and out once (bytes) and does 2 * 9 * C int8-equivalent
// operations per output (tensor-core rate); the smaller sections are bound by
// operations. This first design runs on the CUDA cores instead: one 32-bit
// popcount stands for 32 multiply-adds, and the popcount unit (16 results
// per clock per SM) is what limits it, not memory. Tensor cores are later
// work.
//
// Design:
//  * One block covers one image, a band of TH output rows (all columns) and
//    COT output channels; 256 threads, thread (tco, tpx) owns channel
//    co0 + tco and every PG-th pixel of the band (PG = 256 / COT).
//  * The band plus a one-pixel halo is signed and packed straight into
//    shared memory: lane l of a warp reads channel 32 w + l and
//    __ballot_sync(v < 0) is packed word w, LSB first. The comparison (not
//    the sign bit) maps -0.0 and NaN to +1, as bitpack does; channels >= C
//    and out-of-image pixels give 0 bits, i.e. +1, which is the one-padding.
//  * The filter words of the COT channels stay bitpacked in shared memory,
//    laid out [tap][word][channel] so a warp reads 32 consecutive words.
//    Padding bits are 0 in both operands and add nothing to popc(a ^ f).
//  * Epilogue: __fmul_rn then __fadd_rn (no FMA contraction), round to the
//    activation type, then add x and round again: the two roundings of the
//    unfused "store, then add" chain, so the kernel equals its plain PyTorch
//    version bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;         // pixels a thread accumulates at once
constexpr int kPackUnroll = 4;  // words a warp packs per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
residual_block_kernel(const T* __restrict__ x,
                      const uint32_t* __restrict__ filt,
                      const float* __restrict__ mul,
                      const float* __restrict__ bias,
                      T* __restrict__ out, int H, int W, int C, int CO,
                      int CW, int TH, int COT, int cmin, int cmax) {
  extern __shared__ uint32_t smem[];
  const int n = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int co0 = blockIdx.x * COT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int WP = W + 2;

  uint32_t* sf = smem;                    // [9][CW][COT]
  uint32_t* sa = smem + 9 * CW * COT;     // [TH + 2][W + 2][CW]

  // Filter words of this block's output channels.
  const int nf = 9 * CW * COT;
  for (int i = tid; i < nf; i += kThreads) {
    const int tco = i % COT;
    const int rest = i / COT;
    const int w = rest % CW;
    const int tap = rest / CW;
    const int co = co0 + tco;
    sf[i] = co < CO ? filt[((size_t)co * 9 + tap) * CW + w] : 0u;
  }

  // Sign and pack the band with its halo.
  const int items = (TH + 2) * WP * CW;
  const T* xn = x + (size_t)n * H * W * C;
  for (int base = wid * kPackUnroll; base < items;
       base += kWarps * kPackUnroll) {
    float v[kPackUnroll];
#pragma unroll
    for (int j = 0; j < kPackUnroll; ++j) {
      const int item = base + j;
      v[j] = 0.f;
      if (item < items) {
        const int w = item % CW;
        const int pix = item / CW;
        const int iy = h0 - 1 + pix / WP;
        const int ix = pix % WP - 1;
        const int ch = 32 * w + lane;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W && ch < C)
          v[j] = to_float(xn[((size_t)iy * W + ix) * C + ch]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPackUnroll; ++j) {
      const uint32_t word = __ballot_sync(0xffffffffu, v[j] < 0.f);
      if (lane == 0 && base + j < items) sa[base + j] = word;
    }
  }
  __syncthreads();

  const int tco = tid % COT;
  const int tpx = tid / COT;
  const int PG = kThreads / COT;
  const int co = co0 + tco;
  if (co >= CO) return;
  const int rows = min(TH, H - h0);
  const int P = rows * W;
  const float m = mul[co];
  const float b = bias[co];
  const uint32_t* sfc = sf + tco;

  for (int pbase = tpx; pbase < P; pbase += PG * kPx) {
    int off[kPx];
    int acc[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int p = pbase + j * PG;
      // Out-of-band pixels read a valid tile position and are not stored.
      off[j] = p < P ? ((p / W) * WP + p % W) * CW : 0;
      acc[j] = 0;
    }
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int tap_off = (dy * WP + dx) * CW;
        const uint32_t* sft = sfc + (dy * 3 + dx) * CW * COT;
        for (int w = 0; w < CW; ++w) {
          const uint32_t f = sft[w * COT];
#pragma unroll
          for (int j = 0; j < kPx; ++j)
            acc[j] += __popc(sa[off[j] + tap_off + w] ^ f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int p = pbase + j * PG;
      if (p >= P) continue;
      const int a2 = min(max(2 * acc[j], cmin), cmax);
      const T y = from_float<T>(__fadd_rn(__fmul_rn((float)a2, m), b));
      const size_t pix = ((size_t)n * H + h0 + p / W) * W + p % W;
      if (kResidual) {
        const float xv = to_float(x[pix * C + co]);
        out[pix * CO + co] = from_float<T>(__fadd_rn(xv, to_float(y)));
      } else {
        out[pix * CO + co] = y;
      }
    }
  }
}

template <typename T, bool kResidual>
int launch(const void* x, const void* filt, const void* mul, const void* bias,
           void* out, int N, int H, int W, int C, int CO, int cmin, int cmax,
           cudaStream_t stream) {
  const int CW = (C + 31) / 32;
  const int COT = CO <= 32 ? 32 : 64;
  // About 256 output pixels per block.
  int TH = (256 + W - 1) / W;
  if (TH > H) TH = H;
  const size_t smem =
      sizeof(uint32_t) * ((size_t)9 * CW * COT + (size_t)(TH + 2) * (W + 2) * CW);
  auto kernel = residual_block_kernel<T, kResidual>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((CO + COT - 1) / COT, (H + TH - 1) / TH, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(filt),
      static_cast<const float*>(mul), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, C, CO, CW, TH, COT, cmin, cmax);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = success).
extern "C" int ce_residual_block(const void* x, const void* filt,
                                 const void* mul, const void* bias, void* out,
                                 int n, int h, int w, int c, int c_out,
                                 int clamp_min, int clamp_max,
                                 int has_residual, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c_out <= 0 ||
      (has_residual && c != c_out) || (dtype != 0 && dtype != 1) ||
      n > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return has_residual
        ? launch<float, true>(x, filt, mul, bias, out, n, h, w, c, c_out,
                              clamp_min, clamp_max, s)
        : launch<float, false>(x, filt, mul, bias, out, n, h, w, c, c_out,
                               clamp_min, clamp_max, s);
  return has_residual
      ? launch<__nv_bfloat16, true>(x, filt, mul, bias, out, n, h, w, c,
                                    c_out, clamp_min, clamp_max, s)
      : launch<__nv_bfloat16, false>(x, filt, mul, bias, out, n, h, w, c,
                                     c_out, clamp_min, clamp_max, s);
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
