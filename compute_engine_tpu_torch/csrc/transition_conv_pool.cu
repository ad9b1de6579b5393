// The float transition of the BinaryDenseNets in one kernel for Hopper
// (sm_90a): a 1x1 conv with its BN folded in, then a 2x2/2 VALID average
// pool,
//   out = avg_pool_2x2/2(bf16(bf16(x) . bf16(w) + bias))
// for an NHWC bf16 stream x of C_in channels (a multiple of 16), read at
// its own pixel stride (a channel prefix of a wider buffer, the dense
// block's), to C_out channels (a multiple of 32, at most 288).
//
// Replaces no TPU kernel: the JAX package leaves this conv and pool to XLA
// (compute_engine_tpu/models/builder.py, conv_bn and avg_pool). On the card
// the port ran them as PyTorch around cuDNN (models/layers.py conv2d and
// avg_pool): the bf16 stream widened to float32, a TF32 conv with layout
// passes, the float32 bias add, the cast to bf16, then the pool's casts to
// float32 and back: about seven passes over float32 tensors.
//
// What bounds it on this card: bytes. At batch 128 DenseNet-45's three
// transitions read 603.7 MB of bf16 stream once and write 48.6 MB of
// pooled bf16 once, with 1.3 MB of filters and biases: 653.6 MB, 0.195 ms
// at 3.35 TB/s. Their 60.9 G multiply-adds, counted with the conv before the
// pool, take 0.123 ms at the bf16 dense peak. No conv output goes to device
// memory.
//
// Design: a GEMM of M = the conv positions, N = C_out, K = C_in on the
// tensor cores in warpgroup MMAs (wgmma, bf16 operands read from shared
// memory, float32 sums in registers), whose rows are grouped by pool
// window. A tile is 32 consecutive pooled outputs (in the output's pixel
// order) and all C_out channels: its 128 GEMM rows are two 64-row products,
// window row dy = 0 and dy = 1, and within each, warp w of a warpgroup holds
// pooled outputs 8 w .. 8 w + 7 at dx = 0 in its accumulator rows g and at
// dx = 1 in its rows g + 8, so that a thread holds the four conv values of
// each of its outputs in its own registers. Two warpgroups: each takes half
// of C_out (16 C_out / 32 columns a product, up to 144).
//  * K is walked in chunks of 64, one 128-byte row of the 128-byte swizzle
//    (a 16-byte piece c of row r stored at piece c ^ (r % 8)): the 128 input
//    rows' chunk (each a piece of a pixel's channels) and the filter's
//    (C_out rows) arrive by cp.async in a ring of as many stages as shared
//    memory holds (3 to 6; 4 to 6 at DenseNet-45's widths), one to four
//    chunks ahead. A chunk past C_in (C_in % 64 == 16, 32 or 48) is filled
//    with zeros and multiplied whole.
//  * The products of a chunk run while the next chunk's are issued: each
//    warpgroup waits only for the chunk before, so the stage loaded at chunk
//    it is that of chunk it - 2. A tile's products are waited for whole
//    before its epilogue, outside the loop over its chunks, which is what
//    lets ptxas keep the accumulators in flight (no injected wait).
//  * Blocks are persistent, one an SM (the accumulators take up to 144
//    registers a thread): each walks tiles blockIdx.x + i * gridDim.x, and
//    the ring runs on across tiles, so that the next tile's first chunks
//    load while this tile's epilogue runs.
//  * The stream is read from device memory once: every pixel belongs to one
//    pool window, so to one tile, and every tile computes all C_out
//    channels. The filter (0.14-0.66 MB) is read again by every tile, from
//    L2, where it stays, since every block reads it all the time: at
//    DenseNet-45's b128 that is 0.95 GB of L2 reads beside the 0.60 GB of
//    stream, the larger part of what the loads cost (PERF.md).
//  * Epilogue: the bias added with __fadd_rn (no FMA contraction), each conv
//    value rounded to bf16, the four of a window summed in float32 from 0 in
//    the order (0, 0), (0, 1), (1, 0), (1, 1) and divided by 4, as
//    PyTorch's average pool does, rounded to bf16 into a tile in the ring's
//    free stage, and the tile's 32 output pixels stored as 16-byte words
//    (they are contiguous in the output).
// The rounding points are those of the plain chain: bf16 operands, whose
// products are exact in float32, a float32 sum, the bias added in float32,
// one rounding to bf16 per conv output, the pool's float32 sum and
// division, one rounding to bf16. Only the order of the conv's float32 sum
// differs from cuDNN's.
//
// Debug build (-DCE_DEBUG_CHECKS, debug_checks.cuh): no operand is read
// from outside the tile staged in shared memory (bit 64): the input tile
// against its size or a declared size (the override, to trip it on
// purpose), the filter's chunk against its C_out rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "debug_checks.cuh"
#include "mma_binary.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;           // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kPool = 32;           // pooled outputs a tile
constexpr int kRows = 4 * kPool;    // GEMM rows a tile: 128 conv positions
constexpr int kChunk = 64;          // K a stage: one 128-byte swizzled row
constexpr int kRowBytes = 2 * kChunk;
constexpr int kMaxNT = 9;           // C_out / 32 <= 9: C_out <= 288
constexpr int kMaxDevices = 64;     // cards a process may launch on

struct Shape {
  int N, H, W, C, XS, CO;  // input, its pixel stride; output channels
  int HO, WO, P;           // pooled output rows, columns, and count
  int nk;                  // chunks of K
  int n_tiles;
  int stages;              // of the ring: 3 to 6
};

// Shared memory of a block, in bytes, in the order the kernel lays it out:
// room to align the ring to 1024 bytes (the swizzle's atom), the ring's
// stages (input tile, then filter chunk, rows of 128 bytes; the output tile
// goes to the stage that is free at a tile's end), the bias.
__host__ __device__ inline int shared_bytes(const Shape& s) {
  return 1024 + s.stages * (kRows + s.CO) * kRowBytes + 4 * s.CO;
}

// The stage's GEMM row of window position (dy, dx) of pooled output p: row
// 16 (p / 8) + 8 dx + p % 8 of MMA row tile dy, so that warp w of a
// warpgroup holds pooled outputs 8 w .. 8 w + 7, dx = 0 in its rows g and
// dx = 1 in its rows g + 8, in both tiles.
__device__ __forceinline__ int gemm_row(int p, int dy, int dx) {
  return 64 * dy + 16 * (p >> 3) + 8 * dx + (p & 7);
}

// The byte offset of 16-byte chunk c of row r in the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  switch (stages) {  // all but the stages - 3 newest groups complete
    case 3: ce::cp_async_wait<0>(); break;
    case 4: ce::cp_async_wait<1>(); break;
    case 5: ce::cp_async_wait<2>(); break;
    default: ce::cp_async_wait<3>(); break;
  }
}

// Keeps the compiler from moving any access to the accumulators across the
// point (wgmma writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_accumulators(float (&acc)[2][N]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) ce::register_fence(acc[m][i]);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
transition_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ filt,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_u32 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring_u32 = (smem_u32 + 1023) & ~1023u;
  unsigned char* ring = smem + (ring_u32 - smem_u32);
  const int stage_bytes = (kRows + s.CO) * kRowBytes;
  const int out_ld = s.CO + 8;  // the output tile's row stride, elements
  float* sbias = reinterpret_cast<float*>(ring + s.stages * stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, w4 = warp & 3;  // warpgroup, warp in it
  const int n0 = wg * 16 * NT;              // the warpgroup's columns

  for (int i = tid; i < s.CO; i += kThreads) sbias[i] = bias[i];

  const int my_tiles = (s.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int iters = my_tiles * s.nk;

  // The loads: this thread copies 16 bytes (8 channels, `part`) of the
  // chunk of pooled output `lp` of the tile at each of its four window
  // positions, and 16 bytes of some of the filter's rows.
  const int lp = tid >> 3, part = tid & 7;
  const size_t row_step = (size_t)s.W * s.XS;  // to the window's second row
  const __nv_bfloat16* a_src = x;  // window position (0, 0), this part
  bool a_ok = false;
  auto load = [&](int it) {
    const int kc = it % s.nk;
    if (kc == 0) {  // a new tile: where its pooled output lp reads
      const int p = ((int)blockIdx.x + it / s.nk * (int)gridDim.x) * kPool + lp;
      a_ok = p < s.P;
      if (a_ok) {
        const int n = p / (s.HO * s.WO), r = p % (s.HO * s.WO);
        const int py = r / s.WO, px = r % s.WO;
        a_src = x + (((size_t)n * s.H + 2 * py) * s.W + 2 * px) * s.XS +
                8 * part;
      }
    }
    unsigned char* sa = ring + (it % s.stages) * stage_bytes;
    unsigned char* sb = sa + kRows * kRowBytes;
    const int k0 = kc * kChunk;
    const bool k_ok = k0 + 8 * part < s.C;
    const bool ok = a_ok && k_ok;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat16* src =
          ok ? a_src + (q >> 1) * row_step + (q & 1) * s.XS + k0 : x;
      ce::cp_async_16(sa + swizzled(gemm_row(lp, q >> 1, q & 1), part), src,
                      ok ? 16 : 0);
    }
    for (int o = lp; o < s.CO; o += kThreads / 8) {
      const __nv_bfloat16* src =
          k_ok ? filt + (size_t)o * s.C + k0 + 8 * part : filt;
      ce::cp_async_16(sb + swizzled(o, part), src, k_ok ? 16 : 0);
    }
  };
#ifdef CE_DEBUG_CHECKS
  const int a_limit =
      ce_debug::declared_bits ? ce_debug::declared_bits : kRows * kChunk;
#endif

  // The accumulators of the warpgroup's two 64 x (16 NT) products: window
  // row dy = 0 and dy = 1.
  float acc[2][8 * NT];
  // The ring: chunk it in stage it % stages. At chunk it the products of
  // chunk it are issued and those of chunk it - 1 may still run, so the
  // stage loaded then is that of chunk it - 2, with chunk it + stages - 2.
  // At a tile's end (its last chunk it - 1) the stage of chunk it - 2 is
  // free until the next chunk: the output tile goes there.
  for (int st = 0; st < s.stages - 2; ++st) {
    if (st < iters) load(st);
    ce::cp_async_commit();
  }
  int it = 0;  // the ring's chunk: the tile's chunk kc in stage it % stages
  for (int t = 0; t < my_tiles; ++t) {
    for (int kc = 0; kc < s.nk; ++kc, ++it) {
      cp_async_wait_ring(s.stages);
      ce::fence_proxy_async_shared();  // this thread's copies, for wgmma
      __syncthreads();  // chunk it in place; the products of it - 2 done
      if (it + s.stages - 2 < iters) load(it + s.stages - 2);
      ce::cp_async_commit();

      const uint32_t a_tile = ring_u32 + (it % s.stages) * stage_bytes;
      const uint32_t b_tile = a_tile + (kRows + n0) * kRowBytes;
      fence_accumulators(acc);
      ce::wgmma_fence();
#pragma unroll
      for (int step = 0; step < kChunk / 16; ++step) {  // past C_in: zeros
#ifdef CE_DEBUG_CHECKS
        if ((kRows - 1) * kChunk + 16 * step + 15 >= a_limit ||
            (kRows + n0 + 16 * NT - 1) * kChunk + 16 * step + 15 >=
                (kRows + s.CO) * kChunk)
          ce_debug::fail(ce_debug::kTransitionTile);
#endif
        const int scale_d = kc > 0 || step > 0;  // 0: d = A B, a new tile
        const uint64_t b = ce::smem_descriptor(b_tile + 32 * step);
        ce::wgmma_bf16<NT>(acc[0], ce::smem_descriptor(a_tile + 32 * step),
                           b, scale_d);
        ce::wgmma_bf16<NT>(acc[1],
                           ce::smem_descriptor(a_tile + 64 * kRowBytes +
                                               32 * step),
                           b, scale_d);
      }
      ce::wgmma_commit();
      ce::wgmma_wait<1>();  // the products of chunk it - 1 done
      fence_accumulators(acc);
    }
    ce::wgmma_wait<0>();
    fence_accumulators(acc);
    __syncthreads();  // both warpgroups' products done: stage it - 2 free

    // Epilogue of the tile: bias, bf16, the window's mean, bf16, into the
    // output tile; then the tile's rows out as 16-byte words. This thread
    // holds pooled output 8 w4 + g: dx = 0 in acc[dy][4 i + e], dx = 1 in
    // acc[dy][4 i + 2 + e], at column n0 + 8 i + 2 t4 + e.
    const int tile = (int)blockIdx.x + t * (int)gridDim.x;
    __nv_bfloat16* sout = reinterpret_cast<__nv_bfloat16*>(  // [32][out_ld]
        ring + (it - 2 + s.stages) % s.stages * stage_bytes);
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      float mean[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = sbias[col + e];
        const float v[4] = {acc[0][4 * i + e], acc[0][4 * i + 2 + e],
                            acc[1][4 * i + e], acc[1][4 * i + 2 + e]};
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sum = __fadd_rn(sum, __bfloat162float(__float2bfloat16_rn(
                                   __fadd_rn(v[q], b))));
        mean[e] = __fdiv_rn(sum, 4.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(sout + (8 * w4 + g) * out_ld +
                                         col) =
          __floats2bfloat162_rn(mean[0], mean[1]);
    }
    __syncthreads();  // the output tile written
    const int rows = min(kPool, s.P - tile * kPool);
    const int words = s.CO / 8;  // 16-byte words a pooled output
    for (int i = tid; i < rows * words; i += kThreads) {
      const int r = i / words, w8 = i % words;
      *reinterpret_cast<uint4*>(out + ((size_t)tile * kPool + r) * s.CO +
                                8 * w8) =
          *reinterpret_cast<const uint4*>(sout + r * out_ld + 8 * w8);
    }
    // The next load into this stage follows the next chunk's barrier.
  }
  ce::cp_async_wait<0>();
}

template <int NT>
int launch(const void* x, const void* filt, const void* bias, void* out,
           const Shape& s, int blocks, int smem, cudaStream_t stream) {
  auto kernel = transition_conv_pool_kernel<NT>;
  // Raised once per instantiation and device: the attribute is the current
  // device's.
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed[device] = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(filt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, c) bf16 NHWC, channel stride 1, x_stride elements from one
// pixel to the next (>= c, a multiple of 8: a channel prefix of a wider
// buffer); filt: the (c_out, c) bf16 filter, K contiguous
// (kernels/transition.py transition_filter); bias: c_out float32; out:
// (n, h/2, w/2, c_out) bf16, contiguous. h and w even, c a multiple of 16,
// c_out a multiple of 32 up to 288; x, filt and out 16-byte aligned. The
// launch plan is the caller's (kernels/transition.py plan_transition): the
// ring's stages (3 to 6), the blocks, at most one a tile, and the
// shared-memory bytes, which must be what this kernel lays out. Returns a
// cudaError_t value (0 = success).
extern "C" int ce_transition_conv_pool(const void* x, const void* filt,
                                       const void* bias, void* out, int n,
                                       int h, int w, int c, int x_stride,
                                       int c_out, int stages, int blocks,
                                       int smem_bytes, void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n <= 0 || h <= 0 || w <= 0 || h % 2 || w % 2 || c <= 0 || c % 16 ||
      x_stride < c || x_stride % 8 || c_out <= 0 || c_out % 32 ||
      c_out > 32 * kMaxNT || stages < 3 || stages > 6 ||
      (long long)n * h * w > 0x7fffffffLL || !aligned(x) || !aligned(filt) ||
      !aligned(out))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = n; s.H = h; s.W = w; s.C = c; s.XS = x_stride; s.CO = c_out;
  s.HO = h / 2; s.WO = w / 2;
  s.P = n * s.HO * s.WO;
  s.nk = (c + kChunk - 1) / kChunk;
  s.n_tiles = (s.P + kPool - 1) / kPool;
  s.stages = stages;
  if (blocks < 1 || blocks > s.n_tiles || smem_bytes != shared_bytes(s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_out / 32) {
    case 1: return launch<1>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 2: return launch<2>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 3: return launch<3>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 4: return launch<4>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 5: return launch<5>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 6: return launch<6>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 7: return launch<7>(x, filt, bias, out, s, blocks, smem_bytes, st);
    case 8: return launch<8>(x, filt, bias, out, s, blocks, smem_bytes, st);
    default: return launch<9>(x, filt, bias, out, s, blocks, smem_bytes, st);
  }
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
