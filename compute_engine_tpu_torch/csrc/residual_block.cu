// Fused binary residual block for Hopper (sm_90a):
//   out = x + cast(clip(2 * acc, cmin, cmax) * mul + bias)
// (or, in the tail form, the add of x's last C_out channels)
// where acc is the xor-popcount accumulator of the 3x3, stride-1, SAME
// binary convolution of sign(x) (sign(0) = +1) with a bitpacked filter,
// one-padded, or zero-padded where the caller passes a correction table.
//
// Replaces: compute_engine_tpu/kernels/residual.py::_block_kernel (a Pallas
// TPU kernel that signs the tile in VMEM, builds the 9-tap matrix and
// contracts +-1 int8 operands on the MXU).
//
// What bounds it on this card: bytes at the wide sections (the block reads
// the activation and writes it once: 2 x 51 MB in bf16 at 128 x 56 x 56 x
// 64), and what it costs a block to get going at the deep ones. Its
// 2 * 9 * C operations per output run as single-bit products on the tensor
// cores: mma.sync.m16n8k256.and.popc does 5.2e15 binary multiply-adds per
// second on an H100 (csrc/mma_rate.cu), eight times the int8 MMA, which is
// the most a route that expands bits to +-1 bytes could reach; that makes the
// products of a launch a matter of microseconds. So the design is about
// moving the activation with 16-byte accesses, keeping everything else in
// shared memory as bits, and signing a band once for several channel tiles.
//
// Design: an implicit GEMM over the nine taps, M = output positions,
// N = output channels, K = 9 * C bits.
//  * Positions are indexed flat over the padded images, q = (n (H + 2) + y)
//    (W + 2) + x: tap (dy, dx) of every output is then the input at the
//    constant offset dy (W + 2) + dx, across image borders too. A block
//    takes 32 * WARPS consecutive positions and needs the inputs
//    q0 - (W + 3) .. q0 + BM + W + 2, its band. The outputs at padded
//    positions are computed and dropped.
//  * The band is read once with 16-byte loads (8 channels a thread, several
//    loads in flight), signed by v < 0 (so -0.0 and NaN give +1, as bitpack
//    does; for bf16 one paired compare signs two values) and kept in shared
//    memory as packed words; four lanes join their 8 bits into a word with
//    two shuffles. Padded positions and channels >= C are 0 bits, i.e. +1:
//    the one-padding.
//  * The block then walks over tiles_per_block tiles of 64 output channels.
//    The packed filter rows of a tile arrive by cp.async, those of the next
//    tile while this one is transformed and stored. Blocks that share a band
//    are neighbours in the grid.
//  * Inner loop (mma_binary.cuh): a warp owns 32 positions x 64 channels.
//    Word kk of K is word kk % CW of tap kk / CW; a table in shared memory
//    gives its offset from the position. T = sum popc(A & B) and
//    acc = popc(A row) + popc(B column) - 2 T, the popcounts taken by the
//    same unit against all-ones operands. K is padded to whole MMAs of 8
//    words with zero words in both operands, which add nothing to any term.
//  * Zero padding (kZeroPad; core/reference.py): an out-of-image tap adds
//    binary_zero_point - popcount(filter tap) = delta[co][tap] to acc in
//    place of the one-padding's popcount(filter tap), so the band, the MMAs
//    and the popcounts are the one-padded kernel's and the epilogue adds
//    2 * sum of delta over the outside taps to 2 * acc before the clip. The
//    taps that fall outside follow from which of the four neighbours of a
//    position are padding (its pixel is -1): 16 patterns. Each tile stages
//    the (C_out, 9) int32 delta rows of its channels with its filter rows
//    and sums them into a [16][64] table, whose row 0 (inside) is zeros.
//    Odd C needs nothing more: the plain version's odd-depth term gives the
//    same accumulator.
//  * Epilogue: __fmul_rn then __fadd_rn (no FMA contraction), round to the
//    activation type, staged through shared memory so that the store, and
//    the read of x for the add, are 16 bytes a thread along C; then add x
//    and round again: the two roundings of the unfused "store, then add"
//    chain, so the kernel equals its plain PyTorch version bit for bit.
//  * Strides: a pixel of x lies XS >= C elements after the previous one and
//    a pixel of out OS >= C_out after, so x may be a channel prefix of a
//    wider NHWC buffer and out a channel slice of one. A dense block's layer
//    reads the stream where it lies and writes its channels just after it,
//    and nothing is concatenated. The add reads x at C (its form needs
//    XS == C). The 16-byte paths need the strides and the slices' offsets in
//    whole groups of 8 channels.
//  * Tail form (tail_residual_block_kernel, MeliusNet's improvement block):
//    the add reads the residual from x's own last C_out channels, at channel
//    C - C_out and x's pixel stride, where C >= C_out:
//      out = x[..., C - C_out:] + cast(clip(2 * acc) * mul + bias).
//    Its result cannot go back into those channels: the launch reads them as
//    other blocks' 3x3 neighbourhoods, so out lies apart from every channel
//    x reads (the caller copies it into place). It is a kernel of its own
//    name, the same body, so that a profile tells it from the other forms.
//  * ReActNet's form (react_residual_block_kernel; bf16, zero padding, the
//    add of x): the band signs (float)x + threshold[c] in float32, a learned
//    per-input-channel shift, while the add reads x itself; after the add,
//    rounded to the activation type as the unfused chain stores it, RPReLU in
//    float32, t = z + shift_in[co], t < 0 ? slope[co] t : t, + shift_out[co]
//    (each product and sum rounded apart), with one more rounding at the
//    store. A kernel of its own name; the other forms compile none of it.
//  * Registers are capped at 128 a thread (16 warps an SM), of which 64 are
//    accumulators.
//  * Debug build (-DCE_DEBUG_CHECKS, debug_checks.cuh): the invariant of the
//    Pallas kernel's pl.debug_check (residual.py:118-120), |t| <= K = 9 C
//    for the +-1 conv t of every output channel < C_out (the zero-padded t
//    too), as a bit of an error word; and in the tail form, that no store
//    lands on a channel that x is read at. The default build compiles none
//    of it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "debug_checks.cuh"
#include "mma_binary.cuh"

namespace {

constexpr int kBN = 64;          // output channels per block
constexpr int kNT = kBN / 8;     // MMA tiles across them
constexpr int kMT = 2;           // MMA tiles down a warp's 16 kMT positions
constexpr int kMinWarps = 16;    // warps an SM should hold: caps registers at 128
constexpr int kStageStride = kBN + 8;  // staging row, in elements
constexpr int kSignLoads = 4;    // 16-byte loads a thread has in flight when
constexpr int kStoreLoads = 4;   // it signs the band / reads x for the add
constexpr int kMaxDevices = 64;  // cards a process may launch on
constexpr int kTaps = 9;
constexpr int kPatterns = 16;    // outside above | below << 1 | left << 2 |
                                 // right << 3

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

// Two neighbouring values, rounded to the activation type, in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Eight consecutive values as two 16-byte halves (float) or one (bf16).
template <typename T> struct Vec8;
template <> struct Vec8<float> { float4 lo, hi; };
template <> struct Vec8<__nv_bfloat16> { uint4 v; };

__device__ __forceinline__ Vec8<float> load8(const float* p) {
  return {*reinterpret_cast<const float4*>(p),
          *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ Vec8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ void store8(float* p, const Vec8<float>& v) {
  *reinterpret_cast<float4*>(p) = v.lo;
  *reinterpret_cast<float4*>(p + 4) = v.hi;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const Vec8<__nv_bfloat16>& v) {
  *reinterpret_cast<uint4*>(p) = v.v;
}
__device__ __forceinline__ void unpack8(const Vec8<float>& v, float (&f)[8]) {
  f[0] = v.lo.x; f[1] = v.lo.y; f[2] = v.lo.z; f[3] = v.lo.w;
  f[4] = v.hi.x; f[5] = v.hi.y; f[6] = v.hi.z; f[7] = v.hi.w;
}
__device__ __forceinline__ void unpack8(const Vec8<__nv_bfloat16>& v,
                                        float (&f)[8]) {
  const uint32_t u[4] = {v.v.x, v.v.y, v.v.z, v.v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);  // bf16 is the top half of a float
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// Bit j set where value j is negative: v < 0, so -0.0 and NaN give 0.
__device__ __forceinline__ uint32_t negative_bits(const Vec8<float>& v) {
  float f[8];
  unpack8(v, f);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) bits |= (f[j] < 0.f ? 1u : 0u) << j;
  return bits;
}
// bf16: one paired compare per word (0xFFFF in a half that is < 0); values
// 2i and 2i + 1 are the low and high half of word i.
__device__ __forceinline__ uint32_t negative_bits(
    const Vec8<__nv_bfloat16>& v) {
  const uint32_t u[4] = {v.v.x, v.v.y, v.v.z, v.v.w};
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  uint32_t both = 0;  // low halves at bits 0, 2, 4, 6; high at 17, 19, 21, 23
#pragma unroll
  for (int i = 0; i < 4; ++i)
    both |= __hlt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&u[i]), zero) &
        ((1u << (2 * i)) | (1u << (2 * i + 17)));
  return (both | (both >> 16)) & 0xffu;
}

__device__ __forceinline__ Vec8<float> pack8(const float (&f)[8], float) {
  return {make_float4(f[0], f[1], f[2], f[3]),
          make_float4(f[4], f[5], f[6], f[7])};
}
__device__ __forceinline__ Vec8<__nv_bfloat16> pack8(const float (&f)[8],
                                                     __nv_bfloat16) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __halves2bfloat162(
        __float2bfloat16_rn(f[2 * i]), __float2bfloat16_rn(f[2 * i + 1]));
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return {make_uint4(u[0], u[1], u[2], u[3])};
}

// A float rounded to the activation type and back: what a store of it holds.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ReActNet's block: the learned shift of the signs' input (C values) and the
// RPReLU after the add (C_out values each). Null in every other form.
struct ReAct {
  const float* threshold;
  const float* shift_in;
  const float* slope;
  const float* shift_out;
};

// Eight consecutive floats from p, as two 16-byte loads where p is aligned.
__device__ __forceinline__ void load8f(const float* p, bool vec,
                                       float (&f)[8]) {
  if (vec) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __ldg(p + j);
  }
}

// RPReLU of the stored sum z: (z + si) scaled by sl where negative, + so.
__device__ __forceinline__ float rprelu(float z, float si, float sl,
                                        float so) {
  float t = __fadd_rn(z, si);
  t = t < 0.f ? __fmul_rn(t, sl) : t;
  return __fadd_rn(t, so);
}

struct Shape {
  int N, H, W, C, CO, CW;
  int XS, OS;      // elements between pixels of x (>= C) and of out (>= CO)
  int WP, plane;   // W + 2, (H + 2) (W + 2)
  int total;       // N * plane padded positions
  int KW, KWpad;   // 9 CW words of K, padded to a multiple of 8
  int KWs, CWs;    // words between filter rows / between positions
  uint32_t groups_magic;  // floor(2^32 / (4 CW)) + 1
};

// Padded position p -> the pixel's index in an NHWC tensor, or -1 at a
// padded or out-of-range position.
__device__ __forceinline__ int pixel_of(const Shape& s, int p) {
  if (p < 0 || p >= s.total) return -1;
  const int n = p / s.plane, rem = p % s.plane;
  const int yp = rem / s.WP, xp = rem % s.WP;
  if (yp < 1 || yp > s.H || xp < 1 || xp > s.W) return -1;
  return (n * s.H + (yp - 1)) * s.W + (xp - 1);
}

// Shared-memory words of the zero-padded form, after the pixel table: the
// correction of each (pattern, channel of the tile) and the tile's delta
// rows.
template <bool kZeroPad>
__host__ __device__ constexpr int zero_pad_words() {
  return kZeroPad ? kPatterns * kBN + kBN * kTaps : 0;
}

// Whether a store of n elements at dst lands on a channel that x is read
// at: [pix XS, pix XS + C) of each of its N H W pixels.
template <typename T>
__device__ __forceinline__ bool writes_read_channel(const T* x, const T* dst,
                                                    int n, const Shape& s) {
  const long long span = (long long)(s.N * s.H * s.W - 1) * s.XS + s.C;
  for (int j = 0; j < n; ++j) {
    const long long d = (long long)(dst - x) + j;
    if (d >= 0 && d < span && d % s.XS < s.C) return true;
  }
  return false;
}

// The block's body; kTail adds the residual from x's last C_out channels
// (needs kResidual).
// kReAct: ReActNet's threshold and RPReLU (needs the add of x itself).
template <typename T, bool kResidual, bool kTail, bool kZeroPad, int WARPS,
          bool kReAct = false>
__device__ __forceinline__ void block_body(
    const T* __restrict__ x, const uint32_t* __restrict__ filt,
    const float* __restrict__ mul, const float* __restrict__ bias,
    const int* __restrict__ delta, T* __restrict__ out, const Shape& s,
    int tiles_per_block, int cmin, int cmax, int vec_x, int vec_f,
    int vec_out, const ReAct& ra = ReAct{}) {
  static_assert(kResidual || !kTail, "the tail form adds a residual");
  static_assert(!kReAct || (kResidual && !kTail),
                "ReActNet's form adds x itself");
  constexpr int kThreads = 32 * WARPS, BM = 16 * kMT * WARPS;
  constexpr int NB = kNT / WARPS;  // column tiles whose popcounts a warp adds
  static_assert(NB * WARPS == kNT, "the warps share out the column tiles");
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // A block signs its band once and walks over tiles_per_block channel
  // tiles; the blocks that share a band are neighbours in the grid.
  const int n_tiles = (s.CO + kBN - 1) / kBN;
  const int tile_groups = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const int q0 = blockIdx.x / tile_groups * BM;
  const int tile0 = blockIdx.x % tile_groups * tiles_per_block;
  const int tile_end = min(n_tiles, tile0 + tiles_per_block);
  const int in_rows = BM + 2 * s.WP + 2;   // input positions of the band
  const int p0 = q0 - s.WP - 1;            // the first of them

  uint32_t* sf = smem;                                    // [kBN][KWs]
  T* stage = reinterpret_cast<T*>(sf + kBN * s.KWs);      // [BM][kStageStride]
  uint32_t* sa = reinterpret_cast<uint32_t*>(stage + BM * kStageStride);
  int* koff = reinterpret_cast<int*>(sa + in_rows * s.CWs);  // [KWpad]
  int* col_pop = koff + s.KWpad;                             // [kBN]
  int* pixel = col_pop + kBN;  // [in_rows] pixel of each band position, or -1
  // Zero padding only: [kPatterns][kBN], 8-byte aligned (every region
  // before it is an even number of words); [kBN][kTaps].
  int* corr = pixel + in_rows;
  int* sdelta = corr + kPatterns * kBN;

  // The filter rows of a channel tile, as they lie in memory.
  auto load_filter = [&](int tile) {
    const int co0 = tile * kBN;
    if (vec_f) {
      const int segs = s.KW / 4;
      for (int i = tid; i < kBN * segs; i += kThreads) {
        const int r = i / segs, k = 4 * (i % segs);
        const bool ok = co0 + r < s.CO;
        ce::cp_async_16(sf + r * s.KWs + k,
                        ok ? filt + (size_t)(co0 + r) * s.KW + k : filt,
                        ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBN * s.KW; i += kThreads) {
        const int r = i / s.KW, k = i % s.KW;
        if (co0 + r < s.CO)
          ce::cp_async_4(sf + r * s.KWs + k,
                         filt + (size_t)(co0 + r) * s.KW + k);
        else
          sf[r * s.KWs + k] = 0u;
      }
    }
    if (kZeroPad) {  // the tile's delta rows lie one after the other
      for (int i = tid; i < kBN * kTaps; i += kThreads) {
        if (co0 + i / kTaps < s.CO)
          ce::cp_async_4(sdelta + i, delta + (size_t)co0 * kTaps + i);
        else
          sdelta[i] = 0;
      }
    }
    ce::cp_async_commit();
  };
  load_filter(tile0);
  for (int i = tid; i < kBN * (s.KWpad - s.KW); i += kThreads)
    sf[(i / (s.KWpad - s.KW)) * s.KWs + s.KW + i % (s.KWpad - s.KW)] = 0u;
  for (int kk = tid; kk < s.KWpad; kk += kThreads) {
    const int tap = kk / s.CW;
    koff[kk] = kk < s.KW
        ? ((tap / 3) * s.WP + tap % 3) * s.CWs + kk % s.CW : -1;
  }

  for (int i = tid; i < in_rows; i += kThreads) pixel[i] = pixel_of(s, p0 + i);
  __syncthreads();

  // Sign and pack the band: item = (position, group of 8 channels). A thread
  // issues the loads of kSignLoads items before it uses the first.
  const int groups = 4 * s.CW;
  const int items = in_rows * groups;
  for (int base = warp * 32; base < items; base += kThreads * kSignLoads) {
    Vec8<T> v[kSignLoads];
    const T* src[kSignLoads];
    int word[kSignLoads], c[kSignLoads];  // word < 0: nothing to store
#pragma unroll
    for (int u = 0; u < kSignLoads; ++u) {
      const int item = base + u * kThreads + lane;
      // item / groups, exact while item * groups < 2^32
      const int pos = (int)__umulhi((uint32_t)item, s.groups_magic);
      c[u] = 8 * (item - pos * groups);
      const int pix = item < items ? pixel[pos] : -1;
      word[u] = item < items ? pos * s.CWs + (item - pos * groups) / 4 : -1;
      src[u] = pix >= 0 && c[u] < s.C ? x + (size_t)pix * s.XS + c[u]
                                      : nullptr;
      if (vec_x && src[u]) v[u] = load8(src[u]);
    }
#pragma unroll
    for (int u = 0; u < kSignLoads; ++u) {
      uint32_t bits = 0;
      if (src[u]) {
        if constexpr (kReAct) {  // the sign of (float)x + threshold
          float f[8], th[8];
          if (vec_x) {
            unpack8(v[u], f);
            load8f(ra.threshold + c[u], true, th);
          } else {
            for (int j = 0; j < 8; ++j) {
              const bool in = c[u] + j < s.C;
              f[j] = in ? to_float(src[u][j]) : 0.f;
              th[j] = in ? __ldg(ra.threshold + c[u] + j) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bits |= (__fadd_rn(f[j], th[j]) < 0.f ? 1u : 0u) << j;
        } else if (vec_x) {
          bits = negative_bits(v[u]);
        } else {
          for (int j = 0; j < 8 && c[u] + j < s.C; ++j)
            bits |= (to_float(src[u][j]) < 0.f ? 1u : 0u) << j;
        }
      }
      bits <<= 8 * (lane & 3);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
      if ((lane & 3) == 0 && word[u] >= 0) sa[word[u]] = bits;
    }
  }

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int co0 = tile * kBN;
    ce::cp_async_wait<0>();
    __syncthreads();  // band and filter tile in place; stage free again

    int acc[kMT][kNT][4], pa[kMT][4], pb[NB][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        pa[i][r] = 0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[i][j][r] = 0;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) pb[j][r] = 0;
    }
    // Output position m of the block has tap (0, 0) at band row m.
    const uint32_t* arow = sa + (warp * 16 * kMT + g) * s.CWs;
    const uint32_t* brow = sf + g * s.KWs + t;
    for (int c = 0; c < s.KWpad / 8; ++c) {
      const int k0 = koff[8 * c + t], k1 = koff[8 * c + 4 + t];
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint32_t* r0 = arow + 16 * i * s.CWs;
        const uint32_t* r1 = r0 + 8 * s.CWs;
        a[i][0] = k0 >= 0 ? r0[k0] : 0u;  // the words that pad K are 0
        a[i][1] = k0 >= 0 ? r1[k0] : 0u;
        a[i][2] = k1 >= 0 ? r0[k1] : 0u;
        a[i][3] = k1 >= 0 ? r1[k1] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        b[j][0] = brow[8 * j * s.KWs + 8 * c];
        b[j][1] = brow[8 * j * s.KWs + 8 * c + 4];
      }
      ce::mma_chunk<kMT, kNT>(acc, pa, a, b);
      ce::mma_column_popcounts<NB, kNT>(pb, b, warp * NB);
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        col_pop[8 * (warp * NB + j) + 2 * t] = pb[j][0];
        col_pop[8 * (warp * NB + j) + 2 * t + 1] = pb[j][1];
      }
    }
    if (kZeroPad) {
      // 2 * the sum of delta over the taps outside under each pattern.
      for (int i = tid; i < kPatterns * kBN; i += kThreads) {
        const int p = i / kBN, col = i % kBN;
        int sum = 0;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const bool outside = (dy == 0 && (p & 1)) || (dy == 2 && (p & 2)) ||
                               (dx == 0 && (p & 4)) || (dx == 2 && (p & 8));
          sum += outside ? sdelta[col * kTaps + tap] : 0;
        }
        corr[i] = 2 * sum;
      }
    }
    __syncthreads();  // column popcounts (and corrections) written; sf and
                      // sdelta no longer read
    // The next tile's filter arrives while this one is transformed and stored.
    if (tile + 1 < tile_end) load_filter(tile + 1);

    // Zero padding: the row of the correction table of each of this
    // thread's positions. Output m of the block has tap (0, 0) at band row
    // m; its taps (0, 1), (2, 1), (1, 0), (1, 2) are the neighbours above,
    // below, left and right. (A padded position's output is dropped.)
    int zrow[kMT][2] = {};
    if (kZeroPad) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int* nb = pixel + warp * 16 * kMT + 16 * i + g + 8 * h;
          zrow[i][h] = kBN * ((nb[1] < 0 ? 1 : 0) |
                              (nb[2 * s.WP + 1] < 0 ? 2 : 0) |
                              (nb[s.WP] < 0 ? 4 : 0) |
                              (nb[s.WP + 2] < 0 ? 8 : 0));
        }
      }
    }

    // Transform the fragment (channels 2t, 2t + 1 of rows g, g + 8 of every
    // MMA tile) and stage it in the activation type.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * t;
      const int co = co0 + col;
      const float m0 = co < s.CO ? mul[co] : 0.f;
      const float b0 = co < s.CO ? bias[co] : 0.f;
      const float m1 = co + 1 < s.CO ? mul[co + 1] : 0.f;
      const float b1 = co + 1 < s.CO ? bias[co + 1] : 0.f;
      const int cp0 = 2 * col_pop[col], cp1 = 2 * col_pop[col + 1];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 * kMT + 16 * i + g + 8 * h;
          // 2 * acc = 2 popc(row) + 2 popc(column) - 4 T (+ the correction)
          int z0 = 0, z1 = 0;
          if (kZeroPad) {
            const int2 z =
                *reinterpret_cast<const int2*>(corr + zrow[i][h] + col);
            z0 = z.x;
            z1 = z.y;
          }
          const int rp = 2 * pa[i][2 * h];
          const int a0 =
              min(max(rp + cp0 - 4 * acc[i][j][2 * h] + z0, cmin), cmax);
          const int a1 =
              min(max(rp + cp1 - 4 * acc[i][j][2 * h + 1] + z1, cmin), cmax);
#ifdef CE_DEBUG_CHECKS
          // the accumulator over the 9 C taps: (2 acc) / 2 before the clip
          if (co < s.CO)
            ce_debug::check_bound(
                (rp + cp0 + z0) / 2 - 2 * acc[i][j][2 * h], 9 * s.C,
                ce_debug::kResidualBound);
          if (co + 1 < s.CO)
            ce_debug::check_bound(
                (rp + cp1 + z1) / 2 - 2 * acc[i][j][2 * h + 1], 9 * s.C,
                ce_debug::kResidualBound);
#endif
          store2(stage + row * kStageStride + col,
                 __fadd_rn(__fmul_rn((float)a0, m0), b0),
                 __fadd_rn(__fmul_rn((float)a1, m1), b1));
        }
      }
    }
    __syncthreads();

    // Store: item = (position of the block, group of 8 channels). Position
    // m of the block is band position m + W + 3. The reads of x for the add
    // go first, kStoreLoads of them in flight.
    constexpr int kItems = BM * (kBN / 8);
    // The residual: x's first channels at C, or its last C_out at XS.
    const T* res = kTail ? x + (s.C - s.CO) : x;
    const int rs = kTail ? s.XS : s.C;
    for (int base = tid; base < kItems; base += kThreads * kStoreLoads) {
      Vec8<T> xv[kStoreLoads];
      size_t pix[kStoreLoads];
      bool ok[kStoreLoads];
#pragma unroll
      for (int u = 0; u < kStoreLoads; ++u) {
        const int item = base + u * kThreads;
        const int px =
            item < kItems ? pixel[item / (kBN / 8) + s.WP + 1] : -1;
        const int co = co0 + 8 * (item % (kBN / 8));
        ok[u] = px >= 0 && co < s.CO;
        pix[u] = ok[u] ? (size_t)px : 0;
        if (kResidual && vec_out && ok[u])
          xv[u] = load8(res + pix[u] * rs + co);
      }
#pragma unroll
      for (int u = 0; u < kStoreLoads; ++u) {
        if (!ok[u]) continue;
        const int item = base + u * kThreads;
        const int c = 8 * (item % (kBN / 8)), co = co0 + c;
        const T* y = stage + (item / (kBN / 8)) * kStageStride + c;
        T* dst = out + pix[u] * s.OS + co;
#ifdef CE_DEBUG_CHECKS
        if (kTail && writes_read_channel(x, dst, min(8, s.CO - co), s))
          ce_debug::fail(ce_debug::kTailOverlap);
#endif
        if (vec_out) {
          Vec8<T> v = load8(y);
          if (kResidual) {
            float fy[8], fx[8];
            unpack8(v, fy);
            unpack8(xv[u], fx);
#pragma unroll
            for (int j = 0; j < 8; ++j) fy[j] = __fadd_rn(fx[j], fy[j]);
            if constexpr (kReAct) {  // RPReLU of the sum as it is stored
              float si[8], sl[8], so[8];
              load8f(ra.shift_in + co, true, si);
              load8f(ra.slope + co, true, sl);
              load8f(ra.shift_out + co, true, so);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                fy[j] = rprelu(round_to<T>(fy[j]), si[j], sl[j], so[j]);
            }
            v = pack8(fy, T());
          }
          store8(dst, v);
        } else {
          for (int j = 0; j < 8 && co + j < s.CO; ++j) {
            if constexpr (kReAct) {
              const float z = round_to<T>(__fadd_rn(
                  to_float(res[pix[u] * rs + co + j]), to_float(y[j])));
              dst[j] = from_float<T>(rprelu(z, __ldg(ra.shift_in + co + j),
                                            __ldg(ra.slope + co + j),
                                            __ldg(ra.shift_out + co + j)));
            } else {
              dst[j] = kResidual
                  ? from_float<T>(__fadd_rn(
                        to_float(res[pix[u] * rs + co + j]), to_float(y[j])))
                  : y[j];
            }
          }
        }
      }
    }
  }
}

#define CE_BLOCK_ARGS                                                        \
  const T* __restrict__ x, const uint32_t* __restrict__ filt,                \
      const float* __restrict__ mul, const float* __restrict__ bias,         \
      const int* __restrict__ delta, T* __restrict__ out, Shape s,           \
      int tiles_per_block, int cmin, int cmax, int vec_x, int vec_f,         \
      int vec_out

// The forms without an add and with the add of x itself.
template <typename T, bool kResidual, bool kZeroPad, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, kMinWarps / WARPS)
residual_block_kernel(CE_BLOCK_ARGS) {
  block_body<T, kResidual, false, kZeroPad, WARPS>(
      x, filt, mul, bias, delta, out, s, tiles_per_block, cmin, cmax, vec_x,
      vec_f, vec_out);
}

// The tail form: the add of x's last C_out channels.
template <typename T, bool kZeroPad, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, kMinWarps / WARPS)
tail_residual_block_kernel(CE_BLOCK_ARGS) {
  block_body<T, true, true, kZeroPad, WARPS>(
      x, filt, mul, bias, delta, out, s, tiles_per_block, cmin, cmax, vec_x,
      vec_f, vec_out);
}

// ReActNet's form: the threshold in the signing and RPReLU after the add of
// x itself, zero-padded; its own name, so that a profile tells it apart.
template <typename T, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, kMinWarps / WARPS)
react_residual_block_kernel(CE_BLOCK_ARGS, ReAct ra) {
  block_body<T, true, false, true, WARPS, true>(
      x, filt, mul, bias, delta, out, s, tiles_per_block, cmin, cmax, vec_x,
      vec_f, vec_out, ra);
}

#undef CE_BLOCK_ARGS

// Shared memory of a block, in bytes: filter tile, staged outputs, band,
// offset table, column popcounts, pixel of each band position, and the
// zero-padded form's tables.
template <typename T, bool kZeroPad, int WARPS>
size_t shared_bytes(const Shape& s) {
  constexpr int BM = 16 * kMT * WARPS;
  const int in_rows = BM + 2 * s.WP + 2;
  return sizeof(uint32_t) * ((size_t)kBN * s.KWs + (size_t)in_rows * s.CWs +
                             s.KWpad + kBN + in_rows +
                             zero_pad_words<kZeroPad>()) +
      sizeof(T) * (size_t)BM * kStageStride;
}

// The kernel of a form, as the address cudaFuncSetAttribute takes; only the
// one asked for is instantiated.
template <typename T, bool kResidual, bool kTail, bool kZeroPad, int WARPS,
          bool kReAct>
const void* kernel_of() {
  if constexpr (kReAct)
    return reinterpret_cast<const void*>(react_residual_block_kernel<T, WARPS>);
  else if constexpr (kTail)
    return reinterpret_cast<const void*>(
        tail_residual_block_kernel<T, kZeroPad, WARPS>);
  else
    return reinterpret_cast<const void*>(
        residual_block_kernel<T, kResidual, kZeroPad, WARPS>);
}

template <typename T, bool kResidual, bool kTail, bool kZeroPad, int WARPS,
          bool kReAct = false>
int launch(const void* x, const void* filt, const void* mul, const void* bias,
           const void* delta, void* out, const Shape& s, int tiles_per_block,
           int plan_blocks, int plan_smem_bytes, int cmin, int cmax,
           cudaStream_t stream, const ReAct& ra = ReAct{}) {
  constexpr int BM = 16 * kMT * WARPS;
  const size_t smem = shared_bytes<T, kZeroPad, WARPS>(s);
  const int n_tiles = (s.CO + kBN - 1) / kBN;
  const long long blocks = (long long)((s.total + BM - 1) / BM) *
      ((n_tiles + tiles_per_block - 1) / tiles_per_block);
  // The caller owns the launch plan (and holds it to the card's limits);
  // it must be the one this kernel lays its shared memory out by.
  if (blocks != plan_blocks || smem != (size_t)plan_smem_bytes)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // 16-byte accesses need whole groups of 8 channels and aligned rows (and
  // ReActNet's vectors aligned, read 8 channels at a time beside them).
  const int vec_x = s.C % 8 == 0 && s.XS % 8 == 0 && aligned(x) &&
      (!kReAct || aligned(ra.threshold));
  const int vec_f = s.CW % 4 == 0 && aligned(filt);
  const int vec_out =
      s.CO % 8 == 0 && s.OS % 8 == 0 && aligned(out) && (!kResidual || vec_x) &&
      (!kReAct || (aligned(ra.shift_in) && aligned(ra.slope) &&
                   aligned(ra.shift_out)));

  // Raised once per instantiation and device: the attribute is the current
  // device's.
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    e = cudaFuncSetAttribute(
        kernel_of<T, kResidual, kTail, kZeroPad, WARPS, kReAct>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[device] = smem;
  }
  const dim3 grid((unsigned)blocks);
  const T* xt = static_cast<const T*>(x);
  const uint32_t* ft = static_cast<const uint32_t*>(filt);
  const float* mt = static_cast<const float*>(mul);
  const float* bt = static_cast<const float*>(bias);
  const int* dt = static_cast<const int*>(delta);
  T* ot = static_cast<T*>(out);
  if constexpr (kReAct)
    react_residual_block_kernel<T, WARPS><<<grid, 32 * WARPS, smem, stream>>>(
        xt, ft, mt, bt, dt, ot, s, tiles_per_block, cmin, cmax, vec_x, vec_f,
        vec_out, ra);
  else if constexpr (kTail)
    tail_residual_block_kernel<T, kZeroPad, WARPS>
        <<<grid, 32 * WARPS, smem, stream>>>(
            xt, ft, mt, bt, dt, ot, s, tiles_per_block, cmin, cmax, vec_x,
            vec_f, vec_out);
  else
    residual_block_kernel<T, kResidual, kZeroPad, WARPS>
        <<<grid, 32 * WARPS, smem, stream>>>(
            xt, ft, mt, bt, dt, ot, s, tiles_per_block, cmin, cmax, vec_x,
            vec_f, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, bool kResidual, bool kTail, bool kZeroPad,
          bool kReAct = false>
int launch_warps(int warps, const void* x, const void* filt, const void* mul,
                 const void* bias, const void* delta, void* out,
                 const Shape& s, int tiles, int blocks, int smem_bytes,
                 int cmin, int cmax, cudaStream_t stream,
                 const ReAct& ra = ReAct{}) {
  if (warps == 8)
    return launch<T, kResidual, kTail, kZeroPad, 8, kReAct>(
        x, filt, mul, bias, delta, out, s, tiles, blocks, smem_bytes, cmin,
        cmax, stream, ra);
  if (warps == 4)
    return launch<T, kResidual, kTail, kZeroPad, 4, kReAct>(
        x, filt, mul, bias, delta, out, s, tiles, blocks, smem_bytes, cmin,
        cmax, stream, ra);
  return launch<T, kResidual, kTail, kZeroPad, 2, kReAct>(
      x, filt, mul, bias, delta, out, s, tiles, blocks, smem_bytes, cmin,
      cmax, stream, ra);
}

// residual: 0 none, 1 x itself, 2 x's last c_out channels (the tail form).
template <typename T>
int launch_form(int residual, bool zero_pad, int warps, const void* x,
                const void* filt, const void* mul, const void* bias,
                const void* delta, void* out, const Shape& s, int tiles,
                int blocks, int smem_bytes, int cmin, int cmax,
                cudaStream_t stream) {
  auto run = [&](auto launcher) {
    return launcher(warps, x, filt, mul, bias, delta, out, s, tiles, blocks,
                    smem_bytes, cmin, cmax, stream, ReAct{});
  };
  if (zero_pad)
    return residual == 2 ? run(launch_warps<T, true, true, true>)
         : residual == 1 ? run(launch_warps<T, true, false, true>)
                         : run(launch_warps<T, false, false, true>);
  return residual == 2 ? run(launch_warps<T, true, true, false>)
       : residual == 1 ? run(launch_warps<T, true, false, false>)
                       : run(launch_warps<T, false, false, false>);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tap_delta: null for one padding; for
// zero padding the (c_out, 9) int32 table binary_zero_point - popcount of
// each filter tap (core/reference.py::zero_padding_tap_delta). x_stride and
// out_stride: the elements from one pixel to the next in x (at least c) and
// in out (at least c_out), each a channel slice of a wider NHWC row where it
// exceeds its channels. has_residual: 0 no add; 1 the add of x, which reads
// x at c and needs c == c_out and x_stride == c; 2 the tail form, the add of
// x's last c_out channels (c >= c_out), whose out must lie apart from every
// channel x is read at. threshold, shift_in, slope and shift_out: null, or
// all four for ReActNet's form (bf16, zero padding, has_residual 1): c
// float32 values added to x before the sign, and c_out each of the RPReLU
// after the add. The launch
// plan is the caller's (kernels/residual.py::plan_residual_block): warps, 2,
// 4 or 8 a block, 32 output positions each; tiles_per_block, the tiles of 64
// output channels that a block computes from its band; and the number of
// blocks and the shared-memory bytes that follow from them, which must be
// what this kernel needs. Returns a cudaError_t value (0 = success).
extern "C" int ce_residual_block(const void* x, const void* filt,
                                 const void* mul, const void* bias,
                                 const void* tap_delta,
                                 const void* threshold, const void* shift_in,
                                 const void* slope, const void* shift_out,
                                 void* out,
                                 int n, int h, int w, int c, int c_out,
                                 int x_stride, int out_stride,
                                 int clamp_min, int clamp_max,
                                 int has_residual, int dtype, int warps,
                                 int tiles_per_block, int blocks,
                                 int smem_bytes, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c_out <= 0 ||
      has_residual < 0 || has_residual > 2 ||
      (has_residual == 1 && (c != c_out || x_stride != c)) ||
      (has_residual == 2 && c < c_out) || x_stride < c ||
      out_stride < c_out || (dtype != 0 && dtype != 1) ||
      (warps != 2 && warps != 4 && warps != 8) || tiles_per_block < 1 ||
      blocks < 1 || smem_bytes < 1 ||
      (long long)n * (h + 2) * (w + 2) + 8 * 32 > 0x7fffffffLL ||
      // the band's items, times 4 CW, stay below 2^32 (groups_magic)
      (256LL + 2 * w + 6) * (4 * ((c + 31) / 32)) * (4 * ((c + 31) / 32)) >
          0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = n; s.H = h; s.W = w; s.C = c; s.CO = c_out;
  s.XS = x_stride; s.OS = out_stride;
  s.CW = (c + 31) / 32;
  s.WP = w + 2;
  s.plane = (h + 2) * (w + 2);
  s.total = n * s.plane;
  s.KW = 9 * s.CW;
  s.KWpad = (s.KW + 7) / 8 * 8;
  s.KWs = s.KWpad + 4;
  s.CWs = s.CW % 8 == 0 ? s.CW + 4 : s.CW;
  s.groups_magic = (uint32_t)(0x100000000ULL / (4 * s.CW)) + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ReAct ra{static_cast<const float*>(threshold),
                 static_cast<const float*>(shift_in),
                 static_cast<const float*>(slope),
                 static_cast<const float*>(shift_out)};
  const bool react = ra.threshold || ra.shift_in || ra.slope || ra.shift_out;
  if (react) {  // instantiated for ReActNet's blocks alone
    if (!ra.threshold || !ra.shift_in || !ra.slope || !ra.shift_out ||
        dtype != 1 || has_residual != 1 || tap_delta == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_warps<__nv_bfloat16, true, false, true, true>(
        warps, x, filt, mul, bias, tap_delta, out, s, tiles_per_block, blocks,
        smem_bytes, clamp_min, clamp_max, st, ra);
  }
  auto form = dtype == 0 ? launch_form<float> : launch_form<__nv_bfloat16>;
  return form(has_residual, tap_delta != nullptr, warps, x, filt, mul,
              bias, tap_delta, out, s, tiles_per_block, blocks, smem_bytes,
              clamp_min, clamp_max, st);
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
