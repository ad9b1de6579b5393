// The float stem of Bi-RealNet-18 and the BinaryDenseNets, and its max pool,
// in one kernel for Hopper (sm_90a):
//   out = maxpool_3x3/2_SAME(bf16(act(bf16(x) (*) bf16(w) + bias)))
// where (*) is a KH x KW, stride-2, TF-SAME convolution of an NHWC image of
// C <= 4 channels to 64 channels, w and bias its kernel with the BN folded
// in, and act none, relu or relu6.
//
// Replaces no TPU kernel: the JAX package leaves this conv and pool to XLA
// (compute_engine_tpu/models/builder.py, conv_bn and max_pool). On the card
// the port ran them as PyTorch around cuDNN (models/layers.py conv2d and
// max_pool): at batch 128 the float32 images cast to bf16 and back, padded,
// a TF32 conv writing 411 MB of float32, the bias add reading and writing
// them again, the cast to bf16, the pool's -inf padding and the pool: about
// 3 GB moved where the stem needs 128.5 MB.
//
// What bounds it on this card: bytes. The images are read once (77.1 MB in
// float32 at 128 x 224 x 224 x 3) and the pooled bf16 stream written once
// (51.4 MB at 128 x 56 x 56 x 64): 0.038 ms at 3.35 TB/s. Its 15.1 G
// multiply-adds take 0.031 ms at the bf16 dense peak, and no conv output
// goes to device memory.
//
// Design: a block computes a tile of 7 x 8 pooled outputs of one image, all
// 64 channels, from the 15 x 17 conv outputs that the tile's pool windows
// read (the windows' overlap with the next tile is computed again: 255
// conv positions for 56 pooled ones).
//  * The block's input patch (35 x 40 pixels for a 7 x 7 filter) arrives
//    by cp.async as 16-byte chunks of the image rows, the next tile's while
//    this one is multiplied and pooled, and is rounded to bf16
//    (__float2bfloat16_rn) into a patch in shared memory, with the conv's
//    SAME padding as 0.0.
//  * An implicit GEMM on the tensor cores, bf16 mma.sync m16n8k16 with
//    float32 accumulators: M = the 255 conv positions (16 MMA rows of 16),
//    N = 64 channels, K = KH rows of the filter, each row's KW * C values
//    padded to an even KR (7 x 22 = 154 for 7 x 7 x 3) and K padded to 160.
//    Within a filter row k runs along the patch row (pixel-major, C values a
//    pixel), so two neighbouring k lie side by side and one 32-bit load
//    gives a pair of A. A table in shared memory gives each k pair's offset
//    in the patch and a mask that zeroes the pad slot and K's padding; an
//    output position adds its own offset (2 rows and 2 pixels a step).
//  * The filter, rounded to bf16 once at load (kernels/stem.py stem_filter,
//    64 x 160 in that K order), stays in shared memory while the block, one
//    of two an SM, walks its tiles; its fragments come by ldmatrix.
//  * Epilogue: the bias added with __fadd_rn (no FMA contraction), the
//    activation, one rounding to bf16 into a conv tile in shared memory;
//    then the 3x3/2 max of bf16 pairs (SAME: -inf outside the conv output;
//    a NaN is the max, as in PyTorch's max pool; where +0.0 and -0.0 tie,
//    the sign may differ from PyTorch's first-in-the-window) and the 64
//    channels of each pooled output stored as 16-byte words.
// The rounding points are those of the plain chain: bf16 operands, whose
// products are exact in float32, a float32 sum, the bias added in float32,
// one rounding to bf16, an exact max. Only the order of the float32 sum
// differs from cuDNN's (and the sign of a zero max, which no later layer
// reads: a sign takes -0.0 as +1, and -0.0 adds as +0.0 does).
//
// Debug build (-DCE_DEBUG_CHECKS, debug_checks.cuh): no operand is read
// from outside the staged patch (bit 16), against the patch's size or a
// declared size (the override, to trip it on purpose). The check guards the
// tap table and the tile geometry, which decide every address; the
// products themselves have no bound to hold, since a float conv has no
// count of bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "debug_checks.cuh"
#include "mma_binary.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kCO = 64;                 // output channels
constexpr int kMaxK = 160;              // K the filter holds: 10 MMA steps
constexpr int kSteps = kMaxK / 16;
constexpr int kTPH = 7, kTPW = 8;       // pooled outputs a tile
constexpr int kCR = 2 * kTPH + 1;       // conv rows a tile: 15
constexpr int kCC = 2 * kTPW + 1;       // conv columns a tile: 17
constexpr int kM = kCR * kCC;           // 255 conv positions
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                  // MMA row tiles a warp
constexpr int kRows = 16 * kMT * kWarps;  // 256 rows of the tile's GEMM
constexpr int kNT = kCO / 8;            // MMA column tiles: all 64 channels
constexpr int kFS = kMaxK + 8;          // filter row stride (elements)
constexpr int kTS = kCO + 8;            // conv tile row stride (elements)
constexpr int kMaxDevices = 64;         // cards a process may launch on
static_assert(kRows >= kM, "the warps cover the tile's conv positions");

struct Shape {
  int N, H, W, C;
  int KH, KW, KR, K;   // K = KH * KR: each filter row padded to an even KR
  int pad_top, pad_left;    // the conv's SAME padding before
  int HC, WC;               // conv output
  int pool_top, pool_left;  // the pool's SAME padding before
  int HO, WO;               // pooled output
  int tiles_x, tiles_per_image, n_tiles;
  int PR, PE, PRL;     // patch rows, elements a patch row, its stride
  int E, NCH;          // elements a 16-byte chunk; chunks a staged row
  int act;             // 0 none, 1 relu, 2 relu6
};

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of a block, in bytes, in the order the kernel lays it out:
// filter, tap table, bias, two patches, conv tile, two staged patches.
__host__ __device__ inline int shared_bytes(const Shape& s) {
  return 2 * kCO * kFS + 16 * 4 * kSteps + 4 * kCO +
      2 * round16(2 * s.PR * s.PRL) + 2 * kRows * kTS + 2 * 16 * s.PR * s.NCH;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 0) return y;
  y = y < 0.f ? 0.f : y;  // NaN stays NaN, as torch.relu and clamp keep it
  return act == 2 && y > 6.f ? 6.f : y;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Where a tile lies: its image, its first pooled row and column, and the
// first conv row and column and input row and element its windows reach.
struct Tile {
  int n, py0, px0, cy0, cx0, iy0, e0;
};

__device__ __forceinline__ Tile tile_at(const Shape& s, int tile) {
  Tile t;
  t.n = tile / s.tiles_per_image;
  const int rem = tile % s.tiles_per_image;
  t.py0 = rem / s.tiles_x * kTPH;
  t.px0 = rem % s.tiles_x * kTPW;
  t.cy0 = 2 * t.py0 - s.pool_top;
  t.cx0 = 2 * t.px0 - s.pool_left;
  t.iy0 = 2 * t.cy0 - s.pad_top;
  t.e0 = (2 * t.cx0 - s.pad_left) * s.C;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_pool_kernel(const T* __restrict__ x,
                      const __nv_bfloat16* __restrict__ filt,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, Shape s, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sf = reinterpret_cast<__nv_bfloat16*>(smem);  // [kCO][kFS]
  int4* table = reinterpret_cast<int4*>(sf + kCO * kFS);  // [kSteps][4]
  float* sbias = reinterpret_cast<float*>(table + 4 * kSteps);
  unsigned char* after_bias = reinterpret_cast<unsigned char*>(sbias + kCO);
  const int patch_elems = round16(2 * s.PR * s.PRL) / 2;  // [s.PR][s.PRL]
  __nv_bfloat16* patches = reinterpret_cast<__nv_bfloat16*>(after_bias);
  __nv_bfloat16* ctile = patches + 2 * patch_elems;        // [kRows][kTS]
  unsigned char* staged = reinterpret_cast<unsigned char*>(ctile + kRows * kTS);
  const int stage_bytes = 16 * s.PR * s.NCH;  // one staged patch

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_elems = s.W * s.C;

  // The image rows of a tile's patch, as 16-byte chunks, into a staged
  // buffer (the 16-byte path: rows of whole chunks); the chunks outside
  // the image are filled with zeros, the conv's SAME padding.
  auto stage = [&](int tile, int buf) {
    const Tile tl = tile_at(s, tile);
    const int c0 = floor_div(tl.e0, s.E);
    unsigned char* dst0 = staged + buf * stage_bytes;
    for (int r = warp; r < s.PR; r += kWarps) {  // a row a warp, a chunk a lane
      const int iy = tl.iy0 + r;
      const bool row_in = iy >= 0 && iy < s.H;
      for (int q = lane; q < s.NCH; q += 32) {
        const int chunk = c0 + q;
        const bool ok = row_in && chunk >= 0 && chunk * s.E < row_elems;
        const T* src = ok ? x + ((size_t)tl.n * s.H + iy) * row_elems +
                                (size_t)chunk * s.E
                          : x;
        ce::cp_async_16(dst0 + 16 * (r * s.NCH + q), src, ok ? 16 : 0);
      }
    }
    ce::cp_async_commit();
  };

  // The filter, once: 64 rows of 160 bf16 in 16-byte chunks.
  for (int i = tid; i < kCO * (kMaxK / 8); i += kThreads) {
    const int r = i / (kMaxK / 8), q = i % (kMaxK / 8);
    ce::cp_async_16(sf + r * kFS + 8 * q, filt + r * kMaxK + 8 * q, 16);
  }
  ce::cp_async_commit();
  if (tid < kCO) sbias[tid] = bias[tid];
  // Tap table: for each step of K and lane column t, the patch offsets and
  // masks of the pairs k = 16 step + 2t and k + 8. A pair's second value is
  // masked where it is a filter row's pad slot; a pair beyond K reads
  // offset 0 and is masked whole.
  for (int i = tid; i < 4 * kSteps; i += kThreads) {
    const int step = i >> 2, t = i & 3;
    int v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * step + 8 * h + 2 * t;
      int off = 0;
      uint32_t mask = 0u;
      if (k < s.K) {
        const int j = k % s.KR;
        off = k / s.KR * s.PRL + j;
        mask = j + 1 < s.KW * s.C ? 0xffffffffu : 0x0000ffffu;
      }
      v[2 * h] = off;
      v[2 * h + 1] = (int)mask;
    }
    table[i] = make_int4(v[0], v[1], v[2], v[3]);
  }
  // This thread's GEMM rows: conv position m of the tile at patch offset
  // 2 (m / kCC) rows and 2 (m % kCC) pixels; the rows past kM read the
  // patch's start, and their outputs are dropped.
  int base[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 16 * kMT + 16 * i + g + 8 * h;
      base[i][h] = m < kM ? 2 * (m / kCC) * s.PRL + 2 * (m % kCC) * s.C : 0;
    }
  }
  const uint32_t b_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      sf + ((lane >> 4) * 8 + (lane & 7)) * kFS + ((lane >> 3) & 1) * 8));
#ifdef CE_DEBUG_CHECKS
  const int patch_limit =
      ce_debug::declared_bits ? ce_debug::declared_bits : s.PR * s.PRL;
#endif

  // The patch of a tile in bf16, from its staged buffer, or from x with
  // 0.0 outside the image (the conv's SAME padding).
  auto convert = [&](int tile, int buf, __nv_bfloat16* patch) {
    const Tile tl = tile_at(s, tile);
    const int o = tl.e0 - floor_div(tl.e0, s.E) * s.E;
    const T* srow = reinterpret_cast<const T*>(staged + buf * stage_bytes);
    for (int r = warp; r < s.PR; r += kWarps) {  // a row a warp
      const int iy = tl.iy0 + r;
      const bool row_in = iy >= 0 && iy < s.H;
      const T* src = vec ? srow + r * s.NCH * s.E + o
                         : x + ((size_t)tl.n * s.H + iy) * row_elems + tl.e0;
      for (int e = 2 * lane; e < s.PRL; e += 64) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ge = tl.e0 + e + u;
          v[u] = e + u < s.PE &&
                  (vec || (row_in && ge >= 0 && ge < row_elems))
              ? to_float(src[e + u]) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(patch + r * s.PRL + e) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  };

  // Tile i is staged in buffer i % 2 and converted into patch i % 2 while
  // tile i - 1 is pooled; tile i + 1 is staged while tile i is multiplied.
  const int step_tiles = gridDim.x;
  if (vec) stage(blockIdx.x, 0);
  ce::cp_async_wait<0>();
  __syncthreads();  // the filter, the tables and the first tile in place
  convert(blockIdx.x, 0, patches);
  if (vec && blockIdx.x + step_tiles < s.n_tiles)
    stage(blockIdx.x + step_tiles, 1);
  __syncthreads();
  int buf = 0;
  for (int tile = blockIdx.x; tile < s.n_tiles; tile += step_tiles) {
    const Tile tl = tile_at(s, tile);
    const __nv_bfloat16* patch = patches + buf * patch_elems;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {  // beyond K all masked
      const int4 tb = table[4 * step + t4];
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#ifdef CE_DEBUG_CHECKS
        if (max(base[i][0], base[i][1]) + max(tb.x, tb.z) + 1 >= patch_limit)
          ce_debug::fail(ce_debug::kStemPatch);
#endif
        a[i][0] = *reinterpret_cast<const uint32_t*>(patch + base[i][0] + tb.x) &
                  (uint32_t)tb.y;
        a[i][1] = *reinterpret_cast<const uint32_t*>(patch + base[i][1] + tb.x) &
                  (uint32_t)tb.y;
        a[i][2] = *reinterpret_cast<const uint32_t*>(patch + base[i][0] + tb.z) &
                  (uint32_t)tb.w;
        a[i][3] = *reinterpret_cast<const uint32_t*>(patch + base[i][1] + tb.z) &
                  (uint32_t)tb.w;
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t b[4];
        ce::ldmatrix_x4(b, b_lane + 2 * (16 * jp * kFS + 16 * step));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          ce::mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          ce::mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }

    // Bias, activation, one rounding to bf16, into the conv tile.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * t4;
      const float b0 = sbias[col], b1 = sbias[col + 1];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 * kMT + 16 * i + g + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(ctile + row * kTS + col) =
              __floats2bfloat162_rn(
                  activate(__fadd_rn(acc[i][j][2 * h], b0), s.act),
                  activate(__fadd_rn(acc[i][j][2 * h + 1], b1), s.act));
        }
      }
    }
    const int next = tile + step_tiles;
    ce::cp_async_wait<0>();
    __syncthreads();  // the conv tile written, the next tile staged, this
                      // patch read
    if (next < s.n_tiles) {
      convert(next, buf ^ 1, patches + (buf ^ 1) * patch_elems);
      if (vec && next + step_tiles < s.n_tiles) stage(next + step_tiles, buf);
    }

    // The pool: item = (pooled output of the tile, group of 8 channels).
    for (int item = tid; item < kTPH * kTPW * (kCO / 8); item += kThreads) {
      const int p = item / (kCO / 8), c8 = item % (kCO / 8);
      const int pyl = p / kTPW, pxl = p % kTPW;
      const int py = tl.py0 + pyl, px = tl.px0 + pxl;
      if (py >= s.HO || px >= s.WO) continue;
      __nv_bfloat162 best[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        best[q] = __float2bfloat162_rn(-INFINITY);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int cy = tl.cy0 + 2 * pyl + dy;
        if (cy < 0 || cy >= s.HC) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int cx = tl.cx0 + 2 * pxl + dx;
          if (cx < 0 || cx >= s.WC) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              ctile + ((2 * pyl + dy) * kCC + 2 * pxl + dx) * kTS + 8 * c8);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) best[q] = __hmax2_nan(best[q], h[q]);
        }
      }
      *reinterpret_cast<uint4*>(
          out + (((size_t)tl.n * s.HO + py) * s.WO + px) * kCO + 8 * c8) =
          *reinterpret_cast<const uint4*>(best);
    }
    __syncthreads();  // the next patch written, the conv tile read
    buf ^= 1;
  }
}

template <typename T>
int launch(const void* x, const void* filt, const void* bias, void* out,
           const Shape& s, int blocks, int smem, cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // The filter arrives and the output leaves as 16-byte words.
  if (!aligned(filt) || !aligned(out)) return (int)cudaErrorInvalidValue;
  // The image rows as whole 16-byte chunks, or element by element.
  const int vec = aligned(x) && (s.W * s.C * (int)sizeof(T)) % 16 == 0;
  auto kernel = stem_conv_pool_kernel<T>;
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
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(filt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), s,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, c) NHWC, float32 (dtype 0) or bfloat16 (dtype 1); filt: the
// (64, 160) bf16 filter in the kernel's K order (kernels/stem.py
// stem_filter); bias: 64 float32; out: (n, ceil(ceil(h/2)/2),
// ceil(ceil(w/2)/2), 64) bf16. pad_top, pad_left: the conv's SAME padding
// before; pool_top, pool_left: the pool's. activation: 0 none, 1 relu, 2
// relu6. The launch plan is the caller's (kernels/stem.py plan_stem):
// blocks, at most one a tile, and the shared-memory bytes, which must be
// what this kernel lays out. Returns a cudaError_t value (0 = success).
extern "C" int ce_stem_conv_pool(const void* x, const void* filt,
                                 const void* bias, void* out, int n, int h,
                                 int w, int c, int kh, int kw, int pad_top,
                                 int pad_left, int pool_top, int pool_left,
                                 int activation, int dtype, int blocks,
                                 int smem_bytes, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > 4 || kh <= 0 || kw <= 0 ||
      pad_top < 0 || pad_top >= kh || pad_left < 0 || pad_left >= kw ||
      pool_top < 0 || pool_top > 1 || pool_left < 0 || pool_left > 1 ||
      activation < 0 || activation > 2 || (dtype != 0 && dtype != 1) ||
      (long long)n * h * w * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = n; s.H = h; s.W = w; s.C = c;
  s.KH = kh; s.KW = kw;
  s.KR = (kw * c + 1) / 2 * 2;
  s.K = kh * s.KR;
  s.pad_top = pad_top; s.pad_left = pad_left;
  s.HC = (h + 1) / 2; s.WC = (w + 1) / 2;
  s.pool_top = pool_top; s.pool_left = pool_left;
  s.HO = (s.HC + 1) / 2; s.WO = (s.WC + 1) / 2;
  s.tiles_x = (s.WO + kTPW - 1) / kTPW;
  s.tiles_per_image = (s.HO + kTPH - 1) / kTPH * s.tiles_x;
  s.n_tiles = n * s.tiles_per_image;
  s.PR = 2 * (kCR - 1) + kh;
  s.PE = (2 * (kCC - 1) + kw + (kw * c) % 2) * c;
  s.PRL = (s.PE + 1) / 2 * 2;
  s.E = dtype == 0 ? 4 : 8;
  s.NCH = (s.PE + 2 * s.E - 2) / s.E;
  s.act = activation;
  if (s.K > kMaxK || blocks < 1 || blocks > s.n_tiles ||
      smem_bytes != shared_bytes(s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? launch<float>(x, filt, bias, out, s, blocks, smem_bytes, st)
      : launch<__nv_bfloat16>(x, filt, bias, out, s, blocks, smem_bytes, st);
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
