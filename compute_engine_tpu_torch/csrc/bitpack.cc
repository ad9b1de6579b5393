// Host-side bitpacking for the binary compute engine's PyTorch port.
//
// Native counterpart of LCE's CPU bitpacking
// (`larq_compute_engine/core/bitpacking/bitpack.h` portable path and the
// NEON `bitpack_aarch64.h`): used on the host for converter-time weight
// packing and input-pipeline quantisation, where numpy's bit manipulation is
// much slower than tight native loops. This is a host library, not a GPU
// kernel: packing on the device is ``core.bitpack.bitpack`` (torch).
//
// Semantics (must match core/bitpack.py exactly):
//   - 32 values per uint32 word along the last (contiguous) axis, LSB-first
//   - bit = value < zero_point (floats: < 0)
//   - padding bits (cols % 32 != 0) are 0
//
// Build: g++ -O3 -shared -fPIC -o libce_host.so bitpack.cc (utils/native.py
// builds it at first use into the package's build/ directory).

#include <cstdint>
#include <cstring>

namespace {

template <typename T>
inline void pack_row(const T* in, std::uint32_t* out, std::int64_t cols,
                     T zero_point) {
  const std::int64_t full_words = cols / 32;
  for (std::int64_t w = 0; w < full_words; ++w) {
    std::uint32_t word = 0;
    const T* p = in + w * 32;
    for (int j = 0; j < 32; ++j) {
      word |= static_cast<std::uint32_t>(p[j] < zero_point) << j;
    }
    out[w] = word;
  }
  const std::int64_t rem = cols - full_words * 32;
  if (rem) {
    std::uint32_t word = 0;
    const T* p = in + full_words * 32;
    for (int j = 0; j < rem; ++j) {
      word |= static_cast<std::uint32_t>(p[j] < zero_point) << j;
    }
    out[full_words] = word;  // padding bits stay 0
  }
}

template <typename T>
inline void unpack_row(const std::uint32_t* in, T* out, std::int64_t cols,
                       T zero_bit, T one_bit) {
  for (std::int64_t c = 0; c < cols; ++c) {
    out[c] = (in[c / 32] >> (c % 32)) & 1u ? one_bit : zero_bit;
  }
}

}  // namespace

extern "C" {

void ce_bitpack_f32(const float* in, std::uint32_t* out, std::int64_t rows,
                    std::int64_t cols) {
  const std::int64_t packed_cols = (cols + 31) / 32;
  for (std::int64_t r = 0; r < rows; ++r) {
    pack_row(in + r * cols, out + r * packed_cols, cols, 0.0f);
  }
}

void ce_bitpack_i8(const std::int8_t* in, std::uint32_t* out,
                   std::int64_t rows, std::int64_t cols,
                   std::int32_t zero_point) {
  const std::int64_t packed_cols = (cols + 31) / 32;
  if (zero_point <= -128) {  // all bits 0 (`bitpack.h:259-263`)
    std::memset(out, 0, sizeof(std::uint32_t) * rows * packed_cols);
    return;
  }
  if (zero_point > 127) {  // all ones except padding (`bitpack.h:265-288`)
    const int rem = static_cast<int>(cols % 32);
    const std::uint32_t last =
        rem ? ((1u << rem) - 1u) : 0xFFFFFFFFu;
    for (std::int64_t r = 0; r < rows; ++r) {
      std::uint32_t* o = out + r * packed_cols;
      for (std::int64_t w = 0; w + 1 < packed_cols; ++w) o[w] = 0xFFFFFFFFu;
      o[packed_cols - 1] = last;
    }
    return;
  }
  const std::int8_t zp = static_cast<std::int8_t>(zero_point);
  for (std::int64_t r = 0; r < rows; ++r) {
    pack_row(in + r * cols, out + r * packed_cols, cols, zp);
  }
}

void ce_unpack_f32(const std::uint32_t* in, float* out, std::int64_t rows,
                   std::int64_t cols, float zero_bit, float one_bit) {
  const std::int64_t packed_cols = (cols + 31) / 32;
  for (std::int64_t r = 0; r < rows; ++r) {
    unpack_row(in + r * packed_cols, out + r * cols, cols, zero_bit, one_bit);
  }
}

}  // extern "C"
