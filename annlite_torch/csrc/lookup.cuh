// Pieces of the table-lookup kernels shared by csrc/adc.cu (the lookup core
// of K4, K5 and K7 above two queries), csrc/ivf.cu (K6, K7) and
// csrc/adc_i8.cu (K9): wide code loads and the bucketed top-2's insertion
// rule.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // row r of a row block is in lane r % 128
constexpr float kBig = 3.4e38f;      // BIG of the Python side, in float32

// Four neighbouring codes of one subspace in one load.
template <typename CodeT>
struct Codes4;

template <>
struct Codes4<uint8_t> {
  using Word = uint32_t;
  static __device__ __forceinline__ Word load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ Word zero() { return 0u; }
  // code j of the word, by one byte permute
  static __device__ __forceinline__ uint32_t at(Word w, int j) {
    return __byte_perm(w, 0u, 0x4440u + j);
  }
};

template <>
struct Codes4<uint16_t> {
  using Word = uint2;
  static __device__ __forceinline__ Word load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ Word zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ uint32_t at(Word w, int j) {
    return __byte_perm(j < 2 ? w.x : w.y, 0u, (j & 1) ? 0x4432u : 0x4410u);
  }
};

// Sequential insertion in ascending group order with strict '<' (the lowest
// group wins a tie); g1 and g2 share one register, 16 bits each.
__device__ __forceinline__ void top2_insert(float v, uint32_t g, float& mn1, float& mn2,
                                            uint32_t& gg) {
  if (v < mn1) {  // g1 moves to g2
    mn2 = mn1;
    mn1 = v;
    gg = (gg << 16) | g;
  } else if (v < mn2) {
    mn2 = v;
    gg = (gg & 0xFFFFu) | (g << 16);
  }
}

}  // namespace
