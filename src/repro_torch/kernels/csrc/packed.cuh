// bf16-halfword codec of the packed corpus layout, on the device: the twin
// of repro_torch/kernels/packed.py.  word k = bf16(x[2k]) | bf16(x[2k+1]) << 16,
// bf16 the top 16 bits of the f32 (truncation), so the decode is exact.
#pragma once
#include <cstdint>

namespace repro {

// the even sample of a word (its low halfword)
__device__ __forceinline__ float unpack_even(int w) {
  return __uint_as_float((uint32_t)w << 16);
}

// the odd sample of a word (its high halfword)
__device__ __forceinline__ float unpack_odd(int w) {
  return __uint_as_float((uint32_t)w & 0xFFFF0000u);
}

// sample j of a row of packed words: word j >> 1, halfword j & 1
__device__ __forceinline__ float unpack_at(const int* words, int j) {
  const int w = words[j >> 1];
  return (j & 1) ? unpack_odd(w) : unpack_even(w);
}

// the halfword of x in place for slot parity `odd` (0: low, 1: high)
__device__ __forceinline__ uint32_t pack_half(float x, int odd) {
  const uint32_t h = __float_as_uint(x) >> 16;
  return odd ? h << 16 : h;
}

}  // namespace repro
