// u32 RNG shared by the port's CUDA kernels: the murmur3 fmix32 mixer, the
// two-round keyed hash, the (seed, stream, t) salt and the 24-bit uniform,
// on native uint32_t.  Twin of repro_torch/kernels/common.py (and of the
// JAX package's repro/kernels/common.py); integer parts are bit-exact.
#pragma once
#include <cstdint>

namespace repro {

// salt streams of the ICWS draws (same ids as kernels/common.py)
constexpr uint32_t ICWS_STREAM_R1 = 1u;
constexpr uint32_t ICWS_STREAM_R2 = 2u;
constexpr uint32_t ICWS_STREAM_C1 = 3u;
constexpr uint32_t ICWS_STREAM_C2 = 4u;
constexpr uint32_t ICWS_STREAM_BETA = 5u;
constexpr uint32_t ICWS_STREAM_FP = 9u;
// salt streams of the linear sketches (same ids as kernels/common.py)
constexpr uint32_t CS_STREAM_BUCKET = 21u;
constexpr uint32_t CS_STREAM_SIGN = 22u;
constexpr uint32_t JL_STREAM_SIGN = 31u;
// salt stream of the TS/PS sample hash (host-built rows; listed for the map)
constexpr uint32_t SAMPLE_STREAM_HASH = 41u;
// salt streams of DMH (same ids as kernels/common.py)
constexpr uint32_t DMH_STREAM_BIN = 51u;
constexpr uint32_t DMH_STREAM_R1 = 52u;
constexpr uint32_t DMH_STREAM_R2 = 53u;
constexpr uint32_t DMH_STREAM_C1 = 54u;
constexpr uint32_t DMH_STREAM_C2 = 55u;
constexpr uint32_t DMH_STREAM_BETA = 56u;
constexpr uint32_t DMH_STREAM_FP = 57u;
constexpr uint32_t DMH_STREAM_DENSIFY = 58u;

// XOR salt of DMH replica r's pseudo-keys, key ^ r * REPLICA_SALT (u32 wrap;
// same value as repro_torch/core/dmh.py)
constexpr uint32_t REPLICA_SALT = 0x85EBCA6Bu;

// masked-lane hash value; a row whose minimum is >= BIG is empty
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// a salt's two terms in the keyed hash, for a kernel that hashes many keys
// under one salt: hash_u32(key, salt) == hash_pre(key, salt_pre(salt))
struct SaltPre {
  uint32_t add, mix;
};

__device__ __forceinline__ SaltPre salt_pre(uint32_t salt) {
  return {salt * 0x9E3779B9u, salt * 0xC2B2AE35u + 0x27D4EB2Fu};
}

__device__ __forceinline__ uint32_t hash_pre(uint32_t key, SaltPre s) {
  return mix32(mix32(key + s.add) ^ s.mix);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t key, uint32_t salt) {
  return hash_pre(key, salt_pre(salt));
}

// top 24 bits -> (0, 1): bits * 2^-24 + 2^-25, two roundings as in JAX
// (the product is exact, so a fused multiply-add would give the same value)
__device__ __forceinline__ float uniform01(uint32_t key, uint32_t salt) {
  const uint32_t bits = hash_u32(key, salt) >> 8;
  return __fadd_rn(__fmul_rn(__uint2float_rn(bits), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__device__ __forceinline__ uint32_t salt_for(uint32_t seed, uint32_t stream, uint32_t t) {
  return seed * 0x9E3779B1u + stream * 0x517CC1B7u + t * 0x2545F491u;
}

}  // namespace repro
