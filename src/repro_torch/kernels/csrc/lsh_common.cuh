// Device code shared by the sketch-head kernels (lsh_hash.cu,
// fused_decode.cu, and through gather_ring.cuh sketch_head.cu): the
// L2-LSH hash's code of a projection and its salted Carter–Wegman fold.
// lsh_hash.cu and the fused kernel call the same functions on the same
// fmaf chains, so they compute the same indices by construction.
//
// Arithmetic rules: the hash is IEEE f32 — no fast math, round-to-nearest
// division (__fdiv_rn) and addition (__fadd_rn), no TF32 — because one
// rounding step flips a floor() bucket.  The fold is native uint32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lsh {

constexpr int kThreads = 256;  // threads per block (race_update.cu)
constexpr int kWarps = kThreads / 32;

enum Quant : int { kF32 = 0, kInt8 = 1, kInt4 = 2 };

// Fold salt of sketch row l (the JAX package's row_salts).
__device__ __forceinline__ uint32_t row_salt(int l) {
  return static_cast<uint32_t>(l) * 0x9E3779B9u;
}

// One step of the K-fold mix, bit-for-bit core/lsh.py:_fold_subhashes.
__device__ __forceinline__ uint32_t mix_step(uint32_t acc, uint32_t code,
                                             int i) {
  acc = acc * 1103515245u + code + static_cast<uint32_t>(i * 97 + 13);
  acc ^= acc >> 16;
  acc *= 0x45D9F3Bu;
  acc ^= acc >> 16;
  return acc;
}

// floor((proj + b) / r) as int32, then its uint32 bits.
__device__ __forceinline__ uint32_t subhash_code(float proj, float b,
                                                 float r) {
  const float t = __fdiv_rn(__fadd_rn(proj, b), r);
  return static_cast<uint32_t>(static_cast<int32_t>(floorf(t)));
}

// subhash_code for r a power of two, given inv_r = 1/r (then exact): the
// product y * (1/r) is the correctly rounded y / r, so the code is the
// same.
__device__ __forceinline__ uint32_t subhash_code_pow2(float proj, float b,
                                                      float inv_r) {
  const float t = __fmul_rn(__fadd_rn(proj, b), inv_r);
  return static_cast<uint32_t>(static_cast<int32_t>(floorf(t)));
}

// Batch rows a block of the count gather: the smallest of 1, 2, 4, 8 that
// holds B, 8 beyond.
inline int rows_per_block(int B) { return B >= 8 ? 8 : B >= 4 ? 4 : B >= 2 ? 2 : 1; }

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lsh

// Message of a CUDA error code returned by a launcher (each library
// exports its own copy).
extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
