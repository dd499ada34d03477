// Device code shared by the three sketch-head kernels (lsh_hash.cu,
// sketch_head.cu, fused_decode.cu): the L2-LSH hash with its salted
// Carter–Wegman fold, and the count read of f32 / int8 / packed int4 sketch
// arrays.  The fused kernel and the two-kernel pair call the same functions,
// so they compute the same indices and the same sums by construction.
//
// Arithmetic rules: the hash is IEEE f32 — no fast math, round-to-nearest
// division (__fdiv_rn) and addition (__fadd_rn), no TF32 — because one
// rounding step flips a floor() bucket.  The fold is native uint32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lsh {

constexpr int kThreads = 256;  // threads per block, every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kBlockB = 8;     // most batch rows per block
constexpr int kCols = 2;       // vocab columns per thread in the gather
constexpr int kBlockV = kThreads * kCols;  // vocab columns per block

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

// Bucket indices of nb (<= kBlockB) query rows against an (L, K, dp) bank.
// q_s: (nb, dp) queries in shared memory; idx_s: (nb, L) result in shared
// memory.  Each thread hashes whole (row, l) items; the dot runs in order
// j = 0..dp-1.
__device__ __forceinline__ void hash_rows(
    const float* q_s, int nb, int dp, const float* __restrict__ w,
    const float* __restrict__ bias, int L, int K, float r, int R,
    int* idx_s) {
  for (int item = threadIdx.x; item < nb * L; item += blockDim.x) {
    const int bb = item / L, l = item % L;
    const float* q = q_s + bb * dp;
    uint32_t acc = row_salt(l);
    for (int k = 0; k < K; ++k) {
      const float* wr = w + (static_cast<int64_t>(l) * K + k) * dp;
      float proj = 0.f;
      for (int j = 0; j < dp; ++j) proj = fmaf(q[j], wr[j], proj);
      acc = mix_step(acc, subhash_code(proj, bias[l * K + k], r), k);
    }
    idx_s[item] = static_cast<int>(acc % static_cast<uint32_t>(R));
  }
}

// Count S[l, r, v] of an (L, R, V) f32 or int8 array, or of an
// (ceil(L/2), R, V) packed int4 array whose byte (i, r, v) holds row 2i in
// its low nibble and row 2i+1 in its high nibble.  Integers come back
// unscaled; the caller applies scale[l, r] term by term.
template <int QUANT>
__device__ __forceinline__ float read_count(const void* __restrict__ sketch,
                                            int l, int r, int R, int64_t V,
                                            int64_t v) {
  if constexpr (QUANT == kF32) {
    return static_cast<const float*>(sketch)[(static_cast<int64_t>(l) * R + r) * V + v];
  } else if constexpr (QUANT == kInt8) {
    return static_cast<float>(
        static_cast<const int8_t*>(sketch)[(static_cast<int64_t>(l) * R + r) * V + v]);
  } else {
    const int8_t byte = static_cast<const int8_t*>(
        sketch)[(static_cast<int64_t>(l >> 1) * R + r) * V + v];
    // Sign-extend the nibble: (x << 4) >> 4 for the low one, x >> 4 (an
    // arithmetic shift of the signed byte) for the high one.
    const int nib = (l & 1)
        ? (static_cast<int>(byte) >> 4)
        : (static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(byte) << 4)) >> 4);
    return static_cast<float>(nib);
  }
}

// Rows per block for a batch of B: the smallest of 1, 2, 4, 8 that holds
// it, 8 beyond.  The gather's register tile is (kCols, BT) sums.
inline int rows_per_block(int B) { return B >= 8 ? 8 : B >= 4 ? 4 : B >= 2 ? 2 : 1; }

// The (nb, kBlockV) logit tile starting at column v0:
//   out[b0 + bb, v] = (1/L) * sum_l scale[l, idx] * S[l, idx[bb, l], v]
// idx_s / scale_s: (BT, L) in shared memory, rows >= nb holding copies of
// a valid row so that every load is unguarded (their sums are dropped).
// Neighbouring threads take neighbouring v, so every read of an S row is
// coalesced.  Each thread owns kCols columns and issues U * kCols * BT = 32
// independent loads before adding them; the sum over l stays in f32
// registers, in order l = 0..L-1, as in the plain version.
template <int QUANT, int BT>
__device__ __forceinline__ void gather_tile(
    const void* __restrict__ sketch, const int* idx_s, const float* scale_s,
    int nb, int L, int R, int64_t V, int64_t v0, float inv_l,
    float* __restrict__ out, int64_t b0) {
  constexpr int U = 16 / BT;
  int64_t v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = v0 + threadIdx.x + static_cast<int64_t>(c) * kThreads;
    v[c] = col < V ? col : V - 1;          // ragged edge: load in bounds
  }
  float acc[kCols][BT];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) acc[c][bb] = 0.f;
  int l = 0;
  for (; l + U <= L; l += U) {
    float t[U][kCols][BT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int r = idx_s[bb * L + l + u];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          t[u][c][bb] = read_count<QUANT>(sketch, l + u, r, R, V, v[c]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        float s = 1.f;
        if constexpr (QUANT != kF32) s = scale_s[bb * L + l + u];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c][bb] += (QUANT != kF32) ? __fmul_rn(s, t[u][c][bb]) : t[u][c][bb];
      }
  }
  for (; l < L; ++l) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
      const int r = idx_s[bb * L + l];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float t = read_count<QUANT>(sketch, l, r, R, V, v[c]);
        acc[c][bb] += (QUANT != kF32) ? __fmul_rn(scale_s[bb * L + l], t) : t;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = v0 + threadIdx.x + static_cast<int64_t>(c) * kThreads;
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
      if (bb < nb && col < V) out[(b0 + bb) * V + col] = acc[c][bb] * inv_l;
  }
}

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
