// Fused sketched decode: for final hiddens h (B, d),
//   q = h . A                         (d -> dp asymmetric transform)
//   idx[b, l] = fold_k floor((q . W[l, k] + bias[l, k]) / r)   (L2-LSH)
//   logits[b, v] = (1/L) * sum_l scale[l, idx] * S[l, idx[b, l], v]
// in one launch, with S stored f32, int8 or packed int4 as in
// sketch_head.cu.
//
// Replaces: src/repro/kernels/fused_decode/kernel.py:_fused_decode_kernel,
// the serving default of the sketched head.
//
// Bound on this card: bytes — the S rows the batch touches, as in
// sketch_head.cu; q and the hash cost B*d*dp + B*L*K*dp FMAs, far below
// the f32 rate.  Design: each block owns a (BT, kBlockV) output tile.  It
// first computes q and idx for its batch rows into shared memory, so the
// (B, L) indices never reach device memory, then runs the gather of
// sketch_head.cu.  Every block of a row tile recomputes q, as the TPU
// kernel does per vocab tile, so each reads all of A (256-512 KB, from L2):
// the warps split d, the lanes take columns of A, and each lane issues a
// whole chunk of A loads (kRowsPerWarp x kColsPerLane) before the FMAs so
// that the reads overlap; the warps' partial sums are added in a fixed
// order.
#include "lsh_common.cuh"

namespace {

constexpr int kChunk = 256;                             // rows of d per step
constexpr int kRowsPerWarp = kChunk / lsh::kWarps;      // 32
constexpr int kColsPerLane = 2;                         // pass width 64

// q_s (BT, dp) = h[b0 : b0 + nb] . A, rows >= nb zero.  h_s: (BT, kChunk)
// and part_s: (kWarps, BT, dp) scratch in shared memory.
template <int BT>
__device__ __forceinline__ void transform_rows(
    const float* __restrict__ h, const float* __restrict__ A, int nb, int d,
    int dp, int64_t b0, float* h_s, float* part_s, float* q_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < dp; j0 += 32 * kColsPerLane) {
    float acc[kColsPerLane][BT];
#pragma unroll
    for (int cj = 0; cj < kColsPerLane; ++cj)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[cj][bb] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      // This warp's rows of A in the chunk, all loads issued at once.
      const int i0 = c0 + warp * kRowsPerWarp;
      float a[kRowsPerWarp][kColsPerLane];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u)
#pragma unroll
        for (int cj = 0; cj < kColsPerLane; ++cj) {
          const int i = i0 + u, j = j0 + lane + 32 * cj;
          a[u][cj] = (i < d && j < dp) ? A[static_cast<int64_t>(i) * dp + j] : 0.f;
        }
      for (int t = threadIdx.x; t < BT * kChunk; t += blockDim.x) {
        const int bb = t / kChunk, i = c0 + t % kChunk;
        h_s[t] = (bb < nb && i < d) ? h[(b0 + bb) * d + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u)
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const float x = h_s[bb * kChunk + warp * kRowsPerWarp + u];
#pragma unroll
          for (int cj = 0; cj < kColsPerLane; ++cj)
            acc[cj][bb] = fmaf(x, a[u][cj], acc[cj][bb]);
        }
      __syncthreads();
    }
#pragma unroll
    for (int cj = 0; cj < kColsPerLane; ++cj) {
      const int j = j0 + lane + 32 * cj;
      if (j < dp)
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) part_s[(warp * BT + bb) * dp + j] = acc[cj][bb];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < BT * dp; o += blockDim.x) {
    float s = part_s[o];
    for (int w = 1; w < lsh::kWarps; ++w) s = __fadd_rn(s, part_s[w * BT * dp + o]);
    q_s[o] = s;
  }
  __syncthreads();
}

template <int QUANT, int BT>
__global__ void __launch_bounds__(lsh::kThreads)
fused_decode_kernel(const float* __restrict__ h, const float* __restrict__ A,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const void* __restrict__ sketch,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int* __restrict__ idx_out, int B, int d, int dp, int L,
                    int K, int R, int64_t V, float r, float inv_l) {
  extern __shared__ float smem[];
  float* h_s = smem;                                 // (BT, kChunk)
  float* part_s = h_s + BT * kChunk;                 // (kWarps, BT, dp)
  float* q_s = part_s + lsh::kWarps * BT * dp;       // (BT, dp)
  float* scale_s = q_s + BT * dp;                    // (BT, L)
  int* idx_s = reinterpret_cast<int*>(scale_s + BT * L);  // (BT, L)
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * BT;
  const int nb = min(BT, static_cast<int>(B - b0));

  // 1. q = h . A, 2. hash the block's rows.
  transform_rows<BT>(h, A, nb, d, dp, b0, h_s, part_s, q_s);
  lsh::hash_rows(q_s, nb, dp, w, bias, L, K, r, R, idx_s);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * L; i += blockDim.x) {
    const int bb = i / L, l = i % L;
    // Rows past the batch repeat its last row (their sums are dropped).
    const int idx = idx_s[(bb < nb ? bb : nb - 1) * L + l];
    if (bb >= nb) idx_s[i] = idx;
    if constexpr (QUANT != lsh::kF32) scale_s[i] = scale[l * R + idx];
    if (idx_out != nullptr && blockIdx.x == 0 && bb < nb) idx_out[b0 * L + i] = idx;
  }
  __syncthreads();

  // 3. Gather the tile.
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * lsh::kBlockV;
  lsh::gather_tile<QUANT, BT>(sketch, idx_s, scale_s, nb, L, R, V, v0, inv_l, out, b0);
}

template <int QUANT, int BT>
int launch(const float* h, const float* A, const float* w, const float* bias,
           const void* sketch, const float* scale, float* out, int* idx_out,
           int B, int d, int dp, int L, int K, int R, int64_t V, float r,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (BT * kChunk + lsh::kWarps * BT * dp + BT * dp + 2 * BT * L);
  cudaError_t err = lsh::allow_smem(fused_decode_kernel<QUANT, BT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + lsh::kBlockV - 1) / lsh::kBlockV, (B + BT - 1) / BT);
  fused_decode_kernel<QUANT, BT><<<grid, lsh::kThreads, smem, stream>>>(
      h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r,
      1.0f / static_cast<float>(L));
  return static_cast<int>(cudaGetLastError());
}

template <int QUANT>
int launch_rows(const float* h, const float* A, const float* w,
                const float* bias, const void* sketch, const float* scale,
                float* out, int* idx_out, int B, int d, int dp, int L, int K,
                int R, int64_t V, float r, cudaStream_t stream) {
  switch (lsh::rows_per_block(B)) {
    case 1: return launch<QUANT, 1>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    case 2: return launch<QUANT, 2>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    case 4: return launch<QUANT, 4>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    default: return launch<QUANT, 8>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
  }
}

}  // namespace

extern "C" int fused_decode_launch(const float* h, const float* A,
                                   const float* w, const float* bias,
                                   const void* sketch, const float* scale,
                                   float* out, int* idx_out, int B, int d,
                                   int dp, int L, int K, int R, int64_t V,
                                   float r, int quant, cudaStream_t stream) {
  switch (quant) {
    case lsh::kF32:
      return launch_rows<lsh::kF32>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    case lsh::kInt8:
      return launch_rows<lsh::kInt8>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    case lsh::kInt4:
      return launch_rows<lsh::kInt4>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
