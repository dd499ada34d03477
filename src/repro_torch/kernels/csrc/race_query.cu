// RACE sketch query (Algorithm 2): row reads, then median of means.
//   reads[b, c, l] = S[c, l, idx[b, l]]
//   mean[b, c, j]  = sum_{l in group j} reads[b, c, l] / m,  m = L / g
//                    (groups of m consecutive rows; the L % g tail rows
//                    are dropped)
//   out[b, c]      = median_j mean[b, c, j]  ((lo + hi) * 0.5 for even g)
// S (C, L, R) f32, idx (B, L) int32, out (B, C) f32.  An index outside
// [0, R) reads a zero count, as the TPU kernel's one-hot does.
//
// Replaces: src/repro/kernels/race_query/kernel.py:_race_query_kernel
// (launcher race_query_pallas).
//
// Bound on this card: bytes.  The function reads each query's L indices
// once (B * L * 4 bytes: 40 MB for the adult test set at L = 2000) and the
// sketch once (0.5 - 2 MB at the paper's sizes, small enough to stay in the
// 50 MB L2); its B * C * L adds are negligible.
//
// Design.  The TPU kernel contracted a one-hot (Bt, L, R) cube with the
// sketch on the MXU because the TPU has no fast gather; here each read is a
// direct gather from L2.  One warp owns one query row: its lanes walk a
// group's rows with stride 32 (neighbouring lanes read neighbouring indices,
// coalesced), gather S[c, l, r] for up to kMaxC channels per index read, and
// add into lane partial sums in increasing l.  A fixed xor-shuffle tree then
// adds the 32 partials; each step adds a + b on one lane and b + a on its
// partner, so every lane holds the same bits, and two launches on the same
// inputs give the same bits (no atomics).  The mean is __fdiv_rn(sum, m).
// The g <= 64 group means go to shared memory; lane t ranks mean t among
// them (ties broken by group index, so the ranks are a permutation) and the
// lanes holding the middle rank(s) hand their values to lane 0, which
// writes (lo + hi) * 0.5 — jnp.median's midpoint, exactly x for odd g.  A
// NaN mean (L < g gives 0 / 0) makes the result NaN, as in JAX.
#include "lsh_common.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // query rows per block
constexpr int kMaxC = 4;               // channels per index read
constexpr int kMaxG = 64;              // most groups
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
race_query_kernel(const float* __restrict__ S, const int* __restrict__ idx,
                  float* __restrict__ out, int B, int C, int L, int R,
                  int g) {
  __shared__ float means_s[kWarps][kMaxC][kMaxG];
  __shared__ float mid_s[kWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;                  // whole warps only: no block barrier
  const int m = L / g;
  const int* row = idx + b * L;
  const float nan = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int nc = min(kMaxC, C - c0);
    for (int j = 0; j < g; ++j) {
      float acc[kMaxC];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) acc[cc] = 0.0f;
#pragma unroll 4
      for (int i = lane; i < m; i += 32) {
        const int l = j * m + i;
        const int r = __ldg(row + l);
        if (r < 0 || r >= R) continue;
#pragma unroll
        for (int cc = 0; cc < kMaxC; ++cc)
          if (cc < nc)
            acc[cc] = __fadd_rn(
                acc[cc],
                __ldg(S + (static_cast<int64_t>(c0 + cc) * L + l) * R + r));
      }
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc)
        for (int off = 16; off > 0; off >>= 1)
          acc[cc] = __fadd_rn(acc[cc], __shfl_xor_sync(kFull, acc[cc], off));
      if (lane == 0)
        for (int cc = 0; cc < nc; ++cc)
          means_s[warp][cc][j] = __fdiv_rn(acc[cc], static_cast<float>(m));
    }
    __syncwarp();
    for (int cc = 0; cc < nc; ++cc) {
      const float* means = means_s[warp][cc];
      bool has_nan = false;
      for (int t = lane; t < g; t += 32) {
        const float v = means[t];
        has_nan |= isnan(v);
        int rank = 0;
        for (int u = 0; u < g; ++u) {
          const float w = means[u];
          rank += (w < v) || (w == v && u < t);
        }
        if (rank == (g - 1) / 2) mid_s[warp][0] = v;
        if (rank == g / 2) mid_s[warp][1] = v;
      }
      has_nan = __any_sync(kFull, has_nan);
      __syncwarp();
      if (lane == 0)
        out[b * C + c0 + cc] =
            has_nan ? nan
                    : __fmul_rn(__fadd_rn(mid_s[warp][0], mid_s[warp][1]),
                                0.5f);
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int race_query_launch(const float* S, const int* idx, float* out,
                                 int B, int C, int L, int R, int g,
                                 cudaStream_t stream) {
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kWarps - 1) / kWarps);
  race_query_kernel<<<grid, kThreads, 0, stream>>>(S, idx, out, B, C, L, R,
                                                   g);
  return static_cast<int>(cudaGetLastError());
}
