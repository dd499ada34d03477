// Sketched LM-head gather: given bucket indices idx (B, L) and per-class
// count arrays S, logits[b, v] = (1/L) * sum_l scale[l, idx] * S[l, idx[b, l], v].
// S is (L, R, V) f32, (L, R, V) int8, or (ceil(L/2), R, V) packed int4, the
// integer forms with (L, R) f32 scales.
//
// Replaces: src/repro/kernels/sketch_head/kernel.py:_sketch_head_kernel,
// the second half of the two-kernel sketched head.
//
// Bound on this card: bytes.  A query reads one V-row of S per repetition
// l; the rows a batch touches are at most B*L (fewer where queries share a
// bucket), and from B >= R the whole array.  The operations (B*L*V adds)
// are far below the f32 rate.  Design: the TPU turned the gather into a
// one-hot MXU product because it has no fast gather; here each block owns a
// (BT, kBlockV) output tile (BT = 1, 2, 4 or 8 rows, from B), stages its
// indices (and the matching scales) in shared memory, and makes L reads
// along V in which neighbouring threads read neighbouring v, so every read
// is coalesced.  The reads are latency-bound unless many are in flight, so
// each thread issues 32 independent loads before it adds them.  Integer
// counts are scaled in registers; no dequantized array exists in device
// memory.
#include "lsh_common.cuh"

namespace {

template <int QUANT, int BT>
__global__ void __launch_bounds__(lsh::kThreads)
sketch_head_kernel(const int* __restrict__ idx, const void* __restrict__ sketch,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int B, int L, int R, int64_t V, float inv_l) {
  extern __shared__ float smem[];
  float* scale_s = smem;                                  // (BT, L)
  int* idx_s = reinterpret_cast<int*>(scale_s + BT * L);  // (BT, L)
  __shared__ int bad_s[BT];
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * BT;
  const int nb = min(BT, static_cast<int>(B - b0));
  if (threadIdx.x < BT) bad_s[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < BT * L; i += blockDim.x) {
    const int bb = i / L, l = i % L;
    // Rows past the batch repeat its last row (their sums are dropped).
    int r = idx[(b0 + min(bb, nb - 1)) * L + l];
    // An index outside [0, R) would read outside S: read bucket 0 instead
    // and poison the row's logits with NaN below.
    if (r < 0 || r >= R) {
      bad_s[bb] = 1;
      r = 0;
    }
    idx_s[i] = r;
    if constexpr (QUANT != lsh::kF32) scale_s[i] = scale[l * R + r];
  }
  __syncthreads();
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * lsh::kBlockV;
  lsh::gather_tile<QUANT, BT>(sketch, idx_s, scale_s, nb, L, R, V, v0, inv_l, out, b0);
  for (int bb = 0; bb < nb; ++bb) {
    if (!bad_s[bb]) continue;
    for (int64_t v = v0 + threadIdx.x; v < min(V, v0 + lsh::kBlockV); v += blockDim.x)
      out[(b0 + bb) * V + v] = __int_as_float(0x7fc00000);
  }
}

template <int QUANT, int BT>
int launch(const int* idx, const void* sketch, const float* scale, float* out,
           int B, int L, int R, int64_t V, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * BT * L;
  cudaError_t err = lsh::allow_smem(sketch_head_kernel<QUANT, BT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + lsh::kBlockV - 1) / lsh::kBlockV, (B + BT - 1) / BT);
  sketch_head_kernel<QUANT, BT><<<grid, lsh::kThreads, smem, stream>>>(
      idx, sketch, scale, out, B, L, R, V, 1.0f / static_cast<float>(L));
  return static_cast<int>(cudaGetLastError());
}

template <int QUANT>
int launch_rows(const int* idx, const void* sketch, const float* scale,
                float* out, int B, int L, int R, int64_t V, cudaStream_t stream) {
  switch (lsh::rows_per_block(B)) {
    case 1: return launch<QUANT, 1>(idx, sketch, scale, out, B, L, R, V, stream);
    case 2: return launch<QUANT, 2>(idx, sketch, scale, out, B, L, R, V, stream);
    case 4: return launch<QUANT, 4>(idx, sketch, scale, out, B, L, R, V, stream);
    default: return launch<QUANT, 8>(idx, sketch, scale, out, B, L, R, V, stream);
  }
}

}  // namespace

extern "C" int sketch_head_launch(const int* idx, const void* sketch,
                                  const float* scale, float* out, int B,
                                  int L, int R, int64_t V, int quant,
                                  cudaStream_t stream) {
  switch (quant) {
    case lsh::kF32: return launch_rows<lsh::kF32>(idx, sketch, scale, out, B, L, R, V, stream);
    case lsh::kInt8: return launch_rows<lsh::kInt8>(idx, sketch, scale, out, B, L, R, V, stream);
    case lsh::kInt4: return launch_rows<lsh::kInt4>(idx, sketch, scale, out, B, L, R, V, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
