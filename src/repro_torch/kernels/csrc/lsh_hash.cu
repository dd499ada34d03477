// L2-LSH bucket indices of a batch of queries: (B, dp) x (L, K, dp) bank
// -> (B, L) int32.
//
// Replaces: src/repro/kernels/lsh_hash/kernel.py:_lsh_hash_kernel (with
// _mix_codes), the first half of the two-kernel sketched head.
//
// Bound on this card: neither bytes nor operations — at the serving shapes
// it reads a few tens of KB and does B*L*K*dp FMAs (a few hundred
// thousand), so its time is launch latency.  The TPU kernel ran the
// projection on the MXU; here each thread hashes whole (row, l) items with
// the bank read through L1, which is enough for a kernel this small.  The
// hash itself is lsh_common.cuh's, shared with fused_decode.cu.
#include "lsh_common.cuh"

namespace {

__global__ void __launch_bounds__(lsh::kThreads)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, int* __restrict__ out, int B,
                int dp, int L, int K, int R, float r) {
  extern __shared__ float smem[];
  float* q_s = smem;                              // (kBlockB, dp)
  int* idx_s = reinterpret_cast<int*>(q_s + lsh::kBlockB * dp);  // (kBlockB, L)
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * lsh::kBlockB;
  const int nb = min(lsh::kBlockB, static_cast<int>(B - b0));
  for (int i = threadIdx.x; i < nb * dp; i += blockDim.x) q_s[i] = x[b0 * dp + i];
  __syncthreads();
  lsh::hash_rows(q_s, nb, dp, w, bias, L, K, r, R, idx_s);
  __syncthreads();
  for (int i = threadIdx.x; i < nb * L; i += blockDim.x) out[b0 * L + i] = idx_s[i];
}

}  // namespace

extern "C" int lsh_hash_launch(const float* x, const float* w,
                               const float* bias, int* out, int B, int dp,
                               int L, int K, int R, float r,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * lsh::kBlockB * (dp + L);
  cudaError_t err = lsh::allow_smem(lsh_hash_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + lsh::kBlockB - 1) / lsh::kBlockB);
  lsh_hash_kernel<<<grid, lsh::kThreads, smem, stream>>>(x, w, bias, out, B,
                                                         dp, L, K, R, r);
  return static_cast<int>(cudaGetLastError());
}
