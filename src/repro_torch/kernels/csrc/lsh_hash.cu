// L2-LSH bucket indices of a batch of queries: (B, dp) x (L, K, dp) bank
// -> (B, L) int32.
//
// Replaces: src/repro/kernels/lsh_hash/kernel.py:_lsh_hash_kernel (with
// _mix_codes), the first half of the two-kernel sketched head, and the
// hash of the paper's freeze and query.
//
// Bound on this card: at the serving shapes neither (a few tens of KB, a
// few hundred thousand FMAs: launch latency); at the paper's queries (B
// up to 5000, L 2000-4000) the (B, L) int32 output's bytes, or at yearmsd's
// (K 3, dp 32) the B*L*K*dp f32 FMAs.  No tensor cores: TF32 or bf16 would
// round the projection and flip floor() buckets.
//
// Design: a register-tiled f32 product with the hash in its epilogue.
// Block (x, y) owns query rows [x*TB, x*TB + TB) (TB = 16*RM: 16 for small
// batches, 64 beyond) and sketch rows [y*64, y*64 + 64); its 256 threads
// form a 16 x 16 grid, thread (ty, tx) owning rows ty + 16*i (i < RM) and
// sketch rows tx + 16*jj (jj < 4).  For k = 0..K-1 the block stages the
// queries' and w[., k, .]'s rows in shared memory by cp.async copies, in
// chunks of up to 64 of dp (zero past dp; rows padded to an odd number of
// 16-byte units, so the float4 reads of 16 neighbouring rows hit distinct
// banks), and each thread runs its RM x 4 projections as fmaf chains over
// j = 0..dp-1 in increasing order from +0: lsh_common.cuh's arithmetic,
// the same bits as fused_decode.cu's hash (padding adds fmaf(0, 0, acc),
// which leaves a sum from +0 unchanged).  After each k the epilogue folds
// the projections into the running codes (lsh::subhash_code, or for r a
// power of two lsh::subhash_code_pow2: the same quotient by one product
// in place of a division; then lsh::mix_step); after the last, the codes
// mod R are stored, neighbouring threads on neighbouring l.
#include "bulk_copy.cuh"
#include "lsh_common.cuh"

#include <cmath>

namespace {

constexpr int kTx = 16, kTy = 16;           // threads along l, along rows
constexpr int kThreads = kTx * kTy;
constexpr int kRN = 4;                      // sketch rows a thread
constexpr int kTileL = kTx * kRN;           // sketch rows a block
constexpr int kChunk = 64;                  // of dp staged at once (a multiple of 4)

// Floats between staged rows for a chunk of nj4 (a multiple of 4): an odd
// number of 16-byte units.
__host__ __device__ __forceinline__ int row_stride(int nj4) { return 4 * ((nj4 / 4) | 1); }

// Stage rows [0, rows) of a tile (row i at src + off + i * src_stride, nj
// floats) into dst (row i at dst + i * stride, nj4 floats, zero past nj
// and from row n_valid on) by cp.async: 16-byte copies where `vec` says
// every row start is 16-byte aligned and nj == nj4, else 4-byte ones.
// The caller waits for them (bulk::wait_copies) before a barrier.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int64_t n_valid,
                                      int rows, int src_stride, int64_t off, int nj, int nj4,
                                      int stride, bool vec) {
  if (vec) {
    const int nq = nj4 / 4;
    for (int e = threadIdx.x; e < rows * nq; e += kThreads) {
      const int row = e / nq, q = e % nq;
      float* d = dst + row * stride + 4 * q;
      if (row < n_valid)
        bulk::copy16(d, src + off + static_cast<int64_t>(row) * src_stride + 4 * q);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * nj4; e += kThreads) {
      const int row = e / nj4, j = e % nj4;
      float* d = dst + row * stride + j;
      if (row < n_valid && j < nj)
        bulk::copy4(d, src + off + static_cast<int64_t>(row) * src_stride + j);
      else
        *d = 0.f;
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, int* __restrict__ out, int B,
                int dp, int L, int K, int R, float r, float inv_r, bool vec) {
  constexpr int kTileB = kTy * RM;
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTileB;
  const int l0 = blockIdx.y * kTileL;
  const int n_chunks = (dp + kChunk - 1) / kChunk;
  uint32_t code[RM][kRN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) code[i][jj] = lsh::row_salt(l0 + tx + kTx * jj);

  for (int k = 0; k < K; ++k) {
    float acc[RM][kRN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < kRN; ++jj) acc[i][jj] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk, nj = min(kChunk, dp - j0), nj4 = (nj + 3) & ~3;
      const int stride = row_stride(nj4);
      float* x_s = smem;                       // (kTileB, stride)
      float* w_s = smem + kTileB * stride;     // (kTileL, stride)
      __syncthreads();                         // the last chunk's reads are done
      if (k == 0 || n_chunks > 1)   // the queries' chunk, unless it is still there
        stage(x_s, x, B - b0, kTileB, dp, b0 * dp + j0, nj, nj4, stride, vec);
      stage(w_s, w, L - l0, kTileL, K * dp, (static_cast<int64_t>(l0) * K + k) * dp + j0, nj, nj4,
            stride, vec);
      bulk::wait_copies();
      __syncthreads();
      for (int j = 0; j < nj4; j += 4) {
        float4 xv[RM], wv[kRN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          xv[i] = *reinterpret_cast<const float4*>(x_s + (ty + kTy * i) * stride + j);
#pragma unroll
        for (int jj = 0; jj < kRN; ++jj)
          wv[jj] = *reinterpret_cast<const float4*>(w_s + (tx + kTx * jj) * stride + j);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int jj = 0; jj < kRN; ++jj) {
            acc[i][jj] = fmaf(xv[i].x, wv[jj].x, acc[i][jj]);
            acc[i][jj] = fmaf(xv[i].y, wv[jj].y, acc[i][jj]);
            acc[i][jj] = fmaf(xv[i].z, wv[jj].z, acc[i][jj]);
            acc[i][jj] = fmaf(xv[i].w, wv[jj].w, acc[i][jj]);
          }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) {
      const int l = min(l0 + tx + kTx * jj, L - 1);
      const float bl = bias[l * K + k];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        code[i][jj] = lsh::mix_step(code[i][jj],
                                    inv_r != 0.f ? lsh::subhash_code_pow2(acc[i][jj], bl, inv_r)
                                                 : lsh::subhash_code(acc[i][jj], bl, r),
                                    k);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t b = b0 + ty + kTy * i;
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) {
      const int l = l0 + tx + kTx * jj;
      if (b < B && l < L)
        out[b * L + l] = static_cast<int>(code[i][jj] % static_cast<uint32_t>(R));
    }
  }
}

template <int RM>
int launch(const float* x, const float* w, const float* bias, int* out, int B, int dp, int L,
           int K, int R, float r, cudaStream_t stream) {
  const int nj4 = ((dp < kChunk ? dp : kChunk) + 3) & ~3;
  const size_t smem = sizeof(float) * (kTy * RM + kTileL) * row_stride(nj4);
  const dim3 grid((B + kTy * RM - 1) / (kTy * RM), (L + kTileL - 1) / kTileL);
  const bool vec = dp % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                    reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  // 1/r where r is a power of two (then exact, and y * (1/r) is y / r
  // correctly rounded, one instruction in place of a division), else 0.
  int e = 0;
  const float inv_r = std::frexp(r, &e) == 0.5f ? 1.0f / r : 0.f;
  lsh_hash_kernel<RM><<<grid, kThreads, smem, stream>>>(x, w, bias, out, B, dp, L, K, R, r,
                                                         inv_r, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsh_hash_launch(const float* x, const float* w,
                               const float* bias, int* out, int B, int dp,
                               int L, int K, int R, float r,
                               cudaStream_t stream) {
  // Batches of up to 16 rows take one row a thread (the serving and
  // tenant shapes), larger ones four.
  return B <= kTy ? launch<1>(x, w, bias, out, B, dp, L, K, R, r, stream)
                  : launch<4>(x, w, bias, out, B, dp, L, K, R, r, stream);
}
