// Online fold of weighted points into RACE count arrays (the streaming
// update the Representer Sketch was built for):
//   out[l, r, v] = counts[l, r, v] + sum_m alpha[m, v] * [idx[m, l] == r]
// idx (M, L) int32, alpha (M, V) f32; counts and out are f32 arrays
// addressed through element strides (sl, sr, sv), so the head's own
// (L, R, V) layout (V contiguous) and the reference's (C, L, R) layout
// (C = V classes) both run without a transposed copy.  An index outside
// [0, R) adds nothing, as a one-hot row of zeros does.
//
// Replaces: src/repro/kernels/race_update/kernel.py:_race_update_kernel
// (launcher race_update_pallas; ops.race_update returns sketch + delta).
//
// Bound on this card: bytes.  The function reads the counts and alpha once
// and writes the counts once: at the refresh of the rwkv6 serve head
// (M = 256, L = 128, R = 16, V = 65536) that is 537 + 67 + 537 MB, about
// 0.34 ms at 3.35 TB/s; its M*L*V adds (2.1 G) take about 32 us at the f32
// rate.
//
// Design.  The TPU kernel contracted a one-hot cube against alpha on the
// MXU and carried the sum across grid steps.  Here there are no atomics (an
// f32 atomicAdd sums in an order that changes from run to run) and no
// one-hot: a block owns kRows rows l and kCols columns v of the output,
// one warp per row and four neighbouring columns per lane, and a lane
// keeps the sums of all its (r, v) in registers.  The points stream
// through in chunks of kChunk, copied into shared memory with cp.async,
// two buffers deep, so the next chunk's alpha tile and indices arrive
// while the current one is summed.  Each warp sorts a chunk's points by
// their bucket in its row (a stable counting sort with warp ballots, so m
// stays increasing within a bucket), then walks the buckets in turn,
// adding each point's alpha to that bucket's registers.  Every output
// element is summed by one lane, over m in increasing order: two launches
// on the same inputs give the same bits.  The delta is summed first and
// added to the count once, one rounding, as sketch + delta is in the
// reference.  Each lane reads counts[l, r, v] and then writes out[l, r, v]
// for its own elements only, so out may be counts itself (an in-place
// fold).  alpha is read from device memory once per row tile (L / kRows
// times); the row tiles of one column tile are neighbouring blocks, so the
// repeats come from L2.  More than kBuckets buckets take several passes.
#include "lsh_common.cuh"

namespace {

constexpr int kRows = lsh::kWarps;   // rows l per block, one warp each
constexpr int kLaneCols = 4;         // neighbouring columns per lane
constexpr int kCols = 32 * kLaneCols;  // columns v per block
constexpr int kChunk = 64;           // points per staged chunk
constexpr int kBuckets = 16;         // buckets summed in registers per pass

struct Stage {                       // one buffer of a staged chunk
  float alpha[kChunk * kCols];       // (kChunk, kCols), zero past M and V
  int idx[kChunk * kRows];           // (kChunk, kRows), rows l0..l0+7
};

struct Smem {
  Stage stage[2];
  int ord[kRows][kChunk];            // chunk points of each row, by bucket
  int seg[kRows][kBuckets + 1];      // bucket starts in ord
};

// 4-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Stage chunk c (points c*kChunk ..) of the block's rows and columns.
__device__ __forceinline__ void stage_chunk(Stage& s, const int* idx,
                                            const float* alpha, int c, int M,
                                            int L, int64_t V, int l0,
                                            int64_t v0) {
  const int m0 = c * kChunk;
  const int nm = min(kChunk, M - m0);
#pragma unroll 8
  for (int i = threadIdx.x; i < kChunk * kCols; i += lsh::kThreads) {
    const int mm = i / kCols;
    const int64_t v = v0 + i % kCols;
    const bool ok = mm < nm && v < V;
    copy4(&s.alpha[i], ok ? alpha + (m0 + mm) * V + v : alpha, ok);
  }
  for (int i = threadIdx.x; i < kChunk * kRows; i += lsh::kThreads) {
    const int mm = i / kRows, ll = i % kRows;
    const bool ok = mm < nm && l0 + ll < L;
    copy4(&s.idx[i], ok ? idx + static_cast<int64_t>(m0 + mm) * L + l0 + ll : idx, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(lsh::kThreads, 2)
race_update_kernel(const int* __restrict__ idx, const float* __restrict__ alpha,
                   const float* counts, float* out, int M, int L, int R,
                   int64_t V, int64_t sl, int64_t sr, int64_t sv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * kRows;
  const int l = l0 + w;
  const int64_t v0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const unsigned below = (1u << lane) - 1u;
  const int n_chunks = (M + kChunk - 1) / kChunk;

  for (int r0 = 0; r0 < R; r0 += kBuckets) {
    const int r_end = min(R, r0 + kBuckets);
    float acc[kBuckets][kLaneCols];
#pragma unroll
    for (int r = 0; r < kBuckets; ++r)
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) acc[r][k] = 0.f;

    if (n_chunks > 0) stage_chunk(sm.stage[0], idx, alpha, 0, M, L, V, l0, v0);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        stage_chunk(sm.stage[(c + 1) & 1], idx, alpha, c + 1, M, L, V, l0, v0);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();  // chunk c has landed for every thread
      const Stage& s = sm.stage[c & 1];
      const int nm = min(kChunk, M - c * kChunk);

      // This warp's row: a stable counting sort of the chunk's points by
      // bucket (pass-relative; points outside [r0, r_end) are dropped).
      // Lane j holds points j and 32 + j.
      int b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = h * 32 + lane;
        const int r = s.idx[mm * kRows + w];
        b[h] = (mm < nm && l < L && r >= r0 && r < r_end) ? r - r0 : -1;
      }
      int total = 0, pos[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < kBuckets; ++k) {
        const unsigned in0 = __ballot_sync(0xffffffffu, b[0] == k);
        const unsigned in1 = __ballot_sync(0xffffffffu, b[1] == k);
        if (lane == k) sm.seg[w][k] = total;
        if (b[0] == k) pos[0] = total + __popc(in0 & below);
        if (b[1] == k) pos[1] = total + __popc(in0) + __popc(in1 & below);
        total += __popc(in0) + __popc(in1);
      }
      if (lane == 0) sm.seg[w][kBuckets] = total;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (b[h] >= 0) sm.ord[w][pos[h]] = h * 32 + lane;
      __syncwarp();

      // Add each point's alpha into its bucket's registers, bucket by
      // bucket, in increasing m within a bucket.
      const float4* a4 = reinterpret_cast<const float4*>(s.alpha);
#pragma unroll
      for (int k = 0; k < kBuckets; ++k) {
        int j = sm.seg[w][k];
        const int end = sm.seg[w][k + 1];
        for (; j + 2 <= end; j += 2) {
          const float4 a = a4[sm.ord[w][j] * 32 + lane];
          const float4 e = a4[sm.ord[w][j + 1] * 32 + lane];
          acc[k][0] += a.x; acc[k][1] += a.y; acc[k][2] += a.z; acc[k][3] += a.w;
          acc[k][0] += e.x; acc[k][1] += e.y; acc[k][2] += e.z; acc[k][3] += e.w;
        }
        if (j < end) {
          const float4 a = a4[sm.ord[w][j] * 32 + lane];
          acc[k][0] += a.x; acc[k][1] += a.y; acc[k][2] += a.z; acc[k][3] += a.w;
        }
      }
      __syncthreads();  // every warp is done with this buffer
    }

    // out = counts + delta for this pass's buckets, vectorized along V
    // (the head's layout) when the strides and alignment allow, else
    // element by element.
    if (l >= L) continue;
    const int64_t vl = v0 + lane * kLaneCols;
    const int nb = r_end - r0;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(counts) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (sv == 1 && V % kLaneCols == 0 && aligned) {
      if (vl >= V) continue;
#pragma unroll
      for (int rg = 0; rg < kBuckets; rg += 4) {
        float4 c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (rg + r < nb)
            c[r] = *reinterpret_cast<const float4*>(counts + l * sl + (r0 + rg + r) * sr + vl);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (rg + r < nb) {
            const float* a = acc[rg + r];
            *reinterpret_cast<float4*>(out + l * sl + (r0 + rg + r) * sr + vl) =
                make_float4(__fadd_rn(c[r].x, a[0]), __fadd_rn(c[r].y, a[1]),
                            __fadd_rn(c[r].z, a[2]), __fadd_rn(c[r].w, a[3]));
          }
      }
    } else {
#pragma unroll
      for (int rg = 0; rg < kBuckets; rg += 4) {
        float c[4][kLaneCols];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kLaneCols; ++k)
            if (rg + r < nb && vl + k < V)
              c[r][k] = counts[l * sl + (r0 + rg + r) * sr + (vl + k) * sv];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kLaneCols; ++k)
            if (rg + r < nb && vl + k < V)
              out[l * sl + (r0 + rg + r) * sr + (vl + k) * sv] =
                  __fadd_rn(c[r][k], acc[rg + r][k]);
      }
    }
  }
}

}  // namespace

extern "C" int race_update_launch(const int* idx, const float* alpha,
                                  const float* counts, float* out, int M,
                                  int L, int R, int64_t V, int64_t sl,
                                  int64_t sr, int64_t sv,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = lsh::allow_smem(race_update_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows,
                  static_cast<unsigned>((V + kCols - 1) / kCols));
  race_update_kernel<<<grid, lsh::kThreads, smem, stream>>>(
      idx, alpha, counts, out, M, L, R, V, sl, sr, sv);
  return static_cast<int>(cudaGetLastError());
}
