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
// are far below the f32 rate.  The TPU turned the gather into a one-hot MXU
// product because it has no fast gather.
//
// Design: two kernels, picked by shape, that sum in the same order, so
// they give the same bits (sketch_head_ordered_ref's, and fused_decode's
// at the same indices).
//   sketch_head_ring: fused_decode.cu's gather (gather_ring.cuh) without
//     the transform and the hash.  Persistent blocks of 16 consumer warps
//     and a producer warp, one per SM; block (x, y) owns batch rows
//     [x*BT, x*BT + BT) (BT = 1, 2, 4 or 8, from B; fewer where L is too
//     long for the tables) and the y-th of n_split ranges of V, as many as
//     fill the card.  The block reads its indices (and their scales) from
//     device memory, lists each step's distinct (storage row, bucket)
//     pairs, and streams those count rows through a ring of shared-memory
//     stages filled by TMA bulk copies, so batch rows that share a bucket
//     read it once.  An index outside [0, R) is replaced by bucket 0 before
//     any copy is issued, so no copy reads outside S, and its row is
//     written as NaN.
//   sketch_head_tile: a (BT, kBlockV) output tile a block, each thread 32
//     independent loads (of 4 or 1 bytes) in flight before it adds them,
//     neighbouring threads on neighbouring v.  It was measured faster than
//     the ring at B = 1 (f32, int8), where the ring's segments are a few
//     hundred bytes to 2 KB and a TMA request has a fixed cost whatever its
//     size, and at gemma2's width (V 256000, f32, B 4..7), where its 500
//     blocks keep the HBM busier (PERF.md §6).  An index outside [0, R)
//     reads bucket 0, and its row is written as NaN.
#include "gather_ring.cuh"

namespace {

template <int QUANT, int BT>
__global__ void __launch_bounds__(ring::kThreads, 1)
sketch_head_ring(const int* __restrict__ idx, const void* __restrict__ sketch,
                 const float* __restrict__ scale, float* __restrict__ out, int B, int L, int R,
                 int64_t V, float inv_l, ring::Geometry pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ring::kMaxStages;
  // Rows with an index outside [0, R), a bit each (in the barriers' room).
  unsigned* bad_s = reinterpret_cast<unsigned*>(empty + ring::kMaxStages);
  unsigned char* stages = smem + ring::kBarBytes;
  const ring::Tables tab = ring::carve(
      reinterpret_cast<int*>(stages + pl.n_stages * ring::kStageCap), BT, L, pl.n_slots, pl.G);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int nb = min(BT, static_cast<int>(B - b0));
  if (threadIdx.x == 0) {
    ring::init_barriers(full, empty, pl.n_stages);
    bulk::mbar_fence_init();
    *bad_s = 0;
  }
  __syncthreads();
  unsigned bad = 0;
  for (int i = threadIdx.x; i < BT * L; i += ring::kThreads) {
    const int bb = i / L, l = i % L;
    // Rows past the batch repeat its last row (their sums are dropped).
    int r = idx[(b0 + min(bb, nb - 1)) * L + l];
    if (r < 0 || r >= R) {
      bad |= 1u << bb;
      r = 0;
    }
    tab.idx_s[i] = r;
    if constexpr (QUANT != lsh::kF32) tab.scale_s[i] = scale[l * R + r];
  }
  if (bad) atomicOr(bad_s, bad);
  __syncthreads();
  ring::list_segments<QUANT, BT>(sketch, L, R, V, pl, tab);
  ring::run<QUANT, BT>(sketch, L, V, pl, full, empty, stages, tab, nb, *bad_s, inv_l, out, b0,
                       blockIdx.y);
}

constexpr int kTileThreads = 256;
constexpr int kCols = 2;                              // columns a thread
constexpr int kBlockV = kTileThreads * kCols;         // columns a block

// Count S[l, r, v] of an (L, R, V) f32 or int8 array, or of an
// (ceil(L/2), R, V) packed int4 array (row 2i in the low nibble of byte
// (i, r, v), row 2i+1 in the high one); integers come back unscaled.
template <int QUANT>
__device__ __forceinline__ float read_count(const void* __restrict__ sketch, int l, int r,
                                            int R, int64_t V, int64_t v) {
  if constexpr (QUANT == lsh::kF32) {
    return static_cast<const float*>(sketch)[(static_cast<int64_t>(l) * R + r) * V + v];
  } else if constexpr (QUANT == lsh::kInt8) {
    return static_cast<float>(
        static_cast<const int8_t*>(sketch)[(static_cast<int64_t>(l) * R + r) * V + v]);
  } else {
    const int8_t byte =
        static_cast<const int8_t*>(sketch)[(static_cast<int64_t>(l >> 1) * R + r) * V + v];
    // Sign-extend the nibble: (x << 4) >> 4 for the low one, x >> 4 (an
    // arithmetic shift of the signed byte) for the high one.
    const int nib = (l & 1)
        ? (static_cast<int>(byte) >> 4)
        : (static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(byte) << 4)) >> 4);
    return static_cast<float>(nib);
  }
}

// The (nb, kBlockV) logit tile starting at column v0:
//   out[b0 + bb, v] = (1/L) * sum_l scale[l, idx] * S[l, idx[bb, l], v]
// idx_s / scale_s: (BT, L) in shared memory, rows >= nb holding copies of
// a valid row so that every load is unguarded (their sums are dropped).
// Each thread owns kCols columns and issues U * kCols * BT = 32
// independent loads before adding them; the sum over l stays in f32
// registers, in order l = 0..L-1.
template <int QUANT, int BT>
__device__ __forceinline__ void gather_tile(const void* __restrict__ sketch, const int* idx_s,
                                            const float* scale_s, int nb, int L, int R,
                                            int64_t V, int64_t v0, float inv_l,
                                            float* __restrict__ out, int64_t b0) {
  constexpr int U = 16 / BT;
  int64_t v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = v0 + threadIdx.x + static_cast<int64_t>(c) * kTileThreads;
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
        if constexpr (QUANT != lsh::kF32) s = scale_s[bb * L + l + u];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c][bb] += (QUANT != lsh::kF32) ? __fmul_rn(s, t[u][c][bb]) : t[u][c][bb];
      }
  }
  for (; l < L; ++l) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
      const int r = idx_s[bb * L + l];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float t = read_count<QUANT>(sketch, l, r, R, V, v[c]);
        acc[c][bb] += (QUANT != lsh::kF32) ? __fmul_rn(scale_s[bb * L + l], t) : t;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = v0 + threadIdx.x + static_cast<int64_t>(c) * kTileThreads;
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
      if (bb < nb && col < V) out[(b0 + bb) * V + col] = acc[c][bb] * inv_l;
  }
}

// MINB blocks an SM at least: 4 at one row a block (its loads are few, so
// occupancy hides their latency), else 1.
template <int QUANT, int BT, int MINB>
__global__ void __launch_bounds__(kTileThreads, MINB)
sketch_head_tile(const int* __restrict__ idx, const void* __restrict__ sketch,
                 const float* __restrict__ scale, float* __restrict__ out, int B, int L, int R,
                 int64_t V, float inv_l) {
  extern __shared__ float smem_f[];
  float* scale_s = smem_f;                                // (BT, L)
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
    if (r < 0 || r >= R) {
      bad_s[bb] = 1;
      r = 0;
    }
    idx_s[i] = r;
    if constexpr (QUANT != lsh::kF32) scale_s[i] = scale[l * R + r];
  }
  __syncthreads();
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kBlockV;
  gather_tile<QUANT, BT>(sketch, idx_s, scale_s, nb, L, R, V, v0, inv_l, out, b0);
  for (int bb = 0; bb < nb; ++bb) {
    if (!bad_s[bb]) continue;
    for (int64_t v = v0 + threadIdx.x; v < min(V, v0 + kBlockV); v += blockDim.x)
      out[(b0 + bb) * V + v] = __int_as_float(0x7fc00000);
  }
}

template <int QUANT, int BT>
int launch_tile(const int* idx, const void* sketch, const float* scale, float* out, int B,
                int L, int R, int64_t V, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * BT * L;
  constexpr int kMinBlocks = BT == 1 ? 4 : 1;
  cudaError_t err = lsh::allow_smem(sketch_head_tile<QUANT, BT, kMinBlocks>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + kBlockV - 1) / kBlockV, (B + BT - 1) / BT);
  sketch_head_tile<QUANT, BT, kMinBlocks><<<grid, kTileThreads, smem, stream>>>(
      idx, sketch, scale, out, B, L, R, V, 1.0f / static_cast<float>(L));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block with n_stages stages.
inline int64_t smem_bytes(int BT, int L, int n_stages) {
  return ring::kBarBytes + 4 * static_cast<int64_t>(ring::table_words(BT, L)) +
         static_cast<int64_t>(n_stages) * ring::kStageCap;
}

// The shape a plan was made for.
struct Shape {
  int dev, B, L;
  int64_t V;
  bool operator==(const Shape& o) const {
    return dev == o.dev && B == o.B && L == o.L && V == o.V;
  }
};

template <int QUANT, int BT>
cudaError_t make_plan(const Shape& sh, int n_sm, int max_smem, ring::Geometry* out, int* smem) {
  ring::Geometry pl;
  const int64_t stages = (max_smem - smem_bytes(BT, sh.L, 0)) / ring::kStageCap;
  pl.n_stages = static_cast<int>(stages < ring::kMaxStages ? stages : ring::kMaxStages);
  if (pl.n_stages < 2) return cudaErrorInvalidValue;
  *smem = static_cast<int>(smem_bytes(BT, sh.L, pl.n_stages));
  cudaError_t err = cudaFuncSetAttribute(sketch_head_ring<QUANT, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sketch_head_ring<QUANT, BT>,
                                                      ring::kThreads, *smem);
  if (err != cudaSuccess) return err;
  // V ranges per row tile: as many as fill the card at once, each at least
  // kMinRange columns.
  const int64_t row_tiles = (sh.B + BT - 1) / BT;
  const int64_t most = sh.V / ring::kMinRange > 1 ? sh.V / ring::kMinRange : 1;
  int64_t per = per_sm * n_sm / row_tiles;
  per = per < 1 ? 1 : per > most ? most : per;
  pl.n_split = static_cast<int>(per);
  err = ring::plan_tiles<QUANT, BT>(sh.V, &pl);
  if (err != cudaSuccess) return err;
  *out = pl;
  return cudaSuccess;
}

template <int QUANT, int BT>
int launch_ring(const int* idx, const void* sketch, const float* scale, float* out,
                const Shape& sh, int n_sm, int max_smem, int R, cudaStream_t stream) {
  // The plan of the last shape this thread launched (the decode loop
  // launches one shape over and over, and planning takes several CUDA
  // runtime calls).
  static thread_local Shape last{-1, 0, 0, 0};
  static thread_local ring::Geometry pl;
  static thread_local int smem = 0;
  if (!(sh == last)) {
    cudaError_t err = make_plan<QUANT, BT>(sh, n_sm, max_smem, &pl, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last = sh;
  }
  const dim3 grid((sh.B + BT - 1) / BT, pl.n_split);
  sketch_head_ring<QUANT, BT><<<grid, ring::kThreads, smem, stream>>>(
      idx, sketch, scale, out, sh.B, sh.L, R, sh.V, 1.0f / static_cast<float>(sh.L), pl);
  return static_cast<int>(cudaGetLastError());
}

template <int QUANT>
int launch_rows(const int* idx, const void* sketch, const float* scale, float* out, int B,
                int L, int R, int64_t V, cudaStream_t stream) {
  Shape sh{0, B, L, V};
  cudaError_t err = cudaGetDevice(&sh.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, sh.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, sh.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The tile kernel where it was measured faster (see the top of the file),
  // if its (BT, L) tables fit: f32 and int8 at B = 1; f32 at B = 4..7 when
  // V spans three of its blocks an SM.
  if constexpr (QUANT != lsh::kInt4) {
    if (B == 1 && 8LL * L <= max_smem)
      return launch_tile<QUANT, 1>(idx, sketch, scale, out, B, L, R, V, stream);
    if (QUANT == lsh::kF32 && B >= 4 && B < 8 && V >= 3LL * n_sm * kBlockV &&
        32LL * L <= max_smem)
      return launch_tile<QUANT, 4>(idx, sketch, scale, out, B, L, R, V, stream);
  }
  // The ring: lsh::rows_per_block(B) rows a block, halved while the tables
  // and two stages do not fit.
  int bt = lsh::rows_per_block(B);
  while (bt > 1 && smem_bytes(bt, L, 2) > max_smem) bt /= 2;
  switch (bt) {
    case 1: return launch_ring<QUANT, 1>(idx, sketch, scale, out, sh, n_sm, max_smem, R, stream);
    case 2: return launch_ring<QUANT, 2>(idx, sketch, scale, out, sh, n_sm, max_smem, R, stream);
    case 4: return launch_ring<QUANT, 4>(idx, sketch, scale, out, sh, n_sm, max_smem, R, stream);
    default: return launch_ring<QUANT, 8>(idx, sketch, scale, out, sh, n_sm, max_smem, R, stream);
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
