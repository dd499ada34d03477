// Online fold of weighted points into RACE count arrays (the streaming
// update the Representer Sketch was built for):
//   out[l, r, c] = counts[l, r, c] + sum_m alpha[m, c] * [idx[m, l] == r]
// idx (M, L) int32, alpha (M, C) f32; counts and out are f32 arrays
// addressed through element strides (sl, sr, sc), so the head's own
// (L, R, V) layout (classes contiguous) and the reference's (C, L, R)
// layout (buckets contiguous) both run without a transposed copy.  An
// index outside [0, R) adds nothing, as a one-hot row of zeros does.
//
// Replaces: src/repro/kernels/race_update/kernel.py:_race_update_kernel
// (launcher race_update_pallas; ops.race_update returns sketch + delta).
//
// One summation order, in every kernel below: each output element's delta
// is summed over m in increasing order, from 0.f, in f32, and added to the
// count once, rounding to nearest (race_update_ordered_ref in ops.py is
// this function exactly).  No atomics, so two launches give the same bits;
// each element is read and then written by one thread, so out may be
// counts itself (an in-place fold).
//
// Bound on this card: bytes.  The function reads the counts and alpha once
// and writes the counts once: at the refresh of the rwkv6 serve head
// (M = 256, L = 128, R = 16, C = 65536) that is 537 + 67 + 537 MB, about
// 0.34 ms at 3.35 TB/s; its M*L*C adds (2.1 G) take about 32 us at the f32
// rate.  At a paper freeze (C <= 2, L = 2000-4000, R = 30-100, M = 512)
// it is a few MB: a few microseconds, so latency decides there.
//
// The launcher picks one of two kernels by shape.
//
// Few classes (C <= kFewClasses and R <= kRowsMaxBuckets): race_update_rows.
// A block of 256 threads owns kRowTile = 32 rows l and up to 8 classes;
// warp w < ncls is class c0 + w, one lane per row.  A lane's bucket sums
// sit in shared memory, one column per lane (sums[r * 32 + lane], so lanes
// never share a bank whatever their buckets), with a spare bucket R that
// takes out-of-range indices.  The points stream through once, in chunks
// staged by 16-byte cp.async (idx's (M, L) rows read along l, eight
// threads a point; alpha's live classes only), two buffers deep, every
// warp of the block copying.  A lane folds eight points a round: it loads
// their eight sums at once, adds in registers, a point whose bucket an
// earlier point of the round hit taking that point's new sum, and stores
// them back in order, so the last store to a bucket holds its total and
// each bucket sums in increasing m.  The block's counts are staged at the
// start, behind the points, into (32, R | 1) tiles (odd pitch: the sums
// turn around into them conflict-free), so the epilogue adds in shared
// memory and only stores, along each class's (row, bucket) run, which is
// contiguous in (C, L, R).
//
// Many classes: race_update_cols<class-fast>.  A block owns kRows = 8 rows
// l (a warp each) and kCols = 128 classes c; lane j keeps the sums of
// classes j, j + 32, j + 64, j + 96 for 16 buckets in registers.  Chunks of
// 64 points are staged by 16-byte cp.async (each alpha row from the 16-byte
// group that holds its first class, so a ragged C copies whole groups
// too), two buffers deep.  32 points at a time, lane i holds point i's
// bucket in the warp's row; for each bucket in turn a ballot marks its
// points, and the warp walks the marks from the lowest, adding each
// point's four alpha values into that bucket's registers, so m increases
// within every bucket without a sort and every register index is a
// constant.  The block's counts are prefetched to L2 at the start, so their
// reads from memory overlap the points.  In the (L, R, V) layout the
// epilogue goes from the registers straight to memory, neighbouring lanes
// on neighbouring classes; in the (C, L, R) layout it turns around through
// a shared tile (odd pitch: conflict-free both ways), so that a block's 8
// rows x 16 buckets of one class, 128 contiguous floats, are read and
// written along their length.  More than 16 buckets take several passes.
//
// What holds the many-class kernel back (H100 runs): shared-memory
// bandwidth.  Every add reads its alpha from shared memory, 4 bytes an
// add, and the time per point followed that and nothing else: float4
// reads, a table lookup in place of __ffs, two points in flight and eight
// classes a lane all left it within a few percent.  Reusing an alpha
// value across rows needs a row's bucket to index registers; the TPU's
// one-hot product on the tensor cores would, but it changes the
// summation order.
#include "lsh_common.cuh"

namespace {

// ------------------------------------------------------------------ copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every copy group, or for all but the newest.
__device__ __forceinline__ void wait_copies(bool keep_newest) {
  if (keep_newest) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float load_shared(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void store_shared(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(a), "f"(v));
}

// Position (0..3) of the 4-byte element at byte address a within its
// 16-byte group.
__device__ __forceinline__ int pos_in_group(uintptr_t a) {
  return static_cast<int>((a >> 2) & 3);
}

// A window of n 4-byte elements from src is copied as the 16-byte groups
// that hold it, from the group holding src[0]; src[i] lands at dst[pos + i]
// with pos = pos_in_group(src).  Group g goes to dst + 4 g.  A group that
// holds an element of the window lies in a page that holds it, so reading
// the whole group is safe at either end of the array.
__device__ __forceinline__ void copy_group(void* dst, const void* src, int g) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  copy16(static_cast<char*>(dst) + 16 * g,
         reinterpret_cast<const void*>(base + 16 * static_cast<uintptr_t>(g)));
}

// ------------------------------------------------------ few classes: rows

constexpr int kRowTile = 32;                 // rows l per block, one per lane
constexpr int kRowChunk = 128;               // points per staged chunk
constexpr int kIdxGroups = kRowTile / 4 + 1; // 16-byte groups of a 32-row window
constexpr int kIdxPitch = 4 * kIdxGroups;    // ints per staged idx row
constexpr int kClassWarps = lsh::kWarps;     // most classes per block, a warp each
constexpr int kFewClasses = 32;              // most classes that take this kernel
constexpr int kRowsMaxBuckets = 256;         // most buckets (the epilogue tile)
constexpr size_t kRowsSmemBudget = 110 * 1024;  // two blocks per SM

struct RowStage {
  int idx[kRowChunk * kIdxPitch];        // (chunk, 36): idx[m0 + mm, l0 ..] from its group
  float alpha[kRowChunk * kClassWarps];  // (chunk, 8): alpha[m0 + mm, c0 + w]
};

// Dynamic shared memory of race_update_rows: two stages; cw columns of
// (R + 1) x 32 bucket sums; the block's counts, cw tiles of (32, R | 1).
inline size_t rows_smem(int cw, int R) {
  return 2 * sizeof(RowStage) +
         static_cast<size_t>(cw) * ((R + 1) + (R | 1)) * kRowTile * sizeof(float);
}

// Class warps per block of race_update_rows for C classes and R buckets, or
// 0 where the shape takes race_update_cols.
inline int few_class_warps(int64_t C, int R) {
  if (C > kFewClasses || R > kRowsMaxBuckets) return 0;
  int cw = static_cast<int>(C < kClassWarps ? C : kClassWarps);
  while (cw > 1 && rows_smem(cw, R) > kRowsSmemBudget) --cw;
  return cw;
}

__device__ __forceinline__ void stage_rows(RowStage& s, const int* idx, const float* alpha,
                                           int m0, int nm, int L, int l0, int nrows,
                                           int64_t C, int64_t c0, int ncls) {
  // Eight threads a point, one 16-byte group each; the first also copies
  // a ninth group where the window starts mid-group.
  const int g = threadIdx.x % 8;
  for (int mm = threadIdx.x / 8; mm < nm; mm += blockDim.x / 8) {
    const int* src = idx + static_cast<int64_t>(m0 + mm) * L + l0;
    const int end = pos_in_group(reinterpret_cast<uintptr_t>(src)) + nrows;
    int* dst = &s.idx[mm * kIdxPitch];
    if (4 * g < end) copy_group(dst, src, g);
    if (g == 0 && end > kRowTile) copy_group(dst, src, kIdxGroups - 1);
  }
  for (int i = threadIdx.x; i < kRowChunk * ncls; i += blockDim.x) {
    const int mm = i / ncls, cc = i - mm * ncls;
    if (mm < nm)
      copy4(&s.alpha[mm * kClassWarps + cc], alpha + static_cast<int64_t>(m0 + mm) * C + c0 + cc);
  }
  commit_copies();
}

constexpr int kFold = 8;  // points a lane folds per round

// Bucket (R for "adds nothing") and weight of points j .. j+7 of a chunk
// for this lane's row and this warp's class.
__device__ __forceinline__ void load_points(const RowStage& s, int j, int nm, const int (&pos)[4],
                                            int lane, int w, int R, int (&r)[kFold],
                                            float (&a)[kFold]) {
#pragma unroll
  for (int q = 0; q < kFold; ++q) {
    const int mm = j + q;
    const int v = s.idx[mm * kIdxPitch + pos[q % 4] + lane];
    r[q] = (mm < nm && static_cast<unsigned>(v) < static_cast<unsigned>(R)) ? v : R;
    a[q] = s.alpha[mm * kClassWarps + w];
  }
}

// Add kFold points, in order, into the lane's sums at shared address
// base + 128 r: every sum is loaded first, a point whose bucket an earlier
// point of the round hit takes that point's new sum, and the sums are
// stored back in order, so the last store of a bucket holds its total.
__device__ __forceinline__ void fold(unsigned base, const int (&r)[kFold],
                                     const float (&a)[kFold]) {
  float v[kFold];
#pragma unroll
  for (int q = 0; q < kFold; ++q) v[q] = load_shared(base + 4 * kRowTile * r[q]);
#pragma unroll
  for (int q = 0; q < kFold; ++q) {
    float prev = v[q];
#pragma unroll
    for (int p = 0; p < q; ++p) prev = r[q] == r[p] ? v[p] : prev;
    v[q] = prev + a[q];
  }
#pragma unroll
  for (int q = 0; q < kFold; ++q) store_shared(base + 4 * kRowTile * r[q], v[q]);
}

__global__ void __launch_bounds__(lsh::kThreads)
race_update_rows(const int* __restrict__ idx, const float* __restrict__ alpha,
                 const float* counts, float* out, int M, int L, int R, int64_t C, int cw,
                 int64_t sl, int64_t sr, int64_t sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowStage* stage = reinterpret_cast<RowStage*>(smem_raw);
  float* sums = reinterpret_cast<float*>(stage + 2);
  float* cnt = sums + cw * (R + 1) * kRowTile;
  const int pitch = R | 1;  // odd: the (32, R) tiles turn around conflict-free
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * kRowTile;
  const int nrows = min(kRowTile, L - l0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * cw;
  const int ncls = static_cast<int>(C - c0 < cw ? C - c0 : cw);
  const int n_chunks = (M + kRowChunk - 1) / kRowChunk;
  // (row, bucket) pairs of the tile, bucket fastest, stepped by blockDim.x.
  const int dl = blockDim.x / R, dr = blockDim.x - dl * R;

  // The block's counts, staged behind the points: cnt[cc][l * pitch + r].
  for (int cc = 0; cc < ncls; ++cc) {
    const float* src = counts + (c0 + cc) * sc + l0 * sl;
    int l = threadIdx.x / R, r = threadIdx.x - l * R;
    for (int e = threadIdx.x; e < nrows * R; e += blockDim.x) {
      copy4(&cnt[(cc * kRowTile + l) * pitch + r], src + l * sl + r * sr);
      r += dr;
      l += dl;
      if (r >= R) { r -= R; ++l; }
    }
  }
  commit_copies();

  // This lane's sums (class warps w < ncls): row l0 + lane, class c0 + w;
  // bucket R adds nothing.
  float* acc = sums + w * (R + 1) * kRowTile + lane;
  if (w < ncls)
    for (int r = 0; r <= R; ++r) acc[r * kRowTile] = 0.f;
  // Chunks start at multiples of 4 points, so point j + q of a chunk
  // (j % 4 == 0) has its idx window at position pos[q % 4] of its group.
  int pos[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    pos[q] = pos_in_group(reinterpret_cast<uintptr_t>(idx) +
                          4 * (static_cast<uintptr_t>(q) * L + l0));

  const unsigned acc_at = smem_addr(acc);
  if (n_chunks > 0)
    stage_rows(stage[0], idx, alpha, 0, min(kRowChunk, M), L, l0, nrows, C, c0, ncls);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const bool more = ch + 1 < n_chunks;
    if (more)
      stage_rows(stage[(ch + 1) & 1], idx, alpha, (ch + 1) * kRowChunk,
                 min(kRowChunk, M - (ch + 1) * kRowChunk), L, l0, nrows, C, c0, ncls);
    wait_copies(more);
    __syncthreads();  // chunk ch (and the counts) have landed for every thread
    const RowStage& s = stage[ch & 1];
    const int nm = min(kRowChunk, M - ch * kRowChunk);
    if (w < ncls) {
      int r[kFold];
      float a[kFold];
      load_points(s, 0, nm, pos, lane, w, R, r, a);
      for (int j = 0; j < nm; j += kFold) {
        int rn[kFold];
        float an[kFold];
#pragma unroll
        for (int q = 0; q < kFold; ++q) { rn[q] = R; an[q] = 0.f; }
        if (j + kFold < nm) load_points(s, j + kFold, nm, pos, lane, w, R, rn, an);
        fold(acc_at, r, a);
#pragma unroll
        for (int q = 0; q < kFold; ++q) { r[q] = rn[q]; a[q] = an[q]; }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  wait_copies(false);  // the counts, also with no points
  __syncthreads();     // every sum is final

  // cnt += delta (rows past L too: they are never stored), then out = cnt
  // along each class's (row, bucket) run.
  for (int cc = 0; cc < ncls; ++cc)
    for (int e = threadIdx.x; e < R * kRowTile; e += blockDim.x) {
      float& c = cnt[(cc * kRowTile + e % kRowTile) * pitch + e / kRowTile];
      c = __fadd_rn(c, sums[cc * (R + 1) * kRowTile + e]);
    }
  __syncthreads();
  for (int cc = 0; cc < ncls; ++cc) {
    float* dst = out + (c0 + cc) * sc + l0 * sl;
    int l = threadIdx.x / R, r = threadIdx.x - l * R;
    for (int e = threadIdx.x; e < nrows * R; e += blockDim.x) {
      dst[l * sl + r * sr] = cnt[(cc * kRowTile + l) * pitch + r];
      r += dr;
      l += dl;
      if (r >= R) { r -= R; ++l; }
    }
  }
}

// ---------------------------------------------------- many classes: columns

constexpr int kRows = lsh::kWarps;          // rows l per block, one warp each
constexpr int kLaneCols = 4;                // classes per lane: lane + 32 k
constexpr int kCols = 32 * kLaneCols;       // classes c per block
constexpr int kChunk = 64;                  // points per staged chunk, two per lane
constexpr int kBuckets = 16;                // buckets summed in registers per pass
constexpr int kGroups = kCols / 4 + 1;      // 16-byte groups of a 128-class window
constexpr int kPitch = 4 * kGroups;         // floats per staged alpha row
constexpr int kTileRows = kRows * kBuckets; // (row, bucket) sums per class
constexpr int kTilePitch = kTileRows + 1;   // odd: conflict-free both ways
constexpr int kStream = 16;                 // count loads in flight per thread

struct ColStage {
  float alpha[kChunk * kPitch];  // (chunk, 132): alpha[m0 + mm, c0 ..] from its group
  int idx[kRows * kChunk];       // (8, chunk): bucket of point mm in row l0 + w; -1 past M, L
};

union ColSmem {
  ColStage stage[2];
  float tile[kCols * kTilePitch];  // (128 classes, 8 rows x 16 buckets) sums of a pass
};

__device__ __forceinline__ void stage_cols(ColStage& s, const int* idx, const float* alpha,
                                           int m0, int nm, int L, int l0, int64_t C,
                                           int64_t c0, int ncols) {
  for (int i = threadIdx.x; i < kChunk * kGroups; i += lsh::kThreads) {
    const int mm = i / kGroups, g = i - mm * kGroups;
    if (mm >= nm) continue;
    const float* src = alpha + static_cast<int64_t>(m0 + mm) * C + c0;
    if (4 * g < pos_in_group(reinterpret_cast<uintptr_t>(src)) + ncols)
      copy_group(&s.alpha[mm * kPitch], src, g);
  }
  for (int i = threadIdx.x; i < kChunk * kRows; i += lsh::kThreads) {
    const int mm = i / kRows, w = i - mm * kRows;
    int* dst = &s.idx[w * kChunk + mm];
    if (mm < nm && l0 + w < L)
      copy4(dst, idx + static_cast<int64_t>(m0 + mm) * L + l0 + w);
    else
      *dst = -1;
  }
  commit_copies();
}

// Slot e of the block's (128 classes, 8 rows x 16 buckets) tile in the
// order its counts lie in memory along (row, bucket): the (C, L, R)
// layout's epilogue.
struct TileSlot {
  int c, row, r, at;  // class, row and bucket in the block, offset in the tile
  __device__ __forceinline__ explicit TileSlot(int e)
      : c(e / kTileRows), row(e % kTileRows / kBuckets), r(e % kBuckets), at(e + c) {}
};

// kClassFast: the class axis is contiguous (sc == 1, the (L, R, V) layout),
// so the epilogue goes from registers straight to memory; else ((C, L, R))
// it turns around through the shared tile.
template <bool kClassFast>
__global__ void __launch_bounds__(lsh::kThreads, 2)
race_update_cols(const int* __restrict__ idx, const float* __restrict__ alpha,
                 const float* counts, float* out, int M, int L, int R, int64_t C,
                 int64_t sl, int64_t sr, int64_t sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ColSmem& sm = *reinterpret_cast<ColSmem*>(smem_raw);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * kRows;
  const int nrows = min(kRows, L - l0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int ncols = static_cast<int>(C - c0 < kCols ? C - c0 : kCols);
  const int n_chunks = (M + kChunk - 1) / kChunk;
  // Groups of 32 points start at multiples of 32, so point p of a group has
  // its alpha window at position (pos0 + p C) % 4 of its 16-byte group.
  const int pos0 = pos_in_group(reinterpret_cast<uintptr_t>(alpha) + 4 * static_cast<uintptr_t>(c0));
  const int c_mod4 = static_cast<int>(C & 3);

  for (int r0 = 0; r0 < R; r0 += kBuckets) {
    const int nb = min(kBuckets, R - r0);
    if constexpr (!kClassFast) {
      // The pass's counts go to L2 now, so the epilogue's loads find them
      // there and their reads from memory overlap the points.
      for (int e = 32 * threadIdx.x; e < kCols * kTileRows; e += 32 * lsh::kThreads) {
        const TileSlot t(e);
        if (t.c < ncols && t.row < nrows && t.r < nb)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              counts + (l0 + t.row) * sl + (r0 + t.r) * sr + (c0 + t.c) * sc));
      }
    } else if (w < nrows) {
      for (int r = lane; r < nb; r += 32)  // one row of 128 classes: 4 lines
#pragma unroll
        for (int q = 0; q < kCols; q += 32)
          if (q < ncols)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                counts + (l0 + w) * sl + (r0 + r) * sr + (c0 + q) * sc));
    }
    float acc[kBuckets][kLaneCols];
#pragma unroll
    for (int r = 0; r < kBuckets; ++r)
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) acc[r][k] = 0.f;

    if (n_chunks > 0)
      stage_cols(sm.stage[0], idx, alpha, 0, min(kChunk, M), L, l0, C, c0, ncols);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const bool more = ch + 1 < n_chunks;
      if (more)
        stage_cols(sm.stage[(ch + 1) & 1], idx, alpha, (ch + 1) * kChunk,
                   min(kChunk, M - (ch + 1) * kChunk), L, l0, C, c0, ncols);
      wait_copies(more);
      __syncthreads();  // chunk ch has landed for every thread
      const ColStage& s = sm.stage[ch & 1];
      const int nm = min(kChunk, M - ch * kChunk);
      // 32 points at a time: lane i holds point h + i's pass-relative
      // bucket; for each bucket a ballot marks its points and the warp
      // walks the marks from the lowest, so m increases within every bucket.
      for (int h = 0; h < nm; h += 32) {
        const unsigned k = static_cast<unsigned>(s.idx[w * kChunk + h + lane]) - r0;
        const float* row = s.alpha + h * kPitch + lane;
#pragma unroll
        for (int r = 0; r < kBuckets; ++r) {
          unsigned mark = __ballot_sync(0xffffffffu, k == static_cast<unsigned>(r));
          while (mark) {
            const int p = __ffs(mark) - 1;
            mark &= mark - 1;
            const float* a = row + p * kPitch + ((pos0 + p * c_mod4) & 3);
#pragma unroll
            for (int q = 0; q < kLaneCols; ++q) acc[r][q] += a[32 * q];
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer
    }

    if constexpr (kClassFast) {
      // out = counts + delta straight from the registers: a row of 128
      // classes per (row, bucket), neighbouring lanes on neighbouring
      // classes; all of a lane's loads in flight before its stores.
      if (w < nrows) {
        const int64_t base = (l0 + w) * sl + r0 * sr + c0 + lane;
#pragma unroll
        for (int r = 0; r < kBuckets; r += 4) {
          float cnt[4][kLaneCols];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < kLaneCols; ++k)
              if (r + u < nb && lane + 32 * k < ncols)
                cnt[u][k] = counts[base + (r + u) * sr + 32 * k];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < kLaneCols; ++k)
              if (r + u < nb && lane + 32 * k < ncols)
                out[base + (r + u) * sr + 32 * k] = __fadd_rn(cnt[u][k], acc[r + u][k]);
        }
      }
    } else {
      // Through the tile: each warp writes its sums (tile[c][row * 16 + r],
      // odd pitch: the 32 lanes hit 32 banks), then the block streams
      // counts -> out along (row, bucket).
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k)
#pragma unroll
        for (int r = 0; r < kBuckets; ++r)
          sm.tile[(lane + 32 * k) * kTilePitch + w * kBuckets + r] = acc[r][k];
      __syncthreads();
      for (int base = 0; base < kCols * kTileRows; base += kStream * lsh::kThreads) {
        int64_t off[kStream];
        int at[kStream];
        float cnt[kStream];
        bool ok[kStream];
#pragma unroll
        for (int u = 0; u < kStream; ++u) {
          const TileSlot t(base + u * lsh::kThreads + threadIdx.x);
          ok[u] = t.c < ncols && t.row < nrows && t.r < nb;
          off[u] = (l0 + t.row) * sl + (r0 + t.r) * sr + (c0 + t.c) * sc;
          at[u] = t.at;
          if (ok[u]) cnt[u] = counts[off[u]];
        }
#pragma unroll
        for (int u = 0; u < kStream; ++u)
          if (ok[u]) out[off[u]] = __fadd_rn(cnt[u], sm.tile[at[u]]);
      }
    }
    __syncthreads();  // the stages and the tile are free before the next pass
  }
}

template <bool kClassFast>
cudaError_t launch_cols(const int* idx, const float* alpha, const float* counts, float* out,
                        int M, int L, int R, int64_t C, int64_t sl, int64_t sr, int64_t sc,
                        cudaStream_t stream) {
  const size_t smem = sizeof(ColSmem);
  const cudaError_t err = lsh::allow_smem(race_update_cols<kClassFast>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, static_cast<unsigned>((C + kCols - 1) / kCols));
  race_update_cols<kClassFast><<<grid, lsh::kThreads, smem, stream>>>(
      idx, alpha, counts, out, M, L, R, C, sl, sr, sc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int race_update_launch(const int* idx, const float* alpha,
                                  const float* counts, float* out, int M,
                                  int L, int R, int64_t C, int64_t sl,
                                  int64_t sr, int64_t sc,
                                  cudaStream_t stream) {
  const int cw = few_class_warps(C, R);
  if (cw == 0) {
    const cudaError_t err =
        sc == 1 ? launch_cols<true>(idx, alpha, counts, out, M, L, R, C, sl, sr, sc, stream)
                : launch_cols<false>(idx, alpha, counts, out, M, L, R, C, sl, sr, sc, stream);
    return static_cast<int>(err);
  }
  const size_t smem = rows_smem(cw, R);
  const cudaError_t err = lsh::allow_smem(race_update_rows, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRowTile - 1) / kRowTile, static_cast<unsigned>((C + cw - 1) / cw));
  race_update_rows<<<grid, lsh::kThreads, smem, stream>>>(idx, alpha, counts, out, M, L, R, C,
                                                          cw, sl, sr, sc);
  return static_cast<int>(cudaGetLastError());
}
