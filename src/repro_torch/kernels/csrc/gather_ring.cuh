// The count gather of the sketched head on a ring of distinct count rows,
// shared by fused_decode.cu (after its transform and hash) and
// sketch_head.cu (from indices in device memory):
//   out[b0 + bb, v] = (1/L) * sum_l scale[l, idx[bb, l]] * S[l, idx[bb, l], v]
// for the BT batch rows of a block and its range of V.  Both kernels call
// the same functions, so they give the same sums in the same order.
//
// A block has kConsumers warps that sum and one producer warp.
//   Lists: for each step of G sketch rows the block lists the distinct
//     (storage row, bucket) pairs its batch rows hit (for int4 the storage
//     row is l >> 1; __match_any_sync over a step's (l, row) items), so
//     batch rows that share a bucket read its segment once.
//   Ring: n_stages shared-memory stages of at most kStageCap bytes, one
//     step each.  The producer warp copies a step's segments of the
//     current V tile with cp.async.bulk (1-D TMA: one request a segment,
//     since a request has a fixed issue cost whatever its size),
//     completing on the stage's full mbarrier, and refills a stage when its
//     empty mbarrier says the consumer warps have read it.  Int8 and int4
//     counts are decoded from shared memory a word at a time.
// Each output column sums its L terms in increasing l in f32 (acc += t, or
// acc += __fmul_rn(scale, t) for int8/int4), then acc * (1/L): the order
// and the operations of sketch_head_ordered_ref.  A tile's logits are
// written after its last count read, and no block splits a sum with
// another: no atomics, and two launches give the same bits.
#pragma once

#include "bulk_copy.cuh"
#include "lsh_common.cuh"

namespace ring {

constexpr int kConsumers = 16;                          // warps that sum
constexpr int kThreads = (kConsumers + 1) * 32;         // + the producer warp
constexpr int kMaxStages = 6;
constexpr int kStageCap = 36 * 1024;                    // bytes a stage at most
constexpr int kBarBytes = 128;                          // 2 x kMaxStages mbarriers + 32 bytes
constexpr int kSplitAlign = 16;                         // V ranges start at multiples
constexpr int kMinRange = 256;                          // fewest columns a range
constexpr unsigned kFull = 0xFFFFFFFFu;

// A consumer thread sums kWords 32-bit words of each count-row segment (one
// f32 column or four int8 / int4 columns a word), so that its kWords x (1
// or 4) x BT sums stay within 16 registers; a segment is at most kCols
// columns (4 KB, or 2 KB for int8 / int4 at BT >= 4).
template <int QUANT, int BT>
struct Tiles {
  static constexpr bool kF32 = QUANT == lsh::kF32;
  static constexpr int kWords = kF32 || BT <= 2 ? 2 : 1;
  static constexpr int kPerWord = kF32 ? 1 : 4;
  static constexpr int kElt = kF32 ? 4 : 1;                       // bytes a count
  static constexpr int kCols = kWords * 4 * kConsumers * 32 / kElt;
  // Sketch rows a thread reads ahead in a step (a step has G = slots / BT
  // of them: one for f32 at BT = 8, two for int8 / int4).
  static constexpr int kU = BT < 8 ? 4 : kF32 ? 1 : 2;
};

// Host-side geometry of the gather.
struct Geometry {
  int n_split;       // V ranges a row tile
  int n_stages;
  int tile_cols;     // columns of a V tile (a multiple of 16, <= kCols)
  int slot_bytes;    // a segment's slot: tile_cols counts + the 16-byte widening
  int n_slots;       // segments a stage: 8, 16 or 32
  int G;             // sketch rows a step: n_slots / BT
};

// Words of the per-block tables: idx_s, scale_s (BT, L); sel_s (L, BT);
// key_s (n_groups, n_slots), at most BT * L + 32 words; nseg_s (n_groups
// <= L).
__host__ __device__ __forceinline__ int table_words(int BT, int L) {
  return 4 * BT * L + 32 + L;
}

struct Tables {
  int* idx_s;        // (BT, L) bucket of (batch row, sketch row)
  float* scale_s;    // (BT, L) its scale (int8 / int4)
  int* sel_s;        // (L, BT) stage byte of the item's count at a tile's first column
  int* key_s;        // (n_groups, n_slots) a step's segments
  int* nseg_s;       // (n_groups) segments a step
};

__device__ __forceinline__ Tables carve(int* p, int BT, int L, int n_slots, int G) {
  Tables t;
  t.idx_s = p;
  t.scale_s = reinterpret_cast<float*>(p + BT * L);
  t.sel_s = p + 2 * BT * L;
  t.key_s = t.sel_s + BT * L;
  t.nseg_s = t.key_s + (L + G - 1) / G * n_slots;
  return t;
}

// Start of V range s of n (multiples of kSplitAlign; range n ends at V).
__host__ __device__ __forceinline__ int64_t split_start(int64_t V, int s, int n) {
  return s >= n ? V : V * s / n / kSplitAlign * kSplitAlign;
}

// Bytes [off, off + 4) of shared memory as a word (off need not be aligned).
__device__ __forceinline__ uint32_t load_word(const unsigned char* base, int off) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  return __funnelshift_r(p[0], p[1], (off & 3) * 8);
}

// Count c (0..3) of a word of four count bytes: the signed byte, or the
// sign-extended low or high nibble (int4 row 2i or 2i + 1, as
// common.unpack_int4_rows reads it).
template <int QUANT>
__device__ __forceinline__ float word_count(uint32_t w, int c, bool high) {
  if constexpr (QUANT == lsh::kInt8) {
    return static_cast<float>(static_cast<int>(w << (24 - 8 * c)) >> 24);
  } else {
    return static_cast<float>(high ? static_cast<int>(w << (24 - 8 * c)) >> 28
                                   : static_cast<int>(w << (28 - 8 * c)) >> 28);
  }
}

// The stage barriers: full[s] completes when stage s has landed, empty[s]
// when every consumer warp has read it.  Thread 0 only; a __syncthreads()
// must follow before any wait.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int n_stages) {
  for (int s = 0; s < n_stages; ++s) {
    bulk::mbar_init(&full[s], 1);
    bulk::mbar_init(&empty[s], kConsumers);
  }
}

// The lists.  Items (l, bb), numbered l * BT + bb; step g holds items
// [g * n_slots, (g + 1) * n_slots), keyed by (storage row, bucket).  A
// key's first item leads, and the leaders take the step's slots in item
// order.  sel: the stage byte of an item's count at a tile's first column
// (tile starts are multiples of 16 bytes from the row start, so the
// offset within the widened copy is the row start's, mod 16).  t.idx_s
// must hold an index in [0, R) for every (bb, l), rows past the batch
// included.  Ends with the block's barrier, after a proxy fence (the ring
// may alias memory the block wrote before).
template <int QUANT, int BT>
__device__ __forceinline__ void list_segments(const void* sketch, int L, int R, int64_t V,
                                              const Geometry& pl, const Tables& t) {
  using T = Tiles<QUANT, BT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_groups = (L + pl.G - 1) / pl.G;
  const uintptr_t base = reinterpret_cast<uintptr_t>(sketch);
  if (warp < kConsumers) {
    for (int first = warp * 32; first < n_groups * pl.n_slots; first += kConsumers * 32) {
      const int item = first + lane, l = item / BT;
      const bool valid = item < BT * L;
      const int key = valid ? (QUANT == lsh::kInt4 ? l >> 1 : l) * R + t.idx_s[(item % BT) * L + l]
                            : -1 - lane;
      const unsigned step_lanes =
          pl.n_slots == 32 ? kFull : ((1u << pl.n_slots) - 1) << (lane & ~(pl.n_slots - 1));
      const unsigned same = __match_any_sync(kFull, key) & step_lanes;
      const int leader = __ffs(same) - 1;
      const unsigned leaders = __ballot_sync(kFull, valid && leader == lane) & step_lanes;
      const int slot = __popc(leaders & ((1u << leader) - 1));
      if (valid) {
        t.sel_s[item] = slot * pl.slot_bytes +
                        static_cast<int>((base + static_cast<uint64_t>(key) * V * T::kElt) & 15);
        if (leader == lane) t.key_s[item / pl.n_slots * pl.n_slots + slot] = key;
      }
      if ((lane & (pl.n_slots - 1)) == 0 && item / pl.n_slots < n_groups)
        t.nseg_s[item / pl.n_slots] = __popc(leaders);
    }
  }
  bulk::fence_proxy_async();    // the block's generic accesses before TMA's writes
  __syncthreads();
}

// The ring over V range `split` of pl.n_split: the producer warp returns
// when it has issued its last copy; consumer threads return after writing
// their last logits.  Rows bb < nb are written; a row with bit bb of `bad`
// set is written as NaN.
template <int QUANT, int BT>
__device__ __forceinline__ void run(const void* __restrict__ sketch, int L, int64_t V,
                                    const Geometry& pl, uint64_t* full, uint64_t* empty,
                                    unsigned char* stages, const Tables& t, int nb,
                                    unsigned bad, float inv_l, float* __restrict__ out,
                                    int64_t b0, int split) {
  using T = Tiles<QUANT, BT>;
  const int G = pl.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_groups = (L + G - 1) / G;
  // Step k = (tile k / n_groups, group k % n_groups).
  const int64_t vb = split_start(V, split, pl.n_split);
  const int64_t ve = split_start(V, split + 1, pl.n_split);
  const int n_tiles = ve > vb ? static_cast<int>((ve - vb + pl.tile_cols - 1) / pl.tile_cols) : 0;
  const int n_steps = n_tiles * n_groups;
  const int stage_bytes = pl.n_slots * pl.slot_bytes;
  if (warp == kConsumers) {        // the producer
    for (int k = 0, s = 0, grp = 0, tile = 0; k < n_steps; ++k) {
      if (k >= pl.n_stages) bulk::mbar_wait(&empty[s], (k / pl.n_stages - 1) & 1);
      const int64_t v0 = vb + static_cast<int64_t>(tile) * pl.tile_cols;
      const int64_t cols = ve - v0 < pl.tile_cols ? ve - v0 : pl.tile_cols;
      const int nseg = t.nseg_s[grp];
      bulk::Span span{nullptr, 0};
      if (lane < nseg)
        span = bulk::bulk_span(static_cast<const unsigned char*>(sketch) +
                                   (static_cast<int64_t>(t.key_s[grp * pl.n_slots + lane]) * V + v0) *
                                       T::kElt,
                               static_cast<uint32_t>(cols * T::kElt));
      const uint32_t total = __reduce_add_sync(kFull, span.bytes);
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[s], total);
      __syncwarp();
      if (lane < nseg)
        bulk::load(stages + s * stage_bytes + lane * pl.slot_bytes, span, &full[s]);
      if (++s == pl.n_stages) s = 0;
      if (++grp == n_groups) grp = 0, ++tile;
    }
    return;
  }

  float acc[T::kWords][T::kPerWord][BT];
#pragma unroll
  for (int v = 0; v < T::kWords; ++v)
#pragma unroll
    for (int c = 0; c < T::kPerWord; ++c)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[v][c][bb] = 0.f;
  // Word v of this thread: bytes [4 * wi, 4 * wi + 4) of a segment, wi =
  // tid + kConsumers * 32 * v; words past the tile's bytes are skipped.
  for (int k = 0, s = 0, grp = 0, tile = 0; k < n_steps; ++k) {
    bulk::mbar_wait(&full[s], (k / pl.n_stages) & 1);
    const unsigned char* stage = stages + s * stage_bytes;
    const int64_t v0 = vb + static_cast<int64_t>(tile) * pl.tile_cols;
    const int tile_bytes =
        static_cast<int>((ve - v0 < pl.tile_cols ? ve - v0 : pl.tile_cols) * T::kElt);
    // kU sketch rows at a time, branch-free so that their loads issue
    // together: rows past the step's (L % G) read row L - 1 and add +0,
    // which leaves a sum unchanged (a sum of counts from +0 is never -0).
    const int n_u = min(G, L - grp * G);
    for (int u0 = 0; u0 < n_u; u0 += T::kU) {
      int sel[T::kU][BT];
      float sc[T::kU][BT];
#pragma unroll
      for (int uu = 0; uu < T::kU; ++uu) {
        const int l = min(grp * G + u0 + uu, L - 1);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          sel[uu][bb] = t.sel_s[l * BT + bb];
          sc[uu][bb] = u0 + uu < n_u ? (T::kF32 ? 1.f : t.scale_s[bb * L + l]) : 0.f;
        }
      }
#pragma unroll
      for (int uu = 0; uu < T::kU; ++uu)
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
#pragma unroll
          for (int v = 0; v < T::kWords; ++v) {
            const int wi = tid + kConsumers * 32 * v;
            if (4 * wi >= tile_bytes) continue;
            if constexpr (T::kF32) {
              const float x = *reinterpret_cast<const float*>(stage + sel[uu][bb] + 4 * wi);
              acc[v][0][bb] += sc[uu][bb] != 0.f ? x : 0.f;
            } else {
              const uint32_t word = load_word(stage, sel[uu][bb] + 4 * wi);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[v][c][bb] += __fmul_rn(sc[uu][bb], word_count<QUANT>(word, c, (u0 + uu) & 1));
            }
          }
    }
    __syncwarp();
    if (lane == 0) bulk::mbar_arrive(&empty[s]);
    if (grp == n_groups - 1) {     // the tile's last rows: write its logits
#pragma unroll
      for (int v = 0; v < T::kWords; ++v)
#pragma unroll
        for (int c = 0; c < T::kPerWord; ++c) {
          const int64_t col = v0 + (tid + kConsumers * 32 * v) * T::kPerWord + c;
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            if (bb < nb && col < ve)
              out[(b0 + bb) * V + col] =
                  (bad >> bb) & 1u ? __int_as_float(0x7fc00000) : acc[v][c][bb] * inv_l;
            acc[v][c][bb] = 0.f;
          }
        }
    }
    if (++s == pl.n_stages) s = 0;
    if (++grp == n_groups) grp = 0, ++tile;
  }
}

// The tiles of a plan whose n_split is set: the widest range split into
// equal tiles of at most kCols; a stage of the most slots (a power of two
// up to 32) that fit kStageCap, keeping a step's sketch rows even for
// int4's row pairs.
template <int QUANT, int BT>
inline cudaError_t plan_tiles(int64_t V, Geometry* pl) {
  using T = Tiles<QUANT, BT>;
  const int64_t range = (V + pl->n_split - 1) / pl->n_split + kSplitAlign;
  const int64_t per_range = (range + T::kCols - 1) / T::kCols;
  pl->tile_cols = static_cast<int>(((range + per_range - 1) / per_range + 15) / 16 * 16);
  pl->slot_bytes = pl->tile_cols * T::kElt + 32;
  const int min_slots = QUANT == lsh::kInt4 ? 2 * BT : BT;
  pl->n_slots = 32;
  while (pl->n_slots > min_slots && pl->n_slots * pl->slot_bytes > kStageCap) pl->n_slots /= 2;
  pl->G = pl->n_slots / BT;
  return pl->n_slots * pl->slot_bytes > kStageCap ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace ring
