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
// Bound on this card: bytes — each distinct (storage row, bucket) V-row of
// S that the batch touches, read once; q and the hash cost B*d*dp +
// B*L*K*dp FMAs, far below the f32 rate.
//
// Design: persistent blocks of 16 consumer warps and a producer warp, one
// per SM.  Block (x, y) owns batch rows [x*BT, x*BT + BT) and the y-th of
// n_split contiguous ranges of V (starting at multiples of 16 columns),
// which it walks in equal tiles of at most 4 KB of a count row.  The
// blocks of a row tile form clusters of cs (1, 2, 4 or 8) blocks along V.
//   1. q and idx once per block.  q is summed in one fixed order: d in
//      chunks of 256 rows, chunk row 32*w + u belonging to partial w
//      (w = 0..7); partial w of (b, j) is the fmaf chain over its rows in
//      increasing order from +0 (rows past d add fmaf(0, 0, .)); q =
//      partial 0 + ... + partial 7, added in that order.  Block rank k of a
//      cluster computes partials [k*8/cs, (k+1)*8/cs) from A and h rows
//      staged in shared memory, so the cluster reads A once between its
//      blocks, and writes them into every block of the cluster through
//      distributed shared memory; after a cluster barrier each block adds
//      the eight.  q, and with it every index, has the same bits in every
//      block, launch and cluster size.  The hash is lsh::hash_rows'
//      arithmetic on a transposed shared-memory copy of the bank.
//   2. For each step of G sketch rows the block lists the distinct (storage
//      row, bucket) pairs its batch rows hit (for int4 the storage row is
//      l >> 1; __match_any_sync over a step's (l, row) items): batch rows
//      that share a bucket read its segment once.
//   3. A ring of n_stages shared-memory stages of ~36 KB, one step each.
//      The producer warp copies a step's segments of the current V tile
//      with cp.async.bulk (1-D TMA: one request a segment, since a request
//      has a fixed issue cost whatever its size), completing on the stage's
//      full mbarrier, and refills a stage when its empty mbarrier says the
//      consumer warps have read it.  Int8 and int4 counts are decoded from
//      shared memory a word at a time.
// Each output column sums its L terms in increasing l in f32 (acc += t, or
// acc += __fmul_rn(scale, t) for int8/int4), then acc * (1/L): the order
// and the operations of lsh::gather_tile, so the logits equal
// sketch_head.cu's at the same indices bit for bit.  A tile's logits are
// written after its last count read, and no block splits a sum with
// another: no atomics, and two launches give the same bits.
#include "bulk_copy.cuh"
#include "lsh_common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kConsumers = 16;                          // warps that sum
constexpr int kThreads = (kConsumers + 1) * 32;         // + the producer warp
constexpr int kChunk = 256;                             // rows of d a chunk
constexpr int kParts = 8;                               // partials of q
constexpr int kRowsPerPart = kChunk / kParts;           // 32
constexpr int kMaxStages = 6;
constexpr int kStageCap = 36 * 1024;                    // bytes a stage at most
constexpr int kBarBytes = 128;                          // 2 x kMaxStages + 1 mbarriers
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

// Host-side geometry of a launch.
struct Plan {
  int n_split, cs, n_stages;
  int tile_cols;     // columns of a V tile (a multiple of 16, <= kCols)
  int slot_bytes;    // a segment's slot: tile_cols counts + the 16-byte widening
  int n_slots;       // segments a stage: 8, 16 or 32
  int G;             // sketch rows a step: n_slots / BT
  int region;        // bytes of the ring (the prologue's scratch aliases it)
  int rchunks;       // chunks of d staged a round of the transform
  int bank_stride;   // words between the transposed bank's rows (odd)
  int smem;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Per-block tables after the ring, in words: parts_s (kParts, BT, dp); q_s
// (BT, dp); idx_s, scale_s (BT, L); sel_s (L, BT); key_s (n_groups,
// n_slots), at most BT * L + 32 words; nseg_s (n_groups <= L).
__host__ __device__ __forceinline__ int table_words(int BT, int L, int dp) {
  return 4 * BT * L + 32 + L + (kParts + 1) * BT * dp;
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

// Count c (0..3) of a word of four count bytes, as read_count reads it:
// the signed byte, or the sign-extended low or high nibble (int4 row 2i or
// 2i + 1).
template <int QUANT>
__device__ __forceinline__ float word_count(uint32_t w, int c, bool high) {
  if constexpr (QUANT == lsh::kInt8) {
    return static_cast<float>(static_cast<int>(w << (24 - 8 * c)) >> 24);
  } else {
    return static_cast<float>(high ? static_cast<int>(w << (24 - 8 * c)) >> 28
                                   : static_cast<int>(w << (28 - 8 * c)) >> 28);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int QUANT, int BT>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const float* __restrict__ h, const float* __restrict__ A,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const void* __restrict__ sketch,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int* __restrict__ idx_out, int B, int d, int dp, int L,
                    int K, int R, int64_t V, float r, float inv_l, Plan pl) {
  using T = Tiles<QUANT, BT>;
  const int G = pl.G;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // stage landed
  uint64_t* empty = full + kMaxStages;                  // stage read by all consumers
  uint64_t* pro_bar = empty + kMaxStages;               // the transform's copies
  unsigned char* ring = smem + kBarBytes;
  const int n_groups = (L + G - 1) / G;
  float* parts_s = reinterpret_cast<float*>(ring + pl.region);  // 16-byte aligned
  float* q_s = parts_s + kParts * BT * dp;
  int* idx_s = reinterpret_cast<int*>(q_s + BT * dp);
  float* scale_s = reinterpret_cast<float*>(idx_s + BT * L);
  int* sel_s = reinterpret_cast<int*>(scale_s + BT * L);
  int* key_s = sel_s + BT * L;
  int* nseg_s = key_s + n_groups * pl.n_slots;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int nb = min(BT, static_cast<int>(B - b0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cs = pl.cs, rank = static_cast<int>(cluster.block_rank());
  const int n_own = kParts / cs, part0 = rank * n_own;  // this block's partials

  if (tid == 0) {
    for (int s = 0; s < pl.n_stages; ++s) {
      bulk::mbar_init(&full[s], 1);
      bulk::mbar_init(&empty[s], kConsumers);
    }
    bulk::mbar_init(pro_bar, 1);
    bulk::mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive();   // every block of the cluster has started (waited below)

  // 1. The transform.  Scratch in the ring: the bank transposed (wt_s:
  // dp rows of bank_stride words, row j holding w[l, k, j] at l * K + k),
  // bias_s, the bank as stored (wc_s, staging), then a round of rchunks
  // chunks of the own partials' A rows (a_s: part, chunk, row, dp) and h
  // values (hh_s: part, chunk, b, row).  A's and the bank's rows come in by
  // TMA, a few large requests (a request has a fixed issue cost, whatever
  // its size); h's 128-byte rows and unaligned pieces by cp.async; rows
  // past d or the batch are zero.
  const int LK = L * K;
  float* wt_s = reinterpret_cast<float*>(ring);
  float* bias_s = wt_s + round4(dp * pl.bank_stride);
  float* wc_s = bias_s + round4(LK);
  float* a_s = wc_s + round4(LK * dp);
  float* hh_s = a_s + n_own * pl.rchunks * kRowsPerPart * dp;
  auto aligned = [](const void* p, int n) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && n % 4 == 0 && n > 0;
  };
  // Stage n floats of src at dst, the first `valid` of them read, the rest
  // zero: by TMA onto pro_bar where it can, else float by float.
  auto stage = [&](float* dst, const float* src, int n, int valid) {
    if (aligned(src, valid)) {
      bulk::mbar_expect_tx(pro_bar, 4u * valid);
      bulk::load(dst, bulk::Span{src, 4u * valid}, pro_bar);
    } else {
      for (int e = 0; e < valid; ++e) bulk::copy4(dst + e, src + e);
    }
    for (int e = valid; e < n; ++e) dst[e] = 0.f;
  };
  const bool bank_tma = aligned(w, LK * dp);
  if (tid == 0 && bank_tma) stage(wc_s, w, LK * dp, LK * dp);
  if (!bank_tma)
    for (int lk = warp; lk < LK; lk += kThreads / 32)
      for (int j = lane; j < dp; j += 32)
        bulk::copy4(wt_s + j * pl.bank_stride + lk, w + static_cast<int64_t>(lk) * dp + j);
  for (int e = tid; e < LK; e += kThreads) bulk::copy4(bias_s + e, bias + e);
  for (int e = tid; e < n_own * BT * dp; e += kThreads) parts_s[part0 * BT * dp + e] = 0.f;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  for (int c0 = 0, round = 0; c0 < n_chunks; c0 += pl.rchunks, ++round) {
    const int nc = min(pl.rchunks, n_chunks - c0);
    for (int t = tid; t < n_own * nc; t += kThreads) {   // A: a request a chunk
      const int pw = t / nc, cc = t % nc;
      const int i0 = (c0 + cc) * kChunk + (part0 + pw) * kRowsPerPart;
      stage(a_s + (pw * pl.rchunks + cc) * kRowsPerPart * dp,
            A + static_cast<int64_t>(i0) * dp, kRowsPerPart * dp,
            max(0, min(kRowsPerPart, d - i0)) * dp);
    }
    // h: 8 threads a (part, chunk, batch row), 4 values each.
    for (int t = tid; t < n_own * nc * BT * 8; t += kThreads) {
      const int q = t % 8, bb = t / 8 % BT, cc = t / 8 / BT % nc, pw = t / 8 / BT / nc;
      const int i = (c0 + cc) * kChunk + (part0 + pw) * kRowsPerPart + 4 * q;
      float* dst = hh_s + ((pw * pl.rchunks + cc) * BT + bb) * kRowsPerPart + 4 * q;
      const float* src = h + (b0 + bb) * d + i;
      if (bb < nb && i + 4 <= d && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        bulk::copy16(dst, src);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (bb < nb && i + e < d) bulk::copy4(dst + e, src + e);
          else dst[e] = 0.f;
        }
      }
    }
    __syncthreads();
    if (tid == 0) bulk::mbar_arrive(pro_bar);
    bulk::mbar_wait(pro_bar, round & 1);
    bulk::wait_copies();
    __syncthreads();
    if (round == 0 && bank_tma)
      for (int e = tid; e < LK * dp; e += kThreads)
        wt_s[e % dp * pl.bank_stride + e / dp] = wc_s[e];
    // The chains: four columns j a thread where dp allows 16-byte reads (a
    // quarter of the shared-memory reads), else one.
    const int quad = dp % 4 == 0 ? 4 : 1;
    for (int ch = tid; ch < n_own * BT * dp / quad; ch += kThreads) {
      const int j = ch % (dp / quad) * quad, bb = ch / (dp / quad) % BT;
      const int pw = ch / (dp / quad) / BT;
      float* p = parts_s + ((part0 + pw) * BT + bb) * dp + j;
      if (quad == 4) {
        float4 acc = *reinterpret_cast<const float4*>(p);
        for (int cc = 0; cc < nc; ++cc) {
          const float4* x = reinterpret_cast<const float4*>(
              hh_s + ((pw * pl.rchunks + cc) * BT + bb) * kRowsPerPart);
          const float* a = a_s + (pw * pl.rchunks + cc) * kRowsPerPart * dp + j;
#pragma unroll
          for (int u4 = 0; u4 < kRowsPerPart / 4; ++u4) {
            const float4 xv = x[u4];
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 av = *reinterpret_cast<const float4*>(a + (4 * u4 + e) * dp);
              acc.x = fmaf(xs[e], av.x, acc.x);
              acc.y = fmaf(xs[e], av.y, acc.y);
              acc.z = fmaf(xs[e], av.z, acc.z);
              acc.w = fmaf(xs[e], av.w, acc.w);
            }
          }
        }
        *reinterpret_cast<float4*>(p) = acc;
      } else {
        float acc = *p;
        for (int cc = 0; cc < nc; ++cc) {
          const float* x = hh_s + ((pw * pl.rchunks + cc) * BT + bb) * kRowsPerPart;
          const float* a = a_s + (pw * pl.rchunks + cc) * kRowsPerPart * dp + j;
#pragma unroll
          for (int u = 0; u < kRowsPerPart; ++u) acc = fmaf(x[u], a[u * dp], acc);
        }
        *p = acc;
      }
    }
    bulk::fence_proxy_async();       // before the next round's TMA writes
    __syncthreads();
  }
  cluster_wait();
  for (int e = tid; e < n_own * BT * dp; e += kThreads) {
    const int o = part0 * BT * dp + e;
    for (int k = 1; k < cs; ++k)
      cluster.map_shared_rank(parts_s, (rank + k) % cs)[o] = parts_s[o];
  }
  cluster.sync();                  // every partial has landed everywhere
  for (int o = tid; o < BT * dp; o += kThreads) {
    float s = parts_s[o];
    for (int p = 1; p < kParts; ++p) s = __fadd_rn(s, parts_s[p * BT * dp + o]);
    q_s[o] = s;
  }
  __syncthreads();
  // The hash: lsh::hash_rows' arithmetic item for item (the dot in order
  // j = 0..dp-1, subhash_code, mix_step, the fold mod R), reading the bank
  // transposed, so that the threads of neighbouring rows l read neighbouring
  // words (hash_rows' own layout puts them dp words apart: one bank).
  for (int item = tid; item < nb * L; item += kThreads) {
    const int bb = item / L, l = item % L;
    const float* q = q_s + bb * dp;
    uint32_t code = lsh::row_salt(l);
    for (int k = 0; k < K; ++k) {
      const float* wr = wt_s + l * K + k;
      float proj = 0.f;
      for (int j = 0; j < dp; ++j) proj = fmaf(q[j], wr[j * pl.bank_stride], proj);
      code = lsh::mix_step(code, lsh::subhash_code(proj, bias_s[l * K + k], r), k);
    }
    idx_s[item] = static_cast<int>(code % static_cast<uint32_t>(R));
  }
  __syncthreads();
  for (int i = tid; i < BT * L; i += kThreads) {
    const int bb = i / L, l = i % L;
    // Rows past the batch repeat its last row (their sums are dropped).
    const int idx = idx_s[(bb < nb ? bb : nb - 1) * L + l];
    if (bb >= nb) idx_s[i] = idx;
    if constexpr (QUANT != lsh::kF32) scale_s[i] = scale[l * R + idx];
    if (idx_out != nullptr && blockIdx.y == 0 && bb < nb) idx_out[b0 * L + i] = idx;
  }
  __syncthreads();

  // 2. Items (l, bb), numbered l * BT + bb; step g holds items [g * kSlots,
  // (g + 1) * kSlots), keyed by (storage row, bucket).  A key's first item
  // leads, and the leaders take the step's slots in item order.  sel: the
  // stage byte of an item's count at a tile's first column (tile starts are
  // multiples of 16 bytes from the row start, so the offset within the
  // widened copy is the row start's, mod 16).
  const uintptr_t base = reinterpret_cast<uintptr_t>(sketch);
  if (warp < kConsumers) {
    for (int first = warp * 32; first < n_groups * pl.n_slots; first += kConsumers * 32) {
      const int item = first + lane, l = item / BT;
      const bool valid = item < BT * L;
      const int key = valid ? (QUANT == lsh::kInt4 ? l >> 1 : l) * R + idx_s[(item % BT) * L + l]
                            : -1 - lane;
      const unsigned step_lanes =
          pl.n_slots == 32 ? kFull : ((1u << pl.n_slots) - 1) << (lane & ~(pl.n_slots - 1));
      const unsigned same = __match_any_sync(kFull, key) & step_lanes;
      const int leader = __ffs(same) - 1;
      const unsigned leaders = __ballot_sync(kFull, valid && leader == lane) & step_lanes;
      const int slot = __popc(leaders & ((1u << leader) - 1));
      if (valid) {
        sel_s[item] = slot * pl.slot_bytes +
                      static_cast<int>((base + static_cast<uint64_t>(key) * V * T::kElt) & 15);
        if (leader == lane) key_s[item / pl.n_slots * pl.n_slots + slot] = key;
      }
      if ((lane & (pl.n_slots - 1)) == 0 && item / pl.n_slots < n_groups)
        nseg_s[item / pl.n_slots] = __popc(leaders);
    }
  }
  bulk::fence_proxy_async();    // the scratch's generic accesses before TMA's writes
  __syncthreads();

  // 3. The ring.  Step k = (tile k / n_groups, group k % n_groups).
  const int64_t vb = split_start(V, blockIdx.y, pl.n_split);
  const int64_t ve = split_start(V, blockIdx.y + 1, pl.n_split);
  const int n_tiles = ve > vb ? static_cast<int>((ve - vb + pl.tile_cols - 1) / pl.tile_cols) : 0;
  const int n_steps = n_tiles * n_groups;
  const int stage_bytes = pl.n_slots * pl.slot_bytes;
  if (warp == kConsumers) {        // the producer
    for (int k = 0, s = 0, grp = 0, tile = 0; k < n_steps; ++k) {
      if (k >= pl.n_stages) bulk::mbar_wait(&empty[s], (k / pl.n_stages - 1) & 1);
      const int64_t v0 = vb + static_cast<int64_t>(tile) * pl.tile_cols;
      const int64_t cols = ve - v0 < pl.tile_cols ? ve - v0 : pl.tile_cols;
      const int nseg = nseg_s[grp];
      bulk::Span span{nullptr, 0};
      if (lane < nseg)
        span = bulk::bulk_span(static_cast<const unsigned char*>(sketch) +
                                   (static_cast<int64_t>(key_s[grp * pl.n_slots + lane]) * V + v0) *
                                       T::kElt,
                               static_cast<uint32_t>(cols * T::kElt));
      const uint32_t total = __reduce_add_sync(kFull, span.bytes);
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[s], total);
      __syncwarp();
      if (lane < nseg)
        bulk::load(ring + s * stage_bytes + lane * pl.slot_bytes, span, &full[s]);
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
    const unsigned char* stage = ring + s * stage_bytes;
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
          sel[uu][bb] = sel_s[l * BT + bb];
          sc[uu][bb] = u0 + uu < n_u ? (T::kF32 ? 1.f : scale_s[bb * L + l]) : 0.f;
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
            if (bb < nb && col < ve) out[(b0 + bb) * V + col] = acc[v][c][bb] * inv_l;
            acc[v][c][bb] = 0.f;
          }
        }
    }
    if (++s == pl.n_stages) s = 0;
    if (++grp == n_groups) grp = 0, ++tile;
  }
}

// The shape a plan was made for.
struct Shape {
  int dev, B, d, dp, L, K;
  int64_t V;
  bool operator==(const Shape& o) const {
    return dev == o.dev && B == o.B && d == o.d && dp == o.dp && L == o.L && K == o.K &&
           V == o.V;
  }
};

template <int QUANT, int BT>
cudaError_t make_plan(const Shape& sh, Plan* out) {
  using T = Tiles<QUANT, BT>;
  const int B = sh.B, d = sh.d, dp = sh.dp, L = sh.L, K = sh.K;
  const int64_t V = sh.V;
  int max_smem = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, sh.dev);
  if (err != cudaSuccess) return err;
  Plan pl;
  const int64_t fixed = kBarBytes + 4 * static_cast<int64_t>(table_words(BT, L, dp));
  const int64_t stages = (max_smem - fixed) / kStageCap;
  pl.n_stages = static_cast<int>(stages < kMaxStages ? stages : kMaxStages);
  pl.region = pl.n_stages * kStageCap;
  // The transform's round: as many chunks of d as the ring holds beside the
  // bank, for the most partials a block computes (all eight).
  pl.bank_stride = L * K | 1;
  const int64_t bank = round4(dp * pl.bank_stride) + round4(L * K) + round4(L * K * dp);
  const int64_t per_chunk = kParts * kRowsPerPart * (static_cast<int64_t>(dp) + BT);
  const int64_t n_chunks = (d + kChunk - 1) / kChunk;
  int64_t rchunks = (pl.region / 4 - bank) / per_chunk;
  if (rchunks > n_chunks) rchunks = n_chunks;
  pl.rchunks = static_cast<int>(rchunks);
  pl.smem = static_cast<int>(fixed + pl.region);
  if (pl.n_stages < 2 || rchunks < 1 || fixed + pl.region > max_smem)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_decode_kernel<QUANT, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  // V ranges per row tile: as many as fill the card at once, in clusters of
  // the size (8, 4, 2 or 1) that fills it most, the larger on a tie.
  const int row_tiles = (B + BT - 1) / BT;
  const int64_t most = V / kMinRange > 1 ? V / kMinRange : 1;
  pl.cs = 1;
  pl.n_split = 1;
  int64_t best = 0;
  for (int cs = kParts; cs >= 1; cs /= 2) {
    if (cs > most) continue;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = cs;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fused_decode_kernel<QUANT, BT>, &cfg);
    if (err != cudaSuccess) return err;
    int64_t per = active / row_tiles;
    if (per > most / cs) per = most / cs;
    if (cs * per * row_tiles > best) {
      best = cs * per * row_tiles;
      pl.cs = cs;
      pl.n_split = static_cast<int>(cs * per);
    }
  }
  // Tiles: the widest range split into equal tiles of at most kCols; a
  // stage of the most slots (a power of two up to 32) that fit kStageCap,
  // keeping a step's sketch rows even for int4's row pairs.
  const int64_t range = (V + pl.n_split - 1) / pl.n_split + kSplitAlign;
  const int64_t per_range = (range + T::kCols - 1) / T::kCols;
  pl.tile_cols = static_cast<int>(((range + per_range - 1) / per_range + 15) / 16 * 16);
  pl.slot_bytes = pl.tile_cols * T::kElt + 32;
  const int min_slots = QUANT == lsh::kInt4 ? 2 * BT : BT;
  pl.n_slots = 32;
  while (pl.n_slots > min_slots && pl.n_slots * pl.slot_bytes > kStageCap) pl.n_slots /= 2;
  pl.G = pl.n_slots / BT;
  if (pl.n_slots * pl.slot_bytes > kStageCap) return cudaErrorInvalidValue;
  *out = pl;
  return cudaSuccess;
}

template <int QUANT, int BT>
int launch(const float* h, const float* A, const float* w, const float* bias,
           const void* sketch, const float* scale, float* out, int* idx_out,
           int B, int d, int dp, int L, int K, int R, int64_t V, float r,
           cudaStream_t stream) {
  // The plan of the last shape this thread launched (the decode loop
  // launches one shape over and over, and planning takes several CUDA
  // runtime calls).
  static thread_local Shape last{-1, 0, 0, 0, 0, 0, 0};
  static thread_local Plan pl;
  Shape sh{0, B, d, dp, L, K, V};
  cudaError_t err = cudaGetDevice(&sh.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(sh == last)) {
    err = make_plan<QUANT, BT>(sh, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    last = sh;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = pl.cs;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + BT - 1) / BT, pl.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_decode_kernel<QUANT, BT>, h, A, w, bias, sketch,
                           scale, out, idx_out, B, d, dp, L, K, R, V, r,
                           1.0f / static_cast<float>(L), pl);
  if (err != cudaSuccess) return static_cast<int>(err);
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
