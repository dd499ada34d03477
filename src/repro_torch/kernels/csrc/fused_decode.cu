// Fused sketched decode: for final hiddens h (B, d),
//   q = h . A                         (d -> dp asymmetric transform)
//   idx[b, l] = fold_k floor((q . W[l, k] + bias[l, k]) / r)   (L2-LSH)
//   logits[b, v] = (1/L) * sum_l scale[l, idx] * S[l, idx[b, l], v]
// in one launch, with S stored f32, int8 or packed int4 as in
// sketch_head.cu.  Row l's fold is salted by its global row index row0 + l:
// a shard holding rows [row0, row0 + L) of a larger head (the row-sharded
// path over a mesh's model axis) hashes into the buckets the whole head
// does; row0 = 0 is the whole head.
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
//      block, launch and cluster size.  The hash is lsh_hash.cu's
//      arithmetic on a transposed shared-memory copy of the bank.
//   2-3. The gather of gather_ring.cuh: per step of G sketch rows the
//      distinct (storage row, bucket) pairs the block's batch rows hit, and
//      a ring of shared-memory stages that a producer warp fills by
//      cp.async.bulk, read by the 16 consumer warps.  sketch_head.cu runs
//      the same code on indices from device memory, so the logits equal
//      sketch_head's at the same indices bit for bit.
#include "gather_ring.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

using ring::kBarBytes;
using ring::kMaxStages;
using ring::kMinRange;
using ring::kStageCap;
using ring::kThreads;
constexpr int kChunk = 256;                             // rows of d a chunk
constexpr int kParts = 8;                               // partials of q
constexpr int kRowsPerPart = kChunk / kParts;           // 32

// Host-side geometry of a launch: the gather's, and the transform's.
struct Plan {
  ring::Geometry g;
  int cs;            // blocks a cluster (along V)
  int region;        // bytes of the ring (the prologue's scratch aliases it)
  int rchunks;       // chunks of d staged a round of the transform
  int bank_stride;   // words between the transposed bank's rows (odd)
  int smem;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Per-block tables after the ring, in words: parts_s (kParts, BT, dp); q_s
// (BT, dp); then the gather's (ring::table_words).
__host__ __device__ __forceinline__ int table_words(int BT, int L, int dp) {
  return ring::table_words(BT, L) + (kParts + 1) * BT * dp;
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
                    int K, int R, int64_t V, float r, float inv_l, int row0,
                    Plan pl) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // stage landed
  uint64_t* empty = full + kMaxStages;                  // stage read by all consumers
  uint64_t* pro_bar = empty + kMaxStages;               // the transform's copies
  unsigned char* ring_s = smem + kBarBytes;
  float* parts_s = reinterpret_cast<float*>(ring_s + pl.region);  // 16-byte aligned
  float* q_s = parts_s + kParts * BT * dp;
  const ring::Tables tab =
      ring::carve(reinterpret_cast<int*>(q_s + BT * dp), BT, L, pl.g.n_slots, pl.g.G);
  int* idx_s = tab.idx_s;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int nb = min(BT, static_cast<int>(B - b0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cs = pl.cs, rank = static_cast<int>(cluster.block_rank());
  const int n_own = kParts / cs, part0 = rank * n_own;  // this block's partials

  if (tid == 0) {
    ring::init_barriers(full, empty, pl.g.n_stages);
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
  float* wt_s = reinterpret_cast<float*>(ring_s);
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
  // The hash: lsh_hash.cu's arithmetic item for item (the fmaf chain in
  // order j = 0..dp-1 from +0, subhash_code, mix_step, the fold mod R),
  // reading the bank transposed, so that the threads of neighbouring rows l
  // read neighbouring words.
  for (int item = tid; item < nb * L; item += kThreads) {
    const int bb = item / L, l = item % L;
    const float* q = q_s + bb * dp;
    uint32_t code = lsh::row_salt(row0 + l);
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
    if constexpr (QUANT != lsh::kF32) tab.scale_s[i] = scale[l * R + idx];
    if (idx_out != nullptr && blockIdx.y == 0 && bb < nb) idx_out[b0 * L + i] = idx;
  }
  __syncthreads();

  // 2-3. The lists and the ring.
  ring::list_segments<QUANT, BT>(sketch, L, R, V, pl.g, tab);
  ring::run<QUANT, BT>(sketch, L, V, pl.g, full, empty, ring_s, tab, nb, 0u, inv_l, out, b0,
                       blockIdx.y);
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
  const int B = sh.B, d = sh.d, dp = sh.dp, L = sh.L, K = sh.K;
  const int64_t V = sh.V;
  int max_smem = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, sh.dev);
  if (err != cudaSuccess) return err;
  Plan pl;
  const int64_t fixed = kBarBytes + 4 * static_cast<int64_t>(table_words(BT, L, dp));
  const int64_t stages = (max_smem - fixed) / kStageCap;
  pl.g.n_stages = static_cast<int>(stages < kMaxStages ? stages : kMaxStages);
  pl.region = pl.g.n_stages * kStageCap;
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
  if (pl.g.n_stages < 2 || rchunks < 1 || fixed + pl.region > max_smem)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_decode_kernel<QUANT, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  // V ranges per row tile: as many as fill the card at once, in clusters of
  // the size (8, 4, 2 or 1) that fills it most, the larger on a tie.
  const int row_tiles = (B + BT - 1) / BT;
  const int64_t most = V / kMinRange > 1 ? V / kMinRange : 1;
  pl.cs = 1;
  pl.g.n_split = 1;
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
      pl.g.n_split = static_cast<int>(cs * per);
    }
  }
  err = ring::plan_tiles<QUANT, BT>(V, &pl.g);
  if (err != cudaSuccess) return err;
  *out = pl;
  return cudaSuccess;
}

template <int QUANT, int BT>
int launch(const float* h, const float* A, const float* w, const float* bias,
           const void* sketch, const float* scale, float* out, int* idx_out,
           int B, int d, int dp, int L, int K, int R, int64_t V, float r,
           int row0, cudaStream_t stream) {
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
  cfg.gridDim = dim3((B + BT - 1) / BT, pl.g.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_decode_kernel<QUANT, BT>, h, A, w, bias, sketch,
                           scale, out, idx_out, B, d, dp, L, K, R, V, r,
                           1.0f / static_cast<float>(L), row0, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int QUANT>
int launch_rows(const float* h, const float* A, const float* w,
                const float* bias, const void* sketch, const float* scale,
                float* out, int* idx_out, int B, int d, int dp, int L, int K,
                int R, int64_t V, float r, int row0, cudaStream_t stream) {
  switch (lsh::rows_per_block(B)) {
    case 1: return launch<QUANT, 1>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    case 2: return launch<QUANT, 2>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    case 4: return launch<QUANT, 4>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    default: return launch<QUANT, 8>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
  }
}

}  // namespace

extern "C" int fused_decode_launch(const float* h, const float* A,
                                   const float* w, const float* bias,
                                   const void* sketch, const float* scale,
                                   float* out, int* idx_out, int B, int d,
                                   int dp, int L, int K, int R, int64_t V,
                                   float r, int row0, int quant,
                                   cudaStream_t stream) {
  switch (quant) {
    case lsh::kF32:
      return launch_rows<lsh::kF32>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    case lsh::kInt8:
      return launch_rows<lsh::kInt8>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    case lsh::kInt4:
      return launch_rows<lsh::kInt4>(h, A, w, bias, sketch, scale, out, idx_out, B, d, dp, L, K, R, V, r, row0, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
