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
// The sums, in one order for both kernels below (race_query_ordered_ref in
// kernels/race_query/ops.py is the same function in plain PyTorch): a warp
// owns a (query, group), lane t adds the group's reads i = t, t + 32, ...
// (i < m, skipping indices outside [0, R)) in increasing i from 0.0f, then
// a fixed xor-shuffle tree (offsets 16, 8, 4, 2, 1) adds the 32 partials;
// each step adds a + b on one lane and b + a on its partner, so every lane
// holds the same bits.  The mean is __fdiv_rn(sum, m).  The g <= 64 group
// means of a (query, channel) go to shared memory; lane t ranks mean t among
// them (ties broken by group index, so the ranks are a permutation) and the
// lanes holding the middle rank(s) hand their values to lane 0, which
// writes (lo + hi) * 0.5 — jnp.median's midpoint, exactly x for odd g.  A
// NaN mean (L < g gives 0 / 0) makes the result NaN, as in JAX.  No
// atomics: two launches on the same inputs give the same bits.
//
// race_query_staged, every paper shape.  The TPU kernel contracted a
// one-hot (Bt, L, R) cube with the sketch on the MXU; a direct gather from
// L2 (race_query_rows below) makes each of the B*C*L reads a 32-byte L2
// sector, ~640 MB at adult against the 40 MB of indices.  Here the gathers
// read shared memory:
//   - A cluster of cs = min(g, 8) blocks of 16 warps serves one range of
//     query rows; block rank k owns groups k, k + cs, ... and stages their
//     sketch slices (C x m x R f32; 100 KB at adult, 200 KB at susy) into
//     shared memory once, by cp.async.bulk, so S crosses the L2 once per
//     cluster.  TMA multicast would not cut this further: no two blocks of
//     a cluster stage the same slice.  Where a slice does not fit, its
//     first p rows are staged and the rest read from L2 (the order of the
//     sums does not change).
//   - Each block streams its groups' index segments (m int32 of a query
//     row, contiguous) through a ring of stages of 32 (or 16) rows, a warp
//     a segment, in 16-byte cp.async pieces that complete on the stage's
//     mbarrier, stages ahead of their use: the 40 MB that bound the kernel
//     move without a TMA request, and its fixed issue cost, per ~1 KB
//     segment.
//   - Each warp sums two query rows at once (independent chains).  A block
//     writes the means of its groups into the shared memory of the block
//     that owns the query's median (rows dealt round-robin over the
//     cluster), through distributed shared memory; after a cluster barrier
//     each block takes the medians of its rows.  One launch in all.
// Its gathers hit random buckets, so a warp's 32 shared-memory reads meet
// bank conflicts.
// race_query_rows, the general path, for shapes whose index stages do not
// fit in shared memory or whose groups are shorter than a warp (m < 32):
// one warp a query row, gathers straight from L2.
#include "bulk_copy.cuh"

#include <cooperative_groups.h>

#include <cmath>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;           // threads of a race_query_rows block
constexpr int kWarps = kThreads / 32;  // its query rows
constexpr int kMaxC = 4;               // channels per index read
constexpr int kMaxG = 64;              // most groups
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kMaxStages = 3;
constexpr int kMeansBytes = 16 * 1024; // means buffer's cap per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// The warp's median of means[0 .. g) into out (lane 0 writes); mid: two
// floats of shared memory of this warp.
__device__ __forceinline__ void warp_median(const float* means, int g, float* mid,
                                            float* out) {
  const int lane = threadIdx.x % 32;
  bool has_nan = false;
  for (int t = lane; t < g; t += 32) {
    const float v = means[t];
    has_nan |= isnan(v);
    int rank = 0;
    for (int u = 0; u < g; ++u) {
      const float w = means[u];
      rank += (w < v) || (w == v && u < t);
    }
    if (rank == (g - 1) / 2) mid[0] = v;
    if (rank == g / 2) mid[1] = v;
  }
  has_nan = __any_sync(kFull, has_nan);
  __syncwarp();
  if (lane == 0) *out = has_nan ? qnan() : __fmul_rn(__fadd_rn(mid[0], mid[1]), 0.5f);
  __syncwarp();
}

// The xor-shuffle tree over the warp's 32 lane partials.
__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

// ---------------------------------------------------------------- general

__global__ void __launch_bounds__(kThreads)
race_query_rows(const float* __restrict__ S, const int* __restrict__ idx,
                float* __restrict__ out, int B, int C, int L, int R, int g) {
  __shared__ float means_s[kWarps][kMaxC][kMaxG];
  __shared__ float mid_s[kWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;                  // whole warps only: no block barrier
  const int m = L / g;
  const int* row = idx + b * L;
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
        if (cc < nc) {
          const float sum = warp_sum(acc[cc]);
          if (lane == 0) means_s[warp][cc][j] = __fdiv_rn(sum, static_cast<float>(m));
        }
    }
    __syncwarp();
    for (int cc = 0; cc < nc; ++cc)
      warp_median(means_s[warp][cc], g, mid_s[warp], out + b * C + c0 + cc);
  }
}

// ----------------------------------------------------------------- staged

// Shared-memory plan of race_query_staged, made on the host.
struct Plan {
  int cs;           // blocks per cluster
  int n_clusters;
  int ng;           // groups per block, ceil(g / cs)
  int rpw;          // query rows per warp and stage (1 or 2)
  int n_stages;     // index stages in the ring
  int islot;        // bytes of one staged index segment
  int stage_bytes;  // kSWarps * rpw * ng * islot
  int rc;           // query rows per chunk (a multiple of a stage's rows)
  int p;            // rows of each (group, channel) slice staged, <= m
  int pslot;        // bytes of one staged (group, channel) slice
  int ring_off, slice_off, smem;
};

constexpr int kSThreads = 512;          // threads of a staged block
constexpr int kSWarps = kSThreads / 32;
constexpr int kSliceBar = kMaxStages;   // the slice's barrier, after the stages'
constexpr int kMidOff = 64;             // (kSWarps, 2) floats of the medians
constexpr int kBarBytes = 256;          // the barriers and the median scratch
constexpr int kQC = 2;                  // channels a pass of the gather

__host__ __device__ __forceinline__ int round16(int64_t x) {
  return static_cast<int>((x + 15) & ~int64_t{15});
}

template <int RPW>
__global__ void __launch_bounds__(kSThreads, 1)
race_query_staged(const float* __restrict__ S, const int* __restrict__ idx,
                  float* __restrict__ out, int B, int C, int L, int R, int g,
                  Plan pl) {
  constexpr int kRows = kSWarps * RPW;   // query rows a stage
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float (*mid_s)[2] = reinterpret_cast<float (*)[2]>(smem + kMidOff);  // (kSWarps, 2)
  float* means_s = reinterpret_cast<float*>(smem + kBarBytes);  // (rc / cs, C, g)
  unsigned char* ring = smem + pl.ring_off;                     // (stage, kRows, ng)
  unsigned char* slice = smem + pl.slice_off;                   // (ng, C)
  const int cs = pl.cs, rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / cs;
  const int m = L / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r0 = static_cast<int64_t>(B) * cid / pl.n_clusters;
  const int n_rows = static_cast<int>(static_cast<int64_t>(B) * (cid + 1) / pl.n_clusters - r0);
  const int n_k = (n_rows + kRows - 1) / kRows;                 // index stages

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.n_stages; ++s) bulk::mbar_init(&bar[s], kSThreads);
    bulk::mbar_init(&bar[kSliceBar], 1);
    bulk::mbar_fence_init();
  }
  __syncthreads();

  // The slice of group j, channel c: S[c, j*m : j*m + p, :], and the index
  // segment of row b, group j: idx[b, j*m : j*m + m].
  auto slice_src = [&](int jl, int c) {
    return S + (static_cast<int64_t>(c) * L + static_cast<int64_t>(rank + cs * jl) * m) * R;
  };
  auto idx_src = [&](int64_t b, int jl) {
    return idx + b * L + static_cast<int64_t>(rank + cs * jl) * m;
  };
  // Every thread: its 16-byte pieces of index stage k (slot v * ng + jl
  // holds row r0 + k * kRows + v, group jl), then one arrival on the
  // stage's barrier when they have landed.
  auto issue = [&](int k) {
    const int s = k % pl.n_stages;
    for (int slot = warp; m > 0 && slot < kRows * pl.ng; slot += kSWarps) {
      const int64_t b = r0 + static_cast<int64_t>(k) * kRows + slot / pl.ng;
      const int jl = slot % pl.ng;
      if (b >= r0 + n_rows || rank + cs * jl >= g) continue;
      const bulk::Span span = bulk::bulk_span(idx_src(b, jl), 4u * m);
      unsigned char* dst = ring + s * pl.stage_bytes + slot * pl.islot;
      for (uint32_t piece = 16u * lane; piece < span.bytes; piece += 16u * 32)
        bulk::copy16(dst + piece, static_cast<const unsigned char*>(span.lo) + piece);
    }
    bulk::arrive_on_copies(&bar[s]);
  };
  if (warp == 0) {   // the slice: a few large TMA copies
    const int n_pairs = pl.p > 0 ? pl.ng * C : 0;
    uint32_t bytes = 0;
    for (int pr = lane; pr < n_pairs; pr += 32)
      if (rank + cs * (pr / C) < g)
        bytes += bulk::bulk_span(slice_src(pr / C, pr % C), 4u * pl.p * R).bytes;
    bytes = __reduce_add_sync(kFull, bytes);
    if (lane == 0) bulk::mbar_arrive_expect_tx(&bar[kSliceBar], bytes);
    __syncwarp();
    for (int pr = lane; pr < n_pairs; pr += 32)
      if (rank + cs * (pr / C) < g)
        bulk::load(slice + pr * pl.pslot,
                   bulk::bulk_span(slice_src(pr / C, pr % C), 4u * pl.p * R),
                   &bar[kSliceBar]);
  }
  for (int k = 0; k < min(pl.n_stages, n_k); ++k) issue(k);
  bulk::mbar_wait(&bar[kSliceBar], 0);

  for (int k = 0; k < n_k; ++k) {
    const int s = k % pl.n_stages;
    const int chunk0 = k * kRows / pl.rc * pl.rc;    // the chunk's first row
    bulk::mbar_wait(&bar[s], (k / pl.n_stages) & 1);
    // This warp's rows of the stage: v = warp + kSWarps * u.
    const unsigned char* stage = ring + s * pl.stage_bytes;
    for (int jl = 0; jl < pl.ng && rank + cs * jl < g; ++jl) {
      const int j = rank + cs * jl;
      const int* ix[RPW];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int v = warp + kSWarps * u;
        const int64_t b = r0 + static_cast<int64_t>(k) * kRows + v;
        ix[u] = reinterpret_cast<const int*>(
            stage + (v * pl.ng + jl) * pl.islot +
            (reinterpret_cast<uintptr_t>(idx_src(b, jl)) & 15));
      }
      for (int c0 = 0; c0 < C; c0 += kQC) {
        const int nc = min(kQC, C - c0);
        const float* sl[kQC];
        const float* gl[kQC];
#pragma unroll
        for (int cc = 0; cc < kQC; ++cc) {
          const int c = min(c0 + cc, C - 1);
          gl[cc] = slice_src(jl, c);
          sl[cc] = reinterpret_cast<const float*>(
              slice + (jl * C + c) * pl.pslot + (reinterpret_cast<uintptr_t>(gl[cc]) & 15));
        }
        float acc[RPW][kQC];
#pragma unroll
        for (int u = 0; u < RPW; ++u)
#pragma unroll
          for (int cc = 0; cc < kQC; ++cc) acc[u][cc] = 0.0f;
        // Rows below p from the staged slice, the rest from L2.  An index
        // outside [0, R) adds nothing (stale slots of rows past the block's
        // are read too, and their sums dropped).
        int i = lane;
#pragma unroll 2
        for (; i < pl.p; i += 32) {
#pragma unroll
          for (int u = 0; u < RPW; ++u) {
            const int r = ix[u][i];
            if (r >= 0 && r < R)
#pragma unroll
              for (int cc = 0; cc < kQC; ++cc)
                if (cc < nc) acc[u][cc] = __fadd_rn(acc[u][cc], sl[cc][i * R + r]);
          }
        }
        for (; i < m; i += 32) {
#pragma unroll
          for (int u = 0; u < RPW; ++u) {
            const int r = ix[u][i];
            if (r >= 0 && r < R)
#pragma unroll
              for (int cc = 0; cc < kQC; ++cc)
                if (cc < nc) acc[u][cc] = __fadd_rn(acc[u][cc], __ldg(gl[cc] + i * R + r));
          }
        }
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          const int q = k * kRows + warp + kSWarps * u - chunk0;   // row within the chunk
#pragma unroll
          for (int cc = 0; cc < kQC; ++cc) {
            if (cc >= nc) continue;
            const float sum = warp_sum(acc[u][cc]);
            if (lane == 0 && k * kRows + warp + kSWarps * u < n_rows) {
              float* owner = cluster.map_shared_rank(means_s, q % cs);  // (rc / cs, C, g)
              owner[(static_cast<int64_t>(q / cs) * C + c0 + cc) * g + j] =
                  __fdiv_rn(sum, static_cast<float>(m));
            }
          }
        }
      }
    }
    __syncthreads();                 // every warp is done with stage s
    if (k + pl.n_stages < n_k) issue(k + pl.n_stages);
    const int chunk_rows = min(pl.rc, n_rows - chunk0);
    if ((k + 1) * kRows >= chunk0 + chunk_rows) {   // the chunk's last stage
      cluster.sync();                // every mean of the chunk has landed
      for (int o = warp; rank + cs * o < chunk_rows; o += kSWarps) {
        const int64_t b = r0 + chunk0 + rank + cs * o;
        for (int c = 0; c < C; ++c)
          warp_median(means_s + (static_cast<int64_t>(o) * C + c) * g, g, mid_s[warp],
                      out + b * C + c);
      }
      if (k + 1 < n_k) cluster.sync();   // medians read before the next chunk writes
    }
  }
}

// The staged kernel's plan for this shape, or false where its index stages
// do not fit.  Preference: 32 query rows a stage and three stages in
// flight, then two, then 16 rows and two stages; the first that leaves room
// for whole slices, else the last with part of each slice.
bool make_plan(int B, int C, int L, int R, int g, int n_sm, int max_smem, Plan* pl) {
  pl->cs = g < kMaxCluster ? g : kMaxCluster;
  pl->ng = (g + pl->cs - 1) / pl->cs;
  const int m = L / g;
  pl->islot = round16(4 * static_cast<int64_t>(m)) + 32;
  const int64_t per_row = 4 * static_cast<int64_t>(C) * g;
  const int64_t est = n_sm / pl->cs > 1 ? n_sm / pl->cs : 1;     // clusters, about
  const int64_t share = (B + est - 1) / est;
  const int options[][2] = {{2, 3}, {2, 2}, {1, 2}};
  for (const auto& opt : options) {
    pl->rpw = opt[0];
    pl->n_stages = opt[1];
    const int rows = kSWarps * pl->rpw;
    pl->stage_bytes = rows * pl->ng * pl->islot;
    // Rows per chunk: a cluster's share of B, as far as the means fit
    // kMeansBytes.
    int64_t rc = kMeansBytes / per_row * pl->cs;
    if (rc > share) rc = share;
    rc = (rc + rows - 1) / rows * rows;
    pl->rc = static_cast<int>(rc < rows ? rows : rc);
    const int64_t means = round16((pl->rc + pl->cs - 1) / pl->cs * per_row);
    pl->ring_off = static_cast<int>(kBarBytes + means);
    const int64_t slice_off = pl->ring_off + static_cast<int64_t>(pl->n_stages) * pl->stage_bytes;
    pl->slice_off = static_cast<int>(slice_off < max_smem ? slice_off : max_smem);
    const int64_t left = static_cast<int64_t>(max_smem) - slice_off;
    const int64_t per_pair = left / (static_cast<int64_t>(pl->ng) * C);
    const int64_t p = per_pair > 48 ? (per_pair - 48) / (4 * static_cast<int64_t>(R)) : 0;
    pl->p = static_cast<int>(p < m ? p : m);
    pl->pslot = round16(4 * static_cast<int64_t>(pl->p) * R) + 32;
    if (pl->p == m && left >= 0) break;
  }
  const int64_t smem = static_cast<int64_t>(pl->slice_off) +
                       (pl->p > 0 ? static_cast<int64_t>(pl->ng) * C * pl->pslot : 0);
  pl->smem = static_cast<int>(smem);
  return static_cast<int64_t>(pl->ring_off) + static_cast<int64_t>(pl->n_stages) * pl->stage_bytes
             <= max_smem && smem <= max_smem;
}

// Sets the kernel's shared memory and fills pl.n_clusters: as many
// clusters as fit on the card at once, and no more than give each a stage
// of rows.
template <int RPW>
cudaError_t finish_plan(int B, Plan* pl) {
  cudaError_t err = cudaFuncSetAttribute(
      race_query_staged<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl->smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl->cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl->cs);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = pl->smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, race_query_staged<RPW>, &cfg);
  if (err != cudaSuccess) return err;
  if (n_clusters < 1) return cudaErrorInvalidConfiguration;
  const int most = (B + kSWarps * RPW - 1) / (kSWarps * RPW);
  pl->n_clusters = n_clusters < most ? n_clusters : most;
  return cudaSuccess;
}

template <int RPW>
int launch_staged(const float* S, const int* idx, float* out, int B, int C, int L,
                  int R, int g, const Plan& pl, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.n_clusters * pl.cs);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, race_query_staged<RPW>, S, idx, out, B, C, L, R, g, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The shape a plan was made for.
struct Shape {
  int dev, B, C, L, R, g;
  bool operator==(const Shape& o) const {
    return dev == o.dev && B == o.B && C == o.C && L == o.L && R == o.R && g == o.g;
  }
};

}  // namespace

extern "C" int race_query_launch(const float* S, const int* idx, float* out,
                                 int B, int C, int L, int R, int g,
                                 cudaStream_t stream) {
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  // The plan of the last shape this thread launched (planning takes
  // several CUDA runtime calls; a query shape repeats).
  static thread_local Shape last{-1, 0, 0, 0, 0, 0};
  static thread_local Plan plan;
  static thread_local bool staged = false;
  Shape sh{0, B, C, L, R, g};
  cudaError_t err = cudaGetDevice(&sh.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(sh == last)) {
    int n_sm = 0, max_smem = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, sh.dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, sh.dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // A group shorter than a warp would leave most lanes of the staged
    // kernel idle behind its cluster barriers; those shapes go to the
    // general one.
    staged = L / g >= 32 && make_plan(B, C, L, R, g, n_sm, max_smem, &plan);
    if (staged) {
      err = plan.rpw == 2 ? finish_plan<2>(B, &plan) : finish_plan<1>(B, &plan);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    last = sh;
  }
  if (staged)
    return plan.rpw == 2 ? launch_staged<2>(S, idx, out, B, C, L, R, g, plan, stream)
                         : launch_staged<1>(S, idx, out, B, C, L, R, g, plan, stream);
  const dim3 grid((B + kWarps - 1) / kWarps);
  race_query_rows<<<grid, kThreads, 0, stream>>>(S, idx, out, B, C, L, R, g);
  return static_cast<int>(cudaGetLastError());
}

// Message of a CUDA error code returned by the launcher.
extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
