// Causal flash attention (the prefill's attention), forward only:
//   s[q, k]   = (q_f32 * dh^-0.5) . k_f32            (f32 scores)
//   s         = softcap * tanh(s / softcap)           (optional)
//   s         = -1e30 unless k <= q and k < S and (q - k < window, optional)
//   out[q, :] = softmax_k(s[q, :]) . v_f32, cast to q's dtype
// q (B, S, H, dh), k and v (B, S, Hkv, dh), f32 or bf16 (all one type);
// query head h reads KV head h / (H / Hkv) (GQA, no expansion).  dh is a
// multiple of 16 up to 256.  The softmax is the flash-v2 recurrence (running
// row max m, denominator l, f32 accumulator, then acc / max(l, 1e-30)), with
// the reference's -1e30 masking: a row whose keys of a tile are all masked
// takes p = exp(0) = 1 there, and the first live key later clears it with
// corr = exp(-1e30 - m) = 0; the diagonal key is live for every row and
// tiles run in increasing k, so every row ends right.  Tiles wholly above
// the diagonal or outside the window band are never read, and no block
// splits the keys with another: no atomics, and two launches on the same
// inputs give the same bits.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py:40 (_flash_kernel,
// launcher flash_attention_pallas).
//
// Bound on this card: operations.  At the long prefill of gemma2-27b (B=1,
// S=4160, H=32, Hkv=16, dh=128) a layer's causal attention is 141.8 GFLOP
// (2 per multiply-add of q.k and of p.v over the 8.65 M live (q, k) pairs of
// each head).  Its bytes, q, k, v read and out written once in bf16, are
// about 100 MB: 30 us at 3.35 TB/s.
//
// f32 inputs: f32 FMAs on the CUDA cores, 2.1 ms at 67 TFLOP/s.  One block
// of 256 threads owns one (b, h, tile of 64 queries) with the scaled query
// rows in shared memory (f32); key tiles of 32 keys are staged as f32 (K
// rows padded: conflict-free float4 reads); lane c takes key c of the tile
// for its warp's 8 rows, then the lanes split dh for p.v.  Shared-memory
// wavefronts set its pace; it stays as the first version wrote it, since
// nothing on the serving path is f32.
//
// bf16 inputs (the serving path): bf16 wgmma on the tensor cores with f32
// accumulators.  The function's two products take 0.14 ms at 989 TFLOP/s;
// the kernel does four (below), 0.29 ms, and the softmax's tanh and exp run
// on the CUDA cores.  Every product it forms is exact, so
// the tensor cores cost only their accumulation (parity.py states the
// model and the bound):
//   - scores: q and k are bf16, so one wgmma per 16 of dh gives the exact
//     products q_d.k_d, summed in f32, and the sum is then scaled by
//     dh^-0.5 (one rounding).  The reference instead rounds q.dh^-0.5 to
//     f32 before the products: one more rounding.  Splitting that f32 q into
//     three bf16 terms would make the products the reference's at three
//     times the work and a three times longer accumulation chain;
//     parity.flash_attn_tol derives, for every dh, the bound of the
//     one-term product, which is the tighter of the two.
//   - p.v: p is f32, v bf16.  p * 2^16 (exact) is split into three bf16
//     terms hi + mid + lo, exact for every f32 p in [0, 1] (scaled, all its
//     bits sit at or above bf16's least subnormal 2^-133;
//     tests/test_torch_attention.py checks the split in plain torch), and
//     three wgmma (A from registers in the accumulator's own fragment
//     layout, B the V tile, MN-major) add the exact products; the final
//     division takes the 2^16 back out exactly.
// Block: two consumer warpgroups of 64 query rows and a producer warp.
// When the GQA group is even the two warpgroups take two query heads of one
// KV head at the same 64 positions, so each K/V tile is loaded once for
// both; otherwise they take 128 positions of one head.  The producer fills
// a ring of kStages K/V stages (bf16, 128-, 64- or 32-byte swizzle, 64 keys,
// or 32 above dh = 192) with TMA through 3-D tensor maps over (B, S,
// heads * dh), completing on mbarriers.  A consumer warpgroup issues q.k^T
// of a tile and p.v of the tile before, and runs the tile's softmax as soon
// as its scores are in, while p.v runs on the tensor cores: the scale and
// the softcap's division in one product (the same two roundings), accurate
// tanhf and expf, the mask only on tiles that need it, a row's 64 keys
// spread over a quad (two xor shuffles), o rescaled only when a row maximum
// moved.  Query tiles launch longest first across all heads.
#include "wgmma.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ------------------------------------------------ f32 path: CUDA-core FMAs
namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;                       // query rows per block
constexpr int kRows = kBlockQ / kWarps;           // query rows per warp
constexpr int kBlockK = 32;                       // keys per tile: one per lane
constexpr int kKPad = 4;                          // K row padding in floats

size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * dh +
                          static_cast<size_t>(kBlockK) * (dh + kKPad) +
                          static_cast<size_t>(kBlockK) * dh + kBlockQ * kBlockK);
}

template <int DPL>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int S, int H, int Hkv, int dh,
                  float scale, int window, float softcap) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // (kBlockQ, dh)
  const int ldk = dh + kKPad;
  float* k_s = q_s + kBlockQ * dh;                // (kBlockK, ldk)
  float* v_s = k_s + kBlockK * ldk;               // (kBlockK, dh)
  float* p_s = v_s + kBlockK * dh;                // (kBlockQ, kBlockK)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_step = static_cast<int64_t>(H) * dh;    // per position
  const int64_t kv_step = static_cast<int64_t>(Hkv) * dh;
  const float* qb = q + static_cast<int64_t>(b) * S * q_step + h * dh;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_step + hk * dh;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_step + hk * dh;

  for (int i = threadIdx.x; i < kBlockQ * dh; i += kThreads) {
    const int pos = q0 + i / dh;
    q_s[i] = pos < S ? __fmul_rn(qb[pos * q_step + i % dh], scale)
                     : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }
  const int row0 = warp * kRows;                  // first row of this warp
  const int k_end = min(S, q0 + kBlockQ);
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1) / kBlockK * kBlockK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();              // the last tile's K, V reads are done
    for (int i = threadIdx.x; i < kBlockK * dh; i += kThreads) {
      const int c = i / dh, d = i % dh, pos = k0 + c;
      float kk = 0.0f, vv = 0.0f;
      if (pos < S) {
        kk = kb[pos * kv_step + d];
        vv = vb[pos * kv_step + d];
      }
      k_s[c * ldk + d] = kk;
      v_s[c * dh + d] = vv;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = k_s + lane * ldk;
    for (int d = 0; d < dh; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (row0 + r) * dh + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r;
      float sc = s[r];
      if (softcap > 0.0f)
        sc = __fmul_rn(softcap, tanhf(__fdiv_rn(sc, softcap)));
      const bool live = kpos <= qpos && kpos < S &&
                        (window <= 0 || qpos - kpos < window);
      sc = live ? sc : kNegInf;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = expf(__fsub_rn(sc, m_new));
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(kFull, ps, off));
      corr[r] = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), ps);
      m[r] = m_new;
      p_s[(row0 + r) * kBlockK + lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = __fmul_rn(acc[r][i], corr[r]);
    for (int c = 0; c < kBlockK; c += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[j][i] = d < dh ? v_s[(c + j) * dh + d] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + (row0 + r) * kBlockK + c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          acc[r][i] = fmaf(p4.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(p4.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(p4.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(p4.w, vv[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();                 // p_s rows are rewritten next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // l >= 1 (the row maximum's own term), so log(l) is finite.
    if (lse != nullptr && lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qpos] =
          __fadd_rn(m[r], logf(l[r]));
    float* orow = out + static_cast<int64_t>(b) * S * q_step + qpos * q_step + h * dh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = __fdiv_rn(acc[r][i], denom);
    }
  }
}

template <int DPL>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int dh, float scale, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kernel = flash_attn_kernel<DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, Hkv,
      dh, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int Hkv, int dh, float scale,
              int window, float softcap, cudaStream_t stream) {
  switch ((dh + 31) / 32) {
#define FLASH_CASE(n)                                                      \
  case n:                                                                  \
    return launch<n>(q, k, v, out, lse, B, S, H, Hkv, dh, scale, window, \
                     softcap, stream);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32

// ------------------------------------------ bf16 path: tensor cores (wgmma)
namespace tc {

using namespace wgmma;

constexpr int kConsumers = 2;                     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kRows = 64;                         // query rows per warpgroup
constexpr int kStages = 3;                        // K/V ring depth

// Per dh: W, the column block in bf16 (the widest swizzle, 128, 64 or 32
// bytes, whose width divides dh), and BK, the keys per tile.
template <int DH>
struct Cfg : Cols<DH> {
  static constexpr int BK = DH <= 192 ? 64 : 32;
  static constexpr int kQTile = kRows * DH;       // bf16 per warpgroup's Q
  static constexpr int kKVTile = BK * DH;         // bf16 per K or V stage
  static constexpr size_t kSmem =
      1024 + 2 * static_cast<size_t>(kConsumers * kQTile +
                                     2 * kStages * kKVTile) +
      8 * (1 + 2 * kStages);
};

// The online softmax of one tile for this thread's two rows (qpos0 and
// qpos0 + 8; s[4j + i] is row i >> 1, key 8j + 2*quad + (i & 1)): the
// scores s (f32 sums of q.k) become p, m and l advance, and corr is the
// factor for o.  Both rows go through each step together, for instruction-
// level parallelism.  kMask: the tile holds masked keys for some row.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, int k0, int qpos0,
                                             int quad, int S, float scale,
                                             int window, float softcap,
                                             float scale_cap) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // With a softcap, s / softcap in one product by RN(scale / softcap):
      // the same two roundings as scaling, then dividing.
      const float sc =
          softcap > 0.0f
              ? __fmul_rn(softcap, tanhf(__fmul_rn(s[4 * j + i], scale_cap)))
              : __fmul_rn(s[4 * j + i], scale);
      if (kMask) {
        const int qpos = qpos0 + 8 * (i >> 1);
        const int kpos = k0 + 8 * j + 2 * quad + (i & 1);
        const bool live = kpos <= qpos && kpos < S &&
                          (window <= 0 || qpos - kpos < window);
        s[4 * j + i] = live ? sc : kNegInf;
      } else {
        s[4 * j + i] = sc;
      }
      mx[i >> 1] = fmaxf(mx[i >> 1], s[4 * j + i]);
    }
  float m_new[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(__fsub_rn(s[4 * j + i], m_new[i >> 1]));
      ps[i >> 1] = __fadd_rn(ps[i >> 1], p);
      s[4 * j + i] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    ps[r] = __fadd_rn(ps[r], __shfl_xor_sync(kFull, ps[r], 1));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ps[r] = __fadd_rn(ps[r], __shfl_xor_sync(kFull, ps[r], 2));
    corr[r] = expf(__fsub_rn(m[r], m_new[r]));
    l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), ps[r]);
    m[r] = m_new[r];
  }
}

// Once p.v of the tile before is in: o rescaled by corr (once the row
// maxima settle, corr is 1 and o stays as it is), and p * 2^16 split into
// the A fragments of the three bf16 terms: register q of 16 keys kk holds
// s[i], s[i + 1] with i = 4 * (2kk + (q >> 1)) + 2 * (q & 1).
template <int DH, int BK>
__device__ __forceinline__ void rescale_split(const float* s, float* o,
                                              uint32_t (*a)[BK / 16][4],
                                              const float* corr) {
  if (__any_sync(kFull, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i)
      o[i] = __fmul_rn(o[i], corr[(i >> 1) & 1]);
  }
  split_fragments<BK>(s, a);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ out, float* __restrict__ lse, int S,
                     int H, int Hkv, int heads_per_block, float scale,
                     int window, float softcap) {
  using C = Cfg<DH>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* k_s = q_s + kConsumers * C::kQTile;       // (stage, dh / W, BK, W)
  bf16* v_s = k_s + kStages * C::kKVTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kKVTile);
  uint64_t* full = q_full + 1;                    // stage loaded
  uint64_t* empty = full + kStages;               // stage read by all warps

  // This block: positions [q0, q0 + rows_q) of heads h0 .. h0 +
  // heads_per_block - 1 (one KV head), longest query tiles first.
  const int rows_q = kConsumers * kRows / heads_per_block;
  const int n_qt = (S + rows_q - 1) / rows_q;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * rows_q;
  const int groups = H / heads_per_block;
  const int b = bh / groups, h0 = bh % groups * heads_per_block;
  const int hk = h0 / (H / Hkv);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (min(S, q0 + rows_q) - k_begin + BK - 1) / BK;

  // Through a shuffle, so the compiler knows it is warp-uniform: a wgmma
  // under a branch it cannot prove uniform is serialized.
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues every TMA load of the block.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(q_full, kConsumers * C::kQTile * 2);
      for (int w = 0; w < kConsumers; ++w) {
        const int head = heads_per_block == 1 ? h0 : h0 + w;
        const int pos = heads_per_block == 1 ? q0 + kRows * w : q0;
        tma_tile<DH>(q_s + w * C::kQTile, &tm_q, q_full, kRows, head, pos, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * C::kKVTile * 2);
        const int k0 = k_begin + t * BK;
        tma_tile<DH>(k_s + st * C::kKVTile, &tm_k, &full[st], BK, hk, k0, b);
        tma_tile<DH>(v_s + st * C::kKVTile, &tm_v, &full[st], BK, hk, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, quad = lane % 4;
    const int head = heads_per_block == 1 ? h0 : h0 + wg;
    const int qw = heads_per_block == 1 ? q0 + kRows * wg : q0;
    // This warpgroup's key tiles: from its window band to its diagonal.
    const int my_begin = window > 0 ? max(0, qw - window + 1) / BK * BK : 0;
    const int my_end = qw < S ? min(S, qw + kRows) : 0;
    // Tiles live for all 64 rows need no mask: wholly below the diagonal,
    // inside S and inside every row's window.
    const int live_end = min(qw + 1, S);
    const int live_begin = window > 0 ? qw + kRows - window : 0;
    const int qpos0 = qw + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const bf16* q_t = q_s + wg * C::kQTile;
    const float scale_cap = softcap > 0.0f ? __fdiv_rn(scale, softcap) : 0.0f;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    uint32_t a[3][BK / 16][4];

    auto qk = [&](int t) {
      wgmma_fence();
      ss_product<DH, BK>(s, q_t, k_s + t % kStages * C::kKVTile);
      wgmma_commit();
    };
    auto pv = [&](int t) {
      wgmma_fence();
      rs_product<DH, BK>(o, a, v_s + t % kStages * C::kKVTile);
      wgmma_commit();
    };
    auto softmax = [&](int t, float* corr) {
      const int k0 = k_begin + t * BK;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) reg_fence(s[j]);
      if (k0 + BK <= live_end && k0 >= live_begin)
        softmax_tile<BK, false>(s, m, l, corr, k0, qpos0, quad, S, scale,
                                window, softcap, scale_cap);
      else
        softmax_tile<BK, true>(s, m, l, corr, k0, qpos0, quad, S, scale,
                               window, softcap, scale_cap);
    };
    auto pv_done = [&]() {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) reg_fence(o[j]);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) reg_fence(a[term][kk][q]);
    };
    auto pass = [&](int t) {          // a tile that is not this warpgroup's
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[t % kStages]);
    };

    // This warpgroup's tiles t_lo .. t_hi: q.k^T of tile t runs, then the
    // softmax of tile t runs while p.v of tile t - 1 does.
    const int t_lo = (my_begin - k_begin) / BK;
    const int t_hi = (my_end - k_begin + BK - 1) / BK - 1;
    mbar_wait(q_full, 0);
    int t = 0;
    for (; t < min(t_lo, n_tiles); ++t) pass(t);
    if (t_lo <= t_hi) {
      float corr[2];
      mbar_wait(&full[t_lo % kStages], (t_lo / kStages) & 1);
      qk(t_lo);
      wgmma_wait<0>();
      softmax(t_lo, corr);
      rescale_split<DH, BK>(s, o, a, corr);
      for (t = t_lo + 1; t <= t_hi; ++t) {
        mbar_wait(&full[t % kStages], (t / kStages) & 1);
        qk(t);
        pv(t - 1);
        wgmma_wait<1>();
        softmax(t, corr);
        wgmma_wait<0>();
        pv_done();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
        rescale_split<DH, BK>(s, o, a, corr);
      }
      pv(t_hi);
      wgmma_wait<0>();
      pv_done();
      if (lane == 0) mbar_arrive(&empty[t_hi % kStages]);
      t = t_hi + 1;
    }
    for (; t < n_tiles; ++t) pass(t);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (qpos >= S) continue;
      // The 2^16 of the p terms comes out exactly here.
      const float denom = __fmul_rn(fmaxf(l[r], 1e-30f), kPScale);
      // l sums the unscaled p (the 2^16 sits in o only), and l >= 1.
      if (lse != nullptr && quad == 0)
        lse[(static_cast<int64_t>(b) * H + head) * S + qpos] =
            __fadd_rn(m[r], logf(l[r]));
      bf16* orow =
          out + ((static_cast<int64_t>(b) * S + qpos) * H + head) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * r], denom),
                                  __fdiv_rn(o[4 * j + 2 * r + 1], denom));
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, float scale, int window,
           float softcap, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, DH, kRows, C::W) ||
      !make_map(&mk, k, B, S, Hkv, DH, C::BK, C::W) ||
      !make_map(&mv, v, B, S, Hkv, DH, C::BK, C::W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int heads_per_block = (H / Hkv) % 2 == 0 ? 2 : 1;
  const int rows_q = kConsumers * kRows / heads_per_block;
  const int64_t blocks = static_cast<int64_t>((S + rows_q - 1) / rows_q) * B *
                         (H / heads_per_block);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attn_tc_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, S, H, Hkv, heads_per_block,
      scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int Hkv, int dh, float scale,
              int window, float softcap, cudaStream_t stream) {
  switch (dh) {
#define FLASH_CASE(n)                                                    \
  case n:                                                                \
    return launch<n>(q, k, v, out, lse, B, S, H, Hkv, scale, window,   \
                     softcap, stream);
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64)
    FLASH_CASE(80) FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128)
    FLASH_CASE(144) FLASH_CASE(160) FLASH_CASE(176) FLASH_CASE(192)
    FLASH_CASE(208) FLASH_CASE(224) FLASH_CASE(240) FLASH_CASE(256)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 f32 (CUDA cores), 1 bf16 (tensor cores).  window <= 0: no
// window; softcap <= 0: none.  lse: null, or a (B, H, S) f32 output of each
// row's log-sum-exp m + log(l) over its live scores (what the backward,
// flash_attn_bwd.cu, recomputes p from); writing it changes no other bit.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int S, int H,
                                 int Hkv, int dh, float scale, int window,
                                 float softcap, int dtype,
                                 cudaStream_t stream) {
  if (dh < 16 || dh > 256 || dh % 16 || Hkv < 1 || H % Hkv || B < 1 ||
      S < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return f32::launch_dh(q, k, v, out, lse, B, S, H, Hkv, dh, scale,
                          window, softcap, stream);
  if (dtype == 1)
    return tc::launch_dh(q, k, v, out, lse, B, S, H, Hkv, dh, scale,
                         window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
