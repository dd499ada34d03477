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
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kRows = 64;                         // query rows per warpgroup
constexpr int kStages = 3;                        // K/V ring depth
constexpr float kPScale = 65536.0f;               // p * 2^16 splits exactly

// Per dh: W, the column block in bf16 (the widest swizzle, 128, 64 or 32
// bytes, whose width divides dh), and BK, the keys per tile.
template <int DH>
struct Cfg {
  static constexpr int W = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr int BK = DH <= 192 ? 64 : 32;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
  static constexpr int kQTile = kRows * DH;       // bf16 per warpgroup's Q
  static constexpr int kKVTile = BK * DH;         // bf16 per K or V stage
  static constexpr size_t kSmem =
      1024 + 2 * static_cast<size_t>(kConsumers * kQTile +
                                     2 * kStages * kKVTile) +
      8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of the barrier has completed.  A
// wait that has not ended after 10 s traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0)
      t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull)
      __trap();
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups run on.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma reads or writes across its wait.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64 x 32, f32) (+)= A (64 x 16, smem) . B (16 x 32, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, registers) . B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, registers) . B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (64 x BK) = Q (64 x 16 slice) . K^T (16 x BK) summed over dh, both from
// shared memory, K-major.
template <int BK>
__device__ __forceinline__ void qk_step(float* s, uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (BK == 64)
    wgmma_ss_n64(s, da, db, accumulate);
  else
    wgmma_ss_n32(s, da, db, accumulate);
}

// O[:, N0:N0+REM] += P (64 x 16 keys, registers) . V (16 keys x REM), in
// chunks of 128, 64, 32 and 16 columns (each a whole number of W-wide
// column blocks, LBO apart).
template <int W, int BK, int N0, int REM>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        const bf16* v_keys, uint64_t layout) {
  if constexpr (REM > 0) {
    constexpr int N = REM >= 128 ? 128 : REM >= 64 ? 64 : REM >= 32 ? 32 : 16;
    const uint64_t db =
        make_desc(v_keys + N0 / W * BK * W, BK * W * 2, 8 * W * 2, layout);
    if constexpr (N == 128)
      wgmma_rs_n128(o + N0 / 2, a, db);
    else if constexpr (N == 64)
      wgmma_rs_n64(o + N0 / 2, a, db);
    else if constexpr (N == 32)
      wgmma_rs_n32(o + N0 / 2, a, db);
    else
      wgmma_rs_n16(o + N0 / 2, a, db);
    pv_step<W, BK, N0 + N, REM - N>(o, a, v_keys, layout);
  }
}

// x = hi + mid + lo exactly, for every f32 x whose bits all sit at or above
// 2^-133 (bf16's least subnormal): each residual then has at most 16, then 8,
// significant bits.  Two values at a time, packed as bf16x2 (x0 low).
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h));
  const float r1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 md = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(md);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(r0, __low2float(md)),
                                  __fsub_rn(r1, __high2float(md))));
}

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
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
      split3(__fmul_rn(s[i], kPScale), __fmul_rn(s[i + 1], kPScale),
             a[0][kk][q], a[1][kk][q], a[2][kk][q]);
    }
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
  constexpr int W = C::W, BK = C::BK;
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues every TMA load of the block.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, kConsumers * C::kQTile * 2);
      for (int w = 0; w < kConsumers; ++w) {
        const int head = heads_per_block == 1 ? h0 : h0 + w;
        const int pos = heads_per_block == 1 ? q0 + kRows * w : q0;
        for (int c = 0; c < DH / W; ++c)
          tma_load(q_s + w * C::kQTile + c * kRows * W, &tm_q, q_full,
                   head * DH + c * W, pos, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[st], 2 * C::kKVTile * 2);
        const int k0 = k_begin + t * BK;
        for (int c = 0; c < DH / W; ++c) {
          tma_load(k_s + st * C::kKVTile + c * BK * W, &tm_k, &full[st],
                   hk * DH + c * W, k0, b);
          tma_load(v_s + st * C::kKVTile + c * BK * W, &tm_v, &full[st],
                   hk * DH + c * W, k0, b);
        }
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
      const bf16* k_t = k_s + t % kStages * C::kKVTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk * 16 / W, off = kk * 16 % W;
        qk_step<BK>(s,
                    make_desc(q_t + c * kRows * W + off, 16, 8 * W * 2,
                              C::kLayout),
                    make_desc(k_t + c * BK * W + off, 16, 8 * W * 2,
                              C::kLayout),
                    kk > 0);
      }
      wgmma_commit();
    };
    auto pv = [&](int t) {
      const bf16* v_t = v_s + t % kStages * C::kKVTile;
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          pv_step<W, BK, 0, DH>(o, a[term][kk], v_t + kk * 16 * W,
                                C::kLayout);
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

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads * dh) bf16 tensor map with boxes of (w columns, rows
// positions, 1), swizzled to match the wgmma descriptors.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int dh, int rows, int w) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * dh,
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
