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
// tiles run in increasing k, so every row ends right.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py:_flash_kernel (launcher
// flash_attention_pallas).
//
// Bound on this card: operations.  At the long prefill of gemma2-27b (B=1,
// S=4160, H=32, Hkv=16, dh=128) a layer's causal attention is 141.8 GFLOP
// (2 per multiply-add of q.k and of p.v over the 8.65 M live (q, k) pairs of
// each head): 2.1 ms at 67 TFLOP/s in f32, or 0.14 ms at 989 TFLOP/s on bf16
// tensor cores.  Its bytes, q, k, v read and out written once in bf16, are
// about 100 MB: 30 us at 3.35 TB/s.
//
// Design, first version: plain f32 FMAs, not tensor cores.  q * dh^-0.5 is
// not bf16-exact at dh = 128 and the reference keeps p.v in f32, so a bf16 or
// TF32 mma would move results beyond the tolerance; a wgmma/TMA version with
// its own tolerance is later work.  One block of 256 threads owns one
// (b, h, tile of 64 queries); the 64 scaled query rows stay in shared memory
// (f32) for the whole key loop.  Key tiles of 32 keys run from the first
// tile of the window band to the diagonal, so tiles wholly above the
// diagonal or outside the band are never read.  K and V tiles are staged in
// shared memory as f32 (K rows padded by 4 floats: conflict-free float4
// reads across lanes).  Each warp owns 8 query rows.  Scores: lane c takes
// key c of the tile for the warp's 8 rows (one float4 of K and eight
// broadcast float4 of Q give 32 FMAs).  Softmax: per row, a warp xor-shuffle
// all-reduce of the max and of the sum (every lane ends with the same bits).
// p.v: the lanes split dh (lane j holds d = j + 32 i, i < DPL, because a
// 64 x 128 f32 accumulator does not fit in one thread), reading p of their
// rows as broadcast float4 from shared memory.  No atomics: two launches on
// the same inputs give the same bits.  Query tiles launch last-first, so the
// longest causal rows start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;                       // query rows per block
constexpr int kRows = kBlockQ / kWarps;           // query rows per warp
constexpr int kBlockK = 32;                       // keys per tile: one per lane
constexpr int kKPad = 4;                          // K row padding in floats
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * dh +
                          static_cast<size_t>(kBlockK) * (dh + kKPad) +
                          static_cast<size_t>(kBlockK) * dh + kBlockQ * kBlockK);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int Hkv, int dh, float scale, int window, float softcap) {
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
  const T* qb = q + static_cast<int64_t>(b) * S * q_step + h * dh;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_step + hk * dh;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_step + hk * dh;

  for (int i = threadIdx.x; i < kBlockQ * dh; i += kThreads) {
    const int pos = q0 + i / dh;
    q_s[i] = pos < S ? __fmul_rn(to_f32(qb[pos * q_step + i % dh]), scale)
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
        kk = to_f32(kb[pos * kv_step + d]);
        vv = to_f32(vb[pos * kv_step + d]);
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
    T* orow = out + static_cast<int64_t>(b) * S * q_step + qpos * q_step + h * dh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = from_f32<T>(__fdiv_rn(acc[r][i], denom));
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int dh, float scale, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kernel = flash_attn_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, dh, scale,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int Hkv, int dh, float scale, int window,
              float softcap, cudaStream_t stream) {
  switch ((dh + 31) / 32) {
#define FLASH_CASE(n)                                                     \
  case n:                                                                 \
    return launch<T, n>(q, k, v, out, B, S, H, Hkv, dh, scale, window, \
                        softcap, stream);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16.  window <= 0: no window; softcap <= 0: none.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int H, int Hkv,
                                 int dh, float scale, int window,
                                 float softcap, int dtype,
                                 cudaStream_t stream) {
  if (dh < 16 || dh > 256 || dh % 16 || Hkv < 1 || H % Hkv || B < 1 ||
      S < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, B, S, H, Hkv, dh, scale, window,
                            softcap, stream);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, dh, scale,
                                    window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
