// Causal flash attention, backward: the gradient of flash_attn.cu's function
//   s[q, k]  = (q_f32 * dh^-0.5) . k_f32,  s_c = softcap * tanh(s / softcap)
//   p[q, k]  = exp(s_c - lse[q])  (0 where the causal / window mask drops k)
//   out[q]   = sum_k p[q, k] v[k]
// given dout (q's shape) and the forward's out and row log-sum-exp lse
// (B, H, S) f32:
//   D[q]     = sum_d dout[q, d] out[q, d]
//   dv[k]   += p^T dout,  dp = dout v^T,  ds_c = p * (dp - D),
//   ds       = ds_c * (1 - tanh^2(s / softcap))   (ds = ds_c without one)
//   dk[k]   += ds^T (q * dh^-0.5),   dq[q] = dh^-0.5 * ds k
// q, dout, out (B, S, H, dh) and k, v (B, S, Hkv, dh), all f32 or all bf16;
// query head h reads KV head h / (H / Hkv), and dk, dv sum over each group
// of H / Hkv query heads.  dh is a multiple of 16 up to 256.  Outputs are
// in the inputs' type, every sum in f32.
//
// Replaces no TPU kernel: the JAX package has no backward kernel.  Its
// training attention is plain jnp (models/attention.py's _attend_full,
// _attend_chunked, _attend_banded) and XLA differentiates it; this is the
// same gradient, for the port's forward, which runs flash_attn.cu and so
// has no autograd of its own.
//
// Three kernels, no atomics (each output element is written by one thread,
// after a sum in a fixed order), so two launches give the same bits:
//   1. dot_kernel: D, one warp a row.
//   2. dkdv_kernel: one block per (b, KV head, tile of BKV keys).  K and V
//      of the tile stay in shared memory; the block walks the group's query
//      heads and, for each, the query tiles of its causal (and window) band.
//      Per query tile it recomputes s, p and dp for the BQ x BKV pairs, then
//      adds p^T dout and ds^T q into dk and dv held in registers.
//   3. dq_kernel: one block per (b, head, tile of BQ queries), over the key
//      tiles of its band, recomputing the same p and ds; dq in registers.
// Products and sums run in f32 FMAs on the CUDA cores (a first version that
// is right; wgmma is for a later redesign).  Two tile shapes: dh <= 128
// takes 64 x 64 pairs a step (4 x 4 a thread), larger dh 32 x 32 (2 x 2)
// so that the four staged tiles fit shared memory.  Operand rows are padded
// by 4 floats: the float4 reads of a quarter warp fall on distinct banks.
//
// Bound on this card: operations.  The gradient's four products (dv, dp,
// dk, dq) are 8 * dh flops a live (q, k) pair, plus 2 * dh for s, which
// both kernels recompute (dkdv and dq each form s and dp: 14 * dh in all).
// At gemma2-27b's layer (S = 4160, H 32, dh 128, window 4096) that is 283
// GFLOP of products, 0.29 ms at the bf16 tensor-core peak and 4.2 ms at
// the f32 CUDA-core peak; this kernel runs on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// D = rowsum(dout * out): one warp per (b, s, h) row, lanes over dh, then an
// xor butterfly (every lane ends with the same sum).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
           float* __restrict__ D, int64_t rows, int S, int H, int dh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * dh;
  const T* g = dout + row * dh;
  float acc = 0.0f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(load(o + d), load(g + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;                    // b * S + s
    const int s = static_cast<int>(bs % S);
    const int64_t b = bs / S;
    D[(b * H + h) * S + s] = acc;
  }
}

// Tile shapes: BQ queries by BKV keys a step, R x R pairs a thread (16 x 16
// threads), and in the accumulating phase 4 output rows by 4 * M columns a
// thread (256 / (rows / 4) column groups of 4).
template <int MAXDH>
struct Tile {
  static constexpr int R = MAXDH <= 128 ? 4 : 2;
  static constexpr int BQ = 16 * R, BKV = 16 * R;
  static constexpr int kColGroups = kThreads / (BKV / 4);
  static constexpr int M = (MAXDH + 4 * kColGroups - 1) / (4 * kColGroups);
  static size_t smem_bytes(int dh) {
    return sizeof(float) * (4 * static_cast<size_t>(BQ) * (dh + 4) +
                            2 * static_cast<size_t>(BQ) * (BKV + 4) + 2 * BQ);
  }
};

struct Shape {
  int S, H, Hkv, dh, window;
  float scale, softcap;
};

// rows x dh of a (B, S, heads, dh) tensor from position pos0 of head h into
// shared memory as f32 times mult (rows past S are 0), row stride dh + 4.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b,
                                      int pos0, int h, int heads, int rows,
                                      const Shape& sh, float mult) {
  const int ld = sh.dh + 4;
  const int64_t step = static_cast<int64_t>(heads) * sh.dh;
  const T* base = src + (static_cast<int64_t>(b) * sh.S) * step +
                  static_cast<int64_t>(h) * sh.dh;
  for (int i = threadIdx.x; i < rows * sh.dh; i += kThreads) {
    const int r = i / sh.dh, d = i % sh.dh, pos = pos0 + r;
    float x = 0.0f;
    if (pos < sh.S) {
      x = load(base + pos * step + d);
      if (mult != 1.0f) x = __fmul_rn(x, mult);
    }
    dst[r * ld + d] = x;
  }
}

// The BQ x BKV pairs of query rows q0.. and keys k0..: s = qs . k and
// dp = dout . v from the staged tiles (qs already scaled), then p and ds.
// Writes p and ds at [i][j] (row stride BKV + 4) when kTransposed is false,
// else ds alone at [j][i] (row stride BQ + 4).  Masked pairs get 0.
template <int MAXDH, bool kTransposed>
__device__ __forceinline__ void pair_tile(const float* q_s, const float* o_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* d_s,
                                          float* p_s, float* ds_s, int q0,
                                          int k0, const Shape& sh) {
  using C = Tile<MAXDH>;
  constexpr int R = C::R;
  const int ld = sh.dh + 4;
  const int tq = threadIdx.x / 16, tk = threadIdx.x % 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.0f;
  for (int d = 0; d < sh.dh; d += 4) {
    float4 qa[R], oa[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(q_s + (tq + 16 * a) * ld + d);
      oa[a] = *reinterpret_cast<const float4*>(o_s + (tq + 16 * a) * ld + d);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float4 kc =
          *reinterpret_cast<const float4*>(k_s + (tk + 16 * c) * ld + d);
      const float4 vc =
          *reinterpret_cast<const float4*>(v_s + (tk + 16 * c) * ld + d);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        s[a][c] = fmaf(qa[a].x, kc.x, s[a][c]);
        s[a][c] = fmaf(qa[a].y, kc.y, s[a][c]);
        s[a][c] = fmaf(qa[a].z, kc.z, s[a][c]);
        s[a][c] = fmaf(qa[a].w, kc.w, s[a][c]);
        dp[a][c] = fmaf(oa[a].x, vc.x, dp[a][c]);
        dp[a][c] = fmaf(oa[a].y, vc.y, dp[a][c]);
        dp[a][c] = fmaf(oa[a].z, vc.z, dp[a][c]);
        dp[a][c] = fmaf(oa[a].w, vc.w, dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = tq + 16 * a, qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tk + 16 * c, kpos = k0 + j;
      const bool live = qpos < sh.S && kpos <= qpos &&
                        (sh.window <= 0 || qpos - kpos < sh.window);
      float p = 0.0f, ds = 0.0f;
      if (live) {
        float sc = s[a][c], t = 0.0f;
        if (sh.softcap > 0.0f) {
          t = tanhf(__fdiv_rn(sc, sh.softcap));
          sc = __fmul_rn(sh.softcap, t);
        }
        p = expf(__fsub_rn(sc, lse_s[i]));
        ds = __fmul_rn(p, __fsub_rn(dp[a][c], d_s[i]));
        if (sh.softcap > 0.0f) ds = __fmul_rn(ds, __fsub_rn(1.0f, __fmul_rn(t, t)));
      }
      if (kTransposed) {
        ds_s[j * (C::BQ + 4) + i] = ds;
      } else {
        p_s[i * (C::BKV + 4) + j] = p;
        ds_s[i * (C::BKV + 4) + j] = ds;
      }
    }
  }
}

// Per (b, KV head, key tile): dk and dv of the tile's BKV keys.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  using C = Tile<MAXDH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NCG = C::kColGroups, M = C::M;
  extern __shared__ float4 smem4[];
  const int ld = sh.dh + 4;
  float* k_s = reinterpret_cast<float*>(smem4);   // (BKV, ld)
  float* v_s = k_s + BKV * ld;
  float* q_s = v_s + BKV * ld;                    // (BQ, ld), scaled
  float* o_s = q_s + BQ * ld;                     // dout
  float* p_s = o_s + BQ * ld;                     // (BQ, BKV + 4)
  float* ds_s = p_s + BQ * (BKV + 4);
  float* lse_s = ds_s + BQ * (BKV + 4);           // (BQ)
  float* d_s = lse_s + BQ;

  const int k0 = blockIdx.x * BKV;                // longest bands first
  const int b = blockIdx.y / sh.Hkv, hk = blockIdx.y % sh.Hkv;
  const int group = sh.H / sh.Hkv;
  // Queries that see a key of the tile: from k0, before the last key's
  // window ends.
  const int q_end =
      sh.window > 0 ? min(sh.S, k0 + BKV - 1 + sh.window) : sh.S;
  const int rg = threadIdx.x / NCG, cg = threadIdx.x % NCG;

  stage(k_s, k, b, k0, hk, sh.Hkv, BKV, sh, 1.0f);
  stage(v_s, v, b, k0, hk, sh.Hkv, BKV, sh, 1.0f);

  float acc_k[4][M][4], acc_v[4][M][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_k[e][m][c] = acc_v[e][m][c] = 0.0f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const float* lse_h = lse + (static_cast<int64_t>(b) * sh.H + h) * sh.S;
    const float* d_h = D + (static_cast<int64_t>(b) * sh.H + h) * sh.S;
    for (int q0 = k0 / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();            // the last tile's reads are done
      stage(q_s, q, b, q0, h, sh.H, BQ, sh, sh.scale);
      stage(o_s, dout, b, q0, h, sh.H, BQ, sh, 1.0f);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < sh.S;
        lse_s[i] = in ? lse_h[q0 + i] : 0.0f;
        d_s[i] = in ? d_h[q0 + i] : 0.0f;
      }
      __syncthreads();
      pair_tile<MAXDH, false>(q_s, o_s, k_s, v_s, lse_s, d_s, p_s, ds_s, q0,
                              k0, sh);
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + i * (BKV + 4) + 4 * rg);
        const float4 s4 =
            *reinterpret_cast<const float4*>(ds_s + i * (BKV + 4) + 4 * rg);
        const float pe[4] = {p4.x, p4.y, p4.z, p4.w};
        const float se[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int col = 4 * cg + 4 * NCG * m;
          if (col >= sh.dh) continue;
          const float4 o4 = *reinterpret_cast<const float4*>(o_s + i * ld + col);
          const float4 q4 = *reinterpret_cast<const float4*>(q_s + i * ld + col);
          const float oc[4] = {o4.x, o4.y, o4.z, o4.w};
          const float qc[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc_v[e][m][c] = fmaf(pe[e], oc[c], acc_v[e][m][c]);
              acc_k[e][m][c] = fmaf(se[e], qc[c], acc_k[e][m][c]);
            }
        }
      }
    }
  }

  const int64_t step = static_cast<int64_t>(sh.Hkv) * sh.dh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int pos = k0 + 4 * rg + e;
    if (pos >= sh.S) continue;
    const int64_t row = (static_cast<int64_t>(b) * sh.S + pos) * step +
                        static_cast<int64_t>(hk) * sh.dh;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int col = 4 * cg + 4 * NCG * m;
      if (col >= sh.dh) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store(dk + row + col + c, acc_k[e][m][c]);
        store(dv + row + col + c, acc_v[e][m][c]);
      }
    }
  }
}

// Per (b, head, query tile): dq of the tile's BQ queries.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, Shape sh) {
  using C = Tile<MAXDH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NCG = C::kColGroups, M = C::M;
  extern __shared__ float4 smem4[];
  const int ld = sh.dh + 4;
  float* k_s = reinterpret_cast<float*>(smem4);   // (BKV, ld)
  float* v_s = k_s + BKV * ld;
  float* q_s = v_s + BKV * ld;                    // (BQ, ld), scaled
  float* o_s = q_s + BQ * ld;
  float* dst_s = o_s + BQ * ld;                   // ds^T (BKV, BQ + 4)
  float* lse_s = dst_s + 2 * BQ * (BKV + 4);
  float* d_s = lse_s + BQ;

  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int hk = h / (sh.H / sh.Hkv);
  const int k_begin = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int k_end = min(sh.S, q0 + BQ);
  const int rg = threadIdx.x / NCG, cg = threadIdx.x % NCG;

  stage(q_s, q, b, q0, h, sh.H, BQ, sh, sh.scale);
  stage(o_s, dout, b, q0, h, sh.H, BQ, sh, 1.0f);
  const float* lse_h = lse + (static_cast<int64_t>(b) * sh.H + h) * sh.S;
  const float* d_h = D + (static_cast<int64_t>(b) * sh.H + h) * sh.S;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const bool in = q0 + i < sh.S;
    lse_s[i] = in ? lse_h[q0 + i] : 0.0f;
    d_s[i] = in ? d_h[q0 + i] : 0.0f;
  }

  float acc[4][M][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[e][m][c] = 0.0f;

  for (int k0 = k_begin / BKV * BKV; k0 < k_end; k0 += BKV) {
    __syncthreads();              // the last tile's reads are done
    stage(k_s, k, b, k0, hk, sh.Hkv, BKV, sh, 1.0f);
    stage(v_s, v, b, k0, hk, sh.Hkv, BKV, sh, 1.0f);
    __syncthreads();
    pair_tile<MAXDH, true>(q_s, o_s, k_s, v_s, lse_s, d_s, nullptr, dst_s, q0,
                           k0, sh);
    __syncthreads();
    for (int j = 0; j < BKV; ++j) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(dst_s + j * (BQ + 4) + 4 * rg);
      const float se[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int col = 4 * cg + 4 * NCG * m;
        if (col >= sh.dh) continue;
        const float4 k4 = *reinterpret_cast<const float4*>(k_s + j * ld + col);
        const float kc[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[e][m][c] = fmaf(se[e], kc[c], acc[e][m][c]);
      }
    }
  }

  const int64_t step = static_cast<int64_t>(sh.H) * sh.dh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int pos = q0 + 4 * rg + e;
    if (pos >= sh.S) continue;
    const int64_t row = (static_cast<int64_t>(b) * sh.S + pos) * step +
                        static_cast<int64_t>(h) * sh.dh;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int col = 4 * cg + 4 * NCG * m;
      if (col >= sh.dh) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(dq + row + col + c, __fmul_rn(sh.scale, acc[e][m][c]));
    }
  }
}

template <typename T, int MAXDH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, const Shape& sh, cudaStream_t stream) {
  using C = Tile<MAXDH>;
  const int64_t rows = static_cast<int64_t>(B) * sh.S * sh.H;
  const int64_t dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  dot_kernel<T><<<static_cast<unsigned>(dot_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), D, rows, sh.S,
      sh.H, sh.dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = C::smem_bytes(sh.dh);
  auto kv_kernel = dkdv_kernel<T, MAXDH>;
  auto q_kernel = dq_kernel<T, MAXDH>;
  err = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((sh.S + C::BKV - 1) / C::BKV, B * sh.Hkv);
  kv_kernel<<<kv_grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, D,
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((sh.S + C::BQ - 1) / C::BQ, B * sh.H);
  q_kernel<<<q_grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, D,
      static_cast<T*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* D, void* dq, void* dk,
              void* dv, int B, const Shape& sh, cudaStream_t stream) {
  if (sh.dh <= 128)
    return launch<T, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, B, sh,
                          stream);
  return launch<T, 256>(q, k, v, out, dout, lse, D, dq, dk, dv, B, sh, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (q, k, v, out, dout, dq, dk, dv all of it).  lse and
// D are (B, H, S) f32; D is scratch the launcher fills.  window <= 0: no
// window; softcap <= 0: none.  Launches three kernels on ``stream``.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, const float* lse,
                                     float* D, void* dq, void* dk, void* dv,
                                     int B, int S, int H, int Hkv, int dh,
                                     float scale, int window, float softcap,
                                     int dtype, cudaStream_t stream) {
  if (dh < 16 || dh > 256 || dh % 16 || Hkv < 1 || H % Hkv || B < 1 ||
      S < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, Hkv, dh, window, scale, softcap};
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, dout, lse, D, dq, dk, dv, B, sh,
                            stream);
  if (dtype == 1)
    return launch_dh<bf16>(q, k, v, out, dout, lse, D, dq, dk, dv, B, sh,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
