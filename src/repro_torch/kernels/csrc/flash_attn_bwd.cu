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
// Bound on this card: operations.  The gradient's four products (dv, dp,
// dk, dq) are 8 * dh flops a live (q, k) pair, plus 2 * dh for s, which a
// backward without stored probabilities recomputes.  At gemma2-27b's layer
// (S = 4160, H 32, dh 128, window 4096) that is 283 GFLOP of products,
// 0.29 ms at the bf16 tensor-core peak.
//
// No atomics anywhere: each output element is written by one thread after a
// sum in a fixed order, so two launches give the same bits.  D =
// rowsum(dout * out) runs first (bwd_dot_kernel, one warp a row, both
// types), then a dK/dV kernel and a dQ kernel.
//
// bf16 inputs (the training path): bf16 wgmma on the tensor cores with f32
// accumulators, operands staged by TMA (wgmma.cuh's building blocks, as the
// forward).  Every product is exact, so the tensor cores cost only their
// accumulation (parity.py states the model and flash_attn_bwd_tol's
// tensor-core form the bound):
//   - s = q.k^T and dp = dout.v^T: bf16 by bf16, one wgmma per 16 of dh;
//     the score's dh^-0.5 (or, with a softcap, dh^-0.5 / softcap) is applied
//     once to the sum, as the forward does.
//   - p, ds on the CUDA cores in the accumulator's own layout, with the
//     reference's roundings: p = exp(s_c - lse), ds = p * (dp - D), times
//     1 - t^2 with a softcap.
//   - dv += p^T.dout, dk += ds^T.q, dq += ds.k: p * 2^16 and ds * 2^16
//     (exact) are split into three bf16 terms whose sum is the f32 value
//     exactly (every bit at or above 2^-133, i.e. |ds| below 2^112), and
//     each term is one RS wgmma (A from registers, B the staged q, dout or k
//     tile read MN-major); the 2^-16 (and dk's and dq's dh^-0.5) comes back
//     in one product after the sum.  p and ds are never rounded to bf16, as
//     SDPA and FlashAttention round them.
// Block: two consumer warpgroups and a producer warp (TMA, mbarrier ring).
//   dK/dV (dkdv_tc_kernel): one block per (b, KV head, 64 keys); both
//     warpgroups own the same 64 keys (wgmma's M), one dv, the other dk, so
//     that dk and dv (dh / 2 f32 registers a thread each) fit at every dh up
//     to 256.  K and V stay in shared memory; the producer streams q, dout
//     and the queries' lse and D through a ring, walking the group's query
//     heads and, for each, the query tiles of the keys' band.  The dv
//     warpgroup forms s^T = k.q^T and p^T, then dv += p^T.dout; the dk
//     warpgroup forms s^T and dp^T = v.dout^T, ds^T, then dk += ds^T.q.
//     Each recomputes s^T: 9 products a pair instead of 8, for no
//     exchange between the warpgroups.
//   dQ (dq_tc_kernel): one block per (b, 128 query rows of one head, or 64
//     rows of two heads of one KV head when the group is even), as the
//     forward's blocks; K and V stream through the ring (tiles outside the
//     causal / window band are never read), and each warpgroup forms s =
//     q.k^T and dp = dout.v^T, ds, then dq += ds.k (5 products a pair).
//   The tile streamed is 64 positions for dh <= 128 and 32 above (registers:
//   at dh 256 the dk warpgroup holds 128 accumulators, 16 + 16 for s^T and
//   dp^T and 24 split fragments).  A warpgroup issues the score products of
//   tile t and the split product of tile t - 1 together, and forms tile t's
//   p or ds while the latter runs; the mask runs only on tiles that cross
//   the diagonal, the window's edge or S.
//
// f32 inputs: the first version, f32 FMAs on the CUDA cores
// (f32::dkdv_kernel, f32::dq_kernel): 64 x 64 pair tiles a step for dh <=
// 128 and 32 x 32 above, operands staged in shared memory as f32, rows
// padded by 4 floats; s and dp recomputed in both kernels.
//
// BUILD_PARTS 4 (the line below): _build.py compiles this source as four
// translation units at once, -DBUILD_PART=0 .. 3, and links them.  Part p
// instantiates the tensor-core kernels of the dh values tc::part_of gives
// it (four each, balanced by dh); part 0 also holds D's kernel, the f32
// path and the C entry.  Without BUILD_PART the source is one unit.
// BUILD_PARTS 4
#include "wgmma.cuh"

#include <climits>
#include <cstdint>

#if !defined(BUILD_PART) || BUILD_PART == 0
#define BWD_HOST_PART 1
#endif

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

using bf16 = __nv_bfloat16;

}  // namespace

#ifdef BWD_HOST_PART
namespace {

constexpr int kDotThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// D = rowsum(dout * out): one warp per (b, s, h) row, lanes over dh, then an
// xor butterfly (every lane ends with the same sum).
template <typename T>
__global__ void __launch_bounds__(kDotThreads)
bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ D, int64_t rows, int S, int H, int dh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kDotThreads / 32) +
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

template <typename T>
int launch_dot(const void* out, const void* dout, float* D, int B, int S,
               int H, int dh, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  const int64_t blocks = (rows + kDotThreads / 32 - 1) / (kDotThreads / 32);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), kDotThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), D, rows, S, H,
      dh);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ f32 path: CUDA-core FMAs
namespace f32 {

constexpr int kThreads = 256;

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

template <int MAXDH>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* D, float* dq, float* dk, float* dv,
           int B, const Shape& sh, cudaStream_t stream) {
  using C = Tile<MAXDH>;
  const size_t smem = C::smem_bytes(sh.dh);
  auto kv_kernel = dkdv_kernel<float, MAXDH>;
  auto q_kernel = dq_kernel<float, MAXDH>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((sh.S + C::BKV - 1) / C::BKV, B * sh.Hkv);
  kv_kernel<<<kv_grid, kThreads, smem, stream>>>(q, k, v, dout, lse, D, dk,
                                                 dv, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((sh.S + C::BQ - 1) / C::BQ, B * sh.H);
  q_kernel<<<q_grid, kThreads, smem, stream>>>(q, k, v, dout, lse, D, dq, sh);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* D, void* dq, void* dk, void* dv,
              int B, const Shape& sh, cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  if (sh.dh <= 128)
    return launch<128>(qf, kf, vf, gf, lse, D, dqf, dkf, dvf, B, sh, stream);
  return launch<256>(qf, kf, vf, gf, lse, D, dqf, dkf, dvf, B, sh, stream);
}

}  // namespace f32

}  // namespace
#endif  // BWD_HOST_PART

// ------------------------------------------ bf16 path: tensor cores (wgmma)
// A named namespace: the parts call one another's launchers.
namespace tc {

using namespace wgmma;

constexpr int kConsumers = 2;                     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kRows = 64;                         // keys (dK/dV) or queries (dQ) a warpgroup
constexpr int kStages = 3;                        // ring depth

// Per dh: T, the positions of a streamed tile (queries for dK/dV, keys for
// dQ), and the shared memory of each kernel (1024 for the swizzle's
// alignment, then tiles, lse and D, barriers).
template <int DH>
struct Cfg : Cols<DH> {
  static constexpr int T = DH <= 128 ? 64 : 32;
  static constexpr int kFixed = kRows * DH;       // bf16 of a warpgroup's tile
  static constexpr int kTile = T * DH;            // bf16 of a streamed tile
  static constexpr size_t kSmemKV =
      1024 + 2 * static_cast<size_t>(2 * kFixed + 2 * kStages * kTile) +
      4 * 2 * kStages * T + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmemQ =
      1024 + 2 * static_cast<size_t>(2 * kConsumers * kFixed +
                                     2 * kStages * kTile) +
      8 * (1 + 2 * kStages);
};

struct Grad {
  float scale, scale_cap, softcap;
};

// p = exp(s_c - lse) from the f32 sum of exact products q.k: s_c = sum *
// dh^-0.5, or with a softcap t = tanh(sum * RN(dh^-0.5 / softcap)) (the
// same two roundings as scaling, then dividing) and s_c = softcap * t.
__device__ __forceinline__ float prob(float sum, float lse, const Grad& g,
                                      float& t) {
  float sc;
  if (g.softcap > 0.0f) {
    t = tanhf(__fmul_rn(sum, g.scale_cap));
    sc = __fmul_rn(g.softcap, t);
  } else {
    t = 0.0f;
    sc = __fmul_rn(sum, g.scale);
  }
  return expf(__fsub_rn(sc, lse));
}

// ds = p * (dp - D), times 1 - t^2 with a softcap: the reference's order.
__device__ __forceinline__ float dscore(float p, float dp, float d, float t,
                                        const Grad& g) {
  float ds = __fmul_rn(p, __fsub_rn(dp, d));
  if (g.softcap > 0.0f) ds = __fmul_rn(ds, __fsub_rn(1.0f, __fmul_rn(t, t)));
  return ds;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int window) {
  return kpos <= qpos && qpos < S && (window <= 0 || qpos - kpos < window);
}

// dK/dV, one tile of N queries: s^T (rows this thread's keys kpos0 and
// kpos0 + 8, s[4j + i] at column 8j + 2 * quad + (i & 1)) becomes p^T, or
// with dp^T ds^T (kRoleK), in place; lse and D by column from the stage.
template <int N, bool kRoleK, bool kMask>
__device__ __forceinline__ void grad_kv(float* s, const float* dp,
                                        const float* lse_t, const float* d_t,
                                        int kpos0, int q0, int quad, int S,
                                        int window, const Grad& g) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * quad);
    float2 d2 = make_float2(0.0f, 0.0f);
    if (kRoleK) d2 = *reinterpret_cast<const float2*>(d_t + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t;
      const float p = prob(s[4 * j + i], i & 1 ? l2.y : l2.x, g, t);
      float x = p;
      if (kRoleK) x = dscore(p, dp[4 * j + i], i & 1 ? d2.y : d2.x, t, g);
      if (kMask)
        x = live(q0 + 8 * j + 2 * quad + (i & 1), kpos0 + 8 * (i >> 1), S,
                 window)
                ? x
                : 0.0f;
      s[4 * j + i] = x;
    }
  }
}

// dQ, one tile of N keys: s (rows this thread's queries qpos0 and qpos0 + 8,
// columns keys) and dp become ds in s; lse and D by row.
template <int N, bool kMask>
__device__ __forceinline__ void grad_q(float* s, const float* dp,
                                       const float* lse_r, const float* d_r,
                                       int qpos0, int k0, int quad, int S,
                                       int window, const Grad& g) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t;
      const float p = prob(s[4 * j + i], lse_r[i >> 1], g, t);
      float x = dscore(p, dp[4 * j + i], d_r[i >> 1], t, g);
      if (kMask)
        x = live(qpos0 + 8 * (i >> 1), k0 + 8 * j + 2 * quad + (i & 1), S,
                 window)
                ? x
                : 0.0f;
      s[4 * j + i] = x;
    }
}

// acc * f (f exact: 2^-16, or RN(dh^-0.5) * 2^-16) as bf16 into this
// thread's two rows of a (.., DH) output: row r at `rows[r]` (null: past S).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* const* rows, const float* acc,
                                           float f, int quad) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(rows[r] + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * r], f),
                                __fmul_rn(acc[4 * j + 2 * r + 1], f));
  }
}

// Shared memory and the walk of one dK/dV block.
struct KVBlock {
  const bf16 *k_s, *v_s, *q_s, *do_s;             // K, V; the q, dout ring
  const float *lse_s, *d_s;                       // (stage, T) each
  uint64_t *kv_full, *full, *empty;
  int S, k0, n_qt, n_tiles, window;
};

// One consumer warpgroup of a dK/dV block: dv (kRoleK false) or dk of the
// block's 64 keys, over every tile of the ring.
template <int DH, bool kRoleK>
__device__ __forceinline__ void kv_consumer(const KVBlock& x, const Grad& g,
                                            bf16* const* rows, float f) {
  using C = Cfg<DH>;
  constexpr int T = C::T;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int kpos0 = x.k0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float s[T / 2];
  float dp[kRoleK ? T / 2 : 1];
  uint32_t a[3][T / 16][4];

  auto products = [&](int t) {                    // s^T (and dp^T) of tile t
    const int st = t % kStages;
    wgmma_fence();
    ss_product<DH, T>(s, x.k_s, x.q_s + st * C::kTile);
    if constexpr (kRoleK) ss_product<DH, T>(dp, x.v_s, x.do_s + st * C::kTile);
    wgmma_commit();
  };
  auto accumulate = [&](int t) {                  // acc += split . dout (q)
    wgmma_fence();
    rs_product<DH, T>(acc, a,
                      (kRoleK ? x.q_s : x.do_s) + t % kStages * C::kTile);
    wgmma_commit();
  };
  auto grad = [&](int t) {
    const int st = t % kStages, q0 = x.k0 + t % x.n_qt * T;
#pragma unroll
    for (int j = 0; j < T / 2; ++j) {
      reg_fence(s[j]);
      if constexpr (kRoleK) reg_fence(dp[j]);
    }
    // Every pair live: all queries past the last key, inside S and inside
    // every key's window.
    const bool whole = q0 >= x.k0 + kRows - 1 && q0 + T <= x.S &&
                       (x.window <= 0 || q0 + T - 1 - x.k0 < x.window);
    const float* lse_t = x.lse_s + st * T;
    const float* d_t = x.d_s + st * T;
    if (whole)
      grad_kv<T, kRoleK, false>(s, dp, lse_t, d_t, kpos0, q0, quad, x.S,
                                x.window, g);
    else
      grad_kv<T, kRoleK, true>(s, dp, lse_t, d_t, kpos0, q0, quad, x.S,
                               x.window, g);
  };
  auto acc_done = [&]() {
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) reg_fence(acc[j]);
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) reg_fence(a[term][kk][q]);
  };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&x.empty[t % kStages]);
  };

  // The products of tile t run, then tile t's p or ds forms while the
  // split product of tile t - 1 runs.
  mbar_wait(x.kv_full, 0);
  mbar_wait(&x.full[0], 0);
  products(0);
  wgmma_wait<0>();
  grad(0);
  split_fragments<T>(s, a);
  for (int t = 1; t < x.n_tiles; ++t) {
    mbar_wait(&x.full[t % kStages], (t / kStages) & 1);
    products(t);
    accumulate(t - 1);
    wgmma_wait<1>();
    grad(t);
    wgmma_wait<0>();
    acc_done();
    release(t - 1);
    split_fragments<T>(s, a);
  }
  accumulate(x.n_tiles - 1);
  wgmma_wait<0>();
  acc_done();
  release(x.n_tiles - 1);
  store_rows<DH>(rows, acc, f, quad);
}

// Per (b, KV head, 64 keys): dk and dv of the keys, over the group's query
// heads and the band's query tiles.  Blocks run key tile by key tile, the
// longest bands (the first keys) first.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ lse, const float* __restrict__ D,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
               int Hkv, float scale, int window, float softcap) {
  using C = Cfg<DH>;
  constexpr int T = C::T;
  extern __shared__ uint8_t smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* v_s = k_s + C::kFixed;
  bf16* q_s = v_s + C::kFixed;                    // (stage, dh / W, T, W)
  bf16* do_s = q_s + kStages * C::kTile;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * C::kTile);
  float* d_s = lse_s + kStages * T;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(d_s + kStages * T);
  uint64_t* full = kv_full + 1;                   // stage loaded
  uint64_t* empty = full + kStages;               // stage read by all warps

  const int n_bh = gridDim.x / ((S + kRows - 1) / kRows);
  const int bh = blockIdx.x % n_bh;
  const int k0 = static_cast<int>(blockIdx.x) / n_bh * kRows;
  const int b = bh / Hkv, hk = bh % Hkv, group = H / Hkv;
  // Queries that see a key of the block: from k0, before the last key's
  // window ends.
  const int q_end = window > 0 ? min(S, k0 + kRows - 1 + window) : S;
  const int n_qt = (q_end - k0 + T - 1) / T;
  const int n_tiles = group * n_qt;

  // Through a shuffle, so the compiler knows it is warp-uniform: a wgmma
  // under a branch it cannot prove uniform is serialized.
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1 + 32);   // the TMA's arrival, the lanes' copies
      mbar_init(&empty[st], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one warp; lane 0 issues the TMA loads, every lane copies
    // its share of the tile's lse and D.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < kConsumers * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::kFixed * 2);
        tma_tile<DH>(k_s, &tm_k, kv_full, kRows, hk, k0, b);
        tma_tile<DH>(v_s, &tm_v, kv_full, kRows, hk, k0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int h = hk * group + t / n_qt, q0 = k0 + t % n_qt * T;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * C::kTile * 2);
          tma_tile<DH>(q_s + st * C::kTile, &tm_q, &full[st], T, h, q0, b);
          tma_tile<DH>(do_s + st * C::kTile, &tm_do, &full[st], T, h, q0, b);
        }
        // Queries past S keep stale values: every pair there is masked.
        const int64_t row = (static_cast<int64_t>(b) * H + h) * S + q0;
        for (int i = lane; i < T && q0 + i < S; i += 32) {
          bulk::copy4(lse_s + st * T + i, lse + row + i);
          bulk::copy4(d_s + st * T + i, D + row + i);
        }
        bulk::arrive_on_copies(&full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const KVBlock x{k_s, v_s, q_s, do_s, lse_s, d_s, kv_full, full, empty,
                    S, k0, n_qt, n_tiles, window};
    const Grad g{scale, softcap > 0.0f ? __fdiv_rn(scale, softcap) : 0.0f,
                 softcap};
    const int kpos0 = k0 + 16 * (threadIdx.x % 128 / 32) + threadIdx.x % 32 / 4;
    bf16* out = wg == 0 ? dv : dk;
    bf16* rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kpos0 + 8 * r;
      rows[r] = kpos < S ? out + ((static_cast<int64_t>(b) * S + kpos) * Hkv +
                                  hk) * DH
                         : nullptr;
    }
    // The split's 2^16 comes out of both, dk's dh^-0.5 in the same product.
    if (wg == 0)
      kv_consumer<DH, false>(x, g, rows, 1.0f / kPScale);
    else
      kv_consumer<DH, true>(x, g, rows, __fmul_rn(scale, 1.0f / kPScale));
  }
}

// Per (b, query tile): dq of 64 query rows a consumer warpgroup, two heads
// of one KV head at the same positions when heads_per_block is 2, else 128
// positions of one head; longest tiles first.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ lse, const float* __restrict__ D,
             bf16* __restrict__ dq, int S, int H, int Hkv,
             int heads_per_block, float scale, int window, float softcap) {
  using C = Cfg<DH>;
  constexpr int T = C::T;
  extern __shared__ uint8_t smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* do_s = q_s + kConsumers * C::kFixed;
  bf16* k_s = do_s + kConsumers * C::kFixed;      // (stage, dh / W, T, W)
  bf16* v_s = k_s + kStages * C::kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int rows_q = kConsumers * kRows / heads_per_block;
  const int n_qt = (S + rows_q - 1) / rows_q;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * rows_q;
  const int groups = H / heads_per_block;
  const int b = bh / groups, h0 = bh % groups * heads_per_block;
  const int hk = h0 / (H / Hkv);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / T * T : 0;
  const int n_tiles = (min(S, q0 + rows_q) - k_begin + T - 1) / T;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(q_full, 2 * kConsumers * C::kFixed * 2);
      for (int w = 0; w < kConsumers; ++w) {
        const int head = heads_per_block == 1 ? h0 : h0 + w;
        const int pos = heads_per_block == 1 ? q0 + kRows * w : q0;
        tma_tile<DH>(q_s + w * C::kFixed, &tm_q, q_full, kRows, head, pos, b);
        tma_tile<DH>(do_s + w * C::kFixed, &tm_do, q_full, kRows, head, pos,
                     b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * C::kTile * 2);
        const int k0 = k_begin + t * T;
        tma_tile<DH>(k_s + st * C::kTile, &tm_k, &full[st], T, hk, k0, b);
        tma_tile<DH>(v_s + st * C::kTile, &tm_v, &full[st], T, hk, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, quad = lane % 4;
    const int head = heads_per_block == 1 ? h0 : h0 + wg;
    const int qw = heads_per_block == 1 ? q0 + kRows * wg : q0;
    // This warpgroup's key tiles: from its window band to its diagonal.
    const int my_begin = window > 0 ? max(0, qw - window + 1) / T * T : 0;
    const int my_end = qw < S ? min(S, qw + kRows) : 0;
    // Tiles live for all 64 rows need no mask: wholly below the diagonal,
    // inside S and inside every row's window.
    const int live_end = min(qw + 1, S);
    const int live_begin = window > 0 ? qw + kRows - window : 0;
    const int qpos0 = qw + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const bf16* q_t = q_s + wg * C::kFixed;
    const bf16* do_t = do_s + wg * C::kFixed;
    const Grad g{scale, softcap > 0.0f ? __fdiv_rn(scale, softcap) : 0.0f,
                 softcap};
    float lse_r[2], d_r[2];
    bf16* rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      const int64_t i = (static_cast<int64_t>(b) * H + head) * S + qpos;
      lse_r[r] = qpos < S ? lse[i] : 0.0f;
      d_r[r] = qpos < S ? D[i] : 0.0f;
      rows[r] = qpos < S ? dq + ((static_cast<int64_t>(b) * S + qpos) * H +
                                 head) * DH
                         : nullptr;
    }

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    float s[T / 2], dp[T / 2];
    uint32_t a[3][T / 16][4];

    auto products = [&](int t) {                  // s and dp of tile t
      const int st = t % kStages;
      wgmma_fence();
      ss_product<DH, T>(s, q_t, k_s + st * C::kTile);
      ss_product<DH, T>(dp, do_t, v_s + st * C::kTile);
      wgmma_commit();
    };
    auto accumulate = [&](int t) {                // dq += split ds . k
      wgmma_fence();
      rs_product<DH, T>(acc, a, k_s + t % kStages * C::kTile);
      wgmma_commit();
    };
    auto grad = [&](int t) {
      const int k0 = k_begin + t * T;
#pragma unroll
      for (int j = 0; j < T / 2; ++j) {
        reg_fence(s[j]);
        reg_fence(dp[j]);
      }
      if (k0 + T <= live_end && k0 >= live_begin)
        grad_q<T, false>(s, dp, lse_r, d_r, qpos0, k0, quad, S, window, g);
      else
        grad_q<T, true>(s, dp, lse_r, d_r, qpos0, k0, quad, S, window, g);
    };
    auto acc_done = [&]() {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) reg_fence(acc[j]);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) reg_fence(a[term][kk][q]);
    };
    auto pass = [&](int t) {          // a tile that is not this warpgroup's
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[t % kStages]);
    };

    const int t_lo = (my_begin - k_begin) / T;
    const int t_hi = (my_end - k_begin + T - 1) / T - 1;
    mbar_wait(q_full, 0);
    int t = 0;
    for (; t < min(t_lo, n_tiles); ++t) pass(t);
    if (t_lo <= t_hi) {
      mbar_wait(&full[t_lo % kStages], (t_lo / kStages) & 1);
      products(t_lo);
      wgmma_wait<0>();
      grad(t_lo);
      split_fragments<T>(s, a);
      for (t = t_lo + 1; t <= t_hi; ++t) {
        mbar_wait(&full[t % kStages], (t / kStages) & 1);
        products(t);
        accumulate(t - 1);
        wgmma_wait<1>();
        grad(t);
        wgmma_wait<0>();
        acc_done();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
        split_fragments<T>(s, a);
      }
      accumulate(t_hi);
      wgmma_wait<0>();
      acc_done();
      if (lane == 0) mbar_arrive(&empty[t_hi % kStages]);
      t = t_hi + 1;
    }
    for (; t < n_tiles; ++t) pass(t);
    store_rows<DH>(rows, acc, __fmul_rn(scale, 1.0f / kPScale), quad);
  }
}

// One call's operands and shape.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *D;
  void *dq, *dk, *dv;
  int B, S, H, Hkv;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

template <int DH>
int launch(const Args& x) {
  using C = Cfg<DH>;
  // dK/dV streams T-row q and dout tiles over 64-row K and V tiles; dQ the
  // other way round.
  CUtensorMap q_t, do_t, k_64, v_64, q_64, do_64, k_t, v_t;
  if (!make_map(&q_t, x.q, x.B, x.S, x.H, DH, C::T, C::W) ||
      !make_map(&do_t, x.dout, x.B, x.S, x.H, DH, C::T, C::W) ||
      !make_map(&k_64, x.k, x.B, x.S, x.Hkv, DH, kRows, C::W) ||
      !make_map(&v_64, x.v, x.B, x.S, x.Hkv, DH, kRows, C::W) ||
      !make_map(&q_64, x.q, x.B, x.S, x.H, DH, kRows, C::W) ||
      !make_map(&do_64, x.dout, x.B, x.S, x.H, DH, kRows, C::W) ||
      !make_map(&k_t, x.k, x.B, x.S, x.Hkv, DH, C::T, C::W) ||
      !make_map(&v_t, x.v, x.B, x.S, x.Hkv, DH, C::T, C::W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t kv_blocks =
      static_cast<int64_t>((x.S + kRows - 1) / kRows) * x.B * x.Hkv;
  const int heads_per_block = (x.H / x.Hkv) % 2 == 0 ? 2 : 1;
  const int rows_q = kConsumers * kRows / heads_per_block;
  const int64_t q_blocks = static_cast<int64_t>((x.S + rows_q - 1) / rows_q) *
                           x.B * (x.H / heads_per_block);
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kv_kernel = dkdv_tc_kernel<DH>;
  auto q_kernel = dq_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<static_cast<unsigned>(kv_blocks), kThreads, C::kSmemKV,
              x.stream>>>(q_t, do_t, k_64, v_64, x.lse, x.D,
                          static_cast<bf16*>(x.dk), static_cast<bf16*>(x.dv),
                          x.S, x.H, x.Hkv, x.scale, x.window, x.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<static_cast<unsigned>(q_blocks), kThreads, C::kSmemQ, x.stream>>>(
      q_64, do_64, k_t, v_t, x.lse, x.D, static_cast<bf16*>(x.dq), x.S, x.H,
      x.Hkv, heads_per_block, x.scale, x.window, x.softcap);
  return static_cast<int>(cudaGetLastError());
}

// The part that instantiates dh's kernels: dh / 16 - 1 = i in 0..15 pairs
// with 15 - i, and the pairs go round the parts, so each part holds dh
// values summing to 544.
constexpr int kParts = 4;
constexpr int part_of(int dh) {
  return (dh / 16 - 1 < 16 - dh / 16 ? dh / 16 - 1 : 16 - dh / 16) % kParts;
}

// Launches dh's kernels if part P holds them (the others are not
// instantiated here).
template <int P>
int launch_part(int dh, const Args& x) {
  switch (dh) {
#define BWD_CASE(n)                                            \
  case n:                                                      \
    if constexpr (part_of(n) == P) return launch<n>(x);        \
    break;
    BWD_CASE(16) BWD_CASE(32) BWD_CASE(48) BWD_CASE(64)
    BWD_CASE(80) BWD_CASE(96) BWD_CASE(112) BWD_CASE(128)
    BWD_CASE(144) BWD_CASE(160) BWD_CASE(176) BWD_CASE(192)
    BWD_CASE(208) BWD_CASE(224) BWD_CASE(240) BWD_CASE(256)
#undef BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_part0(int dh, const Args& x);
int launch_part1(int dh, const Args& x);
int launch_part2(int dh, const Args& x);
int launch_part3(int dh, const Args& x);
#if !defined(BUILD_PART) || BUILD_PART == 0
int launch_part0(int dh, const Args& x) { return launch_part<0>(dh, x); }
#endif
#if !defined(BUILD_PART) || BUILD_PART == 1
int launch_part1(int dh, const Args& x) { return launch_part<1>(dh, x); }
#endif
#if !defined(BUILD_PART) || BUILD_PART == 2
int launch_part2(int dh, const Args& x) { return launch_part<2>(dh, x); }
#endif
#if !defined(BUILD_PART) || BUILD_PART == 3
int launch_part3(int dh, const Args& x) { return launch_part<3>(dh, x); }
#endif

}  // namespace tc

#ifdef BWD_HOST_PART

// dtype: 0 f32 (CUDA cores), 1 bf16 (tensor cores; q, k, v, dout 16-byte
// aligned for TMA).  q, k, v, out, dout, dq, dk, dv all of that type; lse
// and D are (B, H, S) f32, D scratch the launcher fills.  window <= 0: no
// window; softcap <= 0: none.  Launches three kernels on ``stream``.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, const float* lse,
                                     float* D, void* dq, void* dk, void* dv,
                                     int B, int S, int H, int Hkv, int dh,
                                     float scale, int window, float softcap,
                                     int dtype, cudaStream_t stream) {
  if (dh < 16 || dh > 256 || dh % 16 || Hkv < 1 || H % Hkv || B < 1 ||
      S < 1 || B * H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = dtype == 0
                     ? launch_dot<float>(out, dout, D, B, S, H, dh, stream)
                     : launch_dot<bf16>(out, dout, D, B, S, H, dh, stream);
  if (rc) return rc;
  if (dtype == 0)
    return f32::launch_dh(q, k, v, dout, lse, D, dq, dk, dv, B,
                          f32::Shape{S, H, Hkv, dh, window, scale, softcap},
                          stream);
  const tc::Args x{q, k, v, dout, lse, D, dq, dk, dv, B, S, H, Hkv,
                   scale, window, softcap, stream};
  switch (tc::part_of(dh)) {
    case 0: return tc::launch_part0(dh, x);
    case 1: return tc::launch_part1(dh, x);
    case 2: return tc::launch_part2(dh, x);
    default: return tc::launch_part3(dh, x);
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // BWD_HOST_PART
