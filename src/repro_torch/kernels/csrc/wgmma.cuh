// Tensor-core building blocks shared by flash_attn.cu (forward) and
// flash_attn_bwd.cu (backward): mbarriers (bulk_copy.cuh's), 3-D TMA loads
// of swizzled bf16 tiles, wgmma shared-memory descriptors, bf16 wgmma with
// f32 accumulators (SS: both operands in shared memory, K-major; RS: A in
// registers in the accumulator's fragment layout, B in shared memory
// MN-major), and the exact three-term bf16 split of an f32 value.
//
// A tile is stored as dh / W column blocks of `rows` x W bf16 (W the widest
// swizzle, 128, 64 or 32 bytes, whose width divides dh), each swizzled as the
// TMA box (W columns, rows positions) of a (B, S, heads * dh) tensor map
// lands it.  The same tile serves as a K-major operand (its rows index M or
// N, its columns the product's depth) and as an MN-major B operand (its rows
// index the depth, its columns N).
#pragma once

#include "bulk_copy.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wgmma {

using bf16 = __nv_bfloat16;
using bulk::mbar_arrive;
using bulk::mbar_arrive_expect_tx;
using bulk::mbar_fence_init;
using bulk::mbar_init;
using bulk::mbar_wait;
using bulk::smem_u32;

constexpr float kPScale = 65536.0f;   // x * 2^16 splits exactly (split3)

// W, the column block in bf16, and the swizzle mode of the descriptors.
template <int DH>
struct Cols {
  static constexpr int W = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
};

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

// rows x dh of head `head` from position `pos` of batch row `b`: dh / W
// boxes into the column blocks of `dst`.
template <int DH>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int head,
                                         int pos, int b) {
  constexpr int W = Cols<DH>::W;
#pragma unroll 1
  for (int c = 0; c < DH / W; ++c)
    tma_load(dst + c * rows * W, map, bar, head * DH + c * W, pos, b);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// A tile's descriptor, opaque to the compiler where it is made: the
// descriptors of each k-step (the base plus an offset in 16-byte units in
// the address field, which stays below 2^14 for any shared address) are
// then formed next to their wgmma on every pass of a loop, instead of being
// hoisted out of it and held in registers (two a descriptor) that the
// accumulators need.
__device__ __forceinline__ uint64_t tile_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  uint64_t d = make_desc(p, lbo, sbo, layout);
  asm volatile("" : "+l"(d));
  return d;
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

// D (64 x N) (+)= A (64 x 16 slice, K-major tile of 64 rows) . B^T (16 x N,
// K-major tile of N rows): one k-step of a product over dh, both operands
// from shared memory.
template <int N>
__device__ __forceinline__ void ss_step(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n32(d, da, db, accumulate);
}

// D (64 x N) (+)= A (64 x DH) . B^T where A and B are tiles of 64 and N
// rows by DH columns: dh / 16 SS wgmma, the first overwriting D.
template <int DH, int N>
__device__ __forceinline__ void ss_product(float* d, const bf16* a_tile,
                                           const bf16* b_tile) {
  constexpr int W = Cols<DH>::W;
  const uint64_t da = tile_desc(a_tile, 16, 8 * W * 2, Cols<DH>::kLayout);
  const uint64_t db = tile_desc(b_tile, 16, 8 * W * 2, Cols<DH>::kLayout);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 / W, off = kk * 16 % W;
    ss_step<N>(d, da + (c * 64 * W + off) * 2 / 16,
               db + (c * N * W + off) * 2 / 16, kk > 0);
  }
}

// D[:, N0:N0+REM] += A (64 x 16 depth, registers) . B (16 depth rows of a
// ROWS-row tile, whose descriptor at its first column is `db_rows`, x REM
// columns), in chunks of 128, 64, 32 and 16 columns (each a whole number of
// W-wide column blocks, LBO apart).
template <int W, int ROWS, int N0, int REM>
__device__ __forceinline__ void rs_step(float* d, const uint32_t* a,
                                        uint64_t db_rows) {
  if constexpr (REM > 0) {
    constexpr int N = REM >= 128 ? 128 : REM >= 64 ? 64 : REM >= 32 ? 32 : 16;
    const uint64_t db = db_rows + N0 / W * ROWS * W * 2 / 16;
    if constexpr (N == 128)
      wgmma_rs_n128(d + N0 / 2, a, db);
    else if constexpr (N == 64)
      wgmma_rs_n64(d + N0 / 2, a, db);
    else if constexpr (N == 32)
      wgmma_rs_n32(d + N0 / 2, a, db);
    else
      wgmma_rs_n16(d + N0 / 2, a, db);
    rs_step<W, ROWS, N0 + N, REM - N>(d, a, db_rows);
  }
}

// D (64 x DH) += sum over the three terms and the ROWS / 16 k-steps of
// A[term][kk] (registers) . B (the ROWS x DH tile, MN-major): the exact
// products of a split operand.  Terms outermost, as the forward's p.v.
template <int DH, int ROWS>
__device__ __forceinline__ void rs_product(float* d,
                                           uint32_t (*a)[ROWS / 16][4],
                                           const bf16* b_tile) {
  constexpr int W = Cols<DH>::W;
  const uint64_t db =
      tile_desc(b_tile, ROWS * W * 2, 8 * W * 2, Cols<DH>::kLayout);
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      rs_step<W, ROWS, 0, DH>(d, a[term][kk], db + kk * 16 * W * 2 / 16);
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

// x * 2^16 of the accumulator-layout values x (64 x N, x[4j + i] at row
// i >> 1, column 8j + 2 * quad + (i & 1)) split into the A fragments of
// the three bf16 terms: register q of k-step kk holds x[i], x[i + 1] with
// i = 4 * (2kk + (q >> 1)) + 2 * (q & 1).
template <int N>
__device__ __forceinline__ void split_fragments(const float* x,
                                                uint32_t (*a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
      split3(__fmul_rn(x[i], kPScale), __fmul_rn(x[i + 1], kPScale),
             a[0][kk][q], a[1][kk][q], a[2][kk][q]);
    }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeTiled encode_tiled() {
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
// positions, 1), swizzled to match the wgmma descriptors.  Rows past S
// land as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, int dh, int rows, int w) {
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

}  // namespace wgmma
