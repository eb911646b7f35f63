// Tensor-core pieces of the flash attention kernels flash_fwd_mma.cu (K2),
// flash_bwd_dkv_mma.cu (K3) and flash_bwd_dq_mma.cu (K4), and of the dot
// interaction's interaction_mma.cu (K1): ldmatrix, mma.sync m16n8k16 in
// bf16 with float32 accumulators, cp.async with zero fill, and the
// two-term bf16 split of a float32 operand.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" with .bf16): lane l of a warp,
// g = l / 4, c = 2 * (l % 4).
//   A, 16 x 16, row-major: a0 = (g, c..c+1), a1 = (g+8, c..c+1),
//                          a2 = (g, 8+c..), a3 = (g+8, 8+c..)
//   B, 16 x 8, "col":      b0 = (k c..c+1, n g), b1 = (k 8+c.., n g)
//   C, 16 x 8, float32:    c0, c1 = (g, c..c+1), c2, c3 = (g+8, c..c+1)
// Two neighbouring C tiles (16 columns) hold exactly an A fragment's
// elements, so a probability tile computed in registers feeds the next
// product as its A operand without passing through shared memory.
//
// Shared-memory tiles are [rows][kLdPad + hd] bf16: the 16 bytes of padding
// per row put the 8 rows that one ldmatrix phase reads on 8 different
// groups of 4 banks for every hd that is a multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rsdl_mma {

constexpr int kLdPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives in r[q] its two elements of matrix q.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, one 16x8x16 product, bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0 or 16) are zero.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared, zero when `src_bytes` is 0.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two float32 values as the two bf16 terms hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in float32). hi + lo carries about 16 significant bits:
// |x - hi - lo| <= 2^-17 |x|, where hi alone errs by up to 2^-9 |x|.
// The element with the lower column index goes in the low 16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi and lo terms) of k-step kk of a 16-row tile of
// float32 C fragments x[2kk], x[2kk+1] (columns 16kk .. 16kk+15).
__device__ __forceinline__ void a_from_c(const float (&x0)[4], const float (&x1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(x0[0], x0[1], hi[0], lo[0]);
  split_bf16(x0[2], x0[3], hi[1], lo[1]);
  split_bf16(x1[0], x1[1], hi[2], lo[2]);
  split_bf16(x1[2], x1[3], hi[3], lo[3]);
}

// Row-major A fragment of rows [r0, r0 + 16) x columns [k0, k0 + 16) of a
// shared tile with row stride `ld` elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int k0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = k0 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_u32(tile + row * ld + col));
}

// B fragments of two neighbouring n-tiles when B = X^T for a shared tile X
// stored [n][k] (X's rows are B's columns): n in [n0, n0 + 16), k in
// [k0, k0 + 16). b[0], b[1] serve n-tile n0; b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int n0, int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, smem_u32(tile + row * ld + col));
}

// B fragments of two neighbouring n-tiles when B is a shared tile stored
// [k][n]: k in [k0, k0 + 16), n in [n0, n0 + 16), transposed by ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, smem_u32(tile + row * ld + col));
}

// Rows [r0, r0 + n) of one head of a [b, t, h, hd] view (`base` points at
// row 0 of the head, rows `st` elements apart) into a shared tile of row
// stride `ld`, 16 bytes per cp.async; rows at or past t read as zero.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* base,
                                          long long st, int r0, int n, int t) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * 8;
    const bool ok = r0 + r < t;
    const __nv_bfloat16* src = ok ? base + static_cast<long long>(r0 + r) * st + e : base;
    cp_async_16(smem_u32(dst + r * ld + e), src, ok ? 16 : 0);
  }
}

// Store a warp's 16 x HD float32 C fragments times `mul` as bf16 rows
// `row0` and `row0 + 8` (skipped at or past t).
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st, int row0, int t,
                                           const float (&x)[HD / 8][4], float mul, int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= t) continue;
    __nv_bfloat16* dst = base + static_cast<long long>(row) * st + c;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
          __floats2bfloat162_rn(x[nt][2 * half] * mul, x[nt][2 * half + 1] * mul);
    }
  }
}

}  // namespace rsdl_mma

// The head dims the tensor-core kernels take: multiples of 16 up to 128.
// RSDL_MMA_HEAD_DIM(hd, F, args) returns F<hd>(args), or
// cudaErrorInvalidValue for another hd.
#define RSDL_MMA_HEAD_DIM(hd, F, ...)                      \
  ((hd) == 16    ? F<16>(__VA_ARGS__)                      \
   : (hd) == 32  ? F<32>(__VA_ARGS__)                      \
   : (hd) == 48  ? F<48>(__VA_ARGS__)                      \
   : (hd) == 64  ? F<64>(__VA_ARGS__)                      \
   : (hd) == 80  ? F<80>(__VA_ARGS__)                      \
   : (hd) == 96  ? F<96>(__VA_ARGS__)                      \
   : (hd) == 112 ? F<112>(__VA_ARGS__)                     \
   : (hd) == 128 ? F<128>(__VA_ARGS__)                     \
                 : static_cast<int>(cudaErrorInvalidValue))
