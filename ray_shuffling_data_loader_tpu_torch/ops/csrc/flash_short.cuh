// Shared pieces of the short route's kernels, flash_fwd_short.cu (the
// forward) and flash_bwd_short.cu (the backward): heads of fewer than 32
// tokens, hd 8 or 16, whose packed batch rows a block stages whole.
//
// A block step takes rows = max(1, heads / h) batch rows (h * hd <=
// kMaxWidth; the heads a step and the steps in flight are each kernel's
// own); each input row is one contiguous span that one thread asks for
// with a 1-D bulk copy (TMA) on the stage's mbarrier, and the outputs
// leave by bulk stores. A persistent grid walks the batch rows; a warp
// takes every kMaxWarps-th head of a step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace rsdl_short {

constexpr int kTokens = 32;     // t padded: one warp's tiles, t < 32
constexpr int kMaxWidth = 128;  // h * hd of the batch rows a block takes whole
constexpr int kMaxWarps = 4;    // a warp takes every kMaxWarps-th head of a step
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// 2^x on the special-function unit (relative error about 2^-22); -1e30 gives 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

// 1-D bulk copies (TMA) between global and shared memory, on
// flash_common.cuh's mbarriers.

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// Batch rows per block step for `heads` heads a step, and warps per block.
inline int step_rows(int h, int heads) { return h >= heads ? 1 : heads / h; }
inline int step_warps(int rows, int h) { return rows * h < kMaxWarps ? rows * h : kMaxWarps; }

// The persistent grid of `kernel` over `chunks` block steps: as many blocks
// as the card holds at `threads` threads and `smem` bytes of dynamic shared
// memory each, at most `chunks`. Returns 0 or a cudaError_t code.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t smem, int chunks, int sms, int* grid) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = chunks < per_sm * sms ? chunks : per_sm * sms;
  return 0;
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace rsdl_short
