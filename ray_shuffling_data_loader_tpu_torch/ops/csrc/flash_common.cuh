// Shared pieces of the flash attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Tensors are [b, t, h, hd] with explicit element strides for b, t and h
// and a contiguous last dim, so q, k and v may be the strided views that
// `qkv.reshape(b, t, 3, h, hd)` yields. The softmax statistics m, l and the
// backward's D = rowsum(dO * out) are float32 [b, h, t], contiguous.
//
// Work split, shared by the three kernels. Each query row (K2, K4) or key
// row (K3) is "owned" by a group of G neighbouring threads of one warp;
// lane g of the group holds elements [g*S, g*S + S) of the row's head dim
// in registers, so a dot product is S fused multiply-adds and a butterfly
// over the G lanes. The other side of the product ("streamed" rows: keys
// and values for K2 and K4, queries, dO, m, l and D for K3) passes through
// shared memory as float32 tiles. A block owns `own` rows of each of `hc`
// neighbouring heads:
//
//   * short sequences (t <= rows a block can own): own = t and hc heads
//     share a block, so a head of 19 tokens does not leave most of a
//     block idle;
//   * long sequences: hc = 1 and the block owns a tile of `own` rows of
//     one head, with the sequence cut into ceil(t / own) blocks.
//
// Owned rows map to threads head-fastest, so neighbouring threads touch
// neighbouring heads, which lie next to each other in memory; the streamed
// tile is stored [row][head][HDP] so that those threads read neighbouring
// rows of shared memory. Causal tiles that are fully masked are never
// loaded, and masked keys inside a tile are skipped one by one: they would
// add exp(NEG_INF - m) = 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rsdl_flash {

constexpr float kNegInf = -1e30f;  // finite: NEG_INF - NEG_INF is 0, not NaN
constexpr int kMaxHeadDim = 128;
constexpr int kMaxThreads = 256;
constexpr int kSmemBudget = 40 * 1024;  // under the 48 KB default

struct View {
  const void* ptr;
  long long sb, st, sh;  // element strides of b, t and h
};

struct OutView {
  void* ptr;
  long long sb, st, sh;
};

struct Plan {
  int hc;         // heads per block
  int own;        // owned rows per head per block
  int own_tiles;  // blocks along the sequence
  int tile;       // streamed rows per head per shared-memory tile
  int threads;
  long long blocks;
};

// The current device's SM count; a failed query returns its error code.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Rows owned by a block of kMaxThreads threads is kMaxThreads / g. A
// streamed row takes `row_bytes` of shared memory per head; `sms` is the
// device's SM count.
inline Plan make_plan(long long bh, int t, int g, int row_bytes, int sms) {
  Plan p;
  const int rows = kMaxThreads / g;
  if (t <= rows) {
    p.hc = rows / t;
    p.own = t;
  } else {
    p.hc = 1;
    p.own = rows;
    // Few long heads: smaller blocks, so that the card has enough of them.
    while (p.own * g > 64 &&
           bh * ((t + p.own - 1) / p.own) < 2LL * sms) {
      p.own /= 2;
    }
  }
  if (p.hc > bh) p.hc = static_cast<int>(bh);
  p.own_tiles = (t + p.own - 1) / p.own;
  int tile = kSmemBudget / (p.hc * row_bytes);
  p.tile = tile < 1 ? 1 : (tile > t ? t : tile);
  p.threads = (p.hc * p.own * g + 31) / 32 * 32;
  p.blocks = (bh + p.hc - 1) / p.hc * p.own_tiles;
  return p;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ long long offset(long long sb, long long st,
                                            long long sh, int bi, int ti,
                                            int hi) {
  return static_cast<long long>(bi) * sb + static_cast<long long>(ti) * st +
         static_cast<long long>(hi) * sh;
}

// Sum over the G lanes of a thread's group (G divides 32; groups aligned).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
  if (G > 1) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned mask =
        G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1u)));
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(mask, v, off);
    }
  }
  return v;
}

// S elements of one row into registers as float32; elements past `valid`
// read as 0. `vec`: 16-byte loads are aligned.
template <typename T, int S>
__device__ __forceinline__ void load_slice(float (&r)[S], const T* row,
                                           int valid, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(S % kVec == 0, "slice must be whole 16-byte vectors");
  if (vec && valid >= S) {
#pragma unroll
    for (int u = 0; u < S; u += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + u);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int w = 0; w < kVec; ++w) r[u + w] = to_f32<T>(vals[w]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < S; ++u) r[u] = u < valid ? to_f32<T>(row[u]) : 0.f;
  }
}

template <typename T, int S>
__device__ __forceinline__ void store_slice(T* row, const float (&r)[S],
                                            int valid, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec && valid >= S) {
#pragma unroll
    for (int u = 0; u < S; u += kVec) {
      uint4 raw;
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int w = 0; w < kVec; ++w) vals[w] = from_f32<T>(r[u + w]);
      *reinterpret_cast<uint4*>(row + u) = raw;
    }
  } else {
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (u < valid) row[u] = from_f32<T>(r[u]);
    }
  }
}

// S float32 values of a shared-memory row (16-byte aligned).
template <int S>
__device__ __forceinline__ void read_smem(float (&r)[S], const float* row) {
#pragma unroll
  for (int u = 0; u < S; u += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + u);
    r[u] = x.x;
    r[u + 1] = x.y;
    r[u + 2] = x.z;
    r[u + 3] = x.w;
  }
}

// Rows [s0, s0 + n) of heads bh0 .. bh0 + hc - 1 into dst[n][hc][HDP] as
// float32, zero past hd and for heads past bh_total.
template <typename T, int HDP>
__device__ void load_tile(float* dst, const View& x, long long bh0, int hc,
                          long long bh_total, int h, int s0, int n, int hd,
                          bool vec) {
  const T* base = static_cast<const T*>(x.ptr);
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = HDP / kVec;
    const int total = n * hc * kChunks;
    for (int w = threadIdx.x; w < total; w += blockDim.x) {
      const int c = w % kChunks;
      const int r = w / kChunks;
      const int hh = r % hc;
      const int jj = r / hc;
      const long long bh = bh0 + hh;
      const int e0 = c * kVec;
      float* out = dst + static_cast<long long>(r) * HDP + e0;
      if (bh < bh_total && e0 < hd) {
        const int bi = static_cast<int>(bh / h), hi = static_cast<int>(bh % h);
        const uint4 raw = *reinterpret_cast<const uint4*>(
            base + offset(x.sb, x.st, x.sh, bi, s0 + jj, hi) + e0);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < kVec; ++u) out[u] = to_f32<T>(vals[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) out[u] = 0.f;
      }
    }
  } else {
    const int total = n * hc * HDP;
    for (int w = threadIdx.x; w < total; w += blockDim.x) {
      const int e = w % HDP;
      const int r = w / HDP;
      const int hh = r % hc;
      const int jj = r / hc;
      const long long bh = bh0 + hh;
      float val = 0.f;
      if (bh < bh_total && e < hd) {
        const int bi = static_cast<int>(bh / h), hi = static_cast<int>(bh % h);
        val = to_f32<T>(base[offset(x.sb, x.st, x.sh, bi, s0 + jj, hi) + e]);
      }
      dst[w] = val;
    }
  }
}

// Row statistics [bh, t] at rows [s0, s0 + n) into dst[n][hc], 0 for heads
// past bh_total; `floor` clamps from below (l is read as max(l, 1e-30)).
__device__ inline void load_stats(float* dst, const float* src, long long bh0,
                                  int hc, long long bh_total, int t, int s0,
                                  int n, float floor) {
  const int total = n * hc;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int jj = w % n;  // neighbouring threads, neighbouring addresses
    const int hh = w / n;
    const long long bh = bh0 + hh;
    const float val =
        bh < bh_total ? src[bh * t + s0 + jj] : 0.f;
    dst[jj * hc + hh] = fmaxf(val, floor);
  }
}

// Loads and stores may use 16-byte vectors when every base pointer and
// stride is a multiple of 16 bytes and hd fills whole vectors.
inline bool vectorizable(size_t elem, int hd, const void* const* ptrs, int nptr,
                         const long long* strides, int nstrides) {
  if ((hd * elem) % 16 != 0) return false;
  for (int i = 0; i < nptr; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  for (int i = 0; i < nstrides; ++i) {
    if ((strides[i] * static_cast<long long>(elem)) % 16 != 0) return false;
  }
  return true;
}

// mbarriers in shared memory, for kernels that stage tiles by TMA (the
// short route's, flash_short.cuh, and K2's wgmma route, flash_wgmma.cuh).

// A barrier whose phase completes at `count` arrivals (and the bytes its
// arrivals expect).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// Make the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

}  // namespace rsdl_flash

// Head-dim buckets: S elements per lane and G lanes per row, S * G >= hd.
// RSDL_FLASH_BUCKET(hd, F, args) returns F<T, S, G>(args) for the bucket.
#define RSDL_FLASH_BUCKET(T, hd, F, ...)                     \
  ((hd) <= 8    ? F<T, 8, 1>(__VA_ARGS__)                    \
   : (hd) <= 16 ? F<T, 16, 1>(__VA_ARGS__)                   \
   : (hd) <= 32 ? F<T, 16, 2>(__VA_ARGS__)                   \
   : (hd) <= 64 ? F<T, 16, 4>(__VA_ARGS__)                   \
                : F<T, 16, 8>(__VA_ARGS__))
