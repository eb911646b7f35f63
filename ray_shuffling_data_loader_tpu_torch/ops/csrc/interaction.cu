// DLRM dot interaction on Hopper: out[b, k] = <x[b, i], x[b, j]> for the
// k-th pair (i < j) of the strict upper triangle, pairs in row-major order.
//
//   x   [B, N, D]        float32 or bfloat16, contiguous
//   out [B, N(N-1)/2]    same dtype as x, sums accumulated in float32
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/interaction.py
// `_interaction_kernel` (a Pallas kernel that took the Gram on the MXU and
// compacted the triangle with 0/1 selection matmuls, a way around Mosaic's
// limits that has no use here).
//
// What bounds it: bytes. At the DLRM shape (B = 65536, N = 19, D = 32,
// bf16) one call reads 79.7 MB and writes 22.4 MB but does only 0.72 GFLOP,
// about 7 operations per byte, far below the ~295 the card needs before its
// arithmetic, not its memory, is the limit.
//
// What the design does about it: every input byte is read from device
// memory once and every output byte written once. A block loads a tile of
// `bt` samples with coalesced 16-byte loads into shared memory (as float32,
// each row padded to an odd stride so that threads reading different rows
// hit different banks), then its threads walk (sample, pair) work items,
// take a D-long float32 dot product from shared memory and store the
// result; a tile's outputs are contiguous, so the stores coalesce. The
// block loops over tiles, so the TPU's sequential grid becomes a loop
// inside the block. This is the simple version: its shared-memory reads,
// not device memory, set its speed (the Gram could go to tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;              // pair indices are stored in bytes
constexpr int kThreads = 256;
constexpr int kTileBudget = 40 * 1024;  // tile bytes per block
constexpr int kMaxTile = 64;            // samples per tile
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
interaction_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                       long long batch, int n, int d, int stride, int pairs,
                       int bt, bool vectorized) {
  extern __shared__ float smem[];
  float* tile = smem;  // [bt * n rows][stride]
  unsigned char* pair_i =
      reinterpret_cast<unsigned char*>(tile + static_cast<size_t>(bt) * n * stride);
  unsigned char* pair_j = pair_i + pairs;

  // Pair table: row i owns pairs [start_i, start_i + n - 1 - i).
  for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
    int i = 0, start = 0;
    while (start + (n - 1 - i) <= k) {
      start += n - 1 - i;
      ++i;
    }
    pair_i[k] = static_cast<unsigned char>(i);
    pair_j[k] = static_cast<unsigned char>(i + 1 + (k - start));
  }

  const long long sample_elems = static_cast<long long>(n) * d;
  for (long long b0 = static_cast<long long>(blockIdx.x) * bt; b0 < batch;
       b0 += static_cast<long long>(gridDim.x) * bt) {
    const int nb = static_cast<int>(min(static_cast<long long>(bt), batch - b0));
    const int elems = nb * n * d;
    const T* src = x + b0 * sample_elems;
    __syncthreads();  // the previous tile's readers are done
    if (vectorized) {
      constexpr int kVec = 16 / sizeof(T);
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      const int nvec = elems / kVec;
      for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        const uint4 raw = src4[v];
        const T* vals = reinterpret_cast<const T*>(&raw);
        int e = v * kVec;
        int row = e / d;
        int col = e - row * d;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          tile[row * stride + col] = to_f32<T>(vals[u]);
          if (++col == d) {
            col = 0;
            ++row;
          }
        }
      }
    } else {
      for (int e = threadIdx.x; e < elems; e += blockDim.x) {
        const int row = e / d;
        tile[row * stride + (e - row * d)] = to_f32<T>(src[e]);
      }
    }
    __syncthreads();

    T* dst = out + b0 * pairs;
    const int work = nb * pairs;
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int s = w / pairs;
      const int k = w - s * pairs;
      const float* xi = tile + (s * n + pair_i[k]) * stride;
      const float* xj = tile + (s * n + pair_j[k]) * stride;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(xi[c], xj[c], acc);
      dst[w] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long long batch, int n, int d,
           cudaStream_t stream) {
  const int stride = d | 1;  // odd row stride: distinct rows, distinct banks
  const int pairs = n * (n - 1) / 2;
  const size_t per_sample = static_cast<size_t>(n) * stride * sizeof(float);
  size_t bt = kTileBudget / per_sample;
  bt = bt < 1 ? 1 : (bt > kMaxTile ? kMaxTile : bt);
  const size_t smem = bt * per_sample + 2 * static_cast<size_t>(pairs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorized = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          (static_cast<long long>(n) * d) % kVec == 0;
  const long long tiles = (batch + static_cast<long long>(bt) - 1) / bt;
  const int grid = static_cast<int>(tiles < (1 << 20) ? tiles : (1 << 20));
  interaction_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), batch, n, d, stride,
      pairs, static_cast<int>(bt), vectorized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t code.
extern "C" int rsdl_interaction_fwd(const void* x, void* out, long long batch,
                                    int n, int d, int dtype, void* stream) {
  if (batch < 0 || n < 2 || n > kMaxN || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, out, batch, n, d, s);
    case 1:
      return launch<__nv_bfloat16>(x, out, batch, n, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
