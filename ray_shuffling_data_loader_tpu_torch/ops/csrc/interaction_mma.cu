// DLRM dot interaction on Hopper's tensor cores (K1, the "mma" route): the
// function of interaction.cu for bf16 inputs whose width fills tensor-core
// tiles.
//
//   x   [B, N, D]        bfloat16, contiguous, 16-byte aligned, D a
//                        multiple of 16 up to 128, 2 <= N <= 64
//   out [B, N(N-1)/2]    bfloat16: out[b, k] = <x[b, i], x[b, j]> for the
//                        k-th pair (i < j), sums in float32, rounded once
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/interaction.py
// `_interaction_kernel` (the Gram on the MXU, the triangle compacted with
// 0/1 selection matmuls).
//
// What bounds it: bytes. At the DLRM shape (B = 65536, N = 19, D = 32) one
// call reads 79.7 MB and writes 22.4 MB for 0.72 GFLOP: 30.5 us at
// 3.35 TB/s. The CUDA-core kernel's two 4-byte shared-memory reads per
// multiply-add (about 11 k per sample there) cost more than that.
//
// What the design does about it: a block of 8 warps walks tiles of `bt`
// samples (bt * N * D * 2 contiguous bytes, about 16 KB: 8 samples at the
// DLRM shape) through a 2-stage cp.async ring, several blocks per SM, so
// device memory streams while the previous tile is computed (on the card,
// deeper rings, larger tiles and 4 or 16 warps were all slower). The
// chunk addresses advance by fixed steps: the load loop divides nothing.
// Each 16-byte chunk lands in its row of a shared tile kept in bf16, rows
// padded by 16 bytes (kLdPad) so that every ldmatrix phase hits distinct
// banks; 15 zeroed rows after the tile let the last
// sample's rows be read as whole 16-row blocks. One warp takes one sample:
// Gram = X X^T with mma.sync m16n8k16 (bf16 in, float32 sums). One
// ldmatrix.x4 of a 16 x 16 block of X is the A fragment of that block's
// rows and, as registers (a0, a2) and (a1, a3), the B fragments of the two
// 8-column n-tiles of the same rows, so each block of X is read from
// shared memory once per warp. Only the C tiles that hold pairs i < j < N
// are computed (at N = 19, D = 32: 4 tiles x 2 k-steps = 8 mma.sync); a
// padded row or column lands only in entries that are dropped, since
// C(i, j) reads rows i and j alone. Each lane writes its kept entries as
// bf16 to their pair index in a shared output tile [bt][N(N-1)/2], which
// the block stores with coalesced 16-byte stores.

#include "flash_mma.cuh"

namespace {

using namespace rsdl_mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 64;
constexpr int kMaxD = 128;
constexpr int kStages = 2;              // depth of the cp.async ring
constexpr int kSpareRows = 15;          // a sample's last 16-row block may run past the tile
constexpr int kStageBudget = 16 * 1024;  // input bytes per stage that set bt
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Plan {
  int bt;           // samples per tile
  int stage_elems;  // bf16 elements per ring stage, spare rows included
  size_t smem;
};

inline Plan make_plan(int n, int d) {
  const int ld = d + kLdPad;
  const int pairs = n * (n - 1) / 2;
  int bt = kStageBudget / (n * d * 2);
  bt = bt >= 8 ? bt / 8 * 8 : kWarps;  // a multiple of 8 keeps output tiles 16-byte aligned
  Plan p;
  for (;; --bt) {  // wide samples: fewer per tile until the ring fits
    p.bt = bt;
    p.stage_elems = (bt * n + kSpareRows) * ld;
    const size_t out_bytes = (static_cast<size_t>(bt) * pairs * sizeof(bf16) + 15) / 16 * 16;
    p.smem = kStages * static_cast<size_t>(p.stage_elems) * sizeof(bf16) + out_bytes;
    if (p.smem <= kMaxSmem || bt == 1) return p;
  }
}

// RB: 16-row blocks per sample, ceil(N / 16).
template <int RB>
__global__ void __launch_bounds__(kThreads)
interaction_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long batch,
                       int n, int d, int bt, int stage_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = d + kLdPad;
  const int pairs = n * (n - 1) / 2;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // kStages stages of [bt * n + 15][ld]
  bf16* outs = ring + kStages * stage_elems;   // [bt][pairs]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long tiles = (batch + bt - 1) / bt;
  const long long sample_elems = static_cast<long long>(n) * d;
  const int chunks_per_row = d / 8;
  const int chunks = bt * n * chunks_per_row;
  // Chunk c of a tile lies in row c / chunks_per_row; a thread's chunks
  // are kThreads apart, so its row and column advance by fixed steps and
  // the load loop divides nothing.
  const int row_first = threadIdx.x / chunks_per_row;
  const int col_first = threadIdx.x - row_first * chunks_per_row;
  const int row_step = kThreads / chunks_per_row;
  const int col_step = kThreads - row_step * chunks_per_row;

  // The spare rows are never loaded: zero them once in every stage.
  for (int i = threadIdx.x; i < kStages * kSpareRows * ld; i += kThreads) {
    const int stage = i / (kSpareRows * ld);
    ring[stage * stage_elems + bt * n * ld + i % (kSpareRows * ld)] = __float2bfloat16(0.f);
  }

  // Tile `tile` into ring stage `stage`; rows of samples past the batch
  // read as zero.
  auto load_tile = [&](int stage, long long tile) {
    const long long b0 = tile * bt;
    const int rows = static_cast<int>(min(static_cast<long long>(bt), batch - b0)) * n;
    bf16* dst = ring + stage * stage_elems;
    const bf16* src = x + b0 * sample_elems;
    int row = row_first, col = col_first;
#pragma unroll 1
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const bool ok = row < rows;
      cp_async_16(smem_u32(dst + row * ld + col * 8), ok ? src + static_cast<long long>(c) * 8 : x,
                  ok ? 16 : 0);
      row += row_step;
      col += col_step;
      if (col >= chunks_per_row) {
        col -= chunks_per_row;
        ++row;
      }
    }
  };

  // Pair tiles: m-tile mt (rows 16 mt ..) x n-tile nt (columns 8 nt ..)
  // holds a pair i < j < n only for 16 mt < n - 1 and 2 mt <= nt < ceil(n / 8).
  const int mt_n = (n - 1 + 15) / 16;
  const int nt_n = (n + 7) / 8;
  const int g = lane / 4, c2 = 2 * (lane & 3);

  // The ring: tile `it` of this block lands in stage it % kStages while
  // the next kStages - 1 tiles are in flight. Every step commits a group,
  // empty past the last tile, so that wait<kStages - 1> always means
  // "tile `it` has landed".
  long long tile = blockIdx.x;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const long long ahead = tile + static_cast<long long>(st) * gridDim.x;
    if (ahead < tiles) load_tile(st, ahead);
    cp_async_commit();
  }
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long ahead = tile + static_cast<long long>(kStages - 1) * gridDim.x;
    if (ahead < tiles) load_tile((it + kStages - 1) % kStages, ahead);  // the stage read at it - 1
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // the tile has landed; the previous output tile is stored
    const bf16* xs = ring + (it % kStages) * stage_elems;
    const long long b0 = tile * bt;
    const int nb = static_cast<int>(min(static_cast<long long>(bt), batch - b0));

    for (int s = warp; s < nb; s += kWarps) {
      float acc[RB][2 * RB][4];
#pragma unroll
      for (int mt = 0; mt < RB; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2 * RB; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        }
      }
      for (int k0 = 0; k0 < d; k0 += 16) {
        uint32_t a[RB][4];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) load_a(a[rb], xs, ld, s * n + 16 * rb, k0, lane);
#pragma unroll
        for (int mt = 0; mt < RB; ++mt) {
          if (mt >= mt_n) continue;
#pragma unroll
          for (int nt = 2 * mt; nt < 2 * RB; ++nt) {
            if (nt >= nt_n) continue;
            // B = X^T over X rows 8 nt ..: (a0, a2) of the 16-row block for
            // an even n-tile, (a1, a3) for an odd one.
            mma_bf16(acc[mt][nt], a[mt], a[nt >> 1][nt & 1], a[nt >> 1][(nt & 1) + 2]);
          }
        }
      }
      // Kept entries to their pair index i (2n - i - 1) / 2 + (j - i - 1).
      bf16* orow = outs + s * pairs;
#pragma unroll
      for (int mt = 0; mt < RB; ++mt) {
#pragma unroll
        for (int nt = 2 * mt; nt < 2 * RB; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * mt + g + (e >> 1) * 8;
            const int j = 8 * nt + c2 + (e & 1);
            if (i < j && j < n) {
              orow[(i * (2 * n - i - 1) >> 1) + (j - i - 1)] = __float2bfloat16(acc[mt][nt][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // the output tile is whole

    // Coalesced store: 16-byte chunks where the tile starts on a 16-byte
    // boundary in device memory, then a scalar tail.
    bf16* dst = out + b0 * pairs;
    const int total = nb * pairs;
    int done = 0;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      const int vecs = total / 8;
      for (int v = threadIdx.x; v < vecs; v += kThreads) {
        reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(outs)[v];
      }
      done = vecs * 8;
    }
    for (int e = done + threadIdx.x; e < total; e += kThreads) dst[e] = outs[e];
  }
  cp_async_wait<0>();
}

template <int RB>
int launch(const void* x, void* out, long long batch, int n, int d, cudaStream_t stream) {
  const Plan plan = make_plan(n, d);
  if (plan.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(interaction_mma_kernel<RB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, interaction_mma_kernel<RB>,
                                                        kThreads, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (batch + plan.bt - 1) / plan.bt;
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < full ? tiles : full);
  interaction_mma_kernel<RB><<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), batch, n, d, plan.bt,
      plan.stage_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface of rsdl_interaction_fwd; dtype must be 1 (bfloat16).
// Returns 0 or a cudaError_t code; a shape, dtype or alignment the route
// does not take is cudaErrorInvalidValue.
extern "C" int rsdl_interaction_mma(const void* x, void* out, long long batch, int n, int d,
                                    int dtype, void* stream) {
  if (dtype != 1 || batch < 0 || n < 2 || n > kMaxN || d < 16 || d > kMaxD || d % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 15) / 16) {
    case 1:
      return launch<1>(x, out, batch, n, d, s);
    case 2:
      return launch<2>(x, out, batch, n, d, s);
    case 3:
      return launch<3>(x, out, batch, n, d, s);
    default:
      return launch<4>(x, out, batch, n, d, s);
  }
}
