// Flash attention forward on Hopper's warpgroup tensor cores (K2, the
// "wgmma" route): the function of flash_fwd_mma.cu, with its numerics, for
// bf16 heads long enough to fill 128-row tiles.
//
//   q, k, v  [b, t, h, hd]  bfloat16, strided (the views of one packed
//                           [b, t, 3, h, hd] projection, read in place),
//                           last dim contiguous, 16-byte aligned pointers
//                           and strides, hd 16, 32, 64 or 128
//   out      [b, t, h, hd]  bfloat16, out = acc / max(l, 1e-30) rounded once
//   m, l     [b, h, t]      float32: row max of the scaled, masked scores and
//                           sum of exp(s - m)
//
// s = (q . k) / sqrt(hd) in float32 (scaled after the dot); masked scores
// (k_pos >= t, or q_pos < k_pos when causal) are NEG_INF = -1e30, and a row
// whose max is still NEG_INF gets probabilities of 0. P enters the tensor
// cores as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), because the
// Pallas kernel takes P . V in float32; l sums the unrounded float32 p.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_kernel` (a Pallas kernel over a (b*h, t/bq, t/bk) grid whose kv
// axis ran in order, carrying m, l and the accumulator in VMEM scratch).
//
// What bounds it: operations. At [2, 4096, 8, 64] one call needs 68.7
// GFLOP (34.4 causal; 103 and 51.5 with P's lo term) against 33.6 MB of
// inputs and outputs: 69 us at the 989 TFLOP/s bf16 peak, which only wgmma
// reaches.
//
// What the design does about it (warp specialisation, as the hopper-kernels
// guide sets out):
//   * one block per (b*h, 128 query rows), 3 warpgroups: a producer, whose
//     one thread issues every TMA load, and two consumers of 64 rows each;
//     setmaxnreg moves registers from the producer (40) to them (232);
//   * tiles arrive by TMA from 4-D tensor maps over the strided views (no
//     copy, rows past t zero-filled), swizzled to the row's bytes: the
//     block's Q once, then K and V tiles of kKeys keys through a ring of
//     kStages stages on "full" (TMA bytes) and "empty" (consumer warps)
//     mbarriers;
//   * S = Q K^T is wgmma with Q and K from shared memory (K-major); the
//     online softmax runs in the accumulator's layout (each row's max among
//     the 4 threads that hold it; masks only on ragged and causal-diagonal
//     tiles); O += P V is wgmma with P from registers (the S accumulator,
//     split into hi and lo, is the next product's A operand) and V from
//     shared memory (MN-major), two wgmma a k-step into one accumulator;
//   * each warpgroup takes its tiles in turn (S, softmax, P V) and the two
//     interleave on the tensor cores by themselves: issuing a tile's S
//     ahead of the last tile's P V (FlashAttention-3's intra-warpgroup
//     overlap) and a third stage both measured slower (PERF.md); the
//     softmax is straight-line code, selects and no branch an element,
//     exp as ex2.approx of (s - m) log2(e);
//   * fully masked causal tiles are never loaded, a consumer skips a tile
//     masked for all its rows, causal query tiles go heaviest first;
//   * out leaves through shared memory (the warpgroup's Q rows) by a TMA
//     store, m and l as float32 rows.

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_wgmma;
using rsdl_mma::split_bf16;
using rsdl_mma::smem_u32;

constexpr int kRows = 128;     // query rows a block: two consumer warpgroups of 64
constexpr int kStages = 2;     // K and V tiles in flight
constexpr int kThreads = 384;  // producer warpgroup, then the two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Registers a thread at launch that setmaxnreg redistributes: 384 threads
// of 168 give (168 - 40) x 128 to the consumers' (232 - 168) x 256.
constexpr int kLaunchRegs = 168;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kKeys = HD <= 64 ? 128 : 64;  // keys a K or V tile
  static constexpr int kCols = HD < 64 ? HD : 64;    // columns a TMA box
  static constexpr int kSpan = kCols * 2;            // bytes a box row: 32, 64, 128
  static constexpr int kParts = HD / kCols;          // boxes across a row: 1 or 2
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;    // one of K or V
  static constexpr int kSmem = kQBytes + kStages * 2 * kKVBytes;
};

struct Params {
  float* m;
  float* l;
  int bh_total;  // b * h; blocks = bh_total * q_tiles < 2^31
  int t, h, causal;
  int q_tiles;  // blocks along the sequence
  float scale;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__device__ __forceinline__ void wgmma_s(float (&s)[Tile<HD>::kKeys / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (Tile<HD>::kKeys == 128) {
    wgmma_ss_n128(s, da, db, acc);
  } else {
    wgmma_ss_n64(s, da, db, acc);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 16) {
    wgmma_rs_n16(o, a, db);
  } else if constexpr (HD == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// S = Q K^T of a warpgroup's 64 rows against a K tile: hd / 16 k-steps, 32
// bytes along the rows each (the second 64 columns at hd 128 in the second
// box tile).
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[Tile<HD>::kKeys / 2], uint32_t q_wg, uint32_t k_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t c = (kk * 16) / T::kCols, along = (kk * 16) % T::kCols * 2;
    wgmma_s<HD>(s, desc<T::kSpan>(q_wg + c * kRows * T::kSpan + along, 16, 8 * T::kSpan),
                desc<T::kSpan>(k_tile + c * T::kKeys * T::kSpan + along, 16, 8 * T::kSpan), kk > 0);
  }
}

// O += P V, P as two bf16 terms: V's k-step kk is its 16 key rows from 16kk.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&ph)[Tile<HD>::kKeys / 16][4],
                                         const uint32_t (&pl)[Tile<HD>::kKeys / 16][4], uint32_t v_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < T::kKeys / 16; ++kk) {
    const uint64_t db = desc<T::kSpan>(v_tile + kk * 16 * T::kSpan, T::kKeys * T::kSpan, 8 * T::kSpan);
    wgmma_pv<HD>(o, ph[kk], db);
    wgmma_pv<HD>(o, pl[kk], db);
  }
}

// The online softmax of one tile's scores, in the accumulator's layout:
// scale; mask on ragged and causal-diagonal tiles (keys from s0; this
// thread's rows row0 and row0 + 8, its warp's first warp_row); each row's
// max among the 4 threads that hold it; p = exp(s - m) in place; m and this
// lane's part of l updated; alpha, the factor of the sums so far, returned.
template <int KEYS>
__device__ __forceinline__ void softmax_tile(float (&s)[KEYS / 2], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int s0, int row0, int warp_row, int c2, int t,
                                             int causal, float scale) {
  // Straight-line code a tile: selects, no branch an element.
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) s[i] *= scale;
  if (s0 + KEYS > t || (causal && s0 + KEYS - 1 > warp_row)) {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int key = s0 + (i / 4) * 8 + c2 + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      s[i] = key >= t || (causal && key > row) ? kNegInf : s[i];
    }
  }
  float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
  float m_l2[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_r[r], tmax[r]);
    alpha[r] = fast_exp2((m_r[r] - m_new) * kLog2e);
    live[r] = m_new > kNegInf * 0.5f;
    m_l2[r] = m_new * kLog2e;
    m_r[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float pv = fast_exp2(fmaf(s[i], kLog2e, -m_l2[r]));
    s[i] = live[r] ? pv : 0.f;
    psum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
}

// P's A fragments of the KEYS / 16 k-steps, hi and lo, from the
// accumulator: k-step kk is columns 16kk .. 16kk + 15, s[8kk .. 8kk + 7].
template <int KEYS>
__device__ __forceinline__ void split_p(const float (&s)[KEYS / 2], uint32_t (&ph)[KEYS / 16][4],
                                        uint32_t (&pl)[KEYS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph[kk][j], pl[kk][j]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                           const Params p) {
  using T = Tile<HD>;
  constexpr int kKeys = T::kKeys, kSpan = T::kSpan, kParts = T::kParts;
  extern __shared__ unsigned char smem_raw[];
  // Tiles at 1024-byte boundaries, where the 128-byte swizzle repeats.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // Q: kParts tiles [kRows][kSpan]
  const uint32_t kv_s = q_s + T::kQBytes;       // stage i: K, then V, kParts tiles [kKeys][kSpan] each
  const uint32_t q_full = kv_s + kStages * 2 * T::kKVBytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  // 32-bit division: a 64-bit one is a call, and spills around it.
  const int bh = static_cast<int>(blockIdx.x) % p.bh_total;
  const int tile_i = static_cast<int>(blockIdx.x) / p.bh_total;
  // Causal: the last query tiles see the most keys; launch them first.
  const int q0 = (p.causal ? p.q_tiles - 1 - tile_i : tile_i) * kRows;
  const int bi = bh / p.h, hi = bh % p.h;
  // Keys past the block's last query are masked for all of its rows.
  const int s_hi = p.causal ? min(p.t, q0 + kRows) : p.t;
  const int n_tiles = (s_hi + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);  // each warp of the two consumers
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer: one thread keeps the ring full.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < kParts; ++c) tma_load(q_s + c * kRows * kSpan, &tq, q_full, c * T::kCols, hi, q0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        // The stage's previous tile (it - kStages) released by every
        // consumer warp; the first round passes at once.
        mbar_wait(empty0 + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t ks = kv_s + st * 2 * T::kKVBytes;
        mbar_expect_tx(full, 2 * T::kKVBytes);
        for (int c = 0; c < kParts; ++c) {
          tma_load(ks + c * kKeys * kSpan, &tk, full, c * T::kCols, hi, it * kKeys, bi);
          tma_load(ks + T::kKVBytes + c * kKeys * kSpan, &tv, full, c * T::kCols, hi, it * kKeys, bi);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_base = q0 + cw * 64;              // the warpgroup's first row
    const int row0 = row_base + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const int c2 = 2 * (lane & 3);
    const uint32_t q_wg = q_s + cw * 64 * kSpan;  // its 64 rows of each Q tile

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};  // this lane's part of the row sums

    // The stage a tile lies in, its K and V.
    const auto k_tile = [&](int it) { return kv_s + (it % kStages) * 2 * T::kKVBytes; };
    const auto v_tile = [&](int it) { return k_tile(it) + T::kKVBytes; };
    const auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty0 + 8 * (it % kStages));
    };
    const auto wait_tile = [&](int it) { mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1); };
    // Tiles this warpgroup computes: causal, none wholly past its last row.
    const int n_wg = p.causal ? min(n_tiles, (row_base + 63) / kKeys + 1) : n_tiles;
    const int warp_row = row_base + warp * 16;

    // Each tile in turn: S, its softmax, P V; then the stage is released.
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_wg; ++it) {
      float s[kKeys / 2], alpha[2];
      uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];  // P's A fragments, hi and lo
      wait_tile(it);
      wgmma_fence();
      issue_s<HD>(s, q_wg, k_tile(it));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<kKeys>(s, m_r, l_r, alpha, it * kKeys, row0, warp_row, c2, p.t, p.causal, p.scale);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      split_p<kKeys>(s, ph, pl);
      wgmma_fence();
      issue_pv<HD>(o, ph, pl, v_tile(it));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      release(it);  // this warp has read the tile's K and V
    }
    // Tiles masked for every row of this warpgroup (causal, the diagonal's
    // second half at 64-key tiles): released unread, in order.
    for (int it = n_wg; it < n_tiles; ++it) {
      wait_tile(it);
      release(it);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    // out = acc / max(l, 1e-30): divide, as the Pallas kernel does, then
    // round once, into the warpgroup's Q rows (read for the last time by
    // the last S product) in the layout the TMA store reads.
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = i * 8 + c2;
      const uint32_t tile = q_wg + (col / T::kCols) * kRows * kSpan;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float denom = fmaxf(l_r[half], 1e-30f);
        const uint32_t off = (warp * 16 + lane / 4 + half * 8) * kSpan + (col % T::kCols) * 2;
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(o[4 * i + 2 * half] / denom, o[4 * i + 2 * half + 1] / denom);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + swizzle<kSpan>(off)),
                     "r"(*reinterpret_cast<const uint32_t*>(&val))
                     : "memory");
      }
    }
    fence_async_shared();
    named_barrier(1 + cw, 128);
    if (tid == 0) {
      for (int c = 0; c < kParts; ++c) tma_store(&to, q_wg + c * kRows * kSpan, c * T::kCols, hi, row_base, bi);
      tma_store_drain();
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row < p.t) {
          p.m[static_cast<long long>(bh) * p.t + row] = m_r[r];
          p.l[static_cast<long long>(bh) * p.t + row] = l_r[r];
        }
      }
    }
  }
}

// Once a device and head dim: the register count setmaxnreg's amounts
// balance (else a consumer would wait for registers that never come) and
// the dynamic shared memory. Returns 0 or a cudaError_t code.
template <int HD>
int prepare(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static int ready[kMaxDevices] = {};  // 0: not yet; 1: ready; else -error
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> hold(mu);
  if (ready[dev] == 0) {
    const auto kernel = flash_fwd_wgmma_kernel<HD>;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs != kLaunchRegs) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    ready[dev] = err == cudaSuccess ? 1 : -static_cast<int>(err);
  }
  return ready[dev] == 1 ? 0 : -ready[dev];
}

ViewMaps view_maps;

template <int HD>
int launch(const void* const* ptrs, const long long* strides, int b, Params p, cudaStream_t stream) {
  using T = Tile<HD>;
  const size_t smem = T::kSmem + 8 * (1 + 2 * kStages) + 1024;  // tiles, barriers, alignment
  int rc = prepare<HD>(smem);
  if (rc != 0) return rc;
  CUtensorMap maps[4];
  const int rows[4] = {kRows, T::kKeys, T::kKeys, 64};  // q, k, v, out (a warpgroup's rows)
  for (int i = 0; i < 4; ++i) {
    rc = view_maps.get(&maps[i], ptrs[i], b, p.t, p.h, HD, strides[3 * i], strides[3 * i + 1], strides[3 * i + 2],
                       T::kCols, rows[i]);
    if (rc != 0) return rc;
  }
  p.q_tiles = (p.t + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(p.bh_total) * p.q_tiles;
  flash_fwd_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                                          maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (b, t, h) of q, k, v and out in that order.
// dtype must be 1 (bfloat16). Returns 0 or a cudaError_t code; a shape,
// dtype or alignment the route does not take is cudaErrorInvalidValue.
extern "C" int rsdl_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                                    const long long* strides, int b, int t, int h, int hd, int causal, int dtype,
                                    void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  if (dtype != 1 || b < 0 || t < 0 || h < 0 || (hd != 16 && hd != 32 && hd != 64 && hd != 128) ||
      !vectorizable(sizeof(__nv_bfloat16), hd, ptrs, 4, strides, 12))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * t == 0) return 0;
  if (static_cast<long long>(b) * h * ((t + kRows - 1) / kRows) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.m = m;
  p.l = l;
  p.bh_total = b * h;
  p.t = t;
  p.h = h;
  p.causal = causal != 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(ptrs, strides, b, p, s);
    case 32:
      return launch<32>(ptrs, strides, b, p, s);
    case 64:
      return launch<64>(ptrs, strides, b, p, s);
    default:
      return launch<128>(ptrs, strides, b, p, s);
  }
}
