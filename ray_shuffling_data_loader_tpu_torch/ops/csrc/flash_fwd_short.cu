// Flash attention forward for short bf16 heads on Hopper's tensor cores
// (the "short" route): out and the float32 row statistics m and l in one
// launch, for heads of fewer than 32 tokens and a head dim of 8 or 16,
// read from the packed projection.
//
//   qkv   [b, t, 3, h, hd]  bfloat16; each batch row contiguous, rows
//                           sb_qkv elements apart (q, k, v along dim 2)
//   out   [b, t, h, hd]     bfloat16, contiguous
//   m, l  [b, h, t]         float32, contiguous: the row max of the scaled,
//                           masked scores and sum(exp(s - m))
//
// s = (q . k) / sqrt(hd) in float32, keys past t and, when causal, keys
// after the query masked; a row with no key left gets m = NEG_INF and
// probabilities of 0. out = (P . V) / max(l, 1e-30) with P . V in float32,
// rounded once to bf16: the function of flash_fwd.cu's K2.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_kernel` at the TabTransformer's shape, where the Pallas grid pads
// each 19-token head to its blocks.
//
// What bounds it: bytes. At the TabTransformer's [65536, 19, 4, 8] it reads
// q, k and v (239.1 MB) and writes out (79.7 MB), m and l (2 x 19.9 MB):
// 358.6 MB, 107 us at 3.35 TB/s, against 3.0 GFLOP of products (3 us at
// the bf16 tensor-core peak).
//
// What the design does about it:
//   * One read of every input and one write of every output, in whole
//     batch rows (flash_short.cuh): a block step takes max(1, 8 / h) of
//     them, each one 1-D bulk copy (TMA) on the stage's mbarrier, one step
//     ahead, on a persistent grid; a step's out rows leave as one bulk
//     store, and so do its m and l rows where h * t * 4 is a multiple of
//     16 (else per-thread stores). The staging alone runs at 0.83 of the
//     bound (tools/torch_port_short_fwd_variants.py).
//   * Past the staging, issue is the limit: in the bytes bound's time the
//     card issues about 430 warp instructions a head, and a head's code is
//     about 900. So a warp takes two heads a block step (8 heads over 4
//     warps), the step and head loops divide by nothing, rows that are all
//     padding skip the softmax, and two stages (not four) leave the shared
//     memory for a seventh block an SM: each measured faster in the
//     variants tool.
//   * One warp per head, its operands read by ldmatrix straight from the
//     staged row (a head's token rows 3 * h * hd elements apart), with no
//     copy into tiles; rows past t read token t - 1, whose scores are
//     masked (keys) or whose results are dropped (queries).
//   * Both products on tensor cores (mma.sync m16n8k16 bf16 -> float32):
//     S = Q K^T with queries in m-tiles of 16 and keys in NQ = ceil(t / 8)
//     n-tiles of 8 (a template parameter), hd 8 padded to 16 with zeros
//     in the contraction; O = P V in k-steps of 16 keys (keys padded to
//     32), P the A operand straight from S's accumulators. At t < 32 one
//     tile holds every key, so the row's max and sum stay in registers
//     and nothing is rescaled.
//   * P goes to the tensor cores as two bf16 terms, hi and lo
//     (flash_mma.cuh, split_bf16): about 16 significant bits, where one
//     bf16 term errs by up to 2^-9 and the reference's P . V is float32.

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_short.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_mma;
using namespace rsdl_short;
using bf16 = __nv_bfloat16;

constexpr int kStepHeads = 8;  // heads per block step: two a warp
constexpr int kStages = 2;     // block steps of input rows in flight

struct Params {
  const bf16* qkv;
  bf16* out;
  float* m;
  float* l;
  long long sb_qkv;  // batch stride of qkv, elements
  int b, t, h, causal;
  int rows;        // batch rows per block step
  int chunks;      // steps: ceil(b / rows)
  int stats_bulk;  // m and l rows stored in bulk (h * t * 4 a multiple of 16)
  float scale;     // 1 / sqrt(hd)
};

// Shared-memory layout, in bytes from the start; every region 16-byte aligned.
struct Layout {
  int stage0, stage_bytes;  // kStages stages of input rows, one after the other
  int outs, outs_bytes;     // two steps' outputs: out rows, then m and l rows
  int st_m, st_l;           // the m and l rows, from an outputs buffer's start
  int total;
};

// The stages' mbarriers come first, at offset 0.
template <int HD>
__host__ __device__ inline Layout make_layout(int rows, int t, int h) {
  Layout s;
  s.stage_bytes = rows * t * 3 * h * HD * 2;
  s.stage0 = 16 * kStages;
  s.outs = s.stage0 + kStages * s.stage_bytes;
  s.st_m = rows * t * h * HD * 2;
  s.st_l = s.st_m + round16(rows * h * t * 4);
  s.outs_bytes = s.st_l + round16(rows * h * t * 4);
  s.total = s.outs + 2 * s.outs_bytes;
  return s;
}

// NQ: key n-tiles of 8 of S, ceil(t / 8); MQ: query m-tiles of 16, and key
// k-steps of 16 of P V, ceil(t / 16).
template <int HD, int NQ>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_fwd_short_kernel(const Params p) {
  constexpr int NT = HD / 8;  // n-tiles of O over the head dim
  constexpr int MQ = (NQ + 1) / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = p.t, h = p.h, rows = p.rows;
  const int warps = blockDim.x / 32;
  const Layout lay = make_layout<HD>(rows, t, h);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const float sc = p.scale * kLog2e;
  const int qkv_row = t * 3 * h * HD * 2;  // bytes of a batch row
  const int out_row = t * h * HD * 2;
  const int stat_row = h * t * 4;
  const int tok = 3 * h * HD;  // elements between a head's token rows in qkv
  const uint32_t bars = smem_u32(smem);
  const float kInf = __int_as_float(0x7f800000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 16 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 asks for the input rows of block step `ch` in stage `s`.
  auto load = [&](int s, int ch) {
    const int row0 = ch * rows;
    const int nrows = min(rows, p.b - row0);
    const uint32_t bar = bars + 16 * s;
    const uint32_t st = smem_u32(smem + lay.stage0 + s * lay.stage_bytes);
    mbar_expect_tx(bar, nrows * qkv_row);
    for (int r = 0; r < nrows; ++r) {
      const long long row = row0 + r;
      bulk_load(st + r * qkv_row, p.qkv + row * p.sb_qkv, qkv_row, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int ch = blockIdx.x + s * gridDim.x;
      if (ch < p.chunks) load(s, ch);
    }
  }

  // A warp's heads: hx = r * h + head, every warps-th of a step.
  const int r_first = warp / h, head_first = warp % h, r_step = warps / h, head_step = warps % h;
  for (int it = 0, ch = blockIdx.x, s = 0, parity = 0; ch < p.chunks; ++it, ch += gridDim.x) {
    mbar_wait(bars + 16 * s, parity);  // this step's rows have landed (stage s, its parity-th fill)
    const bf16* st = reinterpret_cast<const bf16*>(smem + lay.stage0 + s * lay.stage_bytes);
    // Two steps' outputs alternate: the last step's may still be leaving.
    unsigned char* outs = smem + lay.outs + (it & 1) * lay.outs_bytes;
    bf16* ot = reinterpret_cast<bf16*>(outs);
    float* mt = reinterpret_cast<float*>(outs + lay.st_m);
    float* lt = reinterpret_cast<float*>(outs + lay.st_l);
    const int row0 = ch * rows;
    const int nrows = min(rows, p.b - row0);
    for (int hx = warp, r = r_first, head = head_first; hx < nrows * h; hx += warps) {
      const bf16* hq = st + r * (qkv_row / 2) + head * HD;  // the head's q of token 0
      const bf16* hk = hq + h * HD;
      const bf16* hv = hq + 2 * h * HD;
      // A fragments of Q (queries x hd) per query m-tile, B fragments of
      // K^T (hd x keys) per key n-tile, and of V (keys x hd) per key k-step
      // of 16; hd 8 leaves the upper half of the contraction over hd zero.
      uint32_t qa[2][4], kb[4][2], vb[2][NT][2];
      if constexpr (HD == 8) {
        const int row = min(lane, t - 1) * tok;
        uint32_t x[4];
        ldmatrix_x4(x, smem_u32(hq + row));
#pragma unroll
        for (int mq = 0; mq < 2; ++mq) {
          qa[mq][0] = x[2 * mq];
          qa[mq][1] = x[2 * mq + 1];
          qa[mq][2] = qa[mq][3] = 0u;
        }
        ldmatrix_x4(x, smem_u32(hk + row));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          kb[nj][0] = x[nj];
          kb[nj][1] = 0u;
        }
        ldmatrix_x4_trans(x, smem_u32(hv + row));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          vb[kk][0][0] = x[2 * kk];
          vb[kk][0][1] = x[2 * kk + 1];
        }
      } else {
#pragma unroll
        for (int mq = 0; mq < 2; ++mq) {
          if (mq >= MQ) continue;
          // Q and V: rows 16 mq + (lane & 7) + 8 ((lane >> 3) & 1), column
          // 8 (lane >> 4); K: rows 16 mq + (lane & 7) + 8 (lane >> 4),
          // column 8 ((lane >> 3) & 1).
          const int ra = min(16 * mq + (lane & 7) + ((lane >> 3) & 1) * 8, t - 1) * tok + (lane >> 4) * 8;
          const int rb = min(16 * mq + (lane & 7) + (lane >> 4) * 8, t - 1) * tok + ((lane >> 3) & 1) * 8;
          uint32_t x[4];
          ldmatrix_x4(qa[mq], smem_u32(hq + ra));
          ldmatrix_x4(x, smem_u32(hk + rb));
          kb[2 * mq][0] = x[0];
          kb[2 * mq][1] = x[1];
          kb[2 * mq + 1][0] = x[2];
          kb[2 * mq + 1][1] = x[3];
          ldmatrix_x4_trans(x, smem_u32(hv + ra));
          vb[mq][0][0] = x[0];
          vb[mq][0][1] = x[1];
          vb[mq][1][0] = x[2];
          vb[mq][1][1] = x[3];
        }
      }

      // S = Q K^T, [queries] x [keys]; n-tiles past t are skipped and stay
      // 0, so P is 0 there.
      float sa[2][4][4];
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[mq][nj][e] = 0.f;
          if (mq < MQ && nj < NQ) mma_bf16(sa[mq][nj], qa[mq], kb[nj][0], kb[nj][1]);
        }
      }

      // The softmax of this lane's rows 16 mq + g + 8 half: keys past
      // `last` (t - 1, or the query when causal) to -inf, the row's max and
      // sum over its 4 lanes, P in place. Rows at or past 8 NQ are all
      // padding: skipped here and in the output (their S is no P, and
      // what P V makes of it is never stored).
      float mrow[2][2], lrow[2][2];
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
        if (mq >= MQ) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (16 * mq + 8 * half >= 8 * NQ) continue;
          const int query = 16 * mq + g + 8 * half;
          const int last = (p.causal ? min(query, t - 1) : t - 1) - c2;  // against key - c2
          float mx = -kInf;
#pragma unroll
          for (int nj = 0; nj < NQ; ++nj) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float& x = sa[mq][nj][2 * half + u];
              if (8 * nj + u > last) x = -kInf;
              mx = fmaxf(mx, x);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float shift = mx == -kInf ? 0.f : mx * sc;  // a row with no key: P = 0
          float sum = 0.f;
#pragma unroll
          for (int nj = 0; nj < NQ; ++nj) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float& x = sa[mq][nj][2 * half + u];
              x = fast_exp2(fmaf(x, sc, -shift));
              sum += x;
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          mrow[mq][half] = mx;
          lrow[mq][half] = sum;
        }
      }

      // O = P V, P's A operand (hi and lo terms) from S's accumulators.
      float o[2][NT][4];
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mq][nt][e] = 0.f;
        }
        if (mq >= MQ) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk >= MQ) continue;
          uint32_t ph[4], pl[4];
          a_from_c(sa[mq][2 * kk], sa[mq][2 * kk + 1], ph, pl);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(o[mq][nt], ph, vb[kk][nt][0], vb[kk][nt][1]);
            mma_bf16(o[mq][nt], pl, vb[kk][nt][0], vb[kk][nt][1]);
          }
        }
      }

      // out = O / max(l, 1e-30), as O times its reciprocal, into the step's
      // out rows; m (natural units) and l from one lane of the row's four.
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
        if (mq >= MQ) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int query = 16 * mq + g + 8 * half;
          if (16 * mq + 8 * half >= 8 * NQ || query >= t) continue;
          const float rl = 1.f / fmaxf(lrow[mq][half], 1e-30f);
          bf16* dst = ot + ((r * t + query) * h + head) * HD + c2;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            store_bf16x2(dst + nt * 8, o[mq][nt][2 * half] * rl, o[mq][nt][2 * half + 1] * rl);
          }
          if ((lane & 3) == 0) {
            const float mv = mrow[mq][half] == -kInf ? kNegInf : mrow[mq][half] * p.scale;
            const int si = (r * h + head) * t + query;
            if (p.stats_bulk) {
              mt[si] = mv;
              lt[si] = lrow[mq][half];
            } else {
              const long long gi = static_cast<long long>(row0) * h * t + si;
              p.m[gi] = mv;
              p.l[gi] = lrow[mq][half];
            }
          }
        }
      }
      head += head_step;
      r += r_step;
      if (head >= h) {
        head -= h;
        ++r;
      }
    }
    // The step's outputs are whole; the bulk store reads them through the
    // async proxy. Thread 0 first waits until the last step's store has
    // read its buffer, which the next step rewrites.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // and this stage's rows are read: it may be refilled
    if (threadIdx.x == 0) {
      const uint32_t src = smem_u32(outs);
      const long long stat0 = static_cast<long long>(row0) * h * t;
      bulk_store(p.out + static_cast<long long>(row0) * t * h * HD, src, nrows * out_row);
      if (p.stats_bulk) {
        bulk_store(p.m + stat0, src + lay.st_m, nrows * stat_row);
        bulk_store(p.l + stat0, src + lay.st_l, nrows * stat_row);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      const int ahead = ch + kStages * gridDim.x;
      if (ahead < p.chunks) load(s, ahead);
    }
    if (++s == kStages) {
      s = 0;
      parity ^= 1;
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int HD, int NQ>
int launch(Params p, int sms, cudaStream_t stream) {
  p.rows = step_rows(p.h, kStepHeads);
  p.chunks = (p.b + p.rows - 1) / p.rows;
  const int threads = step_warps(p.rows, p.h) * 32;
  const size_t smem = make_layout<HD>(p.rows, p.t, p.h).total;
  int grid = 0;
  const int err = persistent_grid(flash_fwd_short_kernel<HD, NQ>, threads, smem, p.chunks, sms, &grid);
  if (err != 0) return err;
  flash_fwd_short_kernel<HD, NQ><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sb_qkv is in elements. Returns 0 or a cudaError_t code; a shape, stride
// or alignment the route does not take is cudaErrorInvalidValue: hd 8 or
// 16, 1 <= t < 32, h * hd <= 128, 16-byte aligned qkv, out and batch
// stride of qkv.
extern "C" int rsdl_flash_fwd_short(const void* qkv, void* out, float* m, float* l, long long sb_qkv, int b,
                                    int t, int h, int hd, int causal, void* stream) {
  if (b < 0 || t < 1 || t >= kTokens || h < 1 || (hd != 8 && hd != 16) || h * hd > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(qkv) || !aligned16(out) || sb_qkv % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.qkv = static_cast<const bf16*>(qkv);
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.l = l;
  p.sb_qkv = sb_qkv;
  p.b = b;
  p.t = t;
  p.h = h;
  p.causal = causal != 0;
  p.stats_bulk = (h * t) % 4 == 0 && aligned16(m) && aligned16(l);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((t + 7) / 8 + (hd == 16 ? 4 : 0)) {
    case 1: return launch<8, 1>(p, sms, s);
    case 2: return launch<8, 2>(p, sms, s);
    case 3: return launch<8, 3>(p, sms, s);
    case 4: return launch<8, 4>(p, sms, s);
    case 5: return launch<16, 1>(p, sms, s);
    case 6: return launch<16, 2>(p, sms, s);
    case 7: return launch<16, 3>(p, sms, s);
    default: return launch<16, 4>(p, sms, s);
  }
}
