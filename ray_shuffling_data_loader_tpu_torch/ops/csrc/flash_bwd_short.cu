// Flash attention backward for short bf16 heads on Hopper's tensor cores
// (the "short" route): dQ, dK and dV in one launch, for heads of fewer than
// 32 tokens and a head dim of 8 or 16, read from and written to packed
// projections.
//
//   qkv   [b, t, 3, h, hd]  bfloat16; each batch row contiguous, rows
//                           sb_qkv elements apart (q, k, v along dim 2)
//   out   [b, t, h, hd]     bfloat16, the forward's output; each batch row
//   dO    [b, t, h, hd]     contiguous, rows sb_out / sb_dout apart
//   m, l  [b, h, t]         float32, the forward's row statistics
//   dqkv  [b, t, 3, h, hd]  bfloat16, packed like qkv (sb_dqkv apart)
//
// P = exp(s - m) / max(l, 1e-30), 0 where m <= NEG_INF / 2, with
// s = (q . k) / sqrt(hd) and the causal mask q_pos >= k_pos, as the Pallas
// kernels' `_bwd_probs` recomputes it; D = rowsum(dO * out) in float32,
// here in the kernel; dP = dO . v, dS = P * (dP - D), and
//
//   dv_j = sum_i P_ij dO_i   dk_j = sum_i dS_ij q_i / sqrt(hd)   dq_i = sum_j dS_ij k_j / sqrt(hd)
//
// in float32, each rounded once to bf16: the function of flash_bwd.cu's
// K3 and K4 together, with row_dot's D.
//
// Replaces the TPU kernels ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel` at the TabTransformer's
// shape, where the Pallas grid pads each 19-token head to its blocks.
//
// What bounds it: bytes. At the TabTransformer's [65536, 19, 4, 8] it reads
// q, k, v, dO and out (5 x 79.7 MB) and m and l (2 x 19.9 MB) and writes
// dQ, dK and dV (3 x 79.7 MB): 677 MB, 202 us at 3.35 TB/s, against
// 10.6 GFLOP of products (11 us at the bf16 tensor-core peak). Issue is
// the second limit: at that bound the card has about 700 warp instructions
// to spend on each head.
//
// What the design does about it:
//   * One read of every input and one write of every output, in whole
//     batch rows: a block step takes rows = max(1, 4 / h) of them
//     (h * hd <= 128), each input row one contiguous span that one thread
//     asks for with a 1-D bulk copy (TMA) on the stage's mbarrier, up to 4
//     steps ahead; the gradients leave the same way, one bulk store per
//     row. A persistent grid walks the batch rows.
//   * One warp per head. Each lane copies its token's q, k, v and dO rows
//     into the warp's [32 tokens][hd] tiles (rows past t stay zero; hd-16
//     rows swizzled so that ldmatrix reads them without bank conflicts),
//     and takes its token's D = dO . out in float32 from the rows it holds:
//     no separate pass.
//   * Every pair once, on tensor cores (mma.sync m16n8k16 bf16 -> float32),
//     keys padded to 32, queries to a multiple of 8 (NQ tiles, a template
//     parameter), hd 8 padded to 16 in the contractions over hd; one m-tile
//     of 16 keys at a time:
//
//       S^T = K Q^T, dP^T = V dO^T  ->  P^T, dS^T in registers
//       dV = P^T dO, dK = dS^T Q    (P^T, dS^T as A operands from the accumulators)
//       dQ += dS K                  (dS's A operand: dS^T's 8x8 blocks, movmatrix.trans)
//
//     P and dS go to the tensor cores as two bf16 terms, hi and lo, as in
//     the tensor-core route (flash_mma.cuh, split_bf16): about 16
//     significant bits where one bf16 term errs by up to 2^-9.

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_short.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_mma;
using namespace rsdl_short;
using bf16 = __nv_bfloat16;

constexpr int kTargetHeads = 4;  // heads per block step: rows = max(1, 4 / h)
constexpr int kMaxStages = 4;    // block steps of input rows in flight
constexpr int kSmemCap = 200 * 1024;  // fewer stages where 4 would not fit
constexpr float kMasked = 1e30f;  // a masked row's m * log2(e): exp2 gives 0

struct Params {
  const bf16* qkv;
  const bf16* out;
  const bf16* dout;
  const float* m;
  const float* l;
  bf16* dqkv;
  long long sb_qkv, sb_out, sb_dout, sb_dqkv;  // batch strides, elements
  int b, t, h, causal;
  int rows;        // batch rows per block step
  int chunks;      // steps: ceil(b / rows)
  int stages;      // steps of input rows in flight, 2 .. kMaxStages
  int stats_bulk;  // m and l rows copied in bulk (h * t * 4 a multiple of 16)
  float scale;     // 1 / sqrt(hd)
};

// Shared-memory layout, in bytes from the start; every region 16-byte aligned.
struct Layout {
  int st_qkv, st_do, st_out, st_m, st_l;  // a stage's input rows, from its start
  int stage0, stage_bytes;  // `stages` stages, one after the other
  int outs, outs_bytes;     // two steps' gradients, packed as dqkv rows
  int warp, warp_bytes;     // per warp: q, k, v, dO tiles [32][hd], 3 x 32 statistics
  int total;
};

// The stages' mbarriers come first, at offset 0.
template <int HD>
__host__ __device__ inline Layout make_layout(int rows, int t, int h, int warps, int stages) {
  Layout s;
  s.st_qkv = 0;
  s.st_do = rows * t * 3 * h * HD * 2;
  s.st_out = s.st_do + rows * t * h * HD * 2;
  s.st_m = s.st_out + rows * t * h * HD * 2;
  s.st_l = s.st_m + round16(rows * h * t * 4);
  s.stage_bytes = s.st_l + round16(rows * h * t * 4);
  s.stage0 = 16 * kMaxStages;
  s.outs = s.stage0 + stages * s.stage_bytes;
  s.outs_bytes = s.st_do;
  s.warp = s.outs + 2 * s.outs_bytes;
  s.warp_bytes = 4 * kTokens * HD * 2 + 3 * kTokens * 4;
  s.total = s.warp + warps * s.warp_bytes;
  return s;
}

// Element offset of (row, col) in a [32][HD] tile. hd-16 rows swap their
// two 16-byte halves on every other group of 4 rows, so the 8 rows of one
// ldmatrix phase fall on 8 different bank groups.
template <int HD>
__device__ __forceinline__ int tile_off(int row, int col) {
  if constexpr (HD == 16) {
    return row * 16 + ((((col >> 3) ^ (row >> 2)) & 1) << 3) + (col & 7);
  } else {
    return row * 8 + col;
  }
}

// The transpose of an 8x8 bf16 matrix held as one register per lane in
// the mma fragment layout (lane l: row l / 4, columns 2 (l % 4) .. + 1).
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The NQ: query n-tiles of 8, ceil(t / 8); MK: key m-tiles (and query
// m-tiles of dQ) of 16, ceil(t / 16).
template <int HD, int NQ>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_bwd_short_kernel(const Params p) {
  constexpr int C = HD / 8;   // 16-byte pieces of a head's row
  constexpr int NT = HD / 8;  // n-tiles of dQ, dK, dV over the head dim
  constexpr int MK = (NQ + 1) / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = p.t, h = p.h, rows = p.rows, stages = p.stages;
  const int warps = blockDim.x / 32;
  const Layout lay = make_layout<HD>(rows, t, h, warps, stages);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const float sc = p.scale * kLog2e;
  const int qkv_row = t * 3 * h * HD * 2;  // bytes of a batch row
  const int do_row = t * h * HD * 2;
  const int stat_row = h * t * 4;
  const int tok_stride = 3 * h * HD;  // elements between the token rows of dqkv
  const uint32_t bars = smem_u32(smem);
  bf16* qt = reinterpret_cast<bf16*>(smem + lay.warp + warp * lay.warp_bytes);  // the warp's tiles
  bf16* kt = qt + kTokens * HD;
  bf16* vt = kt + kTokens * HD;
  bf16* dot = vt + kTokens * HD;
  float* stm = reinterpret_cast<float*>(dot + kTokens * HD);  // m * log2(e), 1 / l, D of 32 queries

  // The warp's tiles start zero: their rows past t are never written.
  for (int c = lane; c < 4 * kTokens * HD / 8; c += 32) {
    reinterpret_cast<uint4*>(qt)[c] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 16 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 asks for the input rows of block step `ch` in stage `s`.
  auto load = [&](int s, int ch) {
    const int row0 = ch * rows;
    const int nrows = min(rows, p.b - row0);
    const uint32_t bar = bars + 16 * s;
    const uint32_t st = smem_u32(smem + lay.stage0 + s * lay.stage_bytes);
    mbar_expect_tx(bar, nrows * (qkv_row + 2 * do_row + (p.stats_bulk ? 2 * stat_row : 0)));
    for (int r = 0; r < nrows; ++r) {
      const long long row = row0 + r;
      bulk_load(st + lay.st_qkv + r * qkv_row, p.qkv + row * p.sb_qkv, qkv_row, bar);
      bulk_load(st + lay.st_do + r * do_row, p.dout + row * p.sb_dout, do_row, bar);
      bulk_load(st + lay.st_out + r * do_row, p.out + row * p.sb_out, do_row, bar);
      if (p.stats_bulk) {
        bulk_load(st + lay.st_m + r * stat_row, p.m + row * h * t, stat_row, bar);
        bulk_load(st + lay.st_l + r * stat_row, p.l + row * h * t, stat_row, bar);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      const int ch = blockIdx.x + s * gridDim.x;
      if (ch < p.chunks) load(s, ch);
    }
  }

  for (int it = 0, ch = blockIdx.x; ch < p.chunks; ++it, ch += gridDim.x) {
    const int s = it % stages;
    mbar_wait(bars + 16 * s, (it / stages) & 1);  // this step's rows have landed
    const unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
    // Two steps' gradients alternate: the last step's may still be leaving.
    bf16* outs = reinterpret_cast<bf16*>(smem + lay.outs + (it & 1) * lay.outs_bytes);
    const int row0 = ch * rows;
    const int nrows = min(rows, p.b - row0);
    // Head hx = r * h + head of the step; a warp takes every warps-th.
    for (int hx = warp, r = warp / h, head = warp % h; hx < nrows * h; hx += warps) {
      // Lane i < t: token i's q, k, v and dO rows into the tiles, and its
      // row statistics m * log2(e), 1 / max(l, 1e-30) and D = dO . out, or
      // (kMasked, 0, 0) for a masked or padded row.
      {
        float mm = kMasked, rl = 0.f, dd = 0.f;
        if (lane < t) {
          const unsigned char* src = st + lay.st_qkv + r * qkv_row + (lane * 3 * h + head) * HD * 2;
          const int at = r * do_row + (lane * h + head) * HD * 2;
#pragma unroll
          for (int e = 0; e < C; ++e) {
            const int to = tile_off<HD>(lane, e * 8);
            *reinterpret_cast<uint4*>(qt + to) = *reinterpret_cast<const uint4*>(src + e * 16);
            *reinterpret_cast<uint4*>(kt + to) = *reinterpret_cast<const uint4*>(src + h * HD * 2 + e * 16);
            *reinterpret_cast<uint4*>(vt + to) = *reinterpret_cast<const uint4*>(src + 2 * h * HD * 2 + e * 16);
            const uint4 a = *reinterpret_cast<const uint4*>(st + lay.st_do + at + e * 16);
            const uint4 o = *reinterpret_cast<const uint4*>(st + lay.st_out + at + e * 16);
            *reinterpret_cast<uint4*>(dot + to) = a;
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float2 af = __bfloat1622float2(a2[u]);
              const float2 of = __bfloat1622float2(o2[u]);
              dd = fmaf(af.x, of.x, dd);
              dd = fmaf(af.y, of.y, dd);
            }
          }
          float mv, lv;
          if (p.stats_bulk) {
            const int si = (r * h + head) * t + lane;
            mv = reinterpret_cast<const float*>(st + lay.st_m)[si];
            lv = reinterpret_cast<const float*>(st + lay.st_l)[si];
          } else {
            const long long si = (static_cast<long long>(row0 + r) * h + head) * t + lane;
            mv = p.m[si];
            lv = p.l[si];
          }
          if (mv > kNegInf * 0.5f) {
            mm = mv * kLog2e;
            rl = 1.f / fmaxf(lv, 1e-30f);
          }
        }
        stm[lane] = mm;
        stm[kTokens + lane] = rl;
        stm[2 * kTokens + lane] = dd;
      }
      __syncwarp();  // the tiles and statistics are in shared memory

      // B fragments of Q and dO over (hd, queries) for S^T and dP^T, and of
      // dO and Q over (queries, hd) for dV and dK, per query step of 16; hd
      // 8 leaves the upper half of the contractions over hd zero.
      uint32_t qb[4][2], dob[4][2], bdo[2][NT][2], bq[2][NT][2];
      if constexpr (HD == 8) {
        uint32_t x[4];
        ldmatrix_x4(x, smem_u32(qt + lane * 8));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          qb[nj][0] = x[nj];
          qb[nj][1] = 0u;
        }
        ldmatrix_x4(x, smem_u32(dot + lane * 8));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          dob[nj][0] = x[nj];
          dob[nj][1] = 0u;
        }
        ldmatrix_x4_trans(x, smem_u32(dot + lane * 8));
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          bdo[kq][0][0] = x[2 * kq];
          bdo[kq][0][1] = x[2 * kq + 1];
        }
        ldmatrix_x4_trans(x, smem_u32(qt + lane * 8));
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          bq[kq][0][0] = x[2 * kq];
          bq[kq][0][1] = x[2 * kq + 1];
        }
      } else {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int row = np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int col = ((lane >> 3) & 1) * 8;
          uint32_t x[4];
          ldmatrix_x4(x, smem_u32(qt + tile_off<HD>(row, col)));
          qb[2 * np][0] = x[0];
          qb[2 * np][1] = x[1];
          qb[2 * np + 1][0] = x[2];
          qb[2 * np + 1][1] = x[3];
          ldmatrix_x4(x, smem_u32(dot + tile_off<HD>(row, col)));
          dob[2 * np][0] = x[0];
          dob[2 * np][1] = x[1];
          dob[2 * np + 1][0] = x[2];
          dob[2 * np + 1][1] = x[3];
        }
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int row = kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = (lane >> 4) * 8;
          uint32_t x[4];
          ldmatrix_x4_trans(x, smem_u32(dot + tile_off<HD>(row, col)));
          bdo[kq][0][0] = x[0];
          bdo[kq][0][1] = x[1];
          bdo[kq][1][0] = x[2];
          bdo[kq][1][1] = x[3];
          ldmatrix_x4_trans(x, smem_u32(qt + tile_off<HD>(row, col)));
          bq[kq][0][0] = x[0];
          bq[kq][0][1] = x[1];
          bq[kq][1][0] = x[2];
          bq[kq][1][1] = x[3];
        }
      }
      // This lane's queries nj * 8 + c2 and + 1: m * log2(e), 1 / l, D.
      float2 mqv[NQ], rqv[NQ], dqv[NQ];
#pragma unroll
      for (int nj = 0; nj < NQ; ++nj) {
        mqv[nj] = *reinterpret_cast<const float2*>(stm + nj * 8 + c2);
        rqv[nj] = *reinterpret_cast<const float2*>(stm + kTokens + nj * 8 + c2);
        dqv[nj] = *reinterpret_cast<const float2*>(stm + 2 * kTokens + nj * 8 + c2);
      }

      // B fragments of K over (keys, hd) for dQ = dS K, per key step of 16.
      uint32_t bk[2][NT][2];
      if constexpr (HD == 8) {
        uint32_t x[4];
        ldmatrix_x4_trans(x, smem_u32(kt + lane * 8));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          bk[kk][0][0] = x[2 * kk];
          bk[kk][0][1] = x[2 * kk + 1];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = (lane >> 4) * 8;
          uint32_t x[4];
          ldmatrix_x4_trans(x, smem_u32(kt + tile_off<HD>(row, col)));
          bk[kk][0][0] = x[0];
          bk[kk][0][1] = x[1];
          bk[kk][1][0] = x[2];
          bk[kk][1][1] = x[3];
        }
      }
      float dqa[2][NT][4];  // [query m-tile of 16]
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[mq][nt][e] = 0.f;
        }
      }

      // The gradients go to the step's packed rows: token rows g, g + 8 of
      // each 16, columns c2, c2 + 1 of each n-tile of 8.
      bf16* orow = outs + (r * t * 3 * h + head) * HD + g * tok_stride + c2;

      // One m-tile of 16 keys at a time.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= MK) continue;
        // A fragments of K and V (keys x hd).
        uint32_t ka[4], va[4];
        if constexpr (HD == 8) {
          uint32_t x[4];
          const bf16* base = lane < 16 ? kt : vt;
          ldmatrix_x4(x, smem_u32(base + (mt * 16 + (lane & 15)) * 8));
          ka[0] = x[0];
          ka[1] = x[1];
          va[0] = x[2];
          va[1] = x[3];
          ka[2] = ka[3] = va[2] = va[3] = 0u;
        } else {
          const int row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = (lane >> 4) * 8;
          ldmatrix_x4(ka, smem_u32(kt + tile_off<HD>(row, col)));
          ldmatrix_x4(va, smem_u32(vt + tile_off<HD>(row, col)));
        }

        // S^T = K Q^T and dP^T = V dO^T, [16 keys] x [32 queries]; n-tiles
        // past t are skipped and their accumulators stay 0, so P and dS
        // are 0 there.
        float s[4][4], dp[4][4];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nj][e] = dp[nj][e] = 0.f;
          if (nj >= NQ) continue;
          mma_bf16(s[nj], ka, qb[nj][0], qb[nj][1]);
          mma_bf16(dp[nj], va, dob[nj][0], dob[nj][1]);
        }

        // P^T and dS^T in place.
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          if (nj >= NQ) continue;
          const int q0 = nj * 8 + c2;  // this lane's queries q0, q0 + 1
          const int jq = nj < NQ ? nj : 0;  // nj < NQ here; keeps the index in bounds
          const float2 mq = mqv[jq], rq = rqv[jq], dq = dqv[jq];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = mt * 16 + g + (e >> 1) * 8;
            const int query = q0 + (e & 1);
            float pr = fast_exp2(fmaf(s[nj][e], sc, -((e & 1) ? mq.y : mq.x))) * ((e & 1) ? rq.y : rq.x);
            if (key >= t || (p.causal && query < key)) pr = 0.f;
            s[nj][e] = pr;
            dp[nj][e] = pr * (dp[nj][e] - ((e & 1) ? dq.y : dq.x));
          }
        }

        // dV = P^T dO and dK = dS^T Q over query steps of 16, P^T and dS^T
        // as A operands from the accumulators; and dQ += dS K for these
        // keys, dS's A operand the 8x8 blocks of dS^T's transposed.
        float dv[NT][4], dk[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[nt][e] = dk[nt][e] = 0.f;
        }
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          if (2 * kq >= NQ) continue;
          uint32_t ph[4], pl[4], sh[4], sl[4];
          a_from_c(s[2 * kq], s[2 * kq + 1], ph, pl);
          a_from_c(dp[2 * kq], dp[2 * kq + 1], sh, sl);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(dv[nt], ph, bdo[kq][nt][0], bdo[kq][nt][1]);
            mma_bf16(dv[nt], pl, bdo[kq][nt][0], bdo[kq][nt][1]);
            mma_bf16(dk[nt], sh, bq[kq][nt][0], bq[kq][nt][1]);
            mma_bf16(dk[nt], sl, bq[kq][nt][0], bq[kq][nt][1]);
          }
          // sh[x] is the block (keys 16mt + 8 (x & 1), queries 16kq + 8 (x >> 1));
          // dS's fragment over (queries 16kq.., keys 16mt..) takes the
          // blocks with the two offsets swapped, each transposed.
          const uint32_t ah[4] = {transpose8x8(sh[0]), transpose8x8(sh[2]), transpose8x8(sh[1]),
                                  transpose8x8(sh[3])};
          const uint32_t al[4] = {transpose8x8(sl[0]), transpose8x8(sl[2]), transpose8x8(sl[1]),
                                  transpose8x8(sl[3])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(dqa[kq][nt], ah, bk[mt][nt][0], bk[mt][nt][1]);
            mma_bf16(dqa[kq][nt], al, bk[mt][nt][0], bk[mt][nt][1]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (mt * 16 + g + half * 8 >= t) continue;
          bf16* dst = orow + (mt * 16 + half * 8) * tok_stride;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int e = 2 * half;
            store_bf16x2(dst + h * HD + nt * 8, dk[nt][e] * p.scale, dk[nt][e + 1] * p.scale);
            store_bf16x2(dst + 2 * h * HD + nt * 8, dv[nt][e], dv[nt][e + 1]);
          }
        }
      }
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
        if (mq >= MK) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (mq * 16 + g + half * 8 >= t) continue;
          bf16* dst = orow + (mq * 16 + half * 8) * tok_stride;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            store_bf16x2(dst + nt * 8, dqa[mq][nt][2 * half] * p.scale, dqa[mq][nt][2 * half + 1] * p.scale);
          }
        }
      }
      __syncwarp();  // the next head rewrites this warp's tiles and statistics
      head += warps % h;
      r += warps / h;
      if (head >= h) {
        head -= h;
        ++r;
      }
    }
    // The step's gradients are whole; the bulk store reads them through the
    // async proxy. Thread 0 first waits until the last step's store has
    // read its buffer, which the next step rewrites.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // and this stage's rows are read: it may be refilled
    if (threadIdx.x == 0) {
      for (int r = 0; r < nrows; ++r) {
        bulk_store(p.dqkv + (row0 + r) * p.sb_dqkv, smem_u32(outs) + r * qkv_row, qkv_row);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      const int ahead = ch + stages * gridDim.x;
      if (ahead < p.chunks) load(s, ahead);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int HD, int NQ>
int launch(Params p, int sms, cudaStream_t stream) {
  p.rows = step_rows(p.h, kTargetHeads);
  p.chunks = (p.b + p.rows - 1) / p.rows;
  const int warps = step_warps(p.rows, p.h);
  const int threads = warps * 32;
  p.stages = kMaxStages;
  while (p.stages > 2 && make_layout<HD>(p.rows, p.t, p.h, warps, p.stages).total > kSmemCap) --p.stages;
  const size_t smem = make_layout<HD>(p.rows, p.t, p.h, warps, p.stages).total;
  int grid = 0;
  const int err = persistent_grid(flash_bwd_short_kernel<HD, NQ>, threads, smem, p.chunks, sms, &grid);
  if (err != 0) return err;
  flash_bwd_short_kernel<HD, NQ><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Batch strides sb_* are in elements. Returns 0 or a cudaError_t code; a
// shape, stride or alignment the route does not take is
// cudaErrorInvalidValue: hd 8 or 16, 1 <= t < 32, h * hd <= 128, 16-byte
// aligned pointers and batch strides of qkv, out, dout and dqkv.
extern "C" int rsdl_flash_bwd_short(const void* qkv, const void* out, const void* dout, const float* m,
                                    const float* l, void* dqkv, long long sb_qkv, long long sb_out,
                                    long long sb_dout, long long sb_dqkv, int b, int t, int h, int hd,
                                    int causal, void* stream) {
  if (b < 0 || t < 1 || t >= kTokens || h < 1 || (hd != 8 && hd != 16) || h * hd > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {qkv, out, dout, dqkv};
  for (const void* ptr : ptrs) {
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strides[4] = {sb_qkv, sb_out, sb_dout, sb_dqkv};
  for (long long sb : strides) {
    if (sb % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.qkv = static_cast<const bf16*>(qkv);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.m = m;
  p.l = l;
  p.dqkv = static_cast<bf16*>(dqkv);
  p.sb_qkv = sb_qkv;
  p.sb_out = sb_out;
  p.sb_dout = sb_dout;
  p.sb_dqkv = sb_dqkv;
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
