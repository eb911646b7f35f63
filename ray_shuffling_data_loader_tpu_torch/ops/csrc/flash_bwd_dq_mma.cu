// Flash attention dQ on Hopper's tensor cores (K4, the "mma" route): the
// function of flash_bwd.cu's flash_bwd_dq_kernel for bf16 heads long enough
// to fill tensor-core tiles.
//
//   q, k, v, dO  [b, t, h, hd]  bfloat16, strided, last dim contiguous,
//                               16-byte aligned pointers and strides, hd a
//                               multiple of 16 up to 128
//   m, l, D      [b, h, t]      float32; D = rowsum(dO * out), taken outside
//   dq           [b, t, h, hd]  bfloat16 (a view of one packed gradient)
//
// P = exp(s - m) / max(l, 1e-30), 0 where m <= NEG_INF / 2, with
// s = (q . k) / sqrt(hd) and the causal mask q_pos >= k_pos, as the Pallas
// kernels' `_bwd_probs` recomputes it; dP = dO . v, dS = P * (dP - D), and
//
//   dq_i = sum_j dS_ij k_j / sqrt(hd)
//
// in float32, rounded once to bf16.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_bwd_dq_kernel` (grid (b*h, t/bq, t/bk), kv innermost, dQ carried
// in VMEM).
//
// What bounds it: operations at long sequences. At [2, 4096, 8, 64] its
// three products need 103 GFLOP (51.5 causal) against 42 MB moved: 104 us
// at the 989 TFLOP/s bf16 peak. At the CausalLM's [4, 512, 4, 16] causal
// launch latency bounds it.
//
// What the design does about it (FlashAttention-2's dQ pass, K3 with the
// roles of queries and keys swapped): a block of 4 warps owns 64 query rows
// of one head (2 warps and 32 rows when the grid would not give the card 2
// blocks per SM), 16 per warp, and keeps the float32 dQ accumulators in
// registers, Q and dO as mma A fragments (for hd > 64, where registers do
// not hold them beside the accumulators, read from shared memory at each
// use), and m, 1 / max(l, 1e-30) and D of the lane's two rows. It walks
// the key tiles (64 keys, 32 for hd > 64), up to its last query when
// causal; each brings K and V (bf16) through a 2-stage cp.async ring. Per
// tile, with mma.sync m16n8k16 bf16 -> float32:
//
//   S = Q K^T   dP = dO V^T   ->  dS = P (dP - D) in registers   dQ += dS K
//
// dS feeds the last product straight from the accumulators as the A
// operand; K is the B operand through ldmatrix (.trans for dS K, where K is
// [k][n]). No atomics: every block owns its dQ rows; dK and dV are K3's.
//
// Numerics: the Pallas kernel takes dS K in float32. Q K^T and dO V^T of
// bf16 inputs are exact products summed in float32, but dS rounded to one
// bf16 value errs by up to 2^-9 of each term, which over 4096 keys is of
// the order of the smallest gradients. So dS goes to the tensor cores as
// two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), two mma.sync into the
// same float32 accumulator (about 16 significant bits).

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps; 2 for 32-row tiles

struct Params {
  View q, k, v, dout;
  OutView dq;
  const float* m;
  const float* l;
  const float* dsum;
  int bh_total;  // b * h; blocks = bh_total * tiles < 2^31
  int t, h, causal;
  int rows;     // query rows per block: 16 per warp
  int q_tiles;  // blocks along the sequence
  float scale;
};

// Keys per streamed tile: 64, or 32 where the accumulators of a wide head
// leave fewer registers.
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD <= 64 ? 64 : 32;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = HD + kLdPad;
  constexpr int KS = HD / 16;  // k-steps over the head dim
  constexpr int NT = HD / 8;   // n-tiles of dQ over the head dim
  constexpr int BK = key_tile<HD>();
  constexpr int NS = BK / 8;   // n-tiles of S over a key tile
  constexpr bool kFragsInRegs = HD <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [rows][LD]
  bf16* dos = qs + p.rows * LD;              // [rows][LD]
  bf16* kv = dos + p.rows * LD;              // 2 stages of K [BK][LD], V [BK][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // 32-bit division: a 64-bit one is a call, and spills around it.
  const int bh = static_cast<int>(blockIdx.x) % p.bh_total;
  const int tile_i = static_cast<int>(blockIdx.x) / p.bh_total;
  // Causal: the last query tiles see the most keys; launch them first.
  const int q0 = (p.causal ? p.q_tiles - 1 - tile_i : tile_i) * p.rows;
  const int bi = bh / p.h, hi = bh % p.h;
  const bf16* qg = static_cast<const bf16*>(p.q.ptr) + offset(p.q.sb, 0, p.q.sh, bi, 0, hi);
  const bf16* kg = static_cast<const bf16*>(p.k.ptr) + offset(p.k.sb, 0, p.k.sh, bi, 0, hi);
  const bf16* vg = static_cast<const bf16*>(p.v.ptr) + offset(p.v.sb, 0, p.v.sh, bi, 0, hi);
  const bf16* dog =
      static_cast<const bf16*>(p.dout.ptr) + offset(p.dout.sb, 0, p.dout.sh, bi, 0, hi);

  // Keys past the block's last query are masked for all of its rows.
  const int s_hi = p.causal ? min(p.t, q0 + p.rows) : p.t;
  const int n_tiles = (s_hi + BK - 1) / BK;

  load_rows<HD>(qs, LD, qg, p.q.st, q0, p.rows, p.t);
  load_rows<HD>(dos, LD, dog, p.dout.st, q0, p.rows, p.t);
  load_rows<HD>(kv, LD, kg, p.k.st, 0, BK, p.t);
  load_rows<HD>(kv + BK * LD, LD, vg, p.v.st, 0, BK, p.t);
  cp_async_commit();

  const int wr = warp * 16;  // the warp's first row in the block's tile
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + wr + lane / 4;  // this thread's rows: row0, row0 + 8
  // The rows' statistics; a row at or past t reads as dead (P = 0), so
  // nothing of the zero-filled tile reaches a live row.
  float mr[2], rl[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const long long at = static_cast<long long>(bh) * p.t + row;
    const bool ok = row < p.t;
    mr[r] = ok ? p.m[at] : kNegInf;
    rl[r] = ok ? 1.f / fmaxf(p.l[at], 1e-30f) : 0.f;
    dr[r] = ok ? p.dsum[at] : 0.f;
  }
  uint32_t qf[kFragsInRegs ? KS : 1][4], dof[kFragsInRegs ? KS : 1][4];
  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      bf16* nxt = kv + ((it + 1) & 1) * 2 * BK * LD;
      load_rows<HD>(nxt, LD, kg, p.k.st, (it + 1) * BK, BK, p.t);
      load_rows<HD>(nxt + BK * LD, LD, vg, p.v.st, (it + 1) * BK, BK, p.t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kFragsInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          load_a(qf[kk], qs, LD, wr, kk * 16, lane);
          load_a(dof[kk], dos, LD, wr, kk * 16, lane);
        }
      }
    }
    const bf16* ks = kv + (it & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;
    const int s0 = it * BK;

    // S = Q K^T and dP = dO V^T, [16 queries] x [BK keys] per warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = dp[nj][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      if constexpr (kFragsInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kk][e];
          ado[e] = dof[kk][e];
        }
      } else {
        load_a(aq, qs, LD, wr, kk * 16, lane);
        load_a(ado, dos, LD, wr, kk * 16, lane);
      }
#pragma unroll
      for (int nj = 0; nj < NS; nj += 2) {
        uint32_t b[4];
        load_b_nk(b, ks, LD, nj * 8, kk * 16, lane);
        mma_bf16(s[nj], aq, b[0], b[1]);
        mma_bf16(s[nj + 1], aq, b[2], b[3]);
        load_b_nk(b, vs, LD, nj * 8, kk * 16, lane);
        mma_bf16(dp[nj], ado, b[0], b[1]);
        mma_bf16(dp[nj + 1], ado, b[2], b[3]);
      }
    }

    // dS in place of dP; masks only on ragged and causal-diagonal tiles.
    const bool need_mask = s0 + BK > p.t || (p.causal && s0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = mr[r] > kNegInf * 0.5f ? expf(s[nj][e] * p.scale - mr[r]) * rl[r] : 0.f;
        if (need_mask) {
          const int key = s0 + nj * 8 + c2 + (e & 1);
          const int row = row0 + r * 8;
          if (key >= p.t || (p.causal && key > row)) pr = 0.f;
        }
        dp[nj][e] = pr * (dp[nj][e] - dr[r]);
      }
    }

    // dQ += dS K, dS as two bf16 terms.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      a_from_c(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        load_b_kn(b, ks, LD, kk * 16, nt * 8, lane);
        mma_bf16(dq[nt], sh, b[0], b[1]);
        mma_bf16(dq[nt], sl, b[0], b[1]);
        mma_bf16(dq[nt + 1], sh, b[2], b[3]);
        mma_bf16(dq[nt + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* dqg = static_cast<bf16*>(p.dq.ptr) + offset(p.dq.sb, 0, p.dq.sh, bi, 0, hi);
  store_rows<HD>(dqg, p.dq.st, row0, p.t, dq, p.scale, lane);
}

template <int HD>
int launch(Params p, int sms, cudaStream_t stream) {
  // 64-row tiles, or 32 when the card would get fewer than 2 blocks per SM
  // (make_plan's rule).
  p.rows = static_cast<long long>(p.bh_total) * ((p.t + 63) / 64) >= 2LL * sms ? 64 : 32;
  p.q_tiles = (p.t + p.rows - 1) / p.rows;
  constexpr int BK = key_tile<HD>();
  const size_t smem =
      static_cast<size_t>(2 * p.rows + 2 * 2 * BK) * (HD + kLdPad) * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(p.bh_total) * p.q_tiles;
  flash_bwd_dq_mma_kernel<HD><<<static_cast<unsigned>(blocks), p.rows * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 15 element strides, (b, t, h) of q, k, v, dO and dq. dtype must
// be 1 (bfloat16). Returns 0 or a cudaError_t code; a shape, dtype or
// alignment the route does not take is cudaErrorInvalidValue.
extern "C" int rsdl_flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                     const void* dout, const float* m, const float* l,
                                     const float* dsum, void* dq, const long long* strides,
                                     int b, int t, int h, int hd, int causal, int dtype,
                                     void* stream) {
  const void* ptrs[5] = {q, k, v, dout, dq};
  if (dtype != 1 || b < 0 || t < 0 || h < 0 || hd % 16 != 0 || hd < 16 || hd > kMaxHeadDim ||
      !vectorizable(sizeof(bf16), hd, ptrs, 5, strides, 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * t == 0) return 0;
  if (static_cast<long long>(b) * h * ((t + 31) / 32) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.q = View{q, strides[0], strides[1], strides[2]};
  p.k = View{k, strides[3], strides[4], strides[5]};
  p.v = View{v, strides[6], strides[7], strides[8]};
  p.dout = View{dout, strides[9], strides[10], strides[11]};
  p.dq = OutView{dq, strides[12], strides[13], strides[14]};
  p.m = m;
  p.l = l;
  p.dsum = dsum;
  p.bh_total = b * h;
  p.t = t;
  p.h = h;
  p.causal = causal != 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  return RSDL_MMA_HEAD_DIM(hd, launch, p, sms, static_cast<cudaStream_t>(stream));
}
