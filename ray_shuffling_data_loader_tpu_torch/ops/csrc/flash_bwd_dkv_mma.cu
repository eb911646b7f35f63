// Flash attention dK and dV on Hopper's tensor cores (K3, the "mma" route):
// the function of flash_bwd.cu's flash_bwd_dkv_kernel for bf16 heads long
// enough to fill tensor-core tiles.
//
//   q, k, v, dO  [b, t, h, hd]  bfloat16, strided, last dim contiguous,
//                               16-byte aligned pointers and strides, hd a
//                               multiple of 16 up to 128
//   m, l, D      [b, h, t]      float32; D = rowsum(dO * out), taken outside
//   dk, dv       [b, t, h, hd]  bfloat16 (views of one packed gradient)
//
// P = exp(s - m) / max(l, 1e-30), 0 where m <= NEG_INF / 2, with
// s = (q . k) / sqrt(hd) and the causal mask q_pos >= k_pos, as the Pallas
// kernels' `_bwd_probs` recomputes it; dP = dO . v, dS = P * (dP - D), and
//
//   dv_j = sum_i P_ij dO_i     dk_j = sum_i dS_ij q_i / sqrt(hd)
//
// in float32, each rounded once to bf16.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_bwd_dkv_kernel` (grid (b*h, t/bk, t/bq), q innermost, dK and dV
// carried in VMEM).
//
// What bounds it: operations at long sequences. At [2, 4096, 8, 64] the four
// products need 137 GFLOP (68.7 causal) against 50 MB moved: 139 us at the
// 989 TFLOP/s bf16 peak. At the CausalLM's [4, 512, 4, 16] causal launch
// latency bounds it.
//
// What the design does about it: a block of 4 warps owns 64 key rows of one
// head (2 warps and 32 rows when the grid would not give the card 2 blocks
// per SM), 16 per warp, and keeps the float32 dK and dV accumulators in
// registers, and K and V as mma A fragments (for hd > 64, where registers
// do not hold them beside the accumulators, read from shared memory at each
// use). It walks the query tiles (64 queries, 32 for hd > 64), from the
// diagonal on when causal; each brings Q and dO (bf16) with m, l and D
// (float32) through a 2-stage cp.async ring. Per tile, with mma.sync
// m16n8k16 bf16 -> float32:
//
//   S^T = K Q^T  ->  P^T in registers     dV += P^T dO
//   dP^T = V dO^T  ->  dS^T = P^T (dP^T - D)   dK += dS^T Q
//
// P^T and dS^T feed the next products straight from the accumulators as A
// operands; Q and dO are B operands through ldmatrix (.trans where they
// are [k][n]). No atomics: every block owns its dK, dV rows; dQ is K4's.
//
// Numerics: the Pallas kernel takes P^T dO and dS^T Q in float32. K Q^T and
// V dO^T of bf16 inputs are exact products summed in float32, but P or dS
// rounded to one bf16 value err by up to 2^-9 of each term, which over
// 4096 queries is of the order of the smallest gradients. So P and dS go to
// the tensor cores as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// two mma.sync into the same float32 accumulator: about 16 significant
// bits, for 1.5x the tensor-core work of a single-term kernel.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps; 2 for 32-row tiles

struct Params {
  View q, k, v, dout;
  OutView dk, dv;
  const float* m;
  const float* l;
  const float* dsum;
  int bh_total;  // b * h; blocks = bh_total * tiles < 2^31
  int t, h, causal;
  int rows;     // key rows per block: 16 per warp
  int k_tiles;  // blocks along the sequence
  float scale;
};

// Queries per streamed tile: 64, or 32 where the accumulators of a wide
// head leave fewer registers.
template <int HD>
__host__ __device__ constexpr int query_tile() {
  return HD <= 64 ? 64 : 32;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = HD + kLdPad;
  constexpr int KS = HD / 16;  // k-steps over the head dim
  constexpr int NT = HD / 8;   // n-tiles of dK, dV over the head dim
  constexpr int BQ = query_tile<HD>();
  constexpr int NQ = BQ / 8;   // n-tiles of S^T over a query tile
  constexpr bool kFragsInRegs = HD <= 64;
  constexpr int kStage = 2 * BQ * LD * sizeof(bf16) + 3 * BQ * sizeof(float);  // bytes
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [rows][LD]
  bf16* vs = ks + p.rows * LD;               // [rows][LD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + p.rows * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // 32-bit division: a 64-bit one is a call, and spills around it.
  const int bh = static_cast<int>(blockIdx.x) % p.bh_total;
  // Causal: the first key tiles see the most queries and come first.
  const int k0 = static_cast<int>(blockIdx.x) / p.bh_total * p.rows;
  const int bi = bh / p.h, hi = bh % p.h;
  const bf16* qg = static_cast<const bf16*>(p.q.ptr) + offset(p.q.sb, 0, p.q.sh, bi, 0, hi);
  const bf16* kg = static_cast<const bf16*>(p.k.ptr) + offset(p.k.sb, 0, p.k.sh, bi, 0, hi);
  const bf16* vg = static_cast<const bf16*>(p.v.ptr) + offset(p.v.sb, 0, p.v.sh, bi, 0, hi);
  const bf16* dog =
      static_cast<const bf16*>(p.dout.ptr) + offset(p.dout.sb, 0, p.dout.sh, bi, 0, hi);

  // Queries before the block's first key are masked for all of its rows.
  const int q_begin = p.causal ? k0 / BQ * BQ : 0;
  const int n_tiles = (p.t - q_begin + BQ - 1) / BQ;

  auto load_tile = [&](int stage, int q0) {
    bf16* qd = reinterpret_cast<bf16*>(ring + stage * kStage);
    bf16* dod = qd + BQ * LD;
    float* sd = reinterpret_cast<float*>(dod + BQ * LD);
    load_rows<HD>(qd, LD, qg, p.q.st, q0, BQ, p.t);
    load_rows<HD>(dod, LD, dog, p.dout.st, q0, BQ, p.t);
    for (int i = threadIdx.x; i < 3 * BQ; i += blockDim.x) {
      const int r = i % BQ;
      const bool ok = q0 + r < p.t;
      const float* src = i < BQ ? p.m : i < 2 * BQ ? p.l : p.dsum;  // sd: m, l, D
      src += static_cast<long long>(bh) * p.t + (ok ? q0 + r : 0);
      cp_async_4(smem_u32(sd + i), src, ok ? 4 : 0);
    }
  };

  load_rows<HD>(ks, LD, kg, p.k.st, k0, p.rows, p.t);
  load_rows<HD>(vs, LD, vg, p.v.st, k0, p.rows, p.t);
  load_tile(0, q_begin);
  cp_async_commit();

  const int wr = warp * 16;  // the warp's first row in the block's key tile
  const int c2 = 2 * (lane & 3);
  const int key0 = k0 + wr + lane / 4;  // this thread's keys: key0, key0 + 8
  uint32_t kf[kFragsInRegs ? KS : 1][4], vf[kFragsInRegs ? KS : 1][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    if (it + 1 < n_tiles) {
      load_tile((it + 1) & 1, q0 + BQ);
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
          load_a(kf[kk], ks, LD, wr, kk * 16, lane);
          load_a(vf[kk], vs, LD, wr, kk * 16, lane);
        }
      }
    }
    const bf16* qs = reinterpret_cast<const bf16*>(ring + (it & 1) * kStage);
    const bf16* dos = qs + BQ * LD;
    const float* ms = reinterpret_cast<const float*>(dos + BQ * LD);
    const float* ls = ms + BQ;
    const float* ds = ls + BQ;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys] x [BQ queries] per warp.
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nj = 0; nj < NQ; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = dp[nj][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      if constexpr (kFragsInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = kf[kk][e];
          av[e] = vf[kk][e];
        }
      } else {
        load_a(ak, ks, LD, wr, kk * 16, lane);
        load_a(av, vs, LD, wr, kk * 16, lane);
      }
#pragma unroll
      for (int nj = 0; nj < NQ; nj += 2) {
        uint32_t b[4];
        load_b_nk(b, qs, LD, nj * 8, kk * 16, lane);
        mma_bf16(s[nj], ak, b[0], b[1]);
        mma_bf16(s[nj + 1], ak, b[2], b[3]);
        load_b_nk(b, dos, LD, nj * 8, kk * 16, lane);
        mma_bf16(dp[nj], av, b[0], b[1]);
        mma_bf16(dp[nj + 1], av, b[2], b[3]);
      }
    }

    // P^T and dS^T in place; masks only on ragged and causal-diagonal tiles.
    const bool need_mask = q0 + BQ > p.t || (p.causal && q0 < k0 + wr + 16);
#pragma unroll
    for (int nj = 0; nj < NQ; ++nj) {
      const int col = nj * 8 + c2;  // this lane's queries q0 + col, + 1
      const float2 mi = *reinterpret_cast<const float2*>(ms + col);
      const float2 li = *reinterpret_cast<const float2*>(ls + col);
      const float2 di = *reinterpret_cast<const float2*>(ds + col);
      const float mq[2] = {mi.x, mi.y};
      const float rl[2] = {1.f / fmaxf(li.x, 1e-30f), 1.f / fmaxf(li.y, 1e-30f)};
      const float dd[2] = {di.x, di.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float pr = mq[c] > kNegInf * 0.5f ? expf(s[nj][e] * p.scale - mq[c]) * rl[c] : 0.f;
        if (need_mask) {
          const int query = q0 + col + c;
          const int key = key0 + (e >> 1) * 8;
          if (query >= p.t || (p.causal && query < key)) pr = 0.f;
        }
        s[nj][e] = pr;
        dp[nj][e] = pr * (dp[nj][e] - dd[c]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands as two bf16 terms.
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_from_c(s[2 * kq], s[2 * kq + 1], ph, pl);
      a_from_c(dp[2 * kq], dp[2 * kq + 1], sh, sl);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        load_b_kn(b, dos, LD, kq * 16, nt * 8, lane);
        mma_bf16(dv[nt], ph, b[0], b[1]);
        mma_bf16(dv[nt], pl, b[0], b[1]);
        mma_bf16(dv[nt + 1], ph, b[2], b[3]);
        mma_bf16(dv[nt + 1], pl, b[2], b[3]);
        load_b_kn(b, qs, LD, kq * 16, nt * 8, lane);
        mma_bf16(dk[nt], sh, b[0], b[1]);
        mma_bf16(dk[nt], sl, b[0], b[1]);
        mma_bf16(dk[nt + 1], sh, b[2], b[3]);
        mma_bf16(dk[nt + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* dkg = static_cast<bf16*>(p.dk.ptr) + offset(p.dk.sb, 0, p.dk.sh, bi, 0, hi);
  bf16* dvg = static_cast<bf16*>(p.dv.ptr) + offset(p.dv.sb, 0, p.dv.sh, bi, 0, hi);
  store_rows<HD>(dkg, p.dk.st, key0, p.t, dk, p.scale, lane);
  store_rows<HD>(dvg, p.dv.st, key0, p.t, dv, 1.f, lane);
}

template <int HD>
int launch(Params p, int sms, cudaStream_t stream) {
  // 64-row tiles, or 32 when the card would get fewer than 2 blocks per SM
  // (make_plan's rule).
  p.rows = static_cast<long long>(p.bh_total) * ((p.t + 63) / 64) >= 2LL * sms ? 64 : 32;
  p.k_tiles = (p.t + p.rows - 1) / p.rows;
  constexpr int BQ = query_tile<HD>();
  const size_t smem =
      static_cast<size_t>(2 * p.rows + 2 * 2 * BQ) * (HD + kLdPad) * sizeof(bf16) +
      2 * 3 * BQ * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(p.bh_total) * p.k_tiles;
  flash_bwd_dkv_mma_kernel<HD><<<static_cast<unsigned>(blocks), p.rows * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 18 element strides, (b, t, h) of q, k, v, dO, dk and dv. dtype
// must be 1 (bfloat16). Returns 0 or a cudaError_t code; a shape, dtype or
// alignment the route does not take is cudaErrorInvalidValue.
extern "C" int rsdl_flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                      const void* dout, const float* m, const float* l,
                                      const float* dsum, void* dk, void* dv,
                                      const long long* strides, int b, int t, int h, int hd,
                                      int causal, int dtype, void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (dtype != 1 || b < 0 || t < 0 || h < 0 || hd % 16 != 0 || hd < 16 || hd > kMaxHeadDim ||
      !vectorizable(sizeof(bf16), hd, ptrs, 6, strides, 18))
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
  p.dk = OutView{dk, strides[12], strides[13], strides[14]};
  p.dv = OutView{dv, strides[15], strides[16], strides[17]};
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
