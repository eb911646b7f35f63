// Flash attention forward on Hopper's tensor cores (K2, the "mma" route):
// the function of flash_fwd.cu for bf16 heads long enough to fill
// tensor-core tiles.
//
//   q, k, v  [b, t, h, hd]  bfloat16, strided, last dim contiguous, 16-byte
//                           aligned pointers and strides, hd a multiple of
//                           16 up to 128
//   out      [b, t, h, hd]  bfloat16, out = acc / max(l, 1e-30) rounded once
//   m, l     [b, h, t]      float32: row max of the scaled, masked scores and
//                           sum of exp(s - m)
//
// s = (q . k) / sqrt(hd) in float32 (scaled after the dot); masked scores
// (k_pos >= t, or q_pos < k_pos when causal) are NEG_INF = -1e30, and a row
// whose max is still NEG_INF gets probabilities of 0.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_kernel` (a Pallas kernel over a (b*h, t/bq, t/bk) grid whose kv
// axis ran in order, carrying m, l and the accumulator in VMEM scratch).
//
// What bounds it: operations at long sequences. At [2, 4096, 8, 64] one call
// needs 68.7 GFLOP (34.4 causal) against 33.6 MB of inputs and outputs,
// about 2,000 operations per byte: 69 us at the 989 TFLOP/s bf16 peak. At
// the CausalLM's [4, 512, 4, 16] causal the call is tiny (1.1 MB, 0.27
// GFLOP), and launch latency bounds it.
//
// What the design does about it (FlashAttention-2): a block of 4 warps owns
// 64 query rows of one head (2 warps and 32 rows when the grid would not
// give the card 2 blocks per SM), 16 rows per warp. The block's Q tile is
// read once into registers as mma A fragments (ldmatrix). Key and value
// tiles of 64 rows stream through a 2-stage cp.async ring in bf16, padded
// rows against bank conflicts, zero-filled past t. S = Q K^T is mma.sync
// m16n8k16 bf16 -> float32; the NEG_INF mask is applied only on ragged and
// causal-diagonal tiles; the online softmax keeps each row's max and sum
// in the 4 lanes of a quad (max reduced by __shfl_xor_sync per tile, the
// sum once at the end). acc += P V takes P straight from the S accumulators
// as the A operand and V through ldmatrix.trans. Fully masked causal tiles
// are never loaded, and causal query tiles are launched heaviest first.
//
// Numerics: the Pallas kernel takes P . V in float32. Q K^T of bf16 inputs
// is exact products summed in float32, but P rounded to one bf16 value errs
// by up to 2^-9 of each term, which over 4096 keys is of the order of the
// smallest outputs. So P goes to the tensor cores as two bf16 terms,
// hi = bf16(p) and lo = bf16(p - hi), two mma.sync into the same float32
// accumulator: about 16 significant bits of p, for 1.5x the tensor-core
// work of a single-term kernel. l sums the unrounded float32 p.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rsdl_flash;
using namespace rsdl_mma;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;      // keys per streamed tile
constexpr int kThreads = 128;  // 4 warps; 2 for 32-row tiles

struct Params {
  View q, k, v;
  OutView out;
  float* m;
  float* l;
  int bh_total;  // b * h; blocks = bh_total * tiles < 2^31
  int t, h, causal;
  int rows;     // query rows per block: 16 per warp
  int q_tiles;  // blocks along the sequence
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = HD + kLdPad;
  constexpr int KS = HD / 16;  // k-steps of Q K^T over the head dim
  constexpr int NT = HD / 8;   // n-tiles of the output over the head dim
  constexpr int NS = kKeys / 8;  // n-tiles of S over a key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [rows][LD]
  bf16* kv = qs + p.rows * LD;               // 2 stages of K [kKeys][LD], V [kKeys][LD]

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

  // Keys past the block's last query are masked for all of its rows.
  const int s_hi = p.causal ? min(p.t, q0 + p.rows) : p.t;
  const int n_tiles = (s_hi + kKeys - 1) / kKeys;

  load_rows<HD>(qs, LD, qg, p.q.st, q0, p.rows, p.t);
  load_rows<HD>(kv, LD, kg, p.k.st, 0, kKeys, p.t);
  load_rows<HD>(kv + kKeys * LD, LD, vg, p.v.st, 0, kKeys, p.t);
  cp_async_commit();

  const int wr = warp * 16;  // the warp's first row in the block's tile
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + wr + lane / 4;  // this thread's rows: row0, row0 + 8
  uint32_t qf[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      bf16* nxt = kv + ((it + 1) & 1) * 2 * kKeys * LD;
      load_rows<HD>(nxt, LD, kg, p.k.st, (it + 1) * kKeys, kKeys, p.t);
      load_rows<HD>(nxt + kKeys * LD, LD, vg, p.v.st, (it + 1) * kKeys, kKeys, p.t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], qs, LD, wr, ks * 16, lane);
    }
    const bf16* ks_ = kv + (it & 1) * 2 * kKeys * LD;
    const bf16* vs_ = ks_ + kKeys * LD;
    const int s0 = it * kKeys;

    float s[NS][4];
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) s[nj][0] = s[nj][1] = s[nj][2] = s[nj][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nj = 0; nj < NS; nj += 2) {
        uint32_t b[4];
        load_b_nk(b, ks_, LD, nj * 8, ks * 16, lane);
        mma_bf16(s[nj], qf[ks], b[0], b[1]);
        mma_bf16(s[nj + 1], qf[ks], b[2], b[3]);
      }
    }

    // Scale, then mask ragged and causal-diagonal tiles.
    const bool need_mask = s0 + kKeys > p.t || (p.causal && s0 + kKeys - 1 > q0 + wr);
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nj][e] * p.scale;
        if (need_mask) {
          const int key = s0 + nj * 8 + c2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= p.t || (p.causal && key > row)) x = kNegInf;
        }
        s[nj][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_r[r], tmax[r]);
      alpha[r] = expf(m_r[r] - m_new);
      live[r] = m_new > kNegInf * 0.5f;
      m_r[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < NS; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = live[r] ? expf(s[nj][e] - m_r[r]) : 0.f;
        s[nj][e] = pv;
        psum[r] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // acc += P V, P as two bf16 terms.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      a_from_c(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        load_b_kn(b, vs_, LD, kk * 16, nt * 8, lane);
        mma_bf16(acc[nt], ph, b[0], b[1]);
        mma_bf16(acc[nt], pl, b[0], b[1]);
        mma_bf16(acc[nt + 1], ph, b[2], b[3]);
        mma_bf16(acc[nt + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  // out = acc / max(l, 1e-30): divide, as the Pallas kernel does, then
  // round once.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] /= fmaxf(l_r[0], 1e-30f);
    acc[nt][1] /= fmaxf(l_r[0], 1e-30f);
    acc[nt][2] /= fmaxf(l_r[1], 1e-30f);
    acc[nt][3] /= fmaxf(l_r[1], 1e-30f);
  }
  bf16* og = static_cast<bf16*>(p.out.ptr) + offset(p.out.sb, 0, p.out.sh, bi, 0, hi);
  store_rows<HD>(og, p.out.st, row0, p.t, acc, 1.f, lane);
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

template <int HD>
int launch(Params p, int sms, cudaStream_t stream) {
  // 64-row tiles, or 32 when the card would get fewer than 2 blocks per SM
  // (make_plan's rule).
  p.rows = static_cast<long long>(p.bh_total) * ((p.t + 63) / 64) >= 2LL * sms ? 64 : 32;
  p.q_tiles = (p.t + p.rows - 1) / p.rows;
  const size_t smem = static_cast<size_t>(p.rows + 4 * kKeys) * (HD + kLdPad) * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(p.bh_total) * p.q_tiles;
  flash_fwd_mma_kernel<HD><<<static_cast<unsigned>(blocks), p.rows * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (b, t, h) of q, k, v and out in that order.
// dtype must be 1 (bfloat16). Returns 0 or a cudaError_t code; a shape,
// dtype or alignment the route does not take is cudaErrorInvalidValue.
extern "C" int rsdl_flash_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                  float* m, float* l, const long long* strides, int b, int t,
                                  int h, int hd, int causal, int dtype, void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  if (dtype != 1 || b < 0 || t < 0 || h < 0 || hd % 16 != 0 || hd < 16 || hd > kMaxHeadDim ||
      !vectorizable(sizeof(bf16), hd, ptrs, 4, strides, 12))
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
  p.out = OutView{out, strides[9], strides[10], strides[11]};
  p.m = m;
  p.l = l;
  p.bh_total = b * h;
  p.t = t;
  p.h = h;
  p.causal = causal != 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  return RSDL_MMA_HEAD_DIM(hd, launch, p, sms, static_cast<cudaStream_t>(stream));
}
