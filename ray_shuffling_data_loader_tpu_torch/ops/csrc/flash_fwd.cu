// Flash attention forward on Hopper (K2): softmax attention over
// [b, t, h, hd] with the float32 row statistics the backward needs.
//
//   q, k, v  [b, t, h, hd]  float32 or bfloat16, strided, last dim contiguous
//   out      [b, t, h, hd]  same dtype, out = acc / max(l, 1e-30) rounded once
//   m, l     [b, h, t]      float32: row max of the scaled, masked scores and
//                           sum of exp(s - m)
//
// s = (q . k) / sqrt(hd) in float32; masked scores (k_pos >= t, or
// q_pos < k_pos when causal) are NEG_INF = -1e30, and a row whose max is
// still NEG_INF gets probabilities of 0. P . V is taken in float32.
//
// Replaces the TPU kernel ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_kernel` (a Pallas kernel over a (b*h, t/bq, t/bk) grid whose kv
// axis ran in order, carrying m, l and the accumulator in VMEM scratch,
// on [b*h, t_pad, hd] copies of the inputs).
//
// What bounds it: at the TabTransformer's shape (b*h = 262,144 heads of
// t = 19, hd = 8, bf16) bytes. One call reads q, k, v (239.1 MB) and writes
// out, m, l (119.5 MB) for 3.0 GFLOP, about 8 operations per byte against
// the ~295 the card needs before arithmetic becomes the limit: ~107 us at
// 3.35 TB/s. At long sequences (t = 4096, hd = 64) operations bound it.
//
// What the design does about it: every input element is read from device
// memory once per block that needs it, straight from the strided views (no
// transposed or padded copies), and every output written once. A query
// row lives in the registers of its G lanes (see flash_common.cuh); key
// and value tiles of the block's heads go through shared memory as float32;
// the online softmax runs over chunks of kChunk keys, one rescale per
// chunk, as the Pallas kernel runs it over a block of keys. At t = 19 a
// block holds 13 whole heads, so the TPU's sequential kv axis is a single
// tile. This is the simple version: scores and P . V are CUDA-core FMAs,
// not tensor-core products, so long sequences stay far from the
// operations bound.

#include "flash_common.cuh"

namespace {

using namespace rsdl_flash;

constexpr int kChunk = 8;  // keys per online-softmax rescale

struct FwdParams {
  View q, k, v;
  OutView out;
  float* m;
  float* l;
  long long bh_total;
  int t, h, hd, causal, vec;
  float scale;
  int hc, own, own_tiles, tile;
};

template <typename T, int S, int G>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_kernel(const FwdParams p) {
  constexpr int HDP = S * G;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + static_cast<size_t>(p.tile) * p.hc * HDP;

  const int ot = blockIdx.x % p.own_tiles;
  const long long bh0 = static_cast<long long>(blockIdx.x / p.own_tiles) * p.hc;
  const int g = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int il = slot / p.hc;
  const int hh = slot % p.hc;
  const int i = ot * p.own + il;  // this group's query row
  const long long bh = bh0 + hh;
  const bool active = il < p.own && i < p.t && bh < p.bh_total;
  const int bi = static_cast<int>(bh / p.h), hi = static_cast<int>(bh % p.h);
  const int e0 = g * S;
  const int valid = p.hd - e0;

  float q[S], acc[S];
#pragma unroll
  for (int u = 0; u < S; ++u) q[u] = acc[u] = 0.f;
  if (active) {
    load_slice<T, S>(q, static_cast<const T*>(p.q.ptr) +
                            offset(p.q.sb, p.q.st, p.q.sh, bi, i, hi) + e0,
                     valid, p.vec);
  }
  float m = kNegInf, l = 0.f;

  // Keys past the block's last query are masked for all of its rows.
  const int s_hi = p.causal ? min(p.t, ot * p.own + p.own) : p.t;
  for (int s0 = 0; s0 < s_hi; s0 += p.tile) {
    const int n = min(p.tile, s_hi - s0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HDP>(ks, p.k, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    load_tile<T, HDP>(vs, p.v, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    __syncthreads();
    if (!active) continue;
    const int jend = p.causal ? min(n, i - s0 + 1) : n;
    for (int j0 = 0; j0 < jend; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int jj = j0 + c;
        float part = 0.f;
        if (jj < jend) {
          float kr[S];
          read_smem<S>(kr, ks + (static_cast<size_t>(jj) * p.hc + hh) * HDP + e0);
#pragma unroll
          for (int u = 0; u < S; ++u) part = fmaf(q[u], kr[u], part);
        }
        part = group_sum<G>(part);
        s[c] = jj < jend ? part * p.scale : kNegInf;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      const bool live = m_new > kNegInf * 0.5f;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < S; ++u) acc[u] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int jj = j0 + c;
        if (jj < jend) {
          const float pc = live ? expf(s[c] - m_new) : 0.f;
          psum += pc;
          float vr[S];
          read_smem<S>(vr, vs + (static_cast<size_t>(jj) * p.hc + hh) * HDP + e0);
#pragma unroll
          for (int u = 0; u < S; ++u) acc[u] = fmaf(pc, vr[u], acc[u]);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }
  if (!active) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int u = 0; u < S; ++u) acc[u] = acc[u] / den;
  store_slice<T, S>(static_cast<T*>(p.out.ptr) +
                        offset(p.out.sb, p.out.st, p.out.sh, bi, i, hi) + e0,
                    acc, valid, p.vec);
  if (g == 0) {
    p.m[bh * p.t + i] = m;
    p.l[bh * p.t + i] = l;
  }
}

template <typename T, int S, int G>
int launch(FwdParams p, int sms, cudaStream_t stream) {
  constexpr int HDP = S * G;
  const Plan plan = make_plan(p.bh_total, p.t, G, 2 * HDP * sizeof(float), sms);
  p.hc = plan.hc;
  p.own = plan.own;
  p.own_tiles = plan.own_tiles;
  p.tile = plan.tile;
  const size_t smem = static_cast<size_t>(2) * plan.tile * plan.hc * HDP * sizeof(float);
  flash_fwd_kernel<T, S, G><<<static_cast<unsigned>(plan.blocks), plan.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FwdParams& p, int sms, cudaStream_t stream) {
  return RSDL_FLASH_BUCKET(T, p.hd, launch, p, sms, stream);
}

}  // namespace

// strides: 12 element strides, (b, t, h) of q, k, v and out in that order.
// dtype: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t code.
extern "C" int rsdl_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, float* m, float* l,
                              const long long* strides, int b, int t, int h,
                              int hd, int causal, int dtype, void* stream) {
  if (b < 0 || t < 0 || h < 0 || hd < 1 || hd > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * t == 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdParams p{};
  p.q = View{q, strides[0], strides[1], strides[2]};
  p.k = View{k, strides[3], strides[4], strides[5]};
  p.v = View{v, strides[6], strides[7], strides[8]};
  p.out = OutView{out, strides[9], strides[10], strides[11]};
  p.m = m;
  p.l = l;
  p.bh_total = static_cast<long long>(b) * h;
  p.t = t;
  p.h = h;
  p.hd = hd;
  p.causal = causal != 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const void* ptrs[4] = {q, k, v, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      p.vec = vectorizable(sizeof(float), hd, ptrs, 4, strides, 12);
      return dispatch<float>(p, sms, s);
    case 1:
      p.vec = vectorizable(sizeof(__nv_bfloat16), hd, ptrs, 4, strides, 12);
      return dispatch<__nv_bfloat16>(p, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
