// Flash attention backward on Hopper: dK and dV (K3) and dQ (K4) from the
// forward's saved float32 row statistics.
//
//   q, k, v, dO  [b, t, h, hd]  float32 or bfloat16, strided, last dim contiguous
//   m, l, D      [b, h, t]      float32; D = rowsum(dO * out), taken outside
//   dk, dv, dq   [b, t, h, hd]  the dtype of q, k, v, strided, last dim
//                              contiguous (views of one packed gradient)
//
// Both kernels recompute the probabilities from (m, l) as the Pallas
// kernels' `_bwd_probs` does: P = exp(s - m) / max(l, 1e-30), 0 where
// m <= NEG_INF / 2, with s = (q . k) / sqrt(hd) in float32 and the causal
// mask q_pos >= k_pos. Then dP = dO . v, dS = P * (dP - D), and
//
//   K3:  dv_j = sum_i P_ij dO_i     dk_j = sum_i dS_ij q_i / sqrt(hd)
//   K4:  dq_i = sum_j dS_ij k_j / sqrt(hd)
//
// all in float32, rounded once to the output dtype.
//
// Replaces the TPU kernels ray_shuffling_data_loader_tpu/ops/flash_attention.py
// `_flash_bwd_dkv_kernel` (grid (b*h, t/bk, t/bq), q innermost, dK and dV
// carried in VMEM) and `_flash_bwd_dq_kernel` (grid (b*h, t/bq, t/bk), kv
// innermost), which read transposed, padded [b*h, t_pad, hd] copies.
//
// What bounds them: at the TabTransformer's shape (b*h = 262,144 heads of
// t = 19, hd = 8, bf16) bytes. K3 reads q, k, v, dO, m, l, D (378.5 MB) and
// writes dK, dV (159.4 MB): ~161 us at 3.35 TB/s. K4 reads the same and
// writes dQ (79.7 MB): ~137 us. About 6 GFLOP each, far below the card's
// ~295 operations per byte. At t = 4096, hd = 64 operations bound them.
//
// What the design does about it: as the forward (flash_common.cuh), every
// element is read from the strided inputs once per block that needs it
// and every output written once. K3 gives each key row to a group of G
// lanes, which keep k, v, dK and dV in registers and walk the query tiles
// (q, dO, m, max(l, 1e-30), D) in shared memory; K4 gives each query row
// to a group, which keeps q, dO and dQ in registers and walks the key and
// value tiles. The TPU's sequential inner grid axis becomes that walk.
// Causal query tiles wholly before a block's first key (K3) and key tiles
// wholly after its last query (K4) are never loaded. The simple version:
// CUDA-core FMAs, no tensor cores.

#include "flash_common.cuh"

namespace {

using namespace rsdl_flash;

struct BwdParams {
  View q, k, v, dout;
  OutView dq, dk, dv;
  const float* m;
  const float* l;
  const float* dsum;
  long long bh_total;
  int t, h, hd, causal, vec;
  float scale;
  int hc, own, own_tiles, tile;
};

// K3: each group owns a key row j; the block walks query tiles.
template <typename T, int S, int G>
__global__ void __launch_bounds__(kMaxThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int HDP = S * G;
  extern __shared__ __align__(16) float smem[];
  const size_t rows = static_cast<size_t>(p.tile) * p.hc;
  float* qs = smem;
  float* dos = qs + rows * HDP;
  float* ms = dos + rows * HDP;
  float* ls = ms + rows;
  float* ds_ = ls + rows;

  const int ot = blockIdx.x % p.own_tiles;
  const long long bh0 = static_cast<long long>(blockIdx.x / p.own_tiles) * p.hc;
  const int g = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int jl = slot / p.hc;
  const int hh = slot % p.hc;
  const int j = ot * p.own + jl;  // this group's key row
  const long long bh = bh0 + hh;
  const bool active = jl < p.own && j < p.t && bh < p.bh_total;
  const int bi = static_cast<int>(bh / p.h), hi = static_cast<int>(bh % p.h);
  const int e0 = g * S;
  const int valid = p.hd - e0;

  float k[S], v[S], dk[S], dv[S];
#pragma unroll
  for (int u = 0; u < S; ++u) k[u] = v[u] = dk[u] = dv[u] = 0.f;
  if (active) {
    load_slice<T, S>(k, static_cast<const T*>(p.k.ptr) +
                            offset(p.k.sb, p.k.st, p.k.sh, bi, j, hi) + e0,
                     valid, p.vec);
    load_slice<T, S>(v, static_cast<const T*>(p.v.ptr) +
                            offset(p.v.sb, p.v.st, p.v.sh, bi, j, hi) + e0,
                     valid, p.vec);
  }

  // Queries before the block's first key are masked for all of its rows.
  const int s_lo = p.causal ? ot * p.own : 0;
  for (int s0 = s_lo; s0 < p.t; s0 += p.tile) {
    const int n = min(p.tile, p.t - s0);
    __syncthreads();
    load_tile<T, HDP>(qs, p.q, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    load_tile<T, HDP>(dos, p.dout, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    load_stats(ms, p.m, bh0, p.hc, p.bh_total, p.t, s0, n, -INFINITY);
    load_stats(ls, p.l, bh0, p.hc, p.bh_total, p.t, s0, n, 1e-30f);
    load_stats(ds_, p.dsum, bh0, p.hc, p.bh_total, p.t, s0, n, -INFINITY);
    __syncthreads();
    if (!active) continue;
    for (int ii = p.causal ? max(0, j - s0) : 0; ii < n; ++ii) {
      const size_t r = static_cast<size_t>(ii) * p.hc + hh;
      float qr[S], dor[S];
      read_smem<S>(qr, qs + r * HDP + e0);
      read_smem<S>(dor, dos + r * HDP + e0);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        s = fmaf(qr[u], k[u], s);
        dp = fmaf(dor[u], v[u], dp);
      }
      s = group_sum<G>(s) * p.scale;
      dp = group_sum<G>(dp);
      const float mi = ms[r];
      const float pr = mi > kNegInf * 0.5f ? expf(s - mi) / ls[r] : 0.f;
      const float dsv = pr * (dp - ds_[r]);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        dv[u] = fmaf(pr, dor[u], dv[u]);
        dk[u] = fmaf(dsv, qr[u], dk[u]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int u = 0; u < S; ++u) dk[u] *= p.scale;
  store_slice<T, S>(static_cast<T*>(p.dk.ptr) +
                        offset(p.dk.sb, p.dk.st, p.dk.sh, bi, j, hi) + e0,
                    dk, valid, p.vec);
  store_slice<T, S>(static_cast<T*>(p.dv.ptr) +
                        offset(p.dv.sb, p.dv.st, p.dv.sh, bi, j, hi) + e0,
                    dv, valid, p.vec);
}

// K4: each group owns a query row i; the block walks key/value tiles.
template <typename T, int S, int G>
__global__ void __launch_bounds__(kMaxThreads)
flash_bwd_dq_kernel(const BwdParams p) {
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

  float q[S], dout[S], dq[S];
#pragma unroll
  for (int u = 0; u < S; ++u) q[u] = dout[u] = dq[u] = 0.f;
  float mi = kNegInf, li = 1e-30f, di = 0.f;
  if (active) {
    load_slice<T, S>(q, static_cast<const T*>(p.q.ptr) +
                            offset(p.q.sb, p.q.st, p.q.sh, bi, i, hi) + e0,
                     valid, p.vec);
    load_slice<T, S>(dout, static_cast<const T*>(p.dout.ptr) +
                               offset(p.dout.sb, p.dout.st, p.dout.sh, bi, i, hi) + e0,
                     valid, p.vec);
    mi = p.m[bh * p.t + i];
    li = fmaxf(p.l[bh * p.t + i], 1e-30f);
    di = p.dsum[bh * p.t + i];
  }
  const bool live = mi > kNegInf * 0.5f;

  const int s_hi = p.causal ? min(p.t, ot * p.own + p.own) : p.t;
  for (int s0 = 0; s0 < s_hi; s0 += p.tile) {
    const int n = min(p.tile, s_hi - s0);
    __syncthreads();
    load_tile<T, HDP>(ks, p.k, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    load_tile<T, HDP>(vs, p.v, bh0, p.hc, p.bh_total, p.h, s0, n, p.hd, p.vec);
    __syncthreads();
    if (!active) continue;
    const int jend = p.causal ? min(n, i - s0 + 1) : n;
    for (int jj = 0; jj < jend; ++jj) {
      const size_t r = static_cast<size_t>(jj) * p.hc + hh;
      float kr[S], vr[S];
      read_smem<S>(kr, ks + r * HDP + e0);
      read_smem<S>(vr, vs + r * HDP + e0);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        s = fmaf(q[u], kr[u], s);
        dp = fmaf(dout[u], vr[u], dp);
      }
      s = group_sum<G>(s) * p.scale;
      dp = group_sum<G>(dp);
      const float pr = live ? expf(s - mi) / li : 0.f;
      const float dsv = pr * (dp - di);
#pragma unroll
      for (int u = 0; u < S; ++u) dq[u] = fmaf(dsv, kr[u], dq[u]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int u = 0; u < S; ++u) dq[u] *= p.scale;
  store_slice<T, S>(static_cast<T*>(p.dq.ptr) +
                        offset(p.dq.sb, p.dq.st, p.dq.sh, bi, i, hi) + e0,
                    dq, valid, p.vec);
}

template <typename T, int S, int G>
int launch_dkv(BwdParams p, int sms, cudaStream_t stream) {
  constexpr int HDP = S * G;
  const int row_bytes = (2 * HDP + 3) * sizeof(float);
  const Plan plan = make_plan(p.bh_total, p.t, G, row_bytes, sms);
  p.hc = plan.hc;
  p.own = plan.own;
  p.own_tiles = plan.own_tiles;
  p.tile = plan.tile;
  const size_t smem = static_cast<size_t>(plan.tile) * plan.hc * row_bytes;
  flash_bwd_dkv_kernel<T, S, G><<<static_cast<unsigned>(plan.blocks), plan.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, int G>
int launch_dq(BwdParams p, int sms, cudaStream_t stream) {
  constexpr int HDP = S * G;
  const int row_bytes = 2 * HDP * sizeof(float);
  const Plan plan = make_plan(p.bh_total, p.t, G, row_bytes, sms);
  p.hc = plan.hc;
  p.own = plan.own;
  p.own_tiles = plan.own_tiles;
  p.tile = plan.tile;
  const size_t smem = static_cast<size_t>(plan.tile) * plan.hc * row_bytes;
  flash_bwd_dq_kernel<T, S, G><<<static_cast<unsigned>(plan.blocks), plan.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Fills the shared fields and the device's SM count; returns 0 or an
// error code.
int fill(BwdParams& p, int* sms, const void* q, const void* k, const void* v,
         const void* dout, const float* m, const float* l, const float* dsum,
         const long long* strides, int b, int t, int h, int hd, int causal) {
  if (b < 0 || t < 0 || h < 0 || hd < 1 || hd > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.q = View{q, strides[0], strides[1], strides[2]};
  p.k = View{k, strides[3], strides[4], strides[5]};
  p.v = View{v, strides[6], strides[7], strides[8]};
  p.dout = View{dout, strides[9], strides[10], strides[11]};
  p.m = m;
  p.l = l;
  p.dsum = dsum;
  p.bh_total = static_cast<long long>(b) * h;
  p.t = t;
  p.h = h;
  p.hd = hd;
  p.causal = causal != 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  return 0;
}

}  // namespace

// strides: 18 element strides, (b, t, h) of q, k, v, dO, dk and dv.
// dtype: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t code.
extern "C" int rsdl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* m,
                                  const float* l, const float* dsum, void* dk,
                                  void* dv, const long long* strides, int b,
                                  int t, int h, int hd, int causal, int dtype,
                                  void* stream) {
  BwdParams p{};
  int sms = 0;
  const int err = fill(p, &sms, q, k, v, dout, m, l, dsum, strides, b, t, h, hd, causal);
  if (err != 0) return err;
  if (static_cast<long long>(b) * h * t == 0) return 0;
  p.dk = OutView{dk, strides[12], strides[13], strides[14]};
  p.dv = OutView{dv, strides[15], strides[16], strides[17]};
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      p.vec = vectorizable(sizeof(float), hd, ptrs, 6, strides, 18);
      return RSDL_FLASH_BUCKET(float, hd, launch_dkv, p, sms, s);
    case 1:
      p.vec = vectorizable(sizeof(__nv_bfloat16), hd, ptrs, 6, strides, 18);
      return RSDL_FLASH_BUCKET(__nv_bfloat16, hd, launch_dkv, p, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: 15 element strides, (b, t, h) of q, k, v, dO and dq.
extern "C" int rsdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* m,
                                 const float* l, const float* dsum, void* dq,
                                 const long long* strides, int b, int t, int h,
                                 int hd, int causal, int dtype, void* stream) {
  BwdParams p{};
  int sms = 0;
  const int err = fill(p, &sms, q, k, v, dout, m, l, dsum, strides, b, t, h, hd, causal);
  if (err != 0) return err;
  if (static_cast<long long>(b) * h * t == 0) return 0;
  p.dq = OutView{dq, strides[12], strides[13], strides[14]};
  const void* ptrs[5] = {q, k, v, dout, dq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      p.vec = vectorizable(sizeof(float), hd, ptrs, 5, strides, 15);
      return RSDL_FLASH_BUCKET(float, hd, launch_dq, p, sms, s);
    case 1:
      p.vec = vectorizable(sizeof(__nv_bfloat16), hd, ptrs, 5, strides, 15);
      return RSDL_FLASH_BUCKET(__nv_bfloat16, hd, launch_dq, p, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
