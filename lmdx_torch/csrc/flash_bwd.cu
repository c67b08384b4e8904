// Flash-attention backward: dQ, dK, dV by blockwise recompute from the LSE.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention_bwd (the
// TPU kernel, l.384). Inputs q (BH, Lq, d), k/v (BH, Lk, d), o and dO
// (BH, Lq, d), all bf16, and the forward's row LSE (BH, Lq) f32. Outputs
// dq, dk, dv in bf16. With s = q k^T / sqrt(d):
//   p = exp(s - lse), delta = rowsum(dO * O),
//   dV = p^T dO,  dS = p * (dO V^T - delta) / sqrt(d),
//   dQ = dS K,    dK = dS^T Q.
//
// What bounds it on an H100: five (Lq x Lk x d) products per call (the
// recomputed scores, dO V^T, dV, dK and dQ) against a few bytes per input
// element: bound by tensor-core operations, like the forward.
//
// Design. The TPU kernel accumulated dK/dV across q-blocks because its grid
// runs in order on one core (flash_attention.py:478-486). GPU blocks run in
// parallel, so the work is split the FA2 way into three launches on one
// stream: (1) delta = rowsum(dO * O), one warp per row; (2) one block per
// (batch*head, 32-row KV tile) that walks every 64-row q tile and sums
// dK/dV for its KV rows in shared memory; (3) one block per (batch*head,
// 64-row q tile) that walks every 32-row KV tile and sums dQ. Each output
// element is owned by exactly one block, so no atomics are needed and the
// result does not depend on block order. p and dS never reach device
// memory; they are rounded to bf16 for the tensor-core products, the sums
// stay f32. Unaligned KV (the GLIGEN fuser's Lq + 30) and padded q rows get
// p = 0. Not yet done: wgmma, TMA, pipelining, register accumulators.
#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kBQ = 64;  // q rows per tile
constexpr int kBK = 32;  // kv rows per tile

struct BwdLayout {
  int ldh, ldf, lds, ldp;
  size_t q, g, k, v, acc0, acc1, s, dpm, p, ds, lse, delta, total;
  // dkdv: the dK/dV kernel keeps two (kBK x dp) accumulators and a bf16 p
  // tile; the dQ kernel keeps one (kBQ x dp) accumulator.
  __host__ __device__ BwdLayout(int dp, bool dkdv) {
    ldh = dp + 8;
    ldf = dp + 4;
    lds = kBK + 4;
    ldp = kBK + 8;
    Carve cv;
    q = cv.take(sizeof(bf16) * kBQ * ldh);
    g = cv.take(sizeof(bf16) * kBQ * ldh);
    k = cv.take(sizeof(bf16) * kBK * ldh);
    v = cv.take(sizeof(bf16) * kBK * ldh);
    if (dkdv) {
      acc0 = cv.take(sizeof(float) * kBK * ldf);
      acc1 = cv.take(sizeof(float) * kBK * ldf);
    } else {
      acc0 = cv.take(sizeof(float) * kBQ * ldf);
      acc1 = acc0;
    }
    s = cv.take(sizeof(float) * kBQ * lds);
    dpm = cv.take(sizeof(float) * kBQ * lds);
    p = dkdv ? cv.take(sizeof(bf16) * kBQ * ldp) : 0;
    ds = cv.take(sizeof(bf16) * kBQ * ldp);
    lse = cv.take(sizeof(float) * kBQ);
    delta = cv.take(sizeof(float) * kBQ);
    total = cv.off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    acc += __bfloat162float(o[(size_t)row * d + c]) * __bfloat162float(g[(size_t)row * d + c]);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Loads lse/delta for q rows [q0, q0 + kBQ); padded rows get zeros (their p
// is forced to 0 by the caller).
__device__ inline void load_row_stats(float* sLse, float* sDelta,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, int q0, int Lq) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int gr = q0 + r;
    sLse[r] = gr < Lq ? lse[gr] : 0.0f;
    sDelta[r] = gr < Lq ? delta[gr] : 0.0f;
  }
}

// p and dS for the (kBQ x kBK) tile at (q0, k0) from the scores sS and
// dP = dO V^T in sDP. Writes dS (bf16) and, when sP is given, p (bf16).
__device__ inline void probs_and_dscores(const float* sS, const float* sDP, int lds,
                                         const float* sLse, const float* sDelta,
                                         bf16* sP, bf16* sDS, int ldp, int q0, int k0,
                                         int Lq, int Lk, float scale) {
  for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK, c = i % kBK;
    const bool valid = (q0 + r < Lq) && (k0 + c < Lk);
    const float p = valid ? __expf(sS[r * lds + c] * scale - sLse[r]) : 0.0f;
    const float ds = p * (sDP[r * lds + c] - sDelta[r]) * scale;
    if (sP != nullptr) sP[r * ldp + c] = __float2bfloat16(p);
    sDS[r * ldp + c] = __float2bfloat16(ds);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int Lq, int Lk, int d, int dp, float scale) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout lay(dp, true);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sG = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sDK = reinterpret_cast<float*>(smem + lay.acc0);
  float* sDV = reinterpret_cast<float*>(smem + lay.acc1);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dpm);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const size_t qoff = (size_t)bh * Lq * d, koff = (size_t)bh * Lk * d;

  load_tile(sK, lay.ldh, k + koff, k0, kBK, Lk, d, dp);
  load_tile(sV, lay.ldh, v + koff, k0, kBK, Lk, d, dp);
  zero_f32(sDK, kBK * lay.ldf);
  zero_f32(sDV, kBK * lay.ldf);

  for (int q0 = 0; q0 < Lq; q0 += kBQ) {
    __syncthreads();  // the previous q tile's readers are done
    load_tile(sQ, lay.ldh, q + qoff, q0, kBQ, Lq, d, dp);
    load_tile(sG, lay.ldh, g + qoff, q0, kBQ, Lq, d, dp);
    load_row_stats(sLse, sDelta, lse + (size_t)bh * Lq, delta + (size_t)bh * Lq, q0, Lq);
    __syncthreads();
    warp_gemm<false, true>(sQ, lay.ldh, sK, lay.ldh, sS, lay.lds, kBQ, kBK, dp, false);
    warp_gemm<false, true>(sG, lay.ldh, sV, lay.ldh, sDP, lay.lds, kBQ, kBK, dp, false);
    __syncthreads();
    probs_and_dscores(sS, sDP, lay.lds, sLse, sDelta, sP, sDS, lay.ldp, q0, k0, Lq, Lk, scale);
    __syncthreads();
    // dV += p^T dO and dK += dS^T Q: (kBK x dp) += (kBK x kBQ)(kBQ x dp).
    warp_gemm<true, false>(sP, lay.ldp, sG, lay.ldh, sDV, lay.ldf, kBK, dp, kBQ, true);
    warp_gemm<true, false>(sDS, lay.ldp, sQ, lay.ldh, sDK, lay.ldf, kBK, dp, kBQ, true);
  }
  __syncthreads();
  store_tile(dk + koff, sDK, lay.ldf, k0, kBK, Lk, d);
  store_tile(dv + koff, sDV, lay.ldf, k0, kBK, Lk, d);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Lq, int Lk, int d, int dp, float scale) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout lay(dp, false);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sG = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sDQ = reinterpret_cast<float*>(smem + lay.acc0);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dpm);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t qoff = (size_t)bh * Lq * d, koff = (size_t)bh * Lk * d;

  load_tile(sQ, lay.ldh, q + qoff, q0, kBQ, Lq, d, dp);
  load_tile(sG, lay.ldh, g + qoff, q0, kBQ, Lq, d, dp);
  load_row_stats(sLse, sDelta, lse + (size_t)bh * Lq, delta + (size_t)bh * Lq, q0, Lq);
  zero_f32(sDQ, kBQ * lay.ldf);

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // the previous kv tile's readers are done
    load_tile(sK, lay.ldh, k + koff, k0, kBK, Lk, d, dp);
    load_tile(sV, lay.ldh, v + koff, k0, kBK, Lk, d, dp);
    __syncthreads();
    warp_gemm<false, true>(sQ, lay.ldh, sK, lay.ldh, sS, lay.lds, kBQ, kBK, dp, false);
    warp_gemm<false, true>(sG, lay.ldh, sV, lay.ldh, sDP, lay.lds, kBQ, kBK, dp, false);
    __syncthreads();
    probs_and_dscores(sS, sDP, lay.lds, sLse, sDelta, nullptr, sDS, lay.ldp, q0, k0, Lq, Lk,
                      scale);
    __syncthreads();
    // dQ += dS K: (kBQ x dp) += (kBQ x kBK)(kBK x dp).
    warp_gemm<false, false>(sDS, lay.ldp, sK, lay.ldh, sDQ, lay.ldf, kBQ, dp, kBK, true);
  }
  __syncthreads();
  store_tile(dq + qoff, sDQ, lay.ldf, q0, kBQ, Lq, d);
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* g, const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int bh, int lq, int lk, int d,
                              void* stream) {
  using namespace lmdx;
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int dp = round_up(d, 16);
  const float scale = 1.0f / sqrtf((float)d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(g);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const int rows = bh * lq;
  flash_bwd_delta_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const bf16*>(o), g_, delta_, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const BwdLayout kv_lay(dp, true);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_lay.total);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<<<dim3((lk + kBK - 1) / kBK, bh), kThreads, kv_lay.total, st>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      lq, lk, d, dp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const BwdLayout q_lay(dp, false);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_lay.total);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<dim3((lq + kBQ - 1) / kBQ, bh), kThreads, q_lay.total, st>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<bf16*>(dq), lq, lk, d, dp, scale);
  return (int)cudaGetLastError();
}
