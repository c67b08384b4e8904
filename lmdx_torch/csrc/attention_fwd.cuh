// The attention forward body shared by flash_fwd.cu and sam_attention.cu.
//
// O = softmax(Q K^T * scale + bias) V, and optionally the row log-sum-exp
// LSE (in units of the biased, scaled scores). q: (BH, Lq, d), k/v:
// (BH, Lk, d), o: (BH, Lq, d), all bf16 row-major; lse: (BH, Lq) f32 or null.
//
// Each block (one per 64-row q tile and batch*head) walks the KV in 64-row
// tiles with an online softmax: running row max m and denominator l in
// shared memory, the f32 output accumulator rescaled by exp(m_old - m_new)
// before each P V product. Scores, probabilities and the accumulator stay in
// shared memory. Columns past Lk in the last tile are masked to -inf; rows
// past Lq are zero-filled on the load and not stored; head dims are
// zero-padded to a multiple of 16. The products are flash_common.cuh's WMMA
// tiles with f32 accumulation; P is rounded to bf16 for the P V product.
//
// The bias is a policy type: NoBias (flash_fwd.cu) adds nothing and stages
// nothing; RelPosBias (sam_attention.cu) stages the q tile's rows of SAM's
// decomposed rel-pos bias in shared memory and adds two f32 values by index.
#pragma once

#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kFwdBQ = 64;  // q rows per block
constexpr int kFwdBK = 64;  // kv rows per inner tile

struct FwdLayout {
  int ldh, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, a, bias, total;
  // bias_cols: f32 bias values staged per q row (0 for no bias).
  __host__ __device__ FwdLayout(int dp, int bias_cols) {
    ldh = dp + 8;
    lds = kFwdBK + 4;
    ldp = kFwdBK + 8;
    ldo = dp + 4;
    Carve cv;
    q = cv.take(sizeof(bf16) * kFwdBQ * ldh);
    k = cv.take(sizeof(bf16) * kFwdBK * ldh);
    v = cv.take(sizeof(bf16) * kFwdBK * ldh);
    s = cv.take(sizeof(float) * kFwdBQ * lds);
    p = cv.take(sizeof(bf16) * kFwdBQ * ldp);
    o = cv.take(sizeof(float) * kFwdBQ * ldo);
    m = cv.take(sizeof(float) * kFwdBQ);
    l = cv.take(sizeof(float) * kFwdBQ);
    a = cv.take(sizeof(float) * kFwdBQ);
    bias = cv.take(sizeof(float) * kFwdBQ * bias_cols);
    total = cv.off;
  }
};

// A bias policy gives cols() (f32 values staged per q row), stage() (the q
// tile's rows into shared memory), col(c) (what a key column needs, worked
// out once per lane and tile) and add() (the bias of score (r, c)).

// No bias: the scaled scores as they are.
struct NoBias {
  struct Col {};
  __host__ __device__ int cols() const { return 0; }
  __device__ void stage(float*, int /*bh*/, int /*q0*/) const {}
  __device__ Col col(int /*c*/) const { return {}; }
  __device__ float add(float s, const float*, int /*r*/, Col) const { return s; }
};

// SAM's decomposed relative-position bias: bias_h (BH, N, gh) and bias_w
// (BH, N, gw) f32 row-major, N = gh * gw, key c = kh * gw + kw; score (r, c)
// gets bias_h[r, kh] + bias_w[r, kw], unscaled.
struct RelPosBias {
  struct Col {
    int h, w;  // kh and kw of key c
  };
  const float* __restrict__ h;
  const float* __restrict__ w;
  int n, gh, gw;

  __host__ __device__ int cols() const { return gh + gw; }

  // Rows [q0, q0 + kFwdBQ) of this batch*head's bias_h then bias_w into
  // shared memory; rows >= n as zeros.
  __device__ void stage(float* dst, int bh, int q0) const {
    stage_rows(dst, h + (size_t)bh * n * gh, q0, gh);
    stage_rows(dst + kFwdBQ * gh, w + (size_t)bh * n * gw, q0, gw);
  }

  __device__ Col col(int c) const {
    const int kh = c / gw;
    return {kh, c - kh * gw};
  }

  __device__ float add(float s, const float* sb, int r, Col c) const {
    return s + sb[r * gh + c.h] + sb[kFwdBQ * gh + r * gw + c.w];
  }

 private:
  __device__ void stage_rows(float* dst, const float* __restrict__ src, int q0,
                             int g) const {
    for (int i = threadIdx.x; i < kFwdBQ * g; i += kThreads) {
      const int r = i / g, c = i % g;
      const int gr = q0 + r;
      dst[i] = gr < n ? src[(size_t)gr * g + c] : 0.0f;
    }
  }
};

// The body of one block. Each source wraps it in a __global__ kernel of its
// own name (flash_fwd_kernel, sam_attention_kernel), so profiles tell them
// apart, and launches that through launch_attention_fwd.
template <class Bias>
__device__ __forceinline__ void attention_fwd_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, int d, int dp,
    float scale, const Bias& bias) {
  extern __shared__ __align__(128) char smem[];
  const FwdLayout lay(dp, bias.cols());
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sO = reinterpret_cast<float*>(smem + lay.o);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sA = reinterpret_cast<float*>(smem + lay.a);
  float* sB = reinterpret_cast<float*>(smem + lay.bias);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFwdBQ;
  const bf16* qb = q + (size_t)bh * Lq * d;
  const bf16* kb = k + (size_t)bh * Lk * d;
  const bf16* vb = v + (size_t)bh * Lk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(sQ, lay.ldh, qb, q0, kFwdBQ, Lq, d, dp);
  bias.stage(sB, bh, q0);
  zero_f32(sO, kFwdBQ * lay.ldo);
  for (int r = threadIdx.x; r < kFwdBQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kFwdBK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    load_tile(sK, lay.ldh, kb, k0, kFwdBK, Lk, d, dp);
    load_tile(sV, lay.ldh, vb, k0, kFwdBK, Lk, d, dp);
    __syncthreads();
    warp_gemm<false, true>(sQ, lay.ldh, sK, lay.ldh, sS, lay.lds, kFwdBQ, kFwdBK, dp,
                           false);
    __syncthreads();

    // Bias and online softmax, one warp per row; each lane holds two columns.
    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    const typename Bias::Col col0 = bias.col(c0), col1 = bias.col(c1);
    for (int r = warp; r < kFwdBQ; r += kWarps) {
      const float s0 =
          c0 < Lk ? bias.add(sS[r * lay.lds + lane] * scale, sB, r, col0) : -INFINITY;
      const float s1 =
          c1 < Lk ? bias.add(sS[r * lay.lds + lane + 32] * scale, sB, r, col1) : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new);
      const float p1 = __expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      sP[r * lay.ldp + lane] = __float2bfloat16(p0);
      sP[r * lay.ldp + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);  // 0 on the first tile
        sA[r] = alpha;
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + row_sum;
      }
    }
    __syncthreads();
    for (int r = warp; r < kFwdBQ; r += kWarps) {
      const float alpha = sA[r];
      for (int c = lane; c < dp; c += 32) sO[r * lay.ldo + c] *= alpha;
    }
    __syncthreads();
    warp_gemm<false, false>(sP, lay.ldp, sV, lay.ldh, sO, lay.ldo, kFwdBQ, dp, kFwdBK,
                            true);
  }
  __syncthreads();

  for (int r = warp; r < kFwdBQ; r += kWarps) {
    const float inv = 1.0f / sL[r];
    for (int c = lane; c < dp; c += 32) sO[r * lay.ldo + c] *= inv;
  }
  __syncthreads();
  store_tile(o + (size_t)bh * Lq * d, sO, lay.ldo, q0, kFwdBQ, Lq, d);
  if (lse != nullptr) {
    for (int r = threadIdx.x; r < kFwdBQ; r += kThreads) {
      const int gr = q0 + r;
      if (gr < Lq) lse[(size_t)bh * Lq + gr] = sM[r] + logf(sL[r]);
    }
  }
}

template <class Bias>
using AttentionFwdKernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, float*,
                                    int, int, int, int, float, Bias);

// Sizes shared memory and launches `kernel` with one block per 64-row q tile
// and batch*head. Returns a cudaError_t as int.
template <class Bias>
int launch_attention_fwd(AttentionFwdKernel<Bias> kernel, const void* q, const void* k,
                         const void* v, void* o, void* lse, int bh, int lq, int lk, int d,
                         Bias bias, void* stream) {
  const int dp = round_up(d, 16);
  const FwdLayout lay(dp, bias.cols());
  if (lay.total > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kFwdBQ - 1) / kFwdBQ, bh);
  kernel<<<grid, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), lq,
      lk, d, dp, 1.0f / sqrtf((float)d), bias);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lmdx
