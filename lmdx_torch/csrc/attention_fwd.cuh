// The attention forward body shared by flash_fwd.cu, flash_fwd_packed.cu,
// flash_fwd_fusedheads.cu and sam_attention.cu.
//
// O = softmax(Q K^T * scale + bias) V for one head, and optionally the row
// log-sum-exp LSE (in units of the biased, scaled scores). The caller hands
// the body this head's q (Lq, d), k/v (Lk, d) and o (Lq, d), bf16, with the
// distance between rows of each (d for a (BH, L, d) tensor, heads * d for
// the projection layout (B, L, heads * d)), and its lse row (Lq) f32 or null.
//
// Each block takes one 64-row q tile and walks the KV in 64-row tiles with
// an online softmax: running row max m and denominator l in shared memory,
// the f32 output accumulator rescaled by exp(m_old - m_new) before each P V
// product. Scores, probabilities and the accumulator stay in shared memory.
// Columns past Lk in the last tile are masked to -inf; rows past Lq are
// zero-filled on the load and not stored; head dims are zero-padded to a
// multiple of 16. The products are flash_common.cuh's WMMA tiles with f32
// accumulation; P is rounded to bf16 for the P V product. The row max starts
// at m_init and the denominator is clamped from below at l_min (-inf and 0
// give the plain softmax; the head-packed kernel passes its reference's
// -1e30 and 1e-30).
//
// The bias is a policy type: NoBias (the flash kernels) adds nothing and
// stages nothing; RelPosBias (sam_attention.cu) stages the q tile's rows of
// SAM's decomposed rel-pos bias in shared memory and adds two f32 values by
// index.
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

// One head's pointers and row strides (in elements) for the body.
struct HeadView {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // this head's (Lq) row, or null
  int ldq, ldkv, ldo;
  int bh;  // batch*head index, for the bias policy
};

// The head `bh` of row-major (BH, L, d) tensors and a (BH, Lq) lse.
__device__ inline HeadView head_of_bhld(const bf16* q, const bf16* k, const bf16* v,
                                        bf16* o, float* lse, int bh, int Lq, int Lk,
                                        int d) {
  return {q + (size_t)bh * Lq * d,
          k + (size_t)bh * Lk * d,
          v + (size_t)bh * Lk * d,
          o + (size_t)bh * Lq * d,
          lse != nullptr ? lse + (size_t)bh * Lq : nullptr,
          d, d, d, bh};
}

// The body of one block for the q tile at q0 of one head. Each source wraps
// it in a __global__ kernel of its own name, so profiles tell them apart. A
// kernel that runs it for several heads in turn puts a __syncthreads()
// between them.
template <class Bias>
__device__ __forceinline__ void attention_fwd_body(const HeadView& hv, int q0, int Lq,
                                                   int Lk, int d, int dp, float scale,
                                                   const Bias& bias, float m_init,
                                                   float l_min) {
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile_strided(sQ, lay.ldh, hv.q, hv.ldq, q0, kFwdBQ, Lq, d, dp);
  bias.stage(sB, hv.bh, q0);
  zero_f32(sO, kFwdBQ * lay.ldo);
  for (int r = threadIdx.x; r < kFwdBQ; r += kThreads) {
    sM[r] = m_init;
    sL[r] = 0.0f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kFwdBK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    load_tile_strided(sK, lay.ldh, hv.k, hv.ldkv, k0, kFwdBK, Lk, d, dp);
    load_tile_strided(sV, lay.ldh, hv.v, hv.ldkv, k0, kFwdBK, Lk, d, dp);
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
    const float inv = 1.0f / fmaxf(sL[r], l_min);
    for (int c = lane; c < dp; c += 32) sO[r * lay.ldo + c] *= inv;
  }
  __syncthreads();
  store_tile_strided(hv.o, hv.ldo, sO, lay.ldo, q0, kFwdBQ, Lq, d);
  if (hv.lse != nullptr) {
    for (int r = threadIdx.x; r < kFwdBQ; r += kThreads) {
      const int gr = q0 + r;
      if (gr < Lq) hv.lse[gr] = sM[r] + logf(fmaxf(sL[r], l_min));
    }
  }
}

// Shared memory of one block of the body; sets the kernel's dynamic limit.
// Returns a cudaError_t as int and the size in *bytes.
template <class Kernel>
int prepare_attention_fwd(Kernel kernel, int dp, int bias_cols, size_t* bytes) {
  const FwdLayout lay(dp, bias_cols);
  *bytes = lay.total;
  if (lay.total > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)lay.total);
}

// A (BH, L, d) kernel: one block per 64-row q tile (blockIdx.x) and
// batch*head (blockIdx.y), plain softmax.
template <class Bias>
__device__ __forceinline__ void attention_fwd_bhld(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, int d, int dp,
    float scale, const Bias& bias) {
  attention_fwd_body(head_of_bhld(q, k, v, o, lse, blockIdx.y, Lq, Lk, d),
                     blockIdx.x * kFwdBQ, Lq, Lk, d, dp, scale, bias, -INFINITY, 0.0f);
}

template <class Bias>
using AttentionFwdKernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, float*,
                                    int, int, int, int, float, Bias);

// Sizes shared memory and launches a (BH, L, d) `kernel` with one block per
// 64-row q tile and batch*head. Returns a cudaError_t as int.
template <class Bias>
int launch_attention_fwd(AttentionFwdKernel<Bias> kernel, const void* q, const void* k,
                         const void* v, void* o, void* lse, int bh, int lq, int lk, int d,
                         Bias bias, void* stream) {
  const int dp = round_up(d, 16);
  size_t smem = 0;
  const int err = prepare_attention_fwd(kernel, dp, bias.cols(), &smem);
  if (err != 0) return err;
  const dim3 grid((lq + kFwdBQ - 1) / kFwdBQ, bh);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), lq,
      lk, d, dp, 1.0f / sqrtf((float)d), bias);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lmdx
