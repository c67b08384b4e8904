// Flash-attention forward for the UNet's untapped attention layers.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention (the TPU
// kernel, l.107). Computes O = softmax(Q K^T / sqrt(d)) V and the row
// log-sum-exp LSE (in units of the scaled scores) that the backward needs.
// q: (BH, Lq, d), k/v: (BH, Lk, d), o: (BH, Lq, d), all bf16 row-major;
// lse: (BH, Lq) f32.
//
// What bounds it on an H100: at the main path's shapes (Lq = Lk = 4096,
// 1024, 256; d = 40, 80, 160) the work is 4 Lq Lk d operations against
// ~2 (Lq + 2 Lk) d bytes of input, an intensity of ~Lq / 2 operations per
// byte, far above the card's ~295 bf16 ops/byte: it is bound by tensor-core
// operations, and the (Lq, Lk) probabilities must never reach device memory.
//
// Design. The TPU kernel held the whole KV in VMEM per q-block; on Hopper
// the KV does not fit in a block's shared memory, so each block (one per
// 64-row q tile and batch*head) walks the KV in 64-row tiles with an online
// softmax: running row max m and denominator l in shared memory, the f32
// output accumulator rescaled by exp(m_old - m_new) before each P V product.
// Scores, probabilities and the accumulator stay in shared memory. The
// unaligned KV of the GLIGEN fuser (Lk = Lq + 30) is masked to -inf in the
// last tile; head dims 40/80/160 are zero-padded to a multiple of 16 on
// load. The products use WMMA bf16 tiles with f32 accumulation. Not yet
// done (later work): wgmma, TMA loads, a software pipeline, accumulators in
// registers.
#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // kv rows per inner tile

struct FwdLayout {
  int ldh, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, a, total;
  __host__ __device__ explicit FwdLayout(int dp) {
    ldh = dp + 8;
    lds = kBK + 4;
    ldp = kBK + 8;
    ldo = dp + 4;
    Carve cv;
    q = cv.take(sizeof(bf16) * kBQ * ldh);
    k = cv.take(sizeof(bf16) * kBK * ldh);
    v = cv.take(sizeof(bf16) * kBK * ldh);
    s = cv.take(sizeof(float) * kBQ * lds);
    p = cv.take(sizeof(bf16) * kBQ * ldp);
    o = cv.take(sizeof(float) * kBQ * ldo);
    m = cv.take(sizeof(float) * kBQ);
    l = cv.take(sizeof(float) * kBQ);
    a = cv.take(sizeof(float) * kBQ);
    total = cv.off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int d, int dp,
                 float scale) {
  extern __shared__ __align__(128) char smem[];
  const FwdLayout lay(dp);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sO = reinterpret_cast<float*>(smem + lay.o);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sA = reinterpret_cast<float*>(smem + lay.a);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + (size_t)bh * Lq * d;
  const bf16* kb = k + (size_t)bh * Lk * d;
  const bf16* vb = v + (size_t)bh * Lk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(sQ, lay.ldh, qb, q0, kBQ, Lq, d, dp);
  zero_f32(sO, kBQ * lay.ldo);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    load_tile(sK, lay.ldh, kb, k0, kBK, Lk, d, dp);
    load_tile(sV, lay.ldh, vb, k0, kBK, Lk, d, dp);
    __syncthreads();
    warp_gemm<false, true>(sQ, lay.ldh, sK, lay.ldh, sS, lay.lds, kBQ, kBK, dp, false);
    __syncthreads();

    // Online softmax, one warp per row; each lane holds two columns.
    for (int r = warp; r < kBQ; r += kWarps) {
      float s0 = sS[r * lay.lds + lane] * scale;
      float s1 = sS[r * lay.lds + lane + 32] * scale;
      if (k0 + lane >= Lk) s0 = -INFINITY;
      if (k0 + lane + 32 >= Lk) s1 = -INFINITY;
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
    for (int r = warp; r < kBQ; r += kWarps) {
      const float alpha = sA[r];
      for (int c = lane; c < dp; c += 32) sO[r * lay.ldo + c] *= alpha;
    }
    __syncthreads();
    warp_gemm<false, false>(sP, lay.ldp, sV, lay.ldh, sO, lay.ldo, kBQ, dp, kBK, true);
  }
  __syncthreads();

  for (int r = warp; r < kBQ; r += kWarps) {
    const float inv = 1.0f / sL[r];
    for (int c = lane; c < dp; c += 32) sO[r * lay.ldo + c] *= inv;
  }
  __syncthreads();
  store_tile(o + (size_t)bh * Lq * d, sO, lay.ldo, q0, kBQ, Lq, d);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int gr = q0 + r;
    if (gr < Lq) lse[(size_t)bh * Lq + gr] = sM[r] + logf(sL[r]);
  }
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int bh, int lq, int lk, int d,
                              void* stream) {
  using namespace lmdx;
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int dp = round_up(d, 16);
  const FwdLayout lay(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<<<grid, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      lq, lk, d, dp, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}
