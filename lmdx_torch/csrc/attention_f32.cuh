// Float32 attention body on float32 FMA: the float32 forms of kernels 1, 3
// and 5 (kernels 2-f32 and 4-f32 run on the tensor cores, attention_f32_tc.cuh).
//
// The Pallas kernels (lmdx/nn/pallas/flash_attention.py::_pallas_attention,
// l.107, and _pallas_attention_packed, l.211; lmdx/nn/pallas/sam_attention.py::
// _pallas_sam_attention, l.101) take any dtype. At float32 they keep every
// product and every probability in float32, and so does the reference's
// no-autocast run (LMD's published precision). The bf16 body
// (attention_fwd.cuh) cannot serve them: its mma.sync m16n8k16 takes bf16
// operands only, and it rounds P to bf16 for the tensor cores. This body
// keeps scores, P, O and the LSE in float32 and multiplies with float32 FMA
// on the CUDA cores; these three kernels take no TF32 product (a single TF32
// pass keeps ~3 decimal digits; 3xTF32 is attention_f32_tc.cuh's).
//
// What bounds it on an H100. Each kernel does 4 Lq Lk d operations on a few
// bytes per input element, far above the card's ~20 float32 operations per
// byte of HBM: it is bound by operations at the card's float32 FMA rate (67
// TFLOP/s, H100 SXM, outside the tensor cores), and the (Lq, Lk)
// probabilities never reach device memory.
//
// Design, the simple form: one block of 256 threads (16 x 16) per 64-row q
// tile and batch*head. The tile's rows and the walked 64-row KV tiles sit in
// shared memory as float32 rows, zero-filled past L and d; each thread
// computes a register micro-tile of the scores (rows ty*TM .. ty*TM+TM-1,
// columns tx + 16 j) by FMA over the head dim, the online softmax reduces
// each row over the 16 threads of a half-warp with shuffles, the
// probabilities go through shared memory, and each thread accumulates TM
// rows x DP/16 columns (tx + 16 c) of its output in registers. Scores are in
// log2 units (scale * log2 e folded into one multiply, ex2 for exp) and the
// LSE leaves in natural units, as in the bf16 body; the row max starts at
// the caller's m_init and the denominator is clamped at its l_min ((-inf,
// 0): kernels 1 and 5; the head-packed kernel 3 passes its reference's
// (-1e30, 1e-30)), and keys >= Lk (the GLIGEN fuser's L + 30) are masked to
// -inf. The forward reads a head through a view (F32HeadView: pointers and
// row strides; the tensor-core fused-heads kernel takes the same view). Rows
// of a float32 tile lie DP + 1 floats apart (an odd stride: the 16 rows that
// the 16 tx threads read at one column fall in 16 banks); probability tiles
// 4 floats wider than their width (the two half-warps' rows fall in opposite
// halves of the banks). No cp.async ring, no double buffering: tiles load
// with plain coalesced loads between two barriers. Shared memory above 48 KB
// is granted with cudaFuncSetAttribute. Not done for these three kernels:
// 3xTF32 on mma.sync m16n8k8 (the tensor-core body's, K2 in ROADMAP), vector
// shared loads, a load ring.
#pragma once

#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kF32Threads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kF32BK = 64;        // KV rows of a forward tile
constexpr int kF32BQ = 64;        // q rows of a forward block

// Floats between the rows of a (rows, DP) tile.
__host__ __device__ constexpr int f32_ld(int dp) { return dp + 1; }
// Floats between the rows of a probability tile of `cols` columns.
__host__ __device__ constexpr int f32_ldp(int cols) { return cols + 4; }

// Rows [row0, row0 + ROWS) of an (L, d) float32 matrix whose rows lie ld
// floats apart into a shared tile of DP columns; rows >= L and columns >= d
// become zeros.
template <int DP, int ROWS>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* __restrict__ src, int ld,
                                              int row0, int L, int d) {
  constexpr int LD = f32_ld(DP);
  for (int i = threadIdx.x; i < ROWS * DP; i += kF32Threads) {
    const int r = i / DP, c = i - r * DP;
    const int gr = row0 + r;
    dst[r * LD + c] = (gr < L && c < d) ? src[(size_t)gr * ld + c] : 0.0f;
  }
}

// acc[i][j] += sum over c < DP of A[ty*TM + i][c] * B[tx + 16 j][c]; A and B
// are shared tiles of DP columns.
template <int DP, int TM, int TN>
__device__ __forceinline__ void f32_abt(float (&acc)[TM][TN], const float* A, const float* B,
                                        int ty, int tx) {
  constexpr int LD = f32_ld(DP);
  const float* a0 = A + ty * TM * LD;
  const float* b0 = B + tx * LD;
#pragma unroll 8
  for (int c = 0; c < DP; ++c) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = a0[i * LD + c];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = b0[j * 16 * LD + c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][c] += sum over k < K of P[ty*TM + i][k] * V[k][tx + 16 c]; P is a
// shared (rows, K) tile LDP floats a row, V a shared tile of DP columns.
template <int DP, int TM, int K, int LDP>
__device__ __forceinline__ void f32_pv(float (&acc)[TM][DP / 16], const float* P, const float* V,
                                       int ty, int tx) {
  constexpr int LD = f32_ld(DP), NC = DP / 16;
  const float* p0 = P + ty * TM * LDP;
  const float* v0 = V + tx;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float p[TM], w[NC];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = p0[i * LDP + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) w[c] = v0[k * LD + 16 * c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }
}

// Reductions over the 16 threads (tx) of a half-warp that share a row.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// No bias: kernel 1.
struct F32NoBias {
  static constexpr bool kHas = false;
  __host__ __device__ size_t smem_floats(int) const { return 0; }
  __device__ void stage(float*, size_t, int, int) const {}
  __device__ float at(const float*, int, int) const { return 0.0f; }
};

// SAM's decomposed rel-pos bias (kernel 5): bias_h (BH, N, gh) and bias_w
// (BH, N, gw), key index kh * gw + kw; a block stages its q rows of both in
// shared memory, gh + gw floats a row.
struct F32RelPosBias {
  static constexpr bool kHas = true;
  const float* bias_h;
  const float* bias_w;
  int n, gh, gw;
  __host__ __device__ size_t smem_floats(int rows) const { return (size_t)rows * (gh + gw); }
  __device__ void stage(float* dst, size_t bh, int q0, int rows) const {
    const int w = gh + gw;
    for (int i = threadIdx.x; i < rows * w; i += kF32Threads) {
      const int r = i / w, c = i - r * w, gr = q0 + r;
      float x = 0.0f;
      if (gr < n) {
        x = c < gh ? bias_h[((size_t)bh * n + gr) * gh + c]
                   : bias_w[((size_t)bh * n + gr) * gw + (c - gh)];
      }
      dst[i] = x;
    }
  }
  // The bias of staged row r at key < n (a key past n has no entry).
  __device__ float at(const float* s, int r, int key) const {
    const float* row = s + r * (gh + gw);
    return row[key / gw] + row[gh + key % gw];
  }
};

template <int DP, class Bias>
__host__ __device__ size_t f32_fwd_smem_bytes(const Bias& bias) {
  return sizeof(float) * ((size_t)(kF32BQ + 2 * kF32BK) * f32_ld(DP) +
                          (size_t)kF32BQ * f32_ldp(kF32BK) + bias.smem_floats(kF32BQ));
}

// One head as the forward reads it: row pointers and row strides in floats
// (d for a (BH, L, d) tensor, heads * d for the projection layout), this
// head's LSE row (or null), and its batch*head index for the bias policy.
struct F32HeadView {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int ldq, ldk, ldv, ldo;
  int bh;
};

// The head `bh` of row-major (BH, L, d) tensors and a (BH, Lq) lse.
__device__ inline F32HeadView f32_head_of_bhld(const float* q, const float* k, const float* v,
                                               float* o, float* lse, int bh, int Lq, int Lk,
                                               int d) {
  return {q + (size_t)bh * Lq * d,
          k + (size_t)bh * Lk * d,
          v + (size_t)bh * Lk * d,
          o + (size_t)bh * Lq * d,
          lse != nullptr ? lse + (size_t)bh * Lq : nullptr,
          d, d, d, d, bh};
}

// One forward block: q rows [q0, q0 + 64) of the head `hv`.
// o = softmax(q k^T scale + bias) v; lse (natural units) when not null. The
// row max starts at m_init (log2 units) and the denominator is clamped from
// below at l_min.
template <int DP, class Bias>
__device__ __forceinline__ void attention_f32_fwd_body(const F32HeadView& hv, int q0, int Lq,
                                                       int Lk, int d, float scale_log2,
                                                       const Bias& bias, float m_init,
                                                       float l_min) {
  constexpr int TM = kF32BQ / 16, TN = kF32BK / 16, NC = DP / 16;
  constexpr int LD = f32_ld(DP), LDP = f32_ldp(kF32BK);
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kF32BQ * LD;
  float* sV = sK + kF32BK * LD;
  float* sP = sV + kF32BK * LD;
  float* sB = sP + kF32BQ * LDP;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  f32_load_rows<DP, kF32BQ>(sQ, hv.q, hv.ldq, q0, Lq, d);
  bias.stage(sB, hv.bh, q0, kF32BQ);

  float m[TM], l[TM], acc[TM][NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = m_init;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kF32BK) {
    __syncthreads();  // the previous tile's sK, sV and sP are read
    f32_load_rows<DP, kF32BK>(sK, hv.k, hv.ldk, k0, Lk, d);
    f32_load_rows<DP, kF32BK>(sV, hv.v, hv.ldv, k0, Lk, d);
    __syncthreads();
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    }
    f32_abt<DP, TM, TN>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = -INFINITY;  // keys >= Lk; their bias row entries do not exist
        if (key < Lk) {
          x = s[i][j] * scale_log2;
          if (Bias::kHas) x = fmaf(bias.at(sB, r, key), kLog2e, x);
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(mt));
      const float alpha = ex2(m[i] - mn);  // 0 on the first tile (m = m_init)
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ex2(s[i][j] - mn);
        l[i] += p;
        sP[r * LDP + tx + 16 * j] = p;
      }
      m[i] = mn;
    }
    __syncthreads();
    f32_pv<DP, TM, kF32BK, LDP>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float li = fmaxf(half_warp_sum(l[i]), l_min);
    const int r = q0 + ty * TM + i;
    if (r < Lq) {
      const float inv = 1.0f / li;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) hv.o[(size_t)r * hv.ldo + col] = acc[i][c] * inv;
      }
      if (hv.lse != nullptr && tx == 0) hv.lse[r] = m[i] * kLn2 + logf(li);
    }
  }
}

}  // namespace
}  // namespace lmdx
