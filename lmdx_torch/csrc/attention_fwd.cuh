// The attention forward body shared by flash_fwd.cu, flash_fwd_packed.cu,
// flash_fwd_fusedheads.cu and sam_attention.cu.
//
// O = softmax(Q K^T * scale + bias) V for one head, and optionally the row
// log-sum-exp LSE (natural log, in units of the biased, scaled scores). The
// caller hands the body this head's q (Lq, d), k/v (Lk, d) and o (Lq, d),
// bf16, with the distance between rows of each (d for a (BH, L, d) tensor,
// heads * d for the projection layout (B, L, heads * d)), and its lse row
// (Lq) f32 or null.
//
// What bounds it on an H100, and what the design does about it. At the long
// shapes (L >= 1024) the work is tensor-core operations; what decides the
// pace is how many shared-memory bytes and synchronisations each product
// costs. So:
//
// - Scores, probabilities and the output accumulator live in registers. A
//   warp owns 16 q rows of the block's q tile (FwdTile: 4 or 8 warps) and
//   issues mma.sync.m16n8k16 (bf16 in, f32 out) itself. Its q fragments are
//   loaded once (ldmatrix) and kept; S (16 x 64 f32) is an accumulator
//   fragment; the online softmax runs on the fragment, the row max reduced
//   over the four lanes that share a row by two shuffles, the row sum kept
//   per lane and reduced once at the end; P is
//   rounded to bf16 and repacked in registers into the A fragment of P V; O
//   is rescaled in registers. Only K/V tiles, SAM's bias rows, and Q until
//   its fragments are loaded (its rows then stage the warp's O for 16-byte
//   stores) are in shared memory.
// - K and V arrive through cp.async in 16-byte pieces, fwd_stages(DP) - 1
//   tiles of 64 keys ahead of the one being multiplied, with one __syncthreads() a
//   tile. Rows are padded by 16 bytes, which makes every ldmatrix (plain for
//   K, .trans for V) free of bank conflicts. Rows >= L and head-dim columns
//   >= d are zero-filled (cp.async with a source size of 0); key columns
//   >= Lk are masked to -inf in the fragment. A pointer or row stride that
//   is not a multiple of 16 bytes, or a head dim that is not a multiple of
//   8, takes element-wise loads and stores inside the same kernel.
// - exp2 with scale * log2(e) folded into the score: one multiply a score,
//   one ex2.approx; the LSE is converted back to natural units on the store.
// - The head dim is a template parameter DP (d padded up to an instantiated
//   width: 48, 64, 80, 160, and 256 for everything above), so every
//   fragment index is static. At DP = 256 the q fragments are re-read from
//   shared memory each tile to stay inside the register file.
//
// The row max starts at m_init and the denominator is clamped from below at
// l_min (-inf and 0 give the plain softmax; the head-packed kernel passes its
// reference's -1e30 and 1e-30).
//
// The bias is a policy type: NoBias (the flash kernels) adds nothing and
// stages nothing; RelPosBias (sam_attention.cu) stages the q tile's rows of
// SAM's decomposed rel-pos bias in shared memory (cp.async, f32) and adds two
// f32 values by index to each fragment element, each thread working out its
// own (row, column).
#pragma once

#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kFwdBK = 64;  // kv rows per inner tile

// A block's share of the q rows: WARPS warps of 16 rows each.
template <int WARPS>
struct FwdTile {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kBQ = 16 * WARPS;  // q rows per block
};

// The q tile of the three flash forwards at each instantiated head dim, set
// by hand to the faster of 64 rows on 4 warps and 128 rows on 8 warps as
// measured on the card at the UNet's shapes (PERF.md has both times): 128
// rows at 48 and 80, 64 rows elsewhere.
template <int DP>
using FlashTile = std::conditional_t<DP == 48 || DP == 80, FwdTile<8>, FwdTile<4>>;

// K/V tiles in shared memory: three (two loading while one is multiplied)
// where that leaves room for several blocks on an SM, else two.
__host__ __device__ constexpr int fwd_stages(int dp) { return dp <= 80 ? 3 : 2; }

// Bytes of dynamic shared memory of one block: Q, the K/V ring, the bias.
template <int DP, class Tile>
constexpr size_t fwd_smem_bytes(size_t bias_floats) {
  return sizeof(bf16) * (DP + 8) * (Tile::kBQ + fwd_stages(DP) * 2 * kFwdBK) +
         sizeof(float) * bias_floats;
}

// ---------------------------------------------------------------------------
// Bias policies
// ---------------------------------------------------------------------------
//
// A bias policy gives smem_floats(rows) (f32 values staged for a q tile of
// `rows` rows), stage() (the q tile's rows into shared memory, by cp.async;
// the body commits and waits), col(c) / next(col, step) (what a key column
// needs, worked out once per thread and tile and stepped from there) and
// add2() (the bias of scores (r, c) and (r, c + 1), c even). Scores reach
// add2 multiplied by scale * log2(e); it adds bias * log2(e).

// No bias: the scaled scores as they are.
struct NoBias {
  struct Col {};
  __host__ __device__ size_t smem_floats(int /*rows*/) const { return 0; }
  __device__ void stage(float*, int /*bh*/, int /*q0*/, int /*rows*/) const {}
  __device__ Col col(int /*c*/) const { return {}; }
  __device__ Col next(Col c, int /*step*/) const { return c; }
  __device__ void add2(float&, float&, const float*, int /*rows*/, int /*r*/, Col) const {}
};

// SAM's decomposed relative-position bias: bias_h (BH, N, gh) and bias_w
// (BH, N, gw) f32 row-major, N = gh * gw, key c = kh * gw + kw; score (r, c)
// gets bias_h[r, kh] + bias_w[r, kw], unscaled, in f32.
//
// The staged rows are padded so that a warp's reads spread over the banks:
// the 8 rows a warp reads at once lie sh = 4 (mod 8) floats apart for bias_h
// (one 4-byte read a row, the four lanes of a row on one address) and
// sw = 8 (mod 16) apart for bias_w (one 8-byte read of columns (c, c + 1) a
// lane where gw is even, so that a pair never straddles a grid row).
struct RelPosBias {
  struct Col {
    int h, w;  // kh and kw of key c
  };
  const float* __restrict__ h;
  const float* __restrict__ w;
  int n, gh, gw;

  __host__ __device__ int stride_h() const { return gh + ((4 - gh % 8) + 8) % 8; }
  __host__ __device__ int stride_w() const { return gw + ((8 - gw % 16) + 16) % 16; }
  __host__ __device__ size_t smem_floats(int rows) const {
    return (size_t)rows * (stride_h() + stride_w());
  }

  // Rows [q0, q0 + rows) of this batch*head's bias_h then bias_w into shared
  // memory; rows >= n as zeros.
  __device__ void stage(float* dst, int bh, int q0, int rows) const {
    stage_rows(dst, stride_h(), h + (size_t)bh * n * gh, gh, q0, rows);
    stage_rows(dst + rows * stride_h(), stride_w(), w + (size_t)bh * n * gw, gw, q0, rows);
  }

  __device__ Col col(int c) const {
    const int kh = c / gw;
    return {kh, c - kh * gw};
  }

  __device__ Col next(Col c, int step) const {
    c.w += step;
    while (c.w >= gw) {
      c.w -= gw;
      ++c.h;
    }
    return c;
  }

  // Columns past N (masked by the body afterwards) read padding or a
  // neighbouring row: inside the staged block, and never used.
  __device__ void add2(float& s0, float& s1, const float* sb, int rows, int r, Col c) const {
    const float* sh = sb + r * stride_h();
    const float* sw = sb + rows * stride_h() + r * stride_w();
    if ((gw & 1) == 0) {
      const float bh = sh[c.h];
      const float2 bw = *reinterpret_cast<const float2*>(sw + c.w);
      s0 = fmaf(bh + bw.x, kLog2e, s0);
      s1 = fmaf(bh + bw.y, kLog2e, s1);
    } else {
      const Col c1 = next(c, 1);
      s0 = fmaf(sh[c.h] + sw[c.w], kLog2e, s0);
      s1 = fmaf(sh[c1.h] + sw[c1.w], kLog2e, s1);
    }
  }

 private:
  __device__ void stage_rows(float* dst, int stride, const float* __restrict__ src, int g,
                             int q0, int rows) const {
    if ((g & 3) == 0 && aligned16(src)) {
      const int pieces = g / 4;
      for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
        const int r = i / pieces, c = (i % pieces) * 4;
        const bool in = q0 + r < n;
        cp_async_16(dst + r * stride + c, in ? src + (size_t)(q0 + r) * g + c : src,
                    in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < rows * g; i += blockDim.x) {
        const int r = i / g, c = i % g;
        const bool in = q0 + r < n;
        cp_async_4(dst + r * stride + c, in ? src + (size_t)(q0 + r) * g + c : src,
                   in ? 4 : 0);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

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

// The body of one block for the q tile at q0 of one head (Tile::kBQ rows,
// d <= DP). Each source wraps it in a __global__ kernel of its own name, so
// profiles tell them apart.
template <int DP, class Tile, class Bias>
__device__ __forceinline__ void attention_fwd_body(const HeadView& hv, int q0, int Lq,
                                                   int Lk, int d, float scale,
                                                   const Bias& bias, float m_init,
                                                   float l_min) {
  constexpr int LDS = DP + 8;       // shared row pitch, elements
  constexpr int KS = DP / 16;       // 16-deep steps of Q K^T
  constexpr int NB = DP / 8;        // 8-wide column blocks of O
  constexpr int BQ = Tile::kBQ;
  constexpr int THREADS = Tile::kThreads;
  constexpr int STAGES = fwd_stages(DP);
  constexpr int STAGE_ELEMS = 2 * kFwdBK * LDS;  // one K tile and one V tile
  constexpr bool KEEP_Q = DP <= 160;
  static_assert(DP % 16 == 0, "the head dim is padded to whole 16-deep steps");

  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BQ * LDS;
  float* sB = reinterpret_cast<float*>(sKV + STAGES * STAGE_ELEMS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wr0 = warp * 16;              // the warp's first row of the q tile
  const float scale_log2 = scale * kLog2e;
  const int ntiles = (Lk + kFwdBK - 1) / kFwdBK;
  const bool vec_kv = rows_vectorize(hv.k, hv.ldkv, d) && rows_vectorize(hv.v, hv.ldkv, d);

  auto load_kv = [&](int tile) {
    bf16* sK = sKV + (tile % STAGES) * STAGE_ELEMS;
    load_rows<DP, kFwdBK, THREADS>(sK, hv.k, hv.ldkv, tile * kFwdBK, Lk, d, vec_kv);
    load_rows<DP, kFwdBK, THREADS>(sK + kFwdBK * LDS, hv.v, hv.ldkv, tile * kFwdBK, Lk, d,
                                   vec_kv);
  };

  // Q and the bias rows travel in the first group, with KV tile 0.
  load_rows<DP, BQ, THREADS>(sQ, hv.q, hv.ldq, q0, Lq, d, rows_vectorize(hv.q, hv.ldq, d));
  bias.stage(sB, hv.bh, q0, BQ);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  uint32_t qf[KEEP_Q ? KS : 1][4];
  float o[NB][4];
  float m[2], l[2];  // l: this lane's part of the row sum
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
  }
  m[0] = m[1] = m_init;
  l[0] = l[1] = 0.0f;

  // ldmatrix lane offsets. A (rows x 16, row-major): lanes 0-15 rows 0-15 at
  // column 0, lanes 16-31 the same rows at column 8. B of Q K^T from K rows
  // (key-major): matrices (keys 0-7, k 0-7), (keys 0-7, k 8-15), (keys 8-15,
  // k 0-7), (keys 8-15, k 8-15). B of P V from V rows through .trans:
  // (keys 0-7, dims 0-7), (keys 8-15, dims 0-7), (keys 0-7, dims 8-15),
  // (keys 8-15, dims 8-15).
  const int a_off = (lane & 15) * LDS + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8;

  for (int tile = 0; tile < ntiles; ++tile) {
    // Tile `tile` has landed for this thread; after the barrier for all, and
    // every warp is done with tile - 1, whose buffer the next load refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < ntiles) load_kv(tile + STAGES - 1);
    cp_async_commit();

    if (KEEP_Q && tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(qf[KEEP_Q ? kk : 0], sQ + wr0 * LDS + kk * 16 + a_off);
      }
    }

    const bf16* sK = sKV + (tile % STAGES) * STAGE_ELEMS;
    const bf16* sV = sK + kFwdBK * LDS;
    const int k0 = tile * kFwdBK;

    // S = Q K^T for the warp's rows and this tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!KEEP_Q) ldmatrix_x4(qf[0], sQ + wr0 * LDS + kk * 16 + a_off);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {  // 16 keys
        uint32_t b[4];
        ldmatrix_x4(b, sK + j2 * 16 * LDS + kk * 16 + k_off);
        mma_16816(s[2 * j2], qf[KEEP_Q ? kk : 0], b[0], b[1]);
        mma_16816(s[2 * j2 + 1], qf[KEEP_Q ? kk : 0], b[2], b[3]);
      }
    }

    // Scale into log2 units, add the bias, mask the columns past Lk. Element
    // e of block j: row g + 8 * (e / 2), column 8 * j + 2 * t + e % 2.
    typename Bias::Col col = bias.col(k0 + 2 * t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& s0 = s[j][2 * hf];
        float& s1 = s[j][2 * hf + 1];
        s0 *= scale_log2;
        s1 *= scale_log2;
        bias.add2(s0, s1, sB, BQ, wr0 + g + 8 * hf, col);
      }
      col = bias.next(col, 8);
    }
    if (k0 + kFwdBK > Lk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + 8 * j + 2 * t;
        if (c >= Lk) s[j][0] = s[j][2] = -INFINITY;
        if (c + 1 >= Lk) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // Online softmax on the fragment; P repacked as the A operand of P V.
    uint32_t p[4][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = fmaxf(s[0][2 * hf], s[0][2 * hf + 1]);
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = ex2(m[hf] - m_new);  // 0 on the first tile
      m[hf] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(s[j][2 * hf] - m_new);
        const float p1 = ex2(s[j][2 * hf + 1] - m_new);
        sum += p0 + p1;
        // a0/a2: row g, a1/a3: row g + 8; a0/a1: keys 0-7, a2/a3: keys 8-15.
        p[j / 2][hf + 2 * (j % 2)] = pack_bf16(p0, p1);
      }
      l[hf] = l[hf] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        o[nb][2 * hf] *= alpha;
        o[nb][2 * hf + 1] *= alpha;
      }
    }

    // O += P V.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {  // 16 head-dim columns
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + kk * 16 * LDS + n2 * 16 + v_off);
        mma_16816(o[2 * n2], p[kk], b[0], b[1]);
        mma_16816(o[2 * n2 + 1], p[kk], b[2], b[3]);
      }
    }
  }

  // Normalize; stage the warp's O rows as bf16 in its own rows of sQ (only
  // this warp read them), then store in 16-byte pieces.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum = fmaxf(sum, l_min);
    const float inv = 1.0f / sum;
    const int r = wr0 + g + 8 * hf;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      *reinterpret_cast<uint32_t*>(sQ + r * LDS + nb * 8 + 2 * t) =
          pack_bf16(o[nb][2 * hf] * inv, o[nb][2 * hf + 1] * inv);
    }
    if (hv.lse != nullptr && t == 0 && q0 + r < Lq) {
      hv.lse[q0 + r] = m[hf] * kLn2 + logf(sum);
    }
  }
  __syncwarp();
  if (rows_vectorize(hv.o, hv.ldo, d)) {
    constexpr int PIECES = DP / 8;
    for (int i = lane; i < 16 * PIECES; i += 32) {
      const int r = wr0 + i / PIECES, c = (i % PIECES) * 8;
      if (q0 + r < Lq && c < d) {
        *reinterpret_cast<uint4*>(hv.o + (size_t)(q0 + r) * hv.ldo + c) =
            *reinterpret_cast<const uint4*>(sQ + r * LDS + c);
      }
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = wr0 + i / DP, c = i % DP;
      if (q0 + r < Lq && c < d) hv.o[(size_t)(q0 + r) * hv.ldo + c] = sQ[r * LDS + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Sizes shared memory for one block of the body and launches `kernel`.
// Returns a cudaError_t as int.
template <int DP, class Tile, class... Params, class... Args>
int launch_attention_fwd(void (*kernel)(Params...), dim3 grid, size_t bias_floats,
                         void* stream, Args... args) {
  const size_t smem = fwd_smem_bytes<DP, Tile>(bias_floats);
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, Tile::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// A (BH, L, d) kernel's block: one q tile (blockIdx.x) of one batch*head
// (blockIdx.y), plain softmax.
template <int DP, class Tile, class Bias>
__device__ __forceinline__ void attention_fwd_bhld(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, int d, float scale,
    const Bias& bias) {
  attention_fwd_body<DP, Tile>(head_of_bhld(q, k, v, o, lse, blockIdx.y, Lq, Lk, d),
                               blockIdx.x * Tile::kBQ, Lq, Lk, d, scale, bias, -INFINITY,
                               0.0f);
}

}  // namespace
}  // namespace lmdx
