// Float32 attention on the tensor cores: the float32 forms of every attention
// kernel. One forward body serves kernels 1-f32 (the per-head forward), 3-f32
// (the same from the head-packed reference's start values), 4-f32 (the
// fused-heads forward) and 5-f32 (SAM's attention with its rel-pos bias); the
// dQ and dK/dV bodies are kernel 2-f32 (the backward).
//
// Replaces, at float32: lmdx/nn/pallas/flash_attention.py::_pallas_attention
// (l.107), _pallas_attention_packed (l.211) and _pallas_attention_fusedheads
// (l.622) (the forward body), lmdx/nn/pallas/sam_attention.py::
// _pallas_sam_attention (l.101) (the forward body with the bias policy), and
// flash_attention.py::_pallas_attention_bwd (l.384) (the dQ and dK/dV
// bodies). At float32 the Pallas kernels keep every product and probability
// in float32, and so does the reference's no-autocast run (LMD's published
// precision); the bf16 body (attention_fwd.cuh) cannot serve them (m16n8k16
// takes bf16 operands, and it rounds P to bf16).
//
// What bounds them on an H100. The work is 4 (forward) or 10 (backward)
// Lq Lk d operations on a few bytes per input element, far above the card's
// ~20 float32 operations per byte of HBM: operations, and the (Lq, Lk)
// scores never reach device memory. Float32 accuracy on the tensor cores
// costs three TF32 products a product (3xTF32, below), so the least time is
// the operations at a third of the dense TF32 rate, 495 / 3 = 165 TFLOP/s
// (against 67 TFLOP/s of float32 FMA outside the tensor cores).
//
// 3xTF32. Each operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and a product a b is summed as small_a big_b +
// big_a small_b + big_a big_b into float32 accumulators on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (the small terms first;
// CUTLASS's OpMultiplyAddFastF32, which PyTorch's memory-efficient attention
// runs at float32). Only small_a small_b, below 2^-22 of the product, is
// dropped. Scores, P, dP, dS, O, the LSE and every gradient stay float32; no
// product takes a single TF32 pass. The tensor cores' own sums truncate, so a
// product summed across tiles adds each tile's part to its running sum by
// float32 adds (kTcChain). The split's rounding is cvt.rna's, done by two
// integer operations (tf32_rna): the same bits on finite values as the
// conversion instruction, which made the kernels 20-30% slower.
//
// Design, the bf16 body's (attention_fwd.cuh, flash_bwd.cu) at float32:
// - A warp owns 16 rows of the block's tile and issues mma.sync itself. The
//   scores (and dP) are accumulator fragments; the online softmax (forward)
//   and P, dS (backward) run on the fragment, the row max and sum reduced
//   over the four lanes of a quad; O, dQ, dK, dV stay in registers.
// - m16n8k8's accumulator fragment is not its A fragment (a lane holds C at
//   columns 2t, 2t + 1 and A at t, t + 4). So P (and dS, P^T, dS^T) feed the
//   next product straight from C, and the contraction index is permuted
//   instead: the B operand's row t comes from key (or q row) 2t and its row
//   t + 4 from 2t + 1 of each 8-row group (tc_pv, tc_pv_pairs). A sum does not
//   care about the order of its terms.
// - A operands of Q K^T-like products (Q, dO, K, V rows) and B operands from
//   n-major rows (K, V, Q, dO as the right factor) come by ldmatrix.x4, a
//   float being one 32-bit word of the b16 matrix; B operands with the
//   contraction along rows (V, K, dO, Q in tc_pv) by shared loads. Rows lie
//   DP + 4 floats apart (12 mod 32 words at DP 40, 4 mod 16 at the other
//   widths): every ldmatrix phase and every tc_pv / tc_pv_pairs load falls in
//   distinct banks.
// - The walked tiles (K/V in the forward and dQ, Q/dO with lse and delta in
//   dK/dV) come through a cp.async ring, 16-byte pieces where a pointer, its
//   row pitch and d are multiples of 16 bytes and 4-byte pieces (zero-filled
//   the same way) otherwise, so any base pointer and the fused-heads view's
//   pitch of heads * d floats are read in place, without a copy. Rows past L
//   and columns past d are zeros; keys past Lk (q rows past Lq in dK/dV) get
//   p = 0 by mask.
// - Each output element has one owner and every sum a fixed order: no
//   atomics, the same bits from run to run.
// - wgmma is not used: it takes tf32 operands only K-major, so P V and the
//   backward's transposed products would need a transposed copy of V, K, Q
//   or dO in shared memory for every tile.
//
// The forward (attention_f32_tc_fwd_body). Head dims are padded to 40, 48,
// 64, 80, 160 or 256 (m16n8k8 is 8 deep, so d 40 needs no padding; the
// backward pads it to 48 as the bf16 kernels do). KV tiles of 32 keys, q
// tiles of 16 WQ rows: WQ 2 at Lq <= 256, 4 above. Below 132 blocks (one an
// SM; at DP <= 160, Lq <= 256) WK warp groups split the KV tiles (group w
// takes tiles w, w + WK, ...; each runs its own online softmax; group 0
// merges (m, l, O) in group order): WK 4 where 2 to 4 tiles are all (one
// super-step, one ring stage) above DP 80, else 2 (two stages); one rule on
// the host (tc_fwd_kv_groups) for every forward kernel, so kernels 1-f32 and
// 3-f32 deal and merge their tiles alike. What the body does about the cost
// of 3xTF32's splits, as variants timed on the card decided (PERF.md §6):
// - Q's fragments are split once and kept in registers for the walk at DP
//   48 and 64 (tc_fwd_keep_q).
// - P V reads V's pairs of 8-column blocks by 8-byte loads where DP / 8 is
//   even (column 2g of a 16-column group feeds block 2m, column 2g + 1 block
//   2m + 1); O then leaves by 16-byte stores.
// - Not done: splitting each landed K/V tile once for the block (big parts in
//   place, small ones into a plane of their own) instead of once in each of
//   the WQ warps that read it. The pass and the barrier it adds a tile cost
//   more than the splits it saved at every path shape but the 4096-token one
//   (SAM's windows 0.120 -> 0.18 ms).
// The start values (m_init, l_min) and the bias are the caller's: (-inf, 0)
// and no bias for kernels 1-f32 and 4-f32, (-1e30, 1e-30) for 3-f32 (equal
// bits on finite inputs: ex2 of either start minus a finite max is 0, and a
// warp group with no tile merges as nothing from either), SAM's rel-pos bias
// (attention_bias.cuh's RelPosBias, staged with the q tile) and no LSE for
// 5-f32.
//
// Blocks, shared memory a block (blocks an SM it allows) on the paths, at 8
// heads (SAM 12): the forward in the header of attention_f32.cu; the
// backward below.
// - dQ: q tile of 4 warps (64 rows) up to DP 80, 2 warps (32 rows) above; KV
//   tiles of 32 keys up to DP 80, 16 above; 52 KB (DP 48), 84 KB (DP 80), 82
//   KB (DP 160), 130 KB (DP 256). At DP 81 to 160, below 132 blocks, WK
//   groups split the KV tiles as in the forward, their partial dQ added in
//   group order: WK 4 for up to 4 tiles, else 2 (123 KB, 1 an SM). The
//   paths: 4096 tokens 64 x 8 B blocks; 1024 tokens 16 x 8 B (128 at batch
//   1: no split, 4 warps a block); 256 tokens 8 x 8 B (64 and 128 at batch 1
//   and 2: WK 2); 64 tokens 2 x 16 (32: WK 4 at KV 64, 2 at KV 77 and 94).
// - dK/dV: 16 * KG keys a block; a warp owns 16 keys and DP / CS columns of
//   dK and dV, and walks q in slices of QS rows, QW warps splitting the walk.
//   Wide (132 blocks or more): up to DP 80 KG 4, CS 1, QW 1 (64 keys, QS 32:
//   52.5 KB at DP 48, 84.5 KB at DP 80, 2 an SM); above, KG 2, CS 2 (32
//   keys, QS 16: 86 KB at DP 160), the pair of warps of a key group splitting
//   dK and dV's columns: one computes S^T = K Q^T, the other dP^T = V dO^T,
//   they swap them through shared memory, and each sums its half of dV +=
//   P^T dO and dK += dS^T Q (at DP 160 one warp holding both full sums would
//   need 160 registers for them alone). Split (fewer than 132 wide blocks):
//   16 keys a block, QW 4 (CS 1) or QW 2 (CS 2) warps over disjoint q
//   slices, their partial sums added in shared memory in warp order at the
//   end: 59.5 KB (DP 48), 95.5 KB (DP 80), 107 KB (DP 160), 2 an SM. The
//   paths: 4096 tokens 64 x 8 B wide; KV 77 at batch 2 32 (d 40, 80) or 48
//   (d 160) wide blocks, split into 80; 1024 tokens 128 wide at batch 1,
//   split into 512; 256 tokens 64 and 128 wide at batch 1 and 2 (KV 256),
//   split into 128 and 256; 144 wide at KV 286, batch 2; 64 tokens (KV 64,
//   77, 94 at batch 2) 32 to 48 wide, split into 64 to 96.
// __launch_bounds__ states the blocks an SM holds (two where shared memory
// allows, tc_blocks). Every kernel may then take 255 registers a thread: the
// two-an-SM blocks have 64 or 128 threads. ptxas -v on the card: no spill at
// the paths' head dims (40 to 160).
#pragma once

#include "attention_bias.cuh"

namespace lmdx {
namespace {

// ---------------------------------------------------------------------------
// Head views
// ---------------------------------------------------------------------------

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

// The head `bh` of row-major (BH, L, d) tensors and a (BH, Lq) lse (or null).
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

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

// x's bits rounded to TF32 as cvt.rna.tf32.f32 rounds them (to nearest, ties
// away from zero, the 13 low bits cleared), by two integer operations: bit for
// bit the same on finite values (held on the card against the instruction).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// x ~ big + small, both tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__float_as_uint(x));
  small = tf32_rna(__float_as_uint(x - __uint_as_float(big)));
}

// Four float bit patterns (an ldmatrix result) split.
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// c (16 x 8 f32) += a (16 x 8 tf32, row-major) * b (8 x 8 tf32, col-major).
__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b_big0,
                                           uint32_t b_big1, uint32_t b_small0,
                                           uint32_t b_small1) {
  mma_1688(c, a_small, b_big0, b_big1);
  mma_1688(c, a_big, b_small0, b_small1);
  mma_1688(c, a_big, b_big0, b_big1);
}

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------

// Blocks an SM holds of a tensor-core kernel with `bytes` of shared memory:
// two where they fit the SM's 228 KB (1 KB of it reserved a block), else one.
__host__ __device__ constexpr int tc_blocks(size_t bytes) {
  return 2 * (bytes + 1024) <= 233472 ? 2 : 1;
}

// Floats between the rows of a shared tile of DP columns.
__host__ __device__ constexpr int tc_lds(int dp) { return dp + 4; }

// Rows of d floats, ld floats apart, can move in whole 16-byte pieces.
__device__ __forceinline__ bool f32_rows_vectorize(const float* p, int ld, int d) {
  return aligned16(p) && (ld & 3) == 0 && (d & 3) == 0;
}

// Rows [row0, row0 + ROWS) of an (L, d) float32 matrix whose rows lie ld
// floats apart into a shared tile of DP columns (rows tc_lds(DP) apart) by
// cp.async; rows >= L and columns >= d become zeros. vec:
// f32_rows_vectorize(src, ld, d).
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void tc_load_rows(float* dst, const float* __restrict__ src, int ld,
                                             int row0, int L, int d, bool vec) {
  constexpr int LDS = tc_lds(DP);
  if (vec) {
    constexpr int PIECES = DP / 4;
    for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
      const int r = i / PIECES, c = (i % PIECES) * 4;
      const bool in = row0 + r < L && c < d;
      cp_async_16(dst + r * LDS + c, in ? src + (size_t)(row0 + r) * ld + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const bool in = row0 + r < L && c < d;
      cp_async_4(dst + r * LDS + c, in ? src + (size_t)(row0 + r) * ld + c : src, in ? 4 : 0);
    }
  }
}

// ldmatrix lane offsets (floats) into rows `lds` apart, a float being one
// 32-bit word of the b16 matrix. A (16 rows x 8): matrices (rows 0-7, k 0-3),
// (rows 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7) give a0-a3. B of
// two 8-row blocks from n-major rows: (rows 0-7, k 0-3), (rows 0-7, k 4-7),
// (rows 8-15, k 0-3), (rows 8-15, k 4-7) give b0, b1 of each block.
struct TcLanes {
  int a, b;
  __device__ TcLanes(int lane, int lds)
      : a((lane & 15) * lds + (lane >> 4) * 4),
        b(((lane & 7) + ((lane >> 4) << 3)) * lds + ((lane >> 3) & 1) * 4) {}
};

template <int N>
__device__ __forceinline__ void tc_zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }
}

// The tensor cores sum into an accumulator with truncation: a chain of n
// mma into one fragment drifts by up to ~n 2^-24 of its value, one way (a
// dQ summed over 4126 keys in one chain of ~1500 mma missed the one-pass
// plain version by 6e-5 of its maximum on the card). A product within one
// tile (S = Q K^T and the like: at most 3 DP / 8 mma, 60 at DP 160) sums on
// the tensor cores; a product summed across tiles (P V, dS K, P^T dO,
// dS^T Q) sums each tile's steps into a fresh fragment (tc_pv: at most
// kTcChain steps of 3 mma) and adds that to its running sum by float32
// adds, which round to nearest. Splitting S's chain too cost registers
// (ptxas spilled at head dims 80 and 160) and time, and moved the largest
// error on the paths' shapes only from 6.9e-6 to 3.7e-6 of max|plain|.
constexpr int kTcChain = 4;  // 8-deep steps of a tile's product in one tensor-core chain

// acc[j] += A B_j^T over the 8-deep step kk for j < NJ: A's split fragment,
// B_j the 8 rows at b + 8 j rows (DP columns, rows tc_lds(DP) apart).
template <int DP, int NJ>
__device__ __forceinline__ void tc_abt_step(float (&acc)[NJ][4], const uint32_t (&a_big)[4],
                                            const uint32_t (&a_small)[4], const float* b, int kk,
                                            const TcLanes& ln) {
  constexpr int LDS = tc_lds(DP);
  static_assert(DP % 8 == 0 && NJ % 2 == 0, "whole 8-deep steps and pairs of 8-row blocks");
#pragma unroll
  for (int j2 = 0; j2 < NJ / 2; ++j2) {
    uint32_t raw[4], b_big[4], b_small[4];
    ldmatrix_x4(raw, b + j2 * 16 * LDS + kk * 8 + ln.b);
    split_tf32(raw, b_big, b_small);
    mma_3xtf32(acc[2 * j2], a_big, a_small, b_big[0], b_big[1], b_small[0], b_small[1]);
    mma_3xtf32(acc[2 * j2 + 1], a_big, a_small, b_big[2], b_big[3], b_small[2], b_small[3]);
  }
}

// acc[j] += A B_j^T for j < NJ: A the 16 rows at `a` (DP columns), B_j the 8
// rows at b + 8 j rows (DP columns), both shared tiles tc_lds(DP) apart.
template <int DP, int NJ>
__device__ __forceinline__ void tc_abt(float (&acc)[NJ][4], const float* a, const float* b,
                                       const TcLanes& ln) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t raw[4], a_big[4], a_small[4];
    ldmatrix_x4(raw, a + kk * 8 + ln.a);
    split_tf32(raw, a_big, a_small);
    tc_abt_step<DP, NJ>(acc, a_big, a_small, b, kk, ln);
  }
}

// P (16 x 8 NJ) as accumulator fragments, split into A fragments of P V.
// Element e of P[j]: row g + 8 (e / 2), column 8 j + 2 t + e % 2; as A it
// stands at k = t (e even) or t + 4 (e odd).
template <int NJ>
__device__ __forceinline__ void tc_split_p(const float (&p)[NJ][4], uint32_t (&a_big)[NJ][4],
                                           uint32_t (&a_small)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split_tf32(p[j][0], a_big[j][0], a_small[j][0]);
    split_tf32(p[j][2], a_big[j][1], a_small[j][1]);
    split_tf32(p[j][1], a_big[j][2], a_small[j][2]);
    split_tf32(p[j][3], a_big[j][3], a_small[j][3]);
  }
}

// acc[nb] += P W[:, 8 nb .. 8 nb + 7] for nb < NB: P (16 x 8 NJ) as
// accumulator fragments, W the 8 NJ rows at w (rows lds apart, its columns
// from w). As A, P[j] stands at k = t and t + 4 (tc_split_p), so B's row t is
// W's row 8 j + 2 t and its row t + 4 is W's row 8 j + 2 t + 1.
// Each column block sums its NJ steps (NJ <= kTcChain) into a fresh
// fragment, added to acc by float32 adds.
template <int NJ, int NB>
__device__ __forceinline__ void tc_pv(float (&acc)[NB][4], const float (&p)[NJ][4],
                                      const float* w, int lds, int g, int t) {
  static_assert(NJ <= kTcChain, "one tensor-core chain a column block");
  uint32_t a_big[NJ][4], a_small[NJ][4];
  tc_split_p(p, a_big, a_small);
  const float* w0 = w + 2 * t * lds + g;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t b_big0, b_small0, b_big1, b_small1;
      split_tf32(w0[8 * j * lds + 8 * nb], b_big0, b_small0);
      split_tf32(w0[(8 * j + 1) * lds + 8 * nb], b_big1, b_small1);
      mma_3xtf32(part, a_big[j], a_small[j], b_big0, b_big1, b_small0, b_small1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += part[e];
  }
}

// ---------------------------------------------------------------------------
// Forward (kernels 1-f32, 3-f32, 4-f32, 5-f32)
// ---------------------------------------------------------------------------

constexpr int kTcFwdBK = 32;  // keys a KV tile of the forward

// A grid below this many blocks (one an SM) splits its work further: the
// forward's and dQ's KV tiles over warp groups, dK/dV's q walk over warps.
constexpr int kTcSplitBelow = 132;

// Whether the forward keeps Q's split fragments in registers for the whole
// walk (DP registers: 8 a k-step) rather than reloading and splitting them
// each tile: at DP 48 and 64. On the card (PERF.md §6) it took SAM's
// global layers (DP 64) from 1.188 to 1.133 ms; at DP 40 it cost 7% at
// batch 6 of the 4096-token level (160 -> 179 registers a thread), at DP 80
// it moved nothing, and at 80 and above it spills.
__host__ __device__ constexpr bool tc_fwd_keep_q(int dp) { return dp >= 48 && dp <= 64; }

// KV tiles in the ring: one super-step of WK tiles (one a warp group) where
// four groups share the block, else two super-steps (one landing while the
// other is multiplied).
__host__ __device__ constexpr int tc_fwd_stages(int wk) { return wk >= 4 ? 1 : 2; }

// Shared memory of a forward block before any bias rows: the Q tile, then
// the ring of K and V tiles.
template <int DP, int WQ, int WK>
__host__ __device__ constexpr size_t tc_fwd_smem_bytes() {
  return sizeof(float) * tc_lds(DP) * (16 * WQ + tc_fwd_stages(WK) * WK * 2 * kTcFwdBK);
}

// Warp groups that split the KV tiles of a forward block of batch * heads
// heads: one where the grid of 32-row q tiles fills the card (kTcSplitBelow
// blocks or more), where one tile is all, for q tiles of 64 rows (Lq > 256)
// and above head dim 160; else 4 where 3 or 4 tiles are all (one
// super-step) above head dim 80, else 2.
__host__ __device__ constexpr int tc_fwd_kv_groups(int batch, int heads, int lq, int lk, int d) {
  const int tiles = (lk + kTcFwdBK - 1) / kTcFwdBK;
  if ((long long)((lq + 31) / 32) * heads * batch >= kTcSplitBelow || lq > 256 || d > 160 ||
      tiles == 1) {
    return 1;
  }
  return tiles <= 4 && d > 80 ? 4 : 2;
}

// Calls f(integral_constant<int, DP>) with the forward's padded head dim: 40
// for d <= 40, else dispatch_head_dim's.
template <int MAX_DP, class F>
int dispatch_tc_fwd_head_dim(int d, F&& f) {
  if (d <= 40) return f(std::integral_constant<int, 40>{});
  return dispatch_head_dim<MAX_DP>(d, f);
}

// acc += P V for the tile's 8 NJ keys (V's rows at w, lds floats apart) as
// tc_pv sums it, with V's column blocks taken in pairs by 8-byte loads:
// column 2g of the 16 columns from 16 m feeds block 2m and column 2g + 1
// block 2m + 1, so a lane's four O elements of the pair (rows g, g + 8) are
// the four columns from 16 m + 4 t. Where DP / 8 is even (every padded width
// but 40; at DP 160 it took batch 6 of the 256-token level from 0.095 to
// 0.090 ms on the card).
template <int NJ, int NB>
__device__ __forceinline__ void tc_pv_pairs(float (&acc)[NB][4], const float (&p)[NJ][4],
                                            const float* w, int lds, int g, int t) {
  static_assert(NJ <= kTcChain && NB % 2 == 0, "one tensor-core chain a block; pairs of blocks");
  uint32_t a_big[NJ][4], a_small[NJ][4];
  tc_split_p(p, a_big, a_small);
#pragma unroll
  for (int nb = 0; nb < NB; nb += 2) {
    float part0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, part1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = (8 * j + 2 * t) * lds + 8 * nb + 2 * g;  // B's row t; row t + 4 at + lds
      const float2 x0 = *reinterpret_cast<const float2*>(w + i);
      const float2 x1 = *reinterpret_cast<const float2*>(w + i + lds);
      uint32_t bb0[2], bs0[2], bb1[2], bs1[2];  // [row t, row t + 4] of blocks nb, nb + 1
      split_tf32(x0.x, bb0[0], bs0[0]);
      split_tf32(x1.x, bb0[1], bs0[1]);
      split_tf32(x0.y, bb1[0], bs1[0]);
      split_tf32(x1.y, bb1[1], bs1[1]);
      mma_3xtf32(part0, a_big[j], a_small[j], bb0[0], bb0[1], bs0[0], bs0[1]);
      mma_3xtf32(part1, a_big[j], a_small[j], bb1[0], bb1[1], bs1[0], bs1[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nb][e] += part0[e];
      acc[nb + 1][e] += part1[e];
    }
  }
}

// q rows [q0, q0 + 16 WQ) of the head `hv`: o = softmax(q k^T scale + bias)
// v and, where hv.lse is not null, the LSE in natural units; scale_log2 =
// scale * log2(e). The row max starts at m_init (log2 units) and the
// denominator is clamped from below at l_min. WQ warps own 16 q rows each; WK
// warp groups split the KV tiles (group w takes tiles w, w + WK, ...), each
// with its own online softmax, and group 0 merges the others' (m, l, O) in
// group order at the end. The bias rows of the q tile are staged after the
// ring.
template <int DP, int WQ, int WK, class Bias>
__device__ __forceinline__ void attention_f32_tc_fwd_body(const F32HeadView& hv, int q0, int Lq,
                                                          int Lk, int d, float scale_log2,
                                                          const Bias& bias, float m_init,
                                                          float l_min) {
  constexpr int LDS = tc_lds(DP), BK = kTcFwdBK, NJ = BK / 8, NB = DP / 8, KS = DP / 8;
  constexpr int BQ = 16 * WQ, THREADS = 32 * WQ * WK, STAGES = tc_fwd_stages(WK);
  constexpr int TILE = 2 * BK * LDS;  // one K tile and one V tile
  constexpr int STAGE = WK * TILE;    // one super-step
  constexpr bool KEEP_Q = tc_fwd_keep_q(DP);
  constexpr bool PAIR_V = NB % 2 == 0;  // tc_pv_pairs
  extern __shared__ __align__(16) float tc_smem[];
  float* sQ = tc_smem;
  float* sKV = sQ + BQ * LDS;
  float* sB = sKV + STAGES * STAGE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp % WQ, wk = warp / WQ;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wr0 = wq * 16;                // the warp's first row of the q tile
  const int ntiles = (Lk + BK - 1) / BK;
  const int nsteps = (ntiles + WK - 1) / WK;
  const bool vec_kv = f32_rows_vectorize(hv.k, hv.ldk, d) && f32_rows_vectorize(hv.v, hv.ldv, d);
  const TcLanes ln(lane, LDS);

  auto load_step = [&](int step) {
    for (int i = 0; i < WK; ++i) {
      const int tile = step * WK + i;
      if (tile >= ntiles) break;
      float* sK = sKV + (step % STAGES) * STAGE + i * TILE;
      tc_load_rows<DP, BK, THREADS>(sK, hv.k, hv.ldk, tile * BK, Lk, d, vec_kv);
      tc_load_rows<DP, BK, THREADS>(sK + BK * LDS, hv.v, hv.ldv, tile * BK, Lk, d, vec_kv);
    }
  };
  // Q, the bias rows and the first super-step travel in the first group.
  tc_load_rows<DP, BQ, THREADS>(sQ, hv.q, hv.ldq, q0, Lq, d, f32_rows_vectorize(hv.q, hv.ldq, d));
  bias.stage(sB, hv.bh, q0, BQ);
  load_step(0);
  cp_async_commit();

  uint32_t q_big[KEEP_Q ? KS : 1][4], q_small[KEEP_Q ? KS : 1][4];
  if constexpr (KEEP_Q) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      ldmatrix_x4(raw, sQ + wr0 * LDS + kk * 8 + ln.a);
      split_tf32(raw, q_big[kk], q_small[kk]);
    }
  }

  float o[NB][4];
  tc_zero(o);
  float m[2] = {m_init, m_init}, l[2] = {0.0f, 0.0f};  // l: this lane's part

  for (int step = 0; step < nsteps; ++step) {
    // Step `step` has landed for this thread; after the barrier for all, and
    // every warp is done with step - 1, whose stage the next load refills.
    cp_async_wait<0>();
    __syncthreads();
    if (STAGES == 2 && step + 1 < nsteps) load_step(step + 1);
    cp_async_commit();
    const int tile = step * WK + wk;
    if (tile < ntiles) {
      const float* sK = sKV + (step % STAGES) * STAGE + wk * TILE;
      const float* sV = sK + BK * LDS;
      const int k0 = tile * BK;

      float s[NJ][4];
      tc_zero(s);
      if constexpr (KEEP_Q) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) tc_abt_step<DP, NJ>(s, q_big[kk], q_small[kk], sK, kk, ln);
      } else {
        tc_abt<DP, NJ>(s, sQ + wr0 * LDS, sK, ln);
      }

      // Log2 units, the bias added (times log2 e), keys past Lk to -inf.
      // Element e of block j: row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2.
      typename Bias::Col col = bias.col(k0 + 2 * t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
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
      if (k0 + BK > Lk) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = k0 + 8 * j + 2 * t;
          if (c >= Lk) s[j][0] = s[j][2] = -INFINITY;
          if (c + 1 >= Lk) s[j][1] = s[j][3] = -INFINITY;
        }
      }

      // Online softmax on the fragment: rows g (e = 0, 1) and g + 8 (e = 2, 3).
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        const float alpha = ex2(m[hf] - m_new);  // 0 on the group's first tile
        m[hf] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j][2 * hf] = ex2(s[j][2 * hf] - m_new);
          s[j][2 * hf + 1] = ex2(s[j][2 * hf + 1] - m_new);
          sum += s[j][2 * hf] + s[j][2 * hf + 1];
        }
        l[hf] = l[hf] * alpha + sum;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          o[nb][2 * hf] *= alpha;
          o[nb][2 * hf + 1] *= alpha;
        }
      }

      if constexpr (PAIR_V) {  // O += P V
        tc_pv_pairs<NJ, NB>(o, s, sV, LDS, g, t);
      } else {
        tc_pv<NJ, NB>(o, s, sV, LDS, g, t);
      }
    }
    if (STAGES == 1 && step + 1 < nsteps) {
      __syncthreads();  // every warp is done with the stage
      load_step(step + 1);
      cp_async_commit();
    }
  }

  if constexpr (WK > 1) {
    // Groups 1 .. WK - 1 hand (O, m, l) to group 0 through the free ring,
    // lane-major; group 0 merges them in group order. A group that got no
    // tile holds m = m_init, l = 0, O = 0 and merges as nothing.
    constexpr int SLOT = (NB * 4 + 4) * 32;
    static_assert((size_t)(WK - 1) * WQ * SLOT <= (size_t)STAGES * STAGE, "the ring holds it");
    cp_async_wait<0>();
    __syncthreads();
    if (wk > 0) {
      float* dst = sKV + ((wk - 1) * WQ + wq) * SLOT;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(nb * 4 + e) * 32 + lane] = o[nb][e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dst[(NB * 4 + hf) * 32 + lane] = m[hf];
        dst[(NB * 4 + 2 + hf) * 32 + lane] = l[hf];
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < WK; ++w) {
      const float* src = sKV + ((w - 1) * WQ + wq) * SLOT;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m_w = src[(NB * 4 + hf) * 32 + lane];
        const float m_new = fmaxf(m[hf], m_w);
        const float a = ex2(m[hf] - m_new), b = ex2(m_w - m_new);
        l[hf] = l[hf] * a + src[(NB * 4 + 2 + hf) * 32 + lane] * b;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            o[nb][e] = o[nb][e] * a + src[(nb * 4 + e) * 32 + lane] * b;
          }
        }
        m[hf] = m_new;
      }
    }
  }

  // O times 1 / l: paired blocks (tc_pv_pairs) leave by 16-byte stores (four
  // columns from 16 m + 4 t) where the output allows, the rest by 4-byte ones.
  const bool vec_o = aligned16(hv.o) && (hv.ldo & 3) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum = fmaxf(sum, l_min);
    const int r = q0 + wr0 + g + 8 * hf;
    if (r < Lq) {
      const float inv = 1.0f / sum;
      float* orow = hv.o + (size_t)r * hv.ldo;
      if constexpr (PAIR_V) {
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const int c = 8 * nb + 4 * t;
          const float4 x = make_float4(o[nb][2 * hf] * inv, o[nb + 1][2 * hf] * inv,
                                       o[nb][2 * hf + 1] * inv, o[nb + 1][2 * hf + 1] * inv);
          if (vec_o && c + 3 < d) {
            *reinterpret_cast<float4*>(orow + c) = x;
          } else {
            if (c < d) orow[c] = x.x;
            if (c + 1 < d) orow[c + 1] = x.y;
            if (c + 2 < d) orow[c + 2] = x.z;
            if (c + 3 < d) orow[c + 3] = x.w;
          }
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int c = 8 * nb + 2 * t;
          if (c < d) orow[c] = o[nb][2 * hf] * inv;
          if (c + 1 < d) orow[c + 1] = o[nb][2 * hf + 1] * inv;
        }
      }
      if (hv.lse != nullptr && t == 0) hv.lse[r] = m[hf] * kLn2 + logf(sum);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (kernel 2-f32): dQ first, then dK/dV
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int tc_dq_warps(int dp) { return dp <= 80 ? 4 : 2; }
__host__ __device__ constexpr int tc_dq_bk(int dp) { return dp <= 80 ? 32 : 16; }

// Warp groups that split the KV tiles of a dQ block, as the forward's
// (tc_fwd_kv_groups): one where the grid fills the card, where one tile is
// all, and outside head dims 81 to 160 (64-row q tiles of 4 warps fill 128
// blocks at the paths' smallest grid); else 4 for up to 4 tiles, else 2.
__host__ __device__ constexpr int tc_dq_kv_groups(int bh, int lq, int lk, int d) {
  const int tiles = (lk + tc_dq_bk(d) - 1) / tc_dq_bk(d);
  const int bq = 16 * tc_dq_warps(d);
  if ((long long)((lq + bq - 1) / bq) * bh >= kTcSplitBelow || d <= 80 || d > 160 || tiles == 1) {
    return 1;
  }
  return tiles <= 4 ? 4 : 2;
}

// Q and dO, then the ring of K and V tiles (stages as the forward's).
template <int DP, int WK>
__host__ __device__ constexpr size_t tc_dq_smem_bytes() {
  return sizeof(float) * tc_lds(DP) *
         (2 * 16 * tc_dq_warps(DP) + tc_fwd_stages(WK) * WK * 2 * tc_dq_bk(DP));
}

// dQ block: q rows [blockIdx.x * 16 WQ, +16 WQ) of batch*head blockIdx.y,
// WQ = tc_dq_warps(DP). Writes delta = rowsum(dO * O) of its rows (read by
// the dK/dV kernel, launched after it on the same stream) and dQ = sum over
// KV tiles of dS K, dS = P (dO V^T - delta) scale, P = exp2(s scale log2 e -
// lse log2 e). WK warp groups split the KV tiles as the forward's do; group
// 0 adds the others' partial dQ in group order.
template <int DP, int WK>
__device__ __forceinline__ void attention_f32_tc_bwd_dq_body(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int Lq, int Lk, int d, float scale) {
  constexpr int WQ = tc_dq_warps(DP), BQ = 16 * WQ, THREADS = 32 * WQ * WK;
  constexpr int BK = tc_dq_bk(DP), NJ = BK / 8, NB = DP / 8, LDS = tc_lds(DP);
  constexpr int STAGES = tc_fwd_stages(WK), TILE = 2 * BK * LDS, STAGE = WK * TILE;
  extern __shared__ __align__(16) float tc_smem[];
  float* sQ = tc_smem;
  float* sG = sQ + BQ * LDS;
  float* sKV = sG + BQ * LDS;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp % WQ, wk = warp / WQ;
  const int g8 = lane >> 2, t = lane & 3;
  const int wr0 = wq * 16;
  const float scale_log2 = scale * kLog2e;
  const float* qh = q + bh * Lq * d;
  const float* gh = g + bh * Lq * d;
  const float* oh = o + bh * Lq * d;
  const float* kh = k + bh * Lk * d;
  const float* vh = v + bh * Lk * d;
  const int ntiles = (Lk + BK - 1) / BK;
  const int nsteps = (ntiles + WK - 1) / WK;
  const bool vec_kv = f32_rows_vectorize(kh, d, d) && f32_rows_vectorize(vh, d, d);
  const TcLanes ln(lane, LDS);

  auto load_step = [&](int step) {
    for (int i = 0; i < WK; ++i) {
      const int tile = step * WK + i;
      if (tile >= ntiles) break;
      float* sK = sKV + (step % STAGES) * STAGE + i * TILE;
      tc_load_rows<DP, BK, THREADS>(sK, kh, d, tile * BK, Lk, d, vec_kv);
      tc_load_rows<DP, BK, THREADS>(sK + BK * LDS, vh, d, tile * BK, Lk, d, vec_kv);
    }
  };

  tc_load_rows<DP, BQ, THREADS>(sQ, qh, d, q0, Lq, d, f32_rows_vectorize(qh, d, d));
  tc_load_rows<DP, BQ, THREADS>(sG, gh, d, q0, Lq, d, f32_rows_vectorize(gh, d, d));
  load_step(0);
  cp_async_commit();

  // lse (log2 units) and delta of the lane's rows g8 and g8 + 8. delta from
  // device memory while the tiles land: a row a step, the lanes over columns
  // (every group computes it; group 0 writes it).
  float lse2[2], dl[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + wr0 + g8 + 8 * hf;
    lse2[hf] = r < Lq ? lse[bh * Lq + r] * kLog2e : 0.0f;
  }
  for (int i = 0; i < 16; ++i) {
    const int r = q0 + wr0 + i;
    float part = 0.0f;
    if (r < Lq) {
      for (int c = lane; c < d; c += 32) {
        part = fmaf(gh[(size_t)r * d + c], oh[(size_t)r * d + c], part);
      }
    }
    part = warp_sum(part);
    if (i == g8) dl[0] = part;
    if (i == g8 + 8) dl[1] = part;
    if (wk == 0 && lane == 0 && r < Lq) delta[bh * Lq + r] = part;
  }

  float acc[NB][4];
  tc_zero(acc);
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    __syncthreads();
    if (STAGES == 2 && step + 1 < nsteps) load_step(step + 1);
    cp_async_commit();
    const int tile = step * WK + wk;
    if (tile < ntiles) {
      const float* sK = sKV + (step % STAGES) * STAGE + wk * TILE;
      const float* sV = sK + BK * LDS;
      const int k0 = tile * BK;

      float s[NJ][4], dp[NJ][4];
      tc_zero(s);
      tc_zero(dp);
      tc_abt<DP, NJ>(s, sQ + wr0 * LDS, sK, ln);   // S = Q K^T
      tc_abt<DP, NJ>(dp, sG + wr0 * LDS, sV, ln);  // dP = dO V^T

      // dS = P (dP - delta) scale on the fragment, into s.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = k0 + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const float p =
              c + (e & 1) < Lk ? ex2(fmaf(s[j][e], scale_log2, -lse2[hf])) : 0.0f;
          s[j][e] = p * (dp[j][e] - dl[hf]) * scale;
        }
      }
      tc_pv<NJ, NB>(acc, s, sK, LDS, g8, t);  // dQ += dS K
    }
    if (STAGES == 1 && step + 1 < nsteps) {
      __syncthreads();
      load_step(step + 1);
      cp_async_commit();
    }
  }

  if constexpr (WK > 1) {
    // Groups 1 .. WK - 1 hand their partial dQ to group 0 through the free
    // ring, lane-major; group 0 adds them in group order.
    constexpr int SLOT = NB * 4 * 32;
    static_assert((size_t)(WK - 1) * WQ * SLOT <= (size_t)STAGES * STAGE, "the ring holds it");
    cp_async_wait<0>();
    __syncthreads();
    if (wk > 0) {
      float* dst = sKV + ((wk - 1) * WQ + wq) * SLOT;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(nb * 4 + e) * 32 + lane] = acc[nb][e];
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < WK; ++w) {
      const float* src = sKV + ((w - 1) * WQ + wq) * SLOT;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] += src[(nb * 4 + e) * 32 + lane];
      }
    }
  }

  float* dqh = dq + bh * Lq * d;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + wr0 + g8 + 8 * hf;
    if (r < Lq) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = 8 * nb + 2 * t;
        if (c < d) dqh[(size_t)r * d + c] = acc[nb][2 * hf];
        if (c + 1 < d) dqh[(size_t)r * d + c + 1] = acc[nb][2 * hf + 1];
      }
    }
  }
}

// A dK/dV block's shape: KG groups of 16 keys; CS warps share a group's
// columns of dK and dV (1, or 2 swapping S^T and dP^T); QW warps split the
// q walk; a warp's slice of a stage is QS q rows.
template <int DP, int KG, int CS, int QW, int QS>
struct TcDkdv {
  static constexpr int kKG = KG, kCS = CS, kQW = QW, kQS = QS;
  static constexpr int kWarps = KG * CS * QW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * KG;     // keys of the block
  static constexpr int kStep = QS * QW;     // q rows of a ring stage
  static constexpr int kLds = tc_lds(DP);
  static constexpr size_t kRing = (size_t)2 * 2 * kStep * kLds;  // Q and dO, two stages
  static constexpr size_t kXchg = CS > 1 ? (size_t)kWarps * 16 * QS : 0;
  // K and V, the ring, its lse and delta rows, the S^T / dP^T exchange.
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)2 * kRows * kLds + kRing + 2 * 2 * kStep + kXchg);
  static_assert(DP % (8 * CS) == 0 && QS % 16 == 0, "whole fragments");
  static_assert((size_t)(QW - 1) * KG * 2 * 16 * DP <= kRing,
                "the q walk's partial sums fit the ring");
};

// The two shapes of each head dim (the header's table).
template <int DP>
using TcDkdvWide = std::conditional_t<DP <= 80, TcDkdv<DP, 4, 1, 1, 32>, TcDkdv<DP, 2, 2, 1, 16>>;
template <int DP>
using TcDkdvSplit = std::conditional_t<DP <= 80, TcDkdv<DP, 1, 1, 4, 16>,
                                       TcDkdv<DP, 1, 2, 2, 16>>;


// dK/dV block: keys [blockIdx.x * 16 KG, +16 KG) of batch*head blockIdx.y.
// Per stage of the q walk, each warp's slice: S^T = K Q^T and dP^T = V dO^T
// (one each in a column pair, swapped), P^T = exp2(S^T scale log2 e - lse
// log2 e) and dS^T = P^T (dP^T - delta) scale on the fragment with lse and
// delta broadcast by column from the ring, then dV += P^T dO and dK += dS^T Q
// on the warp's columns.
template <int DP, int KG, int CS, int QW, int QS>
__device__ __forceinline__ void attention_f32_tc_bwd_dkdv_body(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int d, float scale) {
  using C = TcDkdv<DP, KG, CS, QW, QS>;
  constexpr int LDS = C::kLds, STEP = C::kStep, THREADS = C::kThreads;
  constexpr int NS = QS / 8;         // 8-wide q blocks of a warp's S^T
  constexpr int COLS = DP / CS;      // dK / dV columns a warp owns
  constexpr int NB = COLS / 8;
  constexpr int STAGE = 2 * STEP * LDS;
  extern __shared__ __align__(16) float tc_smem[];
  float* sK = tc_smem;
  float* sV = sK + C::kRows * LDS;
  float* sRing = sV + C::kRows * LDS;
  float* sStat = sRing + C::kRing;              // per stage: lse (STEP), delta (STEP)
  float* sX = sStat + 2 * 2 * STEP;             // exchange, 16 QS floats a warp
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * C::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int kg = warp % KG, cs = (warp / KG) % CS, qw = warp / (KG * CS);
  const float scale_log2 = scale * kLog2e;
  const float* qh = q + bh * Lq * d;
  const float* gh = g + bh * Lq * d;
  const float* kh = k + bh * Lk * d;
  const float* vh = v + bh * Lk * d;
  const float* lh = lse + bh * Lq;
  const float* dh = delta + bh * Lq;
  const int ntiles = (Lq + STEP - 1) / STEP;
  const bool vec_qg = f32_rows_vectorize(qh, d, d) && f32_rows_vectorize(gh, d, d);
  const TcLanes ln(lane, LDS);

  auto load_q = [&](int tile) {
    float* sQ = sRing + (tile & 1) * STAGE;
    tc_load_rows<DP, STEP, THREADS>(sQ, qh, d, tile * STEP, Lq, d, vec_qg);
    tc_load_rows<DP, STEP, THREADS>(sQ + STEP * LDS, gh, d, tile * STEP, Lq, d, vec_qg);
    float* st = sStat + (tile & 1) * 2 * STEP;
    for (int i = threadIdx.x; i < 2 * STEP; i += THREADS) {
      const float* src = i < STEP ? lh : dh;
      const int r = tile * STEP + i % STEP;
      cp_async_4(st + i, r < Lq ? src + r : src, r < Lq ? 4 : 0);
    }
  };

  // K and V travel with stage 0.
  tc_load_rows<DP, C::kRows, THREADS>(sK, kh, d, k0, Lk, d, f32_rows_vectorize(kh, d, d));
  tc_load_rows<DP, C::kRows, THREADS>(sV, vh, d, k0, Lk, d, f32_rows_vectorize(vh, d, d));
  load_q(0);
  cp_async_commit();

  float dk_acc[NB][4], dv_acc[NB][4];
  tc_zero(dk_acc);
  tc_zero(dv_acc);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < ntiles) load_q(tile + 1);
    cp_async_commit();
    const float* sQ = sRing + (tile & 1) * STAGE + qw * QS * LDS;  // the warp's slice
    const float* sG = sQ + STEP * LDS;
    const float* sL = sStat + (tile & 1) * 2 * STEP + qw * QS;
    const float* sD = sL + STEP;
    const int qc0 = tile * STEP + qw * QS;  // the slice's first q row

    float st[NS][4], dpt[NS][4];
    if (CS == 1) {
      tc_zero(st);
      tc_zero(dpt);
      tc_abt<DP, NS>(st, sK + kg * 16 * LDS, sQ, ln);   // S^T = K Q^T
      tc_abt<DP, NS>(dpt, sV + kg * 16 * LDS, sG, ln);  // dP^T = V dO^T
    } else {
      // cs 0 computes S^T, cs 1 dP^T; each reads the other's from sX.
      float own[NS][4];
      tc_zero(own);
      tc_abt<DP, NS>(own, (cs == 0 ? sK : sV) + kg * 16 * LDS, cs == 0 ? sQ : sG, ln);
      float* mine = sX + warp * 16 * QS;
      const float* other = sX + (kg + KG * ((1 - cs) + CS * qw)) * 16 * QS;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32 + lane] = own[j][e];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = other[(4 * j + e) * 32 + lane];
          st[j][e] = cs == 0 ? own[j][e] : x;
          dpt[j][e] = cs == 0 ? x : own[j][e];
        }
      }
    }

    // P^T into st, dS^T into dpt. Element e of block j: key g8 + 8 (e / 2),
    // q row qc0 + 8 j + 2 t + e % 2.
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float p = qc0 + c + odd < Lq
                            ? ex2(fmaf(st[j][e], scale_log2, -(odd ? l2.y : l2.x) * kLog2e))
                            : 0.0f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - (odd ? d2.y : d2.x)) * scale;
      }
    }
    tc_pv<NS, NB>(dv_acc, st, sG + cs * COLS, LDS, g8, t);   // dV += P^T dO
    tc_pv<NS, NB>(dk_acc, dpt, sQ + cs * COLS, LDS, g8, t);  // dK += dS^T Q
  }

  if (QW > 1) {
    // The q walk's partial sums, added in warp order through the free ring:
    // warp (kg, cs, qw > 0) at slot ((qw - 1) KG + kg) CS + cs, lane-major.
    cp_async_wait<0>();
    __syncthreads();
    constexpr int SLOT = 2 * NB * 4 * 32;
    if (qw > 0) {
      float* dst = sRing + (((qw - 1) * KG + kg) * CS + cs) * SLOT;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[(nb * 4 + e) * 32 + lane] = dk_acc[nb][e];
          dst[((NB + nb) * 4 + e) * 32 + lane] = dv_acc[nb][e];
        }
      }
    }
    __syncthreads();
    if (qw == 0) {
      for (int w = 1; w < QW; ++w) {
        const float* src = sRing + (((w - 1) * KG + kg) * CS + cs) * SLOT;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_acc[nb][e] += src[(nb * 4 + e) * 32 + lane];
            dv_acc[nb][e] += src[((NB + nb) * 4 + e) * 32 + lane];
          }
        }
      }
    }
  }
  if (qw != 0) return;

  float* dkh = dk + bh * Lk * d;
  float* dvh = dv + bh * Lk * d;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = k0 + kg * 16 + g8 + 8 * hf;
    if (r < Lk) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = cs * COLS + 8 * nb + 2 * t;
        if (c < d) {
          dkh[(size_t)r * d + c] = dk_acc[nb][2 * hf];
          dvh[(size_t)r * d + c] = dv_acc[nb][2 * hf];
        }
        if (c + 1 < d) {
          dkh[(size_t)r * d + c + 1] = dk_acc[nb][2 * hf + 1];
          dvh[(size_t)r * d + c + 1] = dv_acc[nb][2 * hf + 1];
        }
      }
    }
  }
}

}  // namespace
}  // namespace lmdx
