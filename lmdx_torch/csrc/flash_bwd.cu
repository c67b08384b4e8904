// Flash-attention backward: dQ, dK, dV by blockwise recompute from the LSE.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention_bwd (the
// TPU kernel, l.384). Inputs q (BH, Lq, d), k/v (BH, Lk, d), o and dO
// (BH, Lq, d), all bf16 row-major, and the forward's row LSE (BH, Lq) f32 in
// natural units. Outputs dq, dk, dv in bf16, and delta (BH, Lq) f32 scratch.
// With s = q k^T / sqrt(d):
//   p = exp(s - lse), delta = rowsum(dO * O),
//   dV = p^T dO,  dS = p * (dO V^T - delta) / sqrt(d),
//   dQ = dS K,    dK = dS^T Q.
//
// What bounds it on an H100: five (Lq x Lk x d) products per call (the
// scores, dO V^T, dV, dK and dQ) against a few bytes per input element:
// tensor-core operations, as in the forward. The split below recomputes the
// scores and dO V^T once more, so it issues seven products where the bound
// counts five.
//
// Design. The TPU kernel accumulated dK/dV across q blocks because its grid
// runs in order on one core (flash_attention.py:478-486). GPU blocks run in
// parallel, so the work is split the FA2 way into two kernels on one stream,
// each output element with one owner, no atomics, so the result does not
// depend on block order:
//
// - flash_bwd_dq_kernel, launched first: one block per (q tile, batch*head),
//   each warp owning 16 q rows (bwd_warps: 8 warps up to head dim 80, 4
//   above). Its prologue computes delta for the tile's rows from O and dO in
//   shared memory (each lane of a row's four sums a quarter of the columns,
//   two shuffles join them) and writes it to the scratch the wrapper
//   allocated. It then walks the KV in 64-row tiles through a cp.async ring,
//   as the forward does: S = Q K^T and dP = dO V^T as mma.sync accumulator
//   fragments (K and V row-major are the B operands, by plain ldmatrix), P =
//   exp2(S * scale * log2 e - lse * log2 e) and dS = P (dP - delta) scale on
//   the fragment, dS repacked in registers as the A operand of dQ += dS K (K
//   by ldmatrix.trans). dQ stays in f32 registers and leaves once, as bf16.
// - flash_bwd_dkdv_kernel: one block per (KV tile, batch*head), each warp
//   owning 16 KV rows (the same number of warps), walks the q rows in steps
//   of 64 (32 above head dim 80) through a cp.async ring of Q, dO, lse and
//   delta. The same products transposed: S^T = K Q^T and dP^T = V dO^T (Q and
//   dO row-major are the B operands), P^T and dS^T on the fragment with lse
//   and delta broadcast by column from shared memory, repacked in registers
//   as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q by
//   ldmatrix.trans). dK and dV stay in f32 registers for the whole walk.
//
// Only the tensor-core operands are rounded to bf16 (P and dS) and the
// outputs; every sum is f32. Rows are padded by 16 bytes in shared memory,
// which keeps ldmatrix free of bank conflicts; rows >= L and columns >= d are
// zero-filled on the load. Key columns >= Lk (dQ kernel) and q columns >= Lq
// (dK/dV kernel) get p = 0 by mask, whatever the LSE holds there. A pointer
// that is not a multiple of 16 bytes, or a head dim that is not a multiple
// of 8, takes element-wise loads and stores inside the same kernels, with
// the same bits. The head dim is a template parameter (48, 64, 80, 160, 256)
// so that every fragment index is static; up to 80 the warp keeps its K/V
// (dK/dV kernel) or Q/dO (dQ kernel) fragments in registers for the whole
// walk, above it rereads them from shared memory each step to stay inside
// the register file. Not done: wgmma and TMA; and a split of the dK/dV
// kernel's q walk over several blocks where its grid is small (KV 77: one
// KV tile a head), as those shapes are a few percent of the backward's time
// on the paths (PERF.md).
#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kBwdBK = 64;  // KV rows a step of the dQ walk

// Warps of a block, 16 rows each: the dQ kernel's q tile and the dK/dV
// kernel's KV tile. Set by hand to the fastest of 4 and 8 warps for each
// kernel as measured on the card at the UNet's shapes (PERF.md): 8 up to
// head dim 80, 4 above, where a thread already holds DP f32 accumulators.
__host__ __device__ constexpr int bwd_warps(int dp) { return dp <= 80 ? 8 : 4; }

// q rows a step of the dK/dV walk: 64, or 32 where dK and dV already take
// DP f32 registers a thread.
__host__ __device__ constexpr int bwd_bq(int dp) { return dp <= 80 ? 64 : 32; }

// Tiles in a ring: three (two loading while one is multiplied) up to head
// dim 80, two above, as in the forward.
__host__ __device__ constexpr int bwd_stages(int dp) { return dp <= 80 ? 3 : 2; }

// Shared memory of the dQ block: Q and dO, then the K/V ring; O is staged
// in the ring's last stage, which no K/V tile fills before delta is done.
template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (DP + 8) * (2 * 16 * bwd_warps(DP) + bwd_stages(DP) * 2 * kBwdBK);
}

// Shared memory of the dK/dV block: K and V, the ring of Q and dO, then the
// ring's lse and delta rows.
template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * (DP + 8) *
             (2 * 16 * bwd_warps(DP) + bwd_stages(DP) * 2 * bwd_bq(DP)) +
         sizeof(float) * bwd_stages(DP) * 2 * bwd_bq(DP);
}

// ldmatrix lane offsets into rows LDS elements apart. A (16 rows x 16,
// row-major): lanes 0-15 rows 0-15 at column 0, lanes 16-31 the same rows at
// column 8. B from n-major rows (K, V, Q or dO as the right factor of a
// product with their rows as its columns): matrices (rows 0-7, k 0-7),
// (rows 0-7, k 8-15), (rows 8-15, k 0-7), (rows 8-15, k 8-15). B from k-major
// rows through .trans (K, dO or Q with their rows as the contraction):
// (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
// (rows 8-15, cols 8-15).
struct LaneOffsets {
  int a, b, bt;
  __device__ LaneOffsets(int lane, int lds)
      : a((lane & 15) * lds + (lane >> 4) * 8),
        b(((lane & 7) + ((lane >> 4) << 3)) * lds + ((lane >> 3) & 1) * 8),
        bt(((lane & 7) + (((lane >> 3) & 1) << 3)) * lds + (lane >> 4) * 8) {}
};

// Writes rows [row0, row0 + 16) of a warp's bf16 staging tile (DP columns,
// rows DP + 8 apart) to an (L, d) matrix whose rows lie ld elements apart,
// skipping rows >= L and columns >= d: 16-byte stores where the rows allow
// them, element stores otherwise.
template <int DP>
__device__ __forceinline__ void store_warp_rows(bf16* __restrict__ dst, int ld,
                                                const bf16* src, int row0, int L, int d) {
  constexpr int LDS = DP + 8;
  const int lane = threadIdx.x & 31;
  if (rows_vectorize(dst, ld, d)) {
    constexpr int PIECES = DP / 8;
    for (int i = lane; i < 16 * PIECES; i += 32) {
      const int r = i / PIECES, c = (i % PIECES) * 8;
      if (row0 + r < L && c < d) {
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + c) =
            *reinterpret_cast<const uint4*>(src + r * LDS + c);
      }
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      if (row0 + r < L && c < d) dst[(size_t)(row0 + r) * ld + c] = src[r * LDS + c];
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
  }
}

// Rounds a warp's (16 x DP) f32 accumulator fragment to bf16 into its 16
// staging rows (DP + 8 apart).
template <int DP>
__device__ __forceinline__ void stage_acc(bf16* rows, const float (&acc)[DP / 8][4], int g,
                                          int t) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(rows + (g + 8 * hf) * (DP + 8) + nb * 8 + 2 * t) =
          pack_bf16(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * bwd_warps(DP))
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int Lq, int Lk, int d,
                    float scale) {
  constexpr int LDS = DP + 8;
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  constexpr int NB = DP / 8;   // 8-wide column blocks of dQ
  constexpr int STAGES = bwd_stages(DP);
  constexpr int STAGE_ELEMS = 2 * kBwdBK * LDS;  // one K tile and one V tile
  constexpr bool KEEP_QG = DP <= 80;
  constexpr int THREADS = 32 * bwd_warps(DP);
  constexpr int ROWS = 16 * bwd_warps(DP);  // q rows of the block
  static_assert(DP % 16 == 0, "the head dim is padded to whole 16-deep steps");

  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + ROWS * LDS;
  bf16* sKV = sG + ROWS * LDS;
  bf16* sO = sKV + (STAGES - 1) * STAGE_ELEMS;

  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const bf16* qh = q + (size_t)bh * Lq * d;
  const bf16* gh = g + (size_t)bh * Lq * d;
  const bf16* oh = o + (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wr0 = warp * 16;               // the warp's first row of the q tile
  const float scale_log2 = scale * kLog2e;
  const int ntiles = (Lk + kBwdBK - 1) / kBwdBK;
  const bool vec_kv = rows_vectorize(kh, d, d) && rows_vectorize(vh, d, d);
  const LaneOffsets off(lane, LDS);

  auto load_kv = [&](int tile) {
    bf16* sK = sKV + (tile % STAGES) * STAGE_ELEMS;
    load_rows<DP, kBwdBK, THREADS>(sK, kh, d, tile * kBwdBK, Lk, d, vec_kv);
    load_rows<DP, kBwdBK, THREADS>(sK + kBwdBK * LDS, vh, d, tile * kBwdBK, Lk, d,
                                       vec_kv);
  };

  // Q, dO and O in the first group; K/V tiles 0 .. STAGES - 2 after it.
  load_rows<DP, ROWS, THREADS>(sQ, qh, d, q0, Lq, d, rows_vectorize(qh, d, d));
  load_rows<DP, ROWS, THREADS>(sG, gh, d, q0, Lq, d, rows_vectorize(gh, d, d));
  load_rows<DP, ROWS, THREADS>(sO, oh, d, q0, Lq, d, rows_vectorize(oh, d, d));
  cp_async_commit();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // lse (in log2 units) and delta of the thread's two rows, g8 and g8 + 8.
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + wr0 + g8 + 8 * hf;
    lse2[hf] = r < Lq ? lse[(size_t)bh * Lq + r] * kLog2e : 0.0f;
  }

  cp_async_wait<STAGES - 1>();  // the first group
  __syncthreads();
  // delta = rowsum(dO * O): the four lanes of a row take columns 2t + 8i.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wr0 + g8 + 8 * hf;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * t;
      const float2 gv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sG + r * LDS + c));
      const float2 ov =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sO + r * LDS + c));
      sum = fmaf(gv.x, ov.x, sum);
      sum = fmaf(gv.y, ov.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[hf] = sum;
    if (t == 0 && q0 + r < Lq) delta[(size_t)bh * Lq + q0 + r] = sum;
  }

  uint32_t qf[KEEP_QG ? KS : 1][4], gf[KEEP_QG ? KS : 1][4];
  if (KEEP_QG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(qf[KEEP_QG ? kk : 0], sQ + wr0 * LDS + kk * 16 + off.a);
      ldmatrix_x4(gf[KEEP_QG ? kk : 0], sG + wr0 * LDS + kk * 16 + off.a);
    }
  }
  float acc[NB][4];
  zero_acc(acc);

  for (int tile = 0; tile < ntiles; ++tile) {
    // Tile `tile` has landed for this thread; after the barrier for all, and
    // every warp is done with tile - 1 (and, at tile 0, with O), whose
    // buffer the next load refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < ntiles) load_kv(tile + STAGES - 1);
    cp_async_commit();

    const bf16* sK = sKV + (tile % STAGES) * STAGE_ELEMS;
    const bf16* sV = sK + kBwdBK * LDS;
    const int k0 = tile * kBwdBK;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and this tile's 64 keys.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!KEEP_QG) {
        ldmatrix_x4(qf[0], sQ + wr0 * LDS + kk * 16 + off.a);
        ldmatrix_x4(gf[0], sG + wr0 * LDS + kk * 16 + off.a);
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {  // 16 keys
        uint32_t b[4];
        ldmatrix_x4(b, sK + j2 * 16 * LDS + kk * 16 + off.b);
        mma_16816(s[2 * j2], qf[KEEP_QG ? kk : 0], b[0], b[1]);
        mma_16816(s[2 * j2 + 1], qf[KEEP_QG ? kk : 0], b[2], b[3]);
        ldmatrix_x4(b, sV + j2 * 16 * LDS + kk * 16 + off.b);
        mma_16816(dp[2 * j2], gf[KEEP_QG ? kk : 0], b[0], b[1]);
        mma_16816(dp[2 * j2 + 1], gf[KEEP_QG ? kk : 0], b[2], b[3]);
      }
    }

    // P and dS on the fragment; dS repacked as the A operand of dS K.
    // Element e of block j: row g8 + 8 * (e / 2), key 8 * j + 2 * t + e % 2.
    uint32_t ds[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p0 = ex2(fmaf(s[j][2 * hf], scale_log2, -lse2[hf]));
        float p1 = ex2(fmaf(s[j][2 * hf + 1], scale_log2, -lse2[hf]));
        if (c >= Lk) p0 = 0.0f;
        if (c + 1 >= Lk) p1 = 0.0f;
        ds[j / 2][hf + 2 * (j % 2)] = pack_bf16(p0 * (dp[j][2 * hf] - dl[hf]) * scale,
                                               p1 * (dp[j][2 * hf + 1] - dl[hf]) * scale);
      }
    }

    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {  // 16 head-dim columns
        uint32_t b[4];
        ldmatrix_x4_trans(b, sK + kk * 16 * LDS + n2 * 16 + off.bt);
        mma_16816(acc[2 * n2], ds[kk], b[0], b[1]);
        mma_16816(acc[2 * n2 + 1], ds[kk], b[2], b[3]);
      }
    }
  }

  // The warp's dQ rows as bf16 in its own rows of sQ (only this warp read
  // them), then out in 16-byte pieces.
  __syncwarp();
  stage_acc<DP>(sQ + wr0 * LDS, acc, g8, t);
  __syncwarp();
  store_warp_rows<DP>(dq + (size_t)bh * Lq * d, d, sQ + wr0 * LDS, q0 + wr0, Lq, d);
}

template <int DP>
__global__ void __launch_bounds__(32 * bwd_warps(DP))
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int d,
                      float scale) {
  constexpr int LDS = DP + 8;
  constexpr int KS = DP / 16;         // 16-deep steps over the head dim
  constexpr int NB = DP / 8;          // 8-wide column blocks of dK, dV
  constexpr int BQ = bwd_bq(DP);    // q rows a step
  constexpr int NS = BQ / 8;          // 8-wide q column blocks of S^T
  constexpr int STAGES = bwd_stages(DP);
  constexpr int STAGE_ELEMS = 2 * BQ * LDS;  // one Q tile and one dO tile
  constexpr bool KEEP_KV = DP <= 80;
  constexpr int THREADS = 32 * bwd_warps(DP);
  constexpr int ROWS = 16 * bwd_warps(DP);  // KV rows of the block
  static_assert(DP % 16 == 0, "the head dim is padded to whole 16-deep steps");

  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + ROWS * LDS;
  bf16* sQG = sV + ROWS * LDS;
  float* sStat = reinterpret_cast<float*>(sQG + STAGES * STAGE_ELEMS);  // lse, delta

  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const bf16* qh = q + (size_t)bh * Lq * d;
  const bf16* gh = g + (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* lh = lse + (size_t)bh * Lq;
  const float* dh = delta + (size_t)bh * Lq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wr0 = warp * 16;               // the warp's first KV row of the tile
  const float scale_log2 = scale * kLog2e;
  const int ntiles = (Lq + BQ - 1) / BQ;
  const bool vec_qg = rows_vectorize(qh, d, d) && rows_vectorize(gh, d, d);
  const LaneOffsets off(lane, LDS);

  auto load_q = [&](int tile) {
    bf16* sQ = sQG + (tile % STAGES) * STAGE_ELEMS;
    load_rows<DP, BQ, THREADS>(sQ, qh, d, tile * BQ, Lq, d, vec_qg);
    load_rows<DP, BQ, THREADS>(sQ + BQ * LDS, gh, d, tile * BQ, Lq, d, vec_qg);
    float* st = sStat + (tile % STAGES) * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const float* src = i < BQ ? lh : dh;
      const int r = tile * BQ + i % BQ;
      cp_async_4(st + i, r < Lq ? src + r : src, r < Lq ? 4 : 0);
    }
  };

  // K and V travel in the first group, with q tile 0.
  load_rows<DP, ROWS, THREADS>(sK, kh, d, k0, Lk, d, rows_vectorize(kh, d, d));
  load_rows<DP, ROWS, THREADS>(sV, vh, d, k0, Lk, d, rows_vectorize(vh, d, d));
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_q(s);
    cp_async_commit();
  }

  uint32_t kf[KEEP_KV ? KS : 1][4], vf[KEEP_KV ? KS : 1][4];
  float dk_acc[NB][4], dv_acc[NB][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < ntiles) load_q(tile + STAGES - 1);
    cp_async_commit();

    if (KEEP_KV && tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(kf[KEEP_KV ? kk : 0], sK + wr0 * LDS + kk * 16 + off.a);
        ldmatrix_x4(vf[KEEP_KV ? kk : 0], sV + wr0 * LDS + kk * 16 + off.a);
      }
    }

    const bf16* sQ = sQG + (tile % STAGES) * STAGE_ELEMS;
    const bf16* sG = sQ + BQ * LDS;
    const float* sL = sStat + (tile % STAGES) * 2 * BQ;
    const float* sD = sL + BQ;
    const int q0 = tile * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 KV rows and BQ q rows.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!KEEP_KV) {
        ldmatrix_x4(kf[0], sK + wr0 * LDS + kk * 16 + off.a);
        ldmatrix_x4(vf[0], sV + wr0 * LDS + kk * 16 + off.a);
      }
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {  // 16 q rows
        uint32_t b[4];
        ldmatrix_x4(b, sQ + j2 * 16 * LDS + kk * 16 + off.b);
        mma_16816(s[2 * j2], kf[KEEP_KV ? kk : 0], b[0], b[1]);
        mma_16816(s[2 * j2 + 1], kf[KEEP_KV ? kk : 0], b[2], b[3]);
        ldmatrix_x4(b, sG + j2 * 16 * LDS + kk * 16 + off.b);
        mma_16816(dp[2 * j2], vf[KEEP_KV ? kk : 0], b[0], b[1]);
        mma_16816(dp[2 * j2 + 1], vf[KEEP_KV ? kk : 0], b[2], b[3]);
      }
    }

    // P^T and dS^T on the fragment, repacked as the A operands of P^T dO and
    // dS^T Q. Element e of block j: KV row g8 + 8 * (e / 2), q row
    // 8 * j + 2 * t + e % 2, whose lse and delta every lane reads from the
    // staged rows.
    uint32_t pa[NS / 2][4], dsa[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
      const float m0 = l2.x * kLog2e, m1 = l2.y * kLog2e;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p0 = ex2(fmaf(s[j][2 * hf], scale_log2, -m0));
        float p1 = ex2(fmaf(s[j][2 * hf + 1], scale_log2, -m1));
        if (q0 + c >= Lq) p0 = 0.0f;
        if (q0 + c + 1 >= Lq) p1 = 0.0f;
        pa[j / 2][hf + 2 * (j % 2)] = pack_bf16(p0, p1);
        dsa[j / 2][hf + 2 * (j % 2)] = pack_bf16(p0 * (dp[j][2 * hf] - d2.x) * scale,
                                                p1 * (dp[j][2 * hf + 1] - d2.y) * scale);
      }
    }

    // dV += P^T dO and dK += dS^T Q.
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {  // 16 q rows
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {  // 16 head-dim columns
        uint32_t b[4];
        ldmatrix_x4_trans(b, sG + kk * 16 * LDS + n2 * 16 + off.bt);
        mma_16816(dv_acc[2 * n2], pa[kk], b[0], b[1]);
        mma_16816(dv_acc[2 * n2 + 1], pa[kk], b[2], b[3]);
        ldmatrix_x4_trans(b, sQ + kk * 16 * LDS + n2 * 16 + off.bt);
        mma_16816(dk_acc[2 * n2], dsa[kk], b[0], b[1]);
        mma_16816(dk_acc[2 * n2 + 1], dsa[kk], b[2], b[3]);
      }
    }
  }

  // The warp's dK and dV rows as bf16 in its own rows of sK and sV (only
  // this warp read them), then out in 16-byte pieces.
  __syncwarp();
  stage_acc<DP>(sK + wr0 * LDS, dk_acc, g8, t);
  stage_acc<DP>(sV + wr0 * LDS, dv_acc, g8, t);
  __syncwarp();
  store_warp_rows<DP>(dk + (size_t)bh * Lk * d, d, sK + wr0 * LDS, k0 + wr0, Lk, d);
  store_warp_rows<DP>(dv + (size_t)bh * Lk * d, d, sV + wr0 * LDS, k0 + wr0, Lk, d);
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxBlockSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dQ (and delta) first, then dK/dV, which reads delta, on one stream.
template <int DP>
int launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                     const bf16* g, const float* lse, float* delta, bf16* dq, bf16* dk,
                     bf16* dv, int bh, int lq, int lk, int d, cudaStream_t st) {
  constexpr int THREADS = 32 * bwd_warps(DP), ROWS = 16 * bwd_warps(DP);
  const float scale = 1.0f / sqrtf((float)d);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<DP>, dq_smem_bytes<DP>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<DP><<<dim3((lq + ROWS - 1) / ROWS, bh), THREADS, dq_smem_bytes<DP>(),
                            st>>>(q, k, v, o, g, lse, delta, dq, lq, lk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem(flash_bwd_dkdv_kernel<DP>, dkdv_smem_bytes<DP>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<DP><<<dim3((lk + ROWS - 1) / ROWS, bh), THREADS,
                              dkdv_smem_bytes<DP>(), st>>>(q, k, v, g, lse, delta, dk, dv, lq,
                                                           lk, d, scale);
  return (int)cudaGetLastError();
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
  return dispatch_head_dim<256>(d, [&](auto dp) {
    return launch_flash_bwd<decltype(dp)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), bh, lq, lk, d, static_cast<cudaStream_t>(stream));
  });
}
