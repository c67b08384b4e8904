// Kernel 2's bf16 backward on Hopper's warpgroup MMA, at the padded head
// dims 48 (SD1.x's head dim 40, the 4096-token level) and 80 (the 1024-token
// level). flash_bwd.cu's entry sends a head dim that is a multiple of 8 and
// pads to 48 or 80 here; every other head dim keeps the mma.sync kernels
// there. The arithmetic is theirs (the port of
// lmdx/nn/pallas/flash_attention.py::_pallas_attention_bwd): p = exp2(s *
// scale * log2 e - lse * log2 e), dS = p (dP - delta) scale, p and dS
// rounded to bf16 as the operands of the products that read them, every sum
// in f32, p = 0 for keys >= Lk and q rows >= Lq.
//
// What bounds it: the five (Lq x Lk x d) products of the bound at 989
// TFLOP/s. Next to them, at d 48, each (q, key) pair costs one exponential
// (the SM's 16 a clock take two thirds of the bound's time) and some six f32
// operations, twice over, as each kernel recomputes p. Measured on the card
// (PERF.md), the two kernels run near the sum of their tensor, exponential
// and f32 work rather than its maximum: a warpgroup's step waits for its
// products, then computes, then waits again, and only the other warpgroups
// of the SM fill those waits. Three warpgroups a block at d 48 (and fewer
// rereads of the walked tiles) gave more than any ring depth, a deeper KV
// tile, turn-taking between warpgroups or waiting for a step's last product
// one step later.
//
// Design. Two kernels on one stream, each output element with one owner
// block, sums in a fixed order and no atomics, so dQ, dK and dV are bit-equal
// from run to run:
//
// - flash_bwd_dq_sm90_kernel: a block owns 64 q rows per warpgroup; it
//   computes delta = rowsum(dO * O) for them (written for the second kernel),
//   then walks the KV in tiles of kDqKv rows: S = Q K^T and dP = dO V^T, p
//   and dS on the accumulator fragments, dQ += dS K.
// - flash_bwd_dkdv_sm90_kernel: a block owns 64 KV rows per warpgroup and
//   walks the q rows in steps of 64 (`bwd_q_step`): S^T = K Q^T and dP^T =
//   V dO^T, p^T and dS^T on the fragments, dV += P^T dO and dK += dS^T Q.
//
// Why dQ keeps a kernel of its own (seven products, two of them the
// recomputed S and dP, where one pass would run five): in one pass every
// KV block adds a partial dQ to every q tile, 33 partials a tile at the
// 4096-token level. Bit-equal results need those adds in a fixed order,
// hence a chain of 33 handoffs a tile, each an L2 round trip of the add's
// completion and a flag (~1.5 us), against a block's whole walk of ~60 us:
// the chain, not the products, would set the pace. Two owners need no
// handoff.
//
// Tiles live in shared memory in the 32-byte swizzle (wgmma.cuh), which the
// products read K-major (head dim the contraction) or MN-major (rows the
// contraction) without a copy; a 40-wide head is padded with zeros to 48
// columns on the load. The operand a block keeps for its whole walk (K and V
// in the dK/dV kernel, Q and dO in the dQ kernel) is loaded into registers
// once by ldmatrix, so that every product reads only B from shared memory.
// The walked tiles come through a ring of kStages slots, kStages - 2 loaded
// ahead, each with a full and an empty mbarrier, so that no step waits for
// the whole block. Loads are 16-byte cp.async pieces; a pointer off 16 bytes
// takes element loads into the same tile, bit for bit. Outputs leave from
// the accumulators as bf16 pairs.
#pragma once

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace lmdx {
namespace {

// Block shapes, measured on the card at the training cell's shapes with
// scripts/torch_flash_bwd_variants.py (PERF.md).
template <int DP>
struct Sm90Bwd {
  // Warpgroups of a block, 64 rows each: 3 at head dim 48 (fewer rereads of
  // the walked operand, more warps to hide the products' latency), 2 at 80,
  // where 3 would spill the accumulators.
  static constexpr int kWarpgroups = DP <= 48 ? 3 : 2;
  static constexpr int kStages = 4;  // tiles in the ring; kStages - 2 load ahead
  static constexpr int kDqKv = 64;   // KV rows a step of the dQ walk
};
constexpr int kSm90DkdvQ = 64;  // q rows a step of the dK/dV walk

// The head dims this path takes: a multiple of 8 that pads to 48 or 80.
__host__ __device__ constexpr bool sm90_bwd_takes(int d) {
  return d > 0 && d % 8 == 0 && (d <= 48 || (d > 64 && d <= 80));
}

// Rows [row0, row0 + R) of an (L, d) bf16 matrix (rows d apart) into an
// R-row tile of DP columns in the 32-byte swizzle; rows >= L and columns >= d
// become zeros. Eight consecutive threads take 4 rows x 32 bytes (distinct
// banks), a warp whole rows of the source. vec (rows_vectorize): 16-byte
// cp.async pieces; otherwise element loads and one shared store a piece, the
// same tile.
template <int DP, int R, int THREADS>
__device__ __forceinline__ void load_tile(char* dst, const bf16* __restrict__ src, int row0, int L,
                                          int d, bool vec) {
  constexpr int NP = DP / 16;  // 32-byte column blocks
  for (int i = threadIdx.x; i < R * DP / 8; i += THREADS) {
    const int j = i & 7, qp = i >> 3;
    const int r = (qp / NP) * 4 + (j >> 1), col = ((qp % NP) * 2 + (j & 1)) * 8;
    const int row = row0 + r;
    const bool in = row < L && col < d;
    const bf16* from = src + (size_t)row * d + col;
    char* to = dst + sw32_off<R>(r, col);
    if (vec) {
      cp_async_16(to, in ? from : src, in ? 16 : 0);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) e[c] = in && col + c < d ? from[c] : __float2bfloat16(0.0f);
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// The register A operands of a warp's 16 rows (row0 .. row0 + 15 of an
// R-row tile) over all DP columns, KS 16-deep steps, by ldmatrix: lane l
// gives the address of row l % 8 of quarter l / 8.
template <int DP, int R>
__device__ __forceinline__ void load_a_regs(uint32_t (&a)[DP / 16][4], const char* tile, int row0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + sw32_off<R>(r, 16 * kk + 8 * (lane >> 4)));
  }
}

// A warpgroup's (64 x DP) f32 accumulator, rounded to bf16, into rows row0
// .. row0 + 63 of an (L, d) matrix (rows d apart): rows < L, columns < d, a
// pair a 4-byte store where the address allows it.
template <int DP>
__device__ __forceinline__ void store_acc_rows(bf16* __restrict__ dst, const float (&acc)[DP / 2],
                                               int row0, int L, int d) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * w + g + 8 * h, c = 8 * j + 2 * t;
      if (r < L && c < d) {
        bf16* p = dst + (size_t)r * d + c;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p) = v;
        } else {
          p[0] = v.x;
          p[1] = v.y;
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarriers of the ring: `full` completes when a tile has landed (every
// thread arrives once a tile), `empty` when every thread is done with it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Accumulator fragments (a 64 x 16k tile) as the register A operands of k
// 16-deep steps: step kk takes elements 8 kk .. 8 kk + 7 in pairs.
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R / 8][4], const float (&x)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// Bytes of an R-row tile of DP bf16 columns (a multiple of 256).
template <int DP, int R>
__host__ __device__ constexpr int tile_bytes() { return R * DP * 2; }

// O is needed only for delta, before the walk's first refill of the ring's
// last stage: it is staged there where it fits.
template <int DP>
__host__ __device__ constexpr bool sm90_dq_o_in_ring() {
  return 2 * Sm90Bwd<DP>::kDqKv >= 64 * Sm90Bwd<DP>::kWarpgroups;
}

// Tiles, then the ring's full and empty mbarriers.
template <int DP>
__host__ __device__ constexpr size_t sm90_dq_tile_bytes() {
  using T = Sm90Bwd<DP>;
  return (sm90_dq_o_in_ring<DP>() ? 2 : 3) * tile_bytes<DP, 64 * T::kWarpgroups>() +
         T::kStages * 2 * tile_bytes<DP, T::kDqKv>();
}

template <int DP>
__host__ __device__ constexpr size_t sm90_dq_smem_bytes() {
  return sm90_dq_tile_bytes<DP>() + 2 * Sm90Bwd<DP>::kStages * sizeof(uint64_t);
}

template <int DP>
__host__ __device__ constexpr size_t sm90_dkdv_stage_bytes() {
  return 2 * tile_bytes<DP, kSm90DkdvQ>() + 256 * ((2 * kSm90DkdvQ * 4 + 255) / 256);
}

template <int DP>
__host__ __device__ constexpr size_t sm90_dkdv_tile_bytes() {
  using T = Sm90Bwd<DP>;
  return 2 * tile_bytes<DP, 64 * T::kWarpgroups>() + T::kStages * sm90_dkdv_stage_bytes<DP>();
}

template <int DP>
__host__ __device__ constexpr size_t sm90_dkdv_smem_bytes() {
  return sm90_dkdv_tile_bytes<DP>() + 2 * Sm90Bwd<DP>::kStages * sizeof(uint64_t);
}

template <int DP>
__global__ void __launch_bounds__(128 * Sm90Bwd<DP>::kWarpgroups, 1)
flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ g, const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq, int Lq, int Lk, int d,
                         float scale) {
  using T = Sm90Bwd<DP>;
  constexpr int THREADS = 128 * T::kWarpgroups, ROWS = 64 * T::kWarpgroups;
  constexpr int BK = T::kDqKv, STAGES = T::kStages, AHEAD = STAGES - 2;
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  constexpr int TILE = tile_bytes<DP, BK>();
  static_assert(DP % 16 == 0 && BK % 16 == 0, "whole 16-deep steps");
  static_assert(AHEAD >= 1, "a tile in flight ahead of the one multiplied");

  extern __shared__ __align__(1024) char smem[];
  char* sQ = smem;
  char* sG = sQ + tile_bytes<DP, ROWS>();
  char* sKV = sG + (sm90_dq_o_in_ring<DP>() ? 1 : 2) * tile_bytes<DP, ROWS>();  // (K, V) x STAGES
  char* sO = sm90_dq_o_in_ring<DP>() ? sKV + (STAGES - 1) * 2 * TILE : sG + tile_bytes<DP, ROWS>();

  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const int w0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int r0 = w0 + (lane >> 2);                          // the thread's rows r0, r0 + 8
  const bf16* qh = q + (size_t)bh * Lq * d;
  const bf16* gh = g + (size_t)bh * Lq * d;
  const bf16* oh = o + (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float scale_log2 = scale * kLog2e;
  const int ntiles = (Lk + BK - 1) / BK;
  const bool vec_kv = rows_vectorize(kh, d, d) && rows_vectorize(vh, d, d);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + sm90_dq_tile_bytes<DP>());
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, THREADS);
      mbar_init(empty + s, THREADS);
    }
  }
  __syncthreads();

  // KV tile n into ring slot n % STAGES, arriving on its full barrier once
  // this thread's part has landed.
  auto load_kv = [&](int n) {
    char* sK = sKV + (n % STAGES) * 2 * TILE;
    load_tile<DP, BK, THREADS>(sK, kh, n * BK, Lk, d, vec_kv);
    load_tile<DP, BK, THREADS>(sK + TILE, vh, n * BK, Lk, d, vec_kv);
    if (vec_kv) {
      mbar_arrive_cp_async(full + n % STAGES);
    } else {
      mbar_arrive(full + n % STAGES);
    }
  };

  // Q, dO and O in one cp.async group; the first AHEAD KV tiles after it.
  load_tile<DP, ROWS, THREADS>(sQ, qh, q0, Lq, d, rows_vectorize(qh, d, d));
  load_tile<DP, ROWS, THREADS>(sG, gh, q0, Lq, d, rows_vectorize(gh, d, d));
  load_tile<DP, ROWS, THREADS>(sO, oh, q0, Lq, d, rows_vectorize(oh, d, d));
  cp_async_commit();
  for (int n = 0; n < AHEAD && n < ntiles; ++n) load_kv(n);

  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    lse2[h] = r < Lq ? lse[(size_t)bh * Lq + r] * kLog2e : 0.0f;
  }

  cp_async_wait<0>();
  __syncthreads();
  // delta = rowsum(dO * O): the four lanes of a row take columns 2t + 8i.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const uint32_t off = sw32_off<ROWS>(r, 8 * i + 2 * t);
      const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sG + off));
      const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sO + off));
      sum = fmaf(gv.x, ov.x, sum);
      sum = fmaf(gv.y, ov.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[h] = sum;
    if (t == 0 && q0 + r < Lq) delta[(size_t)bh * Lq + q0 + r] = sum;
  }
  // Q and dO of the warp's rows as the A operands of S and dP, for the walk.
  uint32_t qa[KS][4], ga[KS][4];
  load_a_regs<DP, ROWS>(qa, sQ, w0);
  load_a_regs<DP, ROWS>(ga, sG, w0);
  __syncthreads();  // O is read: its slot may be refilled

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  for (int tile = 0; tile < ntiles; ++tile) {
    // Tile `tile` has landed; the fence (which also waits for this thread's
    // own loads in flight) comes before the refill of the slot of tile - 2,
    // which every warpgroup is done with.
    mbar_wait(full + tile % STAGES, (tile / STAGES) & 1);
    fence_proxy_async_smem();
    if (tile + AHEAD < ntiles) {
      const int n = tile + AHEAD;
      if (n >= STAGES) mbar_wait(empty + n % STAGES, (n / STAGES - 1) & 1);
      load_kv(n);
    }

    const uint32_t k_addr = smem_u32(sKV + (tile % STAGES) * 2 * TILE);
    const uint64_t k_desc = desc_kmajor(k_addr), v_desc = desc_kmajor(k_addr + TILE);

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows and BK keys.
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Wgmma<BK>::template rs<0>(s, qa[kk], k_desc + kk * k_kstep<BK>(), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Wgmma<BK>::template rs<0>(dp, ga[kk], v_desc + kk * k_kstep<BK>(), kk);
    }
    wgmma_commit();

    // p on S's fragment. Element i: row r0 + 8 (i % 4 / 2), key 8 (i / 4) +
    // 2t + i % 2.
    const int k0 = tile * BK;
    const bool edge = k0 + BK > Lk;
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float p = ex2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
      if (edge && k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Lk) p = 0.0f;
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;
    uint32_t ds[BK / 16][4];
    pack_a<BK / 2>(ds, dp);

    // dQ += dS K, K read MN-major (its rows are the contraction).
    const uint64_t kt_desc = desc_mnmajor<BK>(k_addr);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma<DP>::template rs<1>(acc, ds[kk], kt_desc + kk * kMnKStep, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + tile % STAGES);
  }
  store_acc_rows<DP>(dq + (size_t)bh * Lq * d, acc, q0 + 64 * wg, Lq, d);
}

template <int DP>
__global__ void __launch_bounds__(128 * Sm90Bwd<DP>::kWarpgroups, 1)
flash_bwd_dkdv_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int d,
                           float scale) {
  using T = Sm90Bwd<DP>;
  constexpr int THREADS = 128 * T::kWarpgroups, ROWS = 64 * T::kWarpgroups;
  constexpr int BQ = kSm90DkdvQ, STAGES = T::kStages, AHEAD = STAGES - 2;
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  static_assert(AHEAD >= 1, "a tile in flight ahead of the one multiplied");
  constexpr int TILE = tile_bytes<DP, BQ>();
  constexpr size_t STAGE_BYTES = sm90_dkdv_stage_bytes<DP>();

  extern __shared__ __align__(1024) char smem[];
  char* sK = smem;
  char* sV = sK + tile_bytes<DP, ROWS>();
  char* ring = sV + tile_bytes<DP, ROWS>();  // STAGES x (Q, dO, lse, delta)

  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const int w0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3);  // the warp's first KV row
  const int r0 = w0 + (lane >> 2);                          // the thread's rows r0, r0 + 8
  const bf16* qh = q + (size_t)bh * Lq * d;
  const bf16* gh = g + (size_t)bh * Lq * d;
  const bf16* kh = k + (size_t)bh * Lk * d;
  const bf16* vh = v + (size_t)bh * Lk * d;
  const float* lh = lse + (size_t)bh * Lq;
  const float* dh = delta + (size_t)bh * Lq;
  const float scale_log2 = scale * kLog2e;
  const int ntiles = (Lq + BQ - 1) / BQ;
  const bool vec_qg = rows_vectorize(qh, d, d) && rows_vectorize(gh, d, d);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + sm90_dkdv_tile_bytes<DP>());
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, THREADS);
      mbar_init(empty + s, THREADS);
    }
  }
  __syncthreads();

  // q tile n (Q, dO, lse, delta) into ring slot n % STAGES, arriving on its
  // full barrier once this thread's part has landed.
  auto load_q = [&](int n) {
    char* sQ = ring + (n % STAGES) * STAGE_BYTES;
    load_tile<DP, BQ, THREADS>(sQ, qh, n * BQ, Lq, d, vec_qg);
    load_tile<DP, BQ, THREADS>(sQ + TILE, gh, n * BQ, Lq, d, vec_qg);
    float* st = reinterpret_cast<float*>(sQ + 2 * TILE);
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const float* src = i < BQ ? lh : dh;
      const int r = n * BQ + i % BQ;
      cp_async_4(st + i, r < Lq ? src + r : src, r < Lq ? 4 : 0);
    }
    if (vec_qg) {
      mbar_arrive_cp_async(full + n % STAGES);
    } else {
      cp_async_wait_all();
      mbar_arrive(full + n % STAGES);
    }
  };

  // K and V in one cp.async group; the first AHEAD q tiles after it.
  load_tile<DP, ROWS, THREADS>(sK, kh, k0, Lk, d, rows_vectorize(kh, d, d));
  load_tile<DP, ROWS, THREADS>(sV, vh, k0, Lk, d, rows_vectorize(vh, d, d));
  cp_async_commit();
  for (int n = 0; n < AHEAD && n < ntiles; ++n) load_q(n);

  const bool row_in[2] = {k0 + r0 < Lk, k0 + r0 + 8 < Lk};
  const bool kv_edge = k0 + ROWS > Lk;
  uint32_t ka[KS][4], va[KS][4];  // K and V of the warp's rows, A operands of S^T and dP^T
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  cp_async_wait<0>();
  __syncthreads();
  load_a_regs<DP, ROWS>(ka, sK, w0);
  load_a_regs<DP, ROWS>(va, sV, w0);

  for (int tile = 0; tile < ntiles; ++tile) {
    mbar_wait(full + tile % STAGES, (tile / STAGES) & 1);
    fence_proxy_async_smem();
    if (tile + AHEAD < ntiles) {
      const int n = tile + AHEAD;
      if (n >= STAGES) mbar_wait(empty + n % STAGES, (n / STAGES - 1) & 1);
      load_q(n);
    }

    const char* stage = ring + (tile % STAGES) * STAGE_BYTES;
    const uint32_t q_addr = smem_u32(stage), g_addr = q_addr + TILE;
    const float* sL = reinterpret_cast<const float*>(stage + 2 * TILE);
    const float* sD = sL + BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 KV rows and BQ q rows.
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Wgmma<BQ>::template rs<0>(s, ka[kk], desc_kmajor(q_addr) + kk * k_kstep<BQ>(), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Wgmma<BQ>::template rs<0>(dp, va[kk], desc_kmajor(g_addr) + kk * k_kstep<BQ>(), kk);
    }
    wgmma_commit();

    // p^T on the fragment. Element i: KV row r0 + 8 (i % 4 / 2), q row
    // 8 (i / 4) + 2t + i % 2, whose lse and delta every lane reads from the
    // staged rows.
    const int q0 = tile * BQ;
    const bool edge = kv_edge || q0 + BQ > Lq;
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
      const float m[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * j + e], scale_log2, -m[e & 1]));
        if (edge && (q0 + 8 * j + 2 * t + (e & 1) >= Lq || !row_in[e >> 1])) p = 0.0f;
        s[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
    }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    pack_a<BQ / 2>(pa, s);
    pack_a<BQ / 2>(dsa, dp);

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
    const uint64_t gt_desc = desc_mnmajor<BQ>(g_addr), qt_desc = desc_mnmajor<BQ>(q_addr);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DP>::template rs<1>(dv_acc, pa[kk], gt_desc + kk * kMnKStep, 1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DP>::template rs<1>(dk_acc, dsa[kk], qt_desc + kk * kMnKStep, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(empty + tile % STAGES);
  }
  store_acc_rows<DP>(dk + (size_t)bh * Lk * d, dk_acc, k0 + 64 * wg, Lk, d);
  store_acc_rows<DP>(dv + (size_t)bh * Lk * d, dv_acc, k0 + 64 * wg, Lk, d);
}

}  // namespace
}  // namespace lmdx
