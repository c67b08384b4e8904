// Shared pieces of the port's kernels: the types, the warp reduction
// pair_stats.cu uses, the head-dim dispatch, and the PTX wrappers and
// cp.async row loads that both directions of attention use (the forward
// body in attention_fwd.cuh and the backward in flash_bwd.cu): cp.async
// (16- and 4-byte, zero-fill), ldmatrix (plain and .trans), mma.sync
// m16n8k16 (bf16 in, f32 accumulate), ex2.approx, bf16 packing and the
// zero-filling row load. Both directions keep their scores and accumulators
// in registers and issue mma.sync themselves; nothing here goes through
// shared-memory accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace lmdx {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxBlockSmem = 232448;  // 227 KB a block

__device__ inline float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

namespace {

// ---------------------------------------------------------------------------
// PTX: cp.async, ldmatrix, mma.sync, ex2
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the first src_bytes come from src, the rest are
// zeros (src_bytes 0: nothing is read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, col-major).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows of d bf16, ld elements apart, can move in whole 16-byte pieces.
__device__ __forceinline__ bool rows_vectorize(const bf16* p, int ld, int d) {
  return aligned16(p) && (ld & 7) == 0 && (d & 7) == 0;
}

// Rows [row0, row0 + ROWS) of an (L, d) bf16 matrix whose rows lie ld
// elements apart, into a shared tile of DP columns (rows DP + 8 apart). Rows
// >= L and columns >= d become zeros, so they add exact zeros to every
// product that reads them. vec: rows_vectorize(src, ld, d); cp.async in
// 16-byte pieces then, plain element loads and stores otherwise.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                          int row0, int L, int d, bool vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int PIECES = DP / 8;
    for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
      const int r = i / PIECES, c = (i % PIECES) * 8;
      const int gr = row0 + r;
      const bool in = gr < L && c < d;
      cp_async_16(dst + r * LDS + c, in ? src + (size_t)gr * ld + c : src, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const int gr = row0 + r;
      dst[r * LDS + c] = (gr < L && c < d) ? src[(size_t)gr * ld + c] : zero;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Calls f(integral_constant<int, DP>) with the narrowest instantiated head
// dim DP >= d up to MAX_DP (d <= MAX_DP is the caller's check); a source
// names the widest it needs, so that it builds no wider one.
template <int MAX_DP, class F>
int dispatch_head_dim(int d, F&& f) {
  if (d <= 48) return f(std::integral_constant<int, 48>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 80) return f(std::integral_constant<int, 80>{});
  if (d <= 160) return f(std::integral_constant<int, 160>{});
  if constexpr (MAX_DP > 160) {
    if (d <= 256) return f(std::integral_constant<int, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lmdx
