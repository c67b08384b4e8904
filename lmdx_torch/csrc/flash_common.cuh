// Shared pieces of the port's kernels: the types and the shared-memory
// carving every source uses, the warp reductions pair_stats.cu uses, and the
// WMMA tile product (warp_gemm) with its cooperative tile loads and stores,
// which only the backward (flash_bwd.cu) still uses: the forward body
// (attention_fwd.cuh) keeps its scores and accumulators in registers and
// issues mma.sync itself.
//
// In flash_bwd.cu every matrix product is done by warps on bf16 tensor-core
// tiles through the WMMA API (16x16x16, f32 accumulate). Operands and
// accumulators live in shared memory; the block's threads do the elementwise
// work between products. That keeps the kernel a short sequence of
//   cooperative load -> sync -> warp_gemm -> sync -> elementwise -> sync
// steps, simple to check by reading. Head dims that are not a multiple of
// 16 (SD1.x: 40) are zero-padded to one on the load into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <type_traits>

namespace lmdx {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Carves a dynamic shared-memory buffer into 128-byte aligned regions. The
// host replays the same sequence of take() calls to size the launch.
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    size_t out = off;
    off += (bytes + 127) / 128 * 128;
    return out;
  }
};

// Loads rows [row0, row0 + rows) of a row-major (L, d) bf16 matrix into a
// shared tile of width dp (leading dimension ld). Rows >= L and columns >= d
// are written as zeros, so padded rows and columns add exact zeros to every
// product that reads them.
__device__ inline void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                 int row0, int rows, int L, int d, int dp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16 zero = __float2bfloat16(0.0f);
  for (int r = warp; r < rows; r += kWarps) {
    const int gr = row0 + r;
    const bf16* row = src + (size_t)gr * d;
    for (int c = lane; c < dp; c += 32) {
      dst[r * ld + c] = (gr < L && c < d) ? row[c] : zero;
    }
  }
}

// Writes rows [row0, row0 + rows) of an f32 shared tile back to a row-major
// (L, d) bf16 matrix, skipping rows >= L and the padded columns.
__device__ inline void store_tile(bf16* __restrict__ dst, const float* src, int ld,
                                  int row0, int rows, int L, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= L) continue;
    for (int c = lane; c < d; c += 32) {
      dst[(size_t)gr * d + c] = __float2bfloat16(src[r * ld + c]);
    }
  }
}

__device__ inline void zero_f32(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.0f;
}

// C (M x N, f32, row-major, ldc) = [C +] A (M x K) * B (K x N), with A and B
// bf16 in shared memory. A_T: A is stored transposed (element (m, k) at
// A[k * lda + m]); B_T: B is stored transposed (element (k, n) at
// B[n * ldb + k]). M, N, K are multiples of 16; each warp owns whole 16x16
// output tiles. lda/ldb must be multiples of 8 and ldc of 4, and every
// region must start 32-byte aligned (Carve gives 128).
template <bool A_T, bool B_T>
__device__ inline void warp_gemm(const bf16* A, int lda, const bf16* B, int ldb,
                                 float* C, int ldc, int M, int N, int K,
                                 bool accumulate) {
  using namespace nvcuda;
  using LayoutA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int tiles_n = N / 16;
  const int tiles = (M / 16) * tiles_n;
  for (int t = warp; t < tiles; t += kWarps) {
    const int mi = (t / tiles_n) * 16;
    const int ni = (t % tiles_n) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, C + mi * ldc + ni, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
      const bf16* pa = A_T ? A + k * lda + mi : A + mi * lda + k;
      const bf16* pb = B_T ? B + ni * ldb + k : B + k * ldb + ni;
      wmma::load_matrix_sync(a, pa, lda);
      wmma::load_matrix_sync(b, pb, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + mi * ldc + ni, acc, ldc, wmma::mem_row_major);
  }
}

__device__ inline float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace lmdx
