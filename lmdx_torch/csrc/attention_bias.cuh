// Bias policies of the attention forward bodies: the bf16 body
// (attention_fwd.cuh: kernels 1, 3, 4 and 5) and the float32 tensor-core body
// (attention_f32_tc.cuh: kernels 1-f32, 3-f32, 4-f32 and 5-f32). Both keep
// their scores as mma.sync accumulator fragments of one layout (m16n8k16 at
// bf16, m16n8k8 at tf32: a lane holds rows g and g + 8 at columns 2t and
// 2t + 1 of each 8-column block), so one policy serves both.
#pragma once

#include "flash_common.cuh"

namespace lmdx {
namespace {

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

}  // namespace
}  // namespace lmdx
