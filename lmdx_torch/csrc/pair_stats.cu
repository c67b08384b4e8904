// Per-row sum(a) and sum(a * b): the reduction of GroupNorm's forward and
// backward.
//
// Replaces: lmdx/nn/pallas/group_norm.py::pair_stats (the TPU kernel, l.60).
// a, b: (rows, n) row-major, both bf16 or both f32; sum_a, sum_ab: (rows) f32,
// accumulated in f32. The port is NCHW inside, so a GroupNorm input viewed as
// (B * C, H * W) makes each (image, channel) statistic the sum of one
// contiguous row. The forward calls it with b = a (sum and sum of squares),
// the backward with (g * silu', x_hat): dbeta, dgamma and both group moments
// of the dx formula come from the same two sums.
//
// What bounds it on an H100: two operations per element read: bytes. Each
// input is read once, with 16-byte loads where the rows allow it, and when a
// and b are the same tensor it is read once, not twice.
//
// Design. The TPU kernel reduced 128-channel tiles over the spatial axis of
// an NHWC view and masked the partial channel tile; with rows contiguous
// there is no partial tile and no mask. One block of 256 threads per row at
// n >= 1024; one warp per row (8 rows a block) below that, where a row is a
// few hundred bytes and a block-wide reduction would be mostly barrier.
// Lanes stride over the row, sum in registers, then reduce by shuffles (and
// through shared memory across the 8 warps of a one-row block). One owner
// per output, no atomics: the result does not depend on block order.
#include "flash_common.cuh"

namespace lmdx {
namespace {

constexpr int kStatThreads = 256;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }

// The values of one 16-byte load.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kCount = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  }
};

template <>
struct Vec16<bf16> {
  static constexpr int kCount = 8;
  __device__ static void load(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
};

// kLanes threads per row (32: one warp per row; kStatThreads: one block per
// row). `same`: b is a, read once. `vec`: rows start 16-byte aligned and n is
// a whole number of 16-byte loads.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kStatThreads)
pair_stats_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ sum_a, float* __restrict__ sum_ab, int rows, int n,
                  bool same, bool vec) {
  constexpr int kRows = kStatThreads / kLanes;
  constexpr int kV = Vec16<T>::kCount;
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  float sa = 0.0f, sab = 0.0f;
  if (row < rows) {
    const T* ar = a + (size_t)row * n;
    const T* br = b + (size_t)row * n;
    if (vec) {
      for (int i = t * kV; i < n; i += kLanes * kV) {
        float av[kV], bv[kV];
        Vec16<T>::load(ar + i, av);
        if (!same) Vec16<T>::load(br + i, bv);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          sa += av[j];
          sab += av[j] * (same ? av[j] : bv[j]);
        }
      }
    } else {
      for (int i = t; i < n; i += kLanes) {
        const float x = to_float(ar[i]);
        sa += x;
        sab += x * (same ? x : to_float(br[i]));
      }
    }
  }
  sa = warp_sum(sa);
  sab = warp_sum(sab);
  if constexpr (kLanes == 32) {
    if (t == 0 && row < rows) {
      sum_a[row] = sa;
      sum_ab[row] = sab;
    }
  } else {
    // One row per block: combine its warps through shared memory.
    __shared__ float part[2][kStatThreads / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      part[0][warp] = sa;
      part[1][warp] = sab;
    }
    __syncthreads();
    if (threadIdx.x == 0 && row < rows) {
      float ta = 0.0f, tab = 0.0f;
      for (int w = 0; w < kStatThreads / 32; ++w) {
        ta += part[0][w];
        tab += part[1][w];
      }
      sum_a[row] = ta;
      sum_ab[row] = tab;
    }
  }
}

template <typename T>
int launch_pair_stats(const void* a, const void* b, void* sum_a, void* sum_ab, int rows,
                      int n, cudaStream_t stream) {
  const bool same = a == b;
  const size_t row_bytes = (size_t)n * sizeof(T);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
                   reinterpret_cast<size_t>(b) % 16 == 0;
  const T* a_ = static_cast<const T*>(a);
  const T* b_ = static_cast<const T*>(b);
  float* sa = static_cast<float*>(sum_a);
  float* sab = static_cast<float*>(sum_ab);
  if (n >= 1024) {
    pair_stats_kernel<T, kStatThreads><<<rows, kStatThreads, 0, stream>>>(
        a_, b_, sa, sab, rows, n, same, vec);
  } else {
    constexpr int kRows = kStatThreads / 32;
    pair_stats_kernel<T, 32><<<(rows + kRows - 1) / kRows, kStatThreads, 0, stream>>>(
        a_, b_, sa, sab, rows, n, same, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_pair_stats(const void* a, const void* b, void* sum_a, void* sum_ab,
                               int rows, int n, int is_bf16, void* stream) {
  using namespace lmdx;
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_pair_stats<bf16>(a, b, sum_a, sum_ab, rows, n, st)
                 : launch_pair_stats<float>(a, b, sum_a, sum_ab, rows, n, st);
}
