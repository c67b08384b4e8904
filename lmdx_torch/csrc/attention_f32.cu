// Entry points of the float32 attention body (attention_f32.cuh): the
// float32 forms of kernels 1 to 5.
//
// - lmdx_flash_fwd_f32 replaces lmdx/nn/pallas/flash_attention.py::
//   _pallas_attention (l.107) at float32: o = softmax(q k^T / sqrt(d)) v and
//   the row LSE, q (BH, Lq, d), k/v (BH, Lk, d), o (BH, Lq, d), lse (BH, Lq),
//   all float32 row-major. Kernel attn_f32_fwd_kernel.
// - lmdx_flash_bwd_f32 replaces flash_attention.py::_pallas_attention_bwd
//   (l.384) at float32: dq, dk, dv from q, k, v, o, dO and the forward's LSE
//   (natural units), with delta (BH, Lq) as scratch. Kernels
//   attn_f32_bwd_dq_kernel (first: delta and dQ) and attn_f32_bwd_dkdv_kernel
//   (after it on the same stream: dK and dV), each output element with one
//   owner, no atomics.
// - lmdx_flash_fwd_packed_f32 replaces flash_attention.py::
//   _pallas_attention_packed (l.211) at float32: lmdx_flash_fwd_f32's
//   function from the reference's start values (row max from -1e30, the
//   denominator clamped at 1e-30), q (B, H, Lq, d), k/v (B, H, Lk, d), lse
//   (B, H, Lq). Kernel attn_f32_fwd_packed_kernel, launched as kernel 1-f32
//   is, one block per (q tile, batch*head): the TPU kernel's block-diagonal
//   K/V of up to 3 heads filled its 128-wide matrix unit, which buys nothing
//   here (flash_fwd_packed.cu says why). On finite inputs the start values
//   never bite, so O and LSE equal lmdx_flash_fwd_f32's bit for bit.
// - lmdx_flash_fwd_fusedheads_f32 replaces flash_attention.py::
//   _pallas_attention_fusedheads (l.622) at float32: the same function per
//   head on the projection layout, qf/of (B, Lq, H*d), kf/vf (B, Lk, H*d),
//   read and written in place (row stride H*d, offset head*d), lse
//   (B, H, Lq). Kernel attn_f32_fwd_fusedheads_kernel, grid (q tiles, heads,
//   batch). Its gradient splits heads and runs lmdx_flash_bwd_f32, as the
//   TPU side's _fusedheads_bwd does.
// - lmdx_sam_attention_f32 replaces lmdx/nn/pallas/sam_attention.py::
//   _pallas_sam_attention (l.101) at float32: o = softmax(q k^T / sqrt(d) +
//   bias_h[q, k / gw] + bias_w[q, k % gw]) v over N = gh * gw tokens, the
//   bias added unscaled, no LSE. Kernel sam_f32_kernel.
//
// Each is bound by operations at the float32 FMA rate (67 TFLOP/s on an
// H100 SXM); attention_f32.cuh says why and what the design does about it.
// Every kernel declares a minimum of one block an SM: without it ptxas held
// the forward and SAM kernels at head dim 64 and the dQ kernel at 48 to 64
// registers and spilled (48-60 bytes); with it none spills (ptxas -v on the
// card; shared memory, not registers, sets how many blocks an SM holds).
// Head dims are padded to 48, 64, 80, 160 (256 for the flash kernels) by
// zero-filled columns. Each launch sets its shared memory (above 48 KB) and
// returns cudaGetLastError.
#include "attention_f32.cuh"

namespace lmdx {
namespace {

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Lq, int Lk, int d, float scale_log2) {
  attention_f32_fwd_body<DP>(f32_head_of_bhld(q, k, v, o, lse, blockIdx.y, Lq, Lk, d),
                             blockIdx.x * kF32BQ, Lq, Lk, d, scale_log2, F32NoBias{},
                             -INFINITY, 0.0f);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_fwd_packed_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Lq, int Lk, int d, float scale_log2) {
  attention_f32_fwd_body<DP>(f32_head_of_bhld(q, k, v, o, lse, blockIdx.y, Lq, Lk, d),
                             blockIdx.x * kF32BQ, Lq, Lk, d, scale_log2, F32NoBias{},
                             -1e30f, 1e-30f);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_fwd_fusedheads_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                               const float* __restrict__ vf, float* __restrict__ of,
                               float* __restrict__ lse, int heads, int Lq, int Lk, int d,
                               float scale_log2) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int hd = heads * d;
  const int bh = b * heads + head;
  const F32HeadView hv{qf + (size_t)b * Lq * hd + head * d,
                       kf + (size_t)b * Lk * hd + head * d,
                       vf + (size_t)b * Lk * hd + head * d,
                       of + (size_t)b * Lq * hd + head * d,
                       lse + (size_t)bh * Lq,
                       hd, hd, hd, hd, bh};
  attention_f32_fwd_body<DP>(hv, blockIdx.x * kF32BQ, Lq, Lk, d, scale_log2, F32NoBias{},
                             -INFINITY, 0.0f);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
sam_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int N, int d,
               float scale_log2, F32RelPosBias bias) {
  attention_f32_fwd_body<DP>(f32_head_of_bhld(q, k, v, o, nullptr, blockIdx.y, N, N, d),
                             blockIdx.x * kF32BQ, N, N, d, scale_log2, bias, -INFINITY, 0.0f);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ o,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq, int Lq, int Lk,
                       int d, float scale) {
  attention_f32_bwd_dq_body<DP>(q, k, v, o, g, lse, delta, dq, Lq, Lk, d, scale);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                         int d, float scale) {
  attention_f32_bwd_dkdv_body<DP>(q, k, v, g, lse, delta, dk, dv, Lq, Lk, d, scale);
}

template <class Kernel>
cudaError_t f32_set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxBlockSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

float f32_scale(int d) { return 1.0f / sqrtf((float)d); }

bool f32_args_ok(int bh, int lq, int lk, int d) {
  return bh > 0 && lq > 0 && lk > 0 && d > 0 && d <= 256 && bh <= 65535;
}

template <int DP>
int launch_fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                   int lq, int lk, int d, cudaStream_t st) {
  const size_t smem = f32_fwd_smem_bytes<DP>(F32NoBias{});
  cudaError_t err = f32_set_smem(attn_f32_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_fwd_kernel<DP><<<dim3((lq + kF32BQ - 1) / kF32BQ, bh), kF32Threads, smem, st>>>(
      q, k, v, o, lse, lq, lk, d, f32_scale(d) * kLog2e);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd_packed_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                          int bh, int lq, int lk, int d, cudaStream_t st) {
  const size_t smem = f32_fwd_smem_bytes<DP>(F32NoBias{});
  cudaError_t err = f32_set_smem(attn_f32_fwd_packed_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_fwd_packed_kernel<DP><<<dim3((lq + kF32BQ - 1) / kF32BQ, bh), kF32Threads, smem,
                                   st>>>(q, k, v, o, lse, lq, lk, d, f32_scale(d) * kLog2e);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd_fusedheads_f32(const float* qf, const float* kf, const float* vf, float* of,
                              float* lse, int batch, int heads, int lq, int lk, int d,
                              cudaStream_t st) {
  const size_t smem = f32_fwd_smem_bytes<DP>(F32NoBias{});
  cudaError_t err = f32_set_smem(attn_f32_fwd_fusedheads_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_fwd_fusedheads_kernel<DP><<<dim3((lq + kF32BQ - 1) / kF32BQ, heads, batch),
                                       kF32Threads, smem, st>>>(
      qf, kf, vf, of, lse, heads, lq, lk, d, f32_scale(d) * kLog2e);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_sam_f32(const float* q, const float* k, const float* v, float* o, int bh, int n,
                   int d, const F32RelPosBias& bias, cudaStream_t st) {
  const size_t smem = f32_fwd_smem_bytes<DP>(bias);
  cudaError_t err = f32_set_smem(sam_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  sam_f32_kernel<DP><<<dim3((n + kF32BQ - 1) / kF32BQ, bh), kF32Threads, smem, st>>>(
      q, k, v, o, n, d, f32_scale(d) * kLog2e, bias);
  return (int)cudaGetLastError();
}

// dQ (and delta) first, then dK/dV, which reads delta, on one stream.
template <int DP>
int launch_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                   const float* g, const float* lse, float* delta, float* dq, float* dk,
                   float* dv, int bh, int lq, int lk, int d, cudaStream_t st) {
  constexpr int BQ = f32_bwd_rows(DP);
  const float scale = f32_scale(d);
  cudaError_t err = f32_set_smem(attn_f32_bwd_dq_kernel<DP>, f32_dq_smem_bytes<DP>());
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dq_kernel<DP><<<dim3((lq + BQ - 1) / BQ, bh), kF32Threads,
                               f32_dq_smem_bytes<DP>(), st>>>(q, k, v, o, g, lse, delta, dq,
                                                              lq, lk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = f32_set_smem(attn_f32_bwd_dkdv_kernel<DP>, f32_dkdv_smem_bytes<DP>());
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dkdv_kernel<DP><<<dim3((lk + kF32BK - 1) / kF32BK, bh), kF32Threads,
                                 f32_dkdv_smem_bytes<DP>(), st>>>(q, k, v, g, lse, delta, dk,
                                                                  dv, lq, lk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int lq, int lk, int d, void* stream) {
  using namespace lmdx;
  if (!f32_args_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  return dispatch_head_dim<256>(d, [&](auto dp) {
    return launch_fwd_f32<decltype(dp)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), bh, lq,
        lk, d, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int lmdx_flash_fwd_packed_f32(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int batch, int heads, int lq, int lk, int d,
                                         void* stream) {
  using namespace lmdx;
  if (batch <= 0 || heads <= 0 || (long long)batch * heads > 65535 ||
      !f32_args_ok(batch * heads, lq, lk, d)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_head_dim<256>(d, [&](auto dp) {
    return launch_fwd_packed_f32<decltype(dp)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
        batch * heads, lq, lk, d, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int lmdx_flash_fwd_fusedheads_f32(const void* qf, const void* kf, const void* vf,
                                             void* of, void* lse, int batch, int heads, int lq,
                                             int lk, int d, void* stream) {
  using namespace lmdx;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 ||
      d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_head_dim<256>(d, [&](auto dp) {
    return launch_fwd_fusedheads_f32<decltype(dp)::value>(
        static_cast<const float*>(qf), static_cast<const float*>(kf),
        static_cast<const float*>(vf), static_cast<float*>(of), static_cast<float*>(lse), batch,
        heads, lq, lk, d, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int lmdx_flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int lq, int lk, int d,
                                  void* stream) {
  using namespace lmdx;
  if (!f32_args_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  return dispatch_head_dim<256>(d, [&](auto dp) {
    return launch_bwd_f32<decltype(dp)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(g), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), bh, lq, lk, d, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int lmdx_sam_attention_f32(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int bh,
                                      int n, int d, int gh, int gw, void* stream) {
  using namespace lmdx;
  if (!(bh > 0 && bh <= 65535 && d > 0 && d <= 128 && d % 8 == 0 && gh > 0 && gw > 0 &&
        n == gh * gw)) {
    return (int)cudaErrorInvalidValue;
  }
  const F32RelPosBias bias{static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
                           n, gh, gw};
  return dispatch_head_dim<160>(d, [&](auto dp) {
    return launch_sam_f32<decltype(dp)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), bh, n, d, bias,
        static_cast<cudaStream_t>(stream));
  });
}
