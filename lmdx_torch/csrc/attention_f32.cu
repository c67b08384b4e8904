// Entry points of the float32 attention: the float32 forms of kernels 1 to
// 5. Kernels 1-f32, 3-f32 and 5-f32 run on the FMA body (attention_f32.cuh),
// kernels 2-f32 and 4-f32 on the tensor cores in 3xTF32
// (attention_f32_tc.cuh). Each header says what bounds its kernels and how
// they are built.
//
// - lmdx_flash_fwd_f32 replaces lmdx/nn/pallas/flash_attention.py::
//   _pallas_attention (l.107) at float32: o = softmax(q k^T / sqrt(d)) v and
//   the row LSE, q (BH, Lq, d), k/v (BH, Lk, d), o (BH, Lq, d), lse (BH, Lq),
//   all float32 row-major. Kernel attn_f32_fwd_kernel (FMA), bound by
//   operations at the float32 FMA rate (67 TFLOP/s on an H100 SXM).
// - lmdx_flash_bwd_f32 replaces flash_attention.py::_pallas_attention_bwd
//   (l.384) at float32: dq, dk, dv from q, k, v, o, dO and the forward's LSE
//   (natural units), with delta (BH, Lq) as scratch. Kernels
//   attn_f32_bwd_dq_kernel<DP, WK> (first: delta and dQ; WK warp groups over
//   the KV tiles where its grid has fewer than 132 blocks, head dims 81 to
//   160) and
//   attn_f32_bwd_dkdv_kernel<DP, KG, CS, QW, QS> (after it on the same
//   stream: dK and dV; the wide shape, or the split one where the wide grid
//   has fewer than 132 blocks), 3xTF32 tensor cores, each output element
//   with one owner, no atomics; bound by operations at 495 / 3 = 165 TFLOP/s.
// - lmdx_flash_fwd_packed_f32 replaces flash_attention.py::
//   _pallas_attention_packed (l.211) at float32: lmdx_flash_fwd_f32's
//   function from the reference's start values (row max from -1e30, the
//   denominator clamped at 1e-30), q (B, H, Lq, d), k/v (B, H, Lk, d), lse
//   (B, H, Lq). Kernel attn_f32_fwd_packed_kernel (FMA), launched as kernel
//   1-f32 is, one block per (q tile, batch*head): the TPU kernel's
//   block-diagonal K/V of up to 3 heads filled its 128-wide matrix unit,
//   which buys nothing here (flash_fwd_packed.cu says why). On finite inputs
//   the start values never bite, so O and LSE equal lmdx_flash_fwd_f32's bit
//   for bit.
// - lmdx_flash_fwd_fusedheads_f32 replaces flash_attention.py::
//   _pallas_attention_fusedheads (l.622) at float32: the same function per
//   head on the projection layout, qf/of (B, Lq, H*d), kf/vf (B, Lk, H*d),
//   read and written in place (row stride H*d, offset head*d), lse
//   (B, H, Lq). Kernel attn_f32_fwd_fusedheads_kernel<DP, WQ, WK>, 3xTF32
//   tensor cores, grid (q tiles of 16 WQ rows, heads, batch), WQ 2 at
//   Lq <= 256 and 4 above, WK warp groups over the KV tiles where the grid
//   has fewer than 132 blocks; bound by operations at 165 TFLOP/s. Its gradient
//   splits heads and runs lmdx_flash_bwd_f32, as the TPU side's
//   _fusedheads_bwd does.
// - lmdx_sam_attention_f32 replaces lmdx/nn/pallas/sam_attention.py::
//   _pallas_sam_attention (l.101) at float32: o = softmax(q k^T / sqrt(d) +
//   bias_h[q, k / gw] + bias_w[q, k % gw]) v over N = gh * gw tokens, the
//   bias added unscaled, no LSE. Kernel sam_f32_kernel (FMA).
//
// The FMA kernels declare a minimum of one block an SM: without it ptxas held
// the forward and SAM kernels at head dim 64 to 64 registers and spilled
// (48-60 bytes); with it none spills (ptxas -v on the card; shared memory,
// not registers, sets how many blocks an SM holds). The tensor-core kernels
// declare the blocks their shared memory lets an SM hold (tc_blocks: two
// where it fits, else one); that caps none of them below 255 registers.
// Head dims are padded to 48, 64, 80, 160 (256 for the flash kernels) by
// zero-filled columns. Each launch sets its shared memory (above 48 KB) and
// returns cudaGetLastError.
#include "attention_f32_tc.cuh"

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

template <int DP, int WQ, int WK>
__global__ void __launch_bounds__(32 * WQ * WK, tc_blocks(tc_fwd_smem_bytes<DP, WQ, WK>()))
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
  attention_f32_tc_fwd_body<DP, WQ, WK>(hv, blockIdx.x * 16 * WQ, Lq, Lk, d, scale_log2);
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
sam_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int N, int d,
               float scale_log2, F32RelPosBias bias) {
  attention_f32_fwd_body<DP>(f32_head_of_bhld(q, k, v, o, nullptr, blockIdx.y, N, N, d),
                             blockIdx.x * kF32BQ, N, N, d, scale_log2, bias, -INFINITY, 0.0f);
}

template <int DP, int WK>
__global__ void __launch_bounds__(32 * tc_dq_warps(DP) * WK, tc_blocks(tc_dq_smem_bytes<DP, WK>()))
attn_f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ o,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq, int Lq, int Lk,
                       int d, float scale) {
  attention_f32_tc_bwd_dq_body<DP, WK>(q, k, v, o, g, lse, delta, dq, Lq, Lk, d, scale);
}

template <int DP, int KG, int CS, int QW, int QS>
__global__ void __launch_bounds__(TcDkdv<DP, KG, CS, QW, QS>::kThreads,
                                  tc_blocks(TcDkdv<DP, KG, CS, QW, QS>::kSmemBytes))
attn_f32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                         int d, float scale) {
  attention_f32_tc_bwd_dkdv_body<DP, KG, CS, QW, QS>(q, k, v, g, lse, delta, dk, dv, Lq, Lk, d,
                                                      scale);
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

template <int DP, int WQ, int WK>
int launch_fwd_fusedheads_f32(const float* qf, const float* kf, const float* vf, float* of,
                              float* lse, int batch, int heads, int lq, int lk, int d,
                              cudaStream_t st) {
  constexpr size_t smem = tc_fwd_smem_bytes<DP, WQ, WK>();
  cudaError_t err = f32_set_smem(attn_f32_fwd_fusedheads_kernel<DP, WQ, WK>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_fwd_fusedheads_kernel<DP, WQ, WK>
      <<<dim3((lq + 16 * WQ - 1) / (16 * WQ), heads, batch), 32 * WQ * WK, smem, st>>>(
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

template <int DP, class C>
int launch_dkdv_f32(const float* q, const float* k, const float* v, const float* g,
                    const float* lse, const float* delta, float* dk, float* dv, int bh, int lq,
                    int lk, int d, float scale, cudaStream_t st) {
  auto kernel = attn_f32_bwd_dkdv_kernel<DP, C::kKG, C::kCS, C::kQW, C::kQS>;
  const cudaError_t err = f32_set_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((lk + C::kRows - 1) / C::kRows, bh), C::kThreads, C::kSmemBytes, st>>>(
      q, k, v, g, lse, delta, dk, dv, lq, lk, d, scale);
  return (int)cudaGetLastError();
}

template <int DP, int WK>
int launch_dq_f32(const float* q, const float* k, const float* v, const float* o, const float* g,
                  const float* lse, float* delta, float* dq, int bh, int lq, int lk, int d,
                  float scale, cudaStream_t st) {
  constexpr int BQ = 16 * tc_dq_warps(DP);
  constexpr size_t smem = tc_dq_smem_bytes<DP, WK>();
  const cudaError_t err = f32_set_smem(attn_f32_bwd_dq_kernel<DP, WK>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dq_kernel<DP, WK><<<dim3((lq + BQ - 1) / BQ, bh), 32 * tc_dq_warps(DP) * WK, smem,
                                   st>>>(q, k, v, o, g, lse, delta, dq, lq, lk, d, scale);
  return (int)cudaGetLastError();
}

// dQ (and delta) first, then dK/dV, which reads delta, on one stream; dK/dV
// takes the split shape where the wide grid would hold fewer than
// kTcSplitBelow blocks.
template <int DP>
int launch_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                   const float* g, const float* lse, float* delta, float* dq, float* dk,
                   float* dv, int bh, int lq, int lk, int d, cudaStream_t st) {
  const float scale = f32_scale(d);
  auto dq_launch = launch_dq_f32<DP, 1>;
  if constexpr (DP > 80 && DP <= 160) {
    const int wk = tc_dq_kv_groups(bh, lq, lk, d);
    if (wk == 2) dq_launch = launch_dq_f32<DP, 2>;
    if (wk == 4) dq_launch = launch_dq_f32<DP, 4>;
  }
  const int err = dq_launch(q, k, v, o, g, lse, delta, dq, bh, lq, lk, d, scale, st);
  if (err != 0) return err;
  using Wide = TcDkdvWide<DP>;
  const long long wide_blocks = (long long)((lk + Wide::kRows - 1) / Wide::kRows) * bh;
  if (wide_blocks >= kTcSplitBelow) {
    return launch_dkdv_f32<DP, Wide>(q, k, v, g, lse, delta, dk, dv, bh, lq, lk, d, scale, st);
  }
  return launch_dkdv_f32<DP, TcDkdvSplit<DP>>(q, k, v, g, lse, delta, dk, dv, bh, lq, lk, d,
                                              scale, st);
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
  // 32-row q tiles at Lq <= 256 (the 256- and 64-token levels), 64 above;
  // below kTcSplitBelow blocks (up to head dim 160) the KV tiles split over
  // warp groups: 4 where that takes all of them in one super-step, else 2.
  const int wk = tc_fwd_kv_groups(batch, heads, lq, lk, d);
  return dispatch_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    auto launch = launch_fwd_fusedheads_f32<DP, 4, 1>;
    if (lq <= 256) launch = launch_fwd_fusedheads_f32<DP, 2, 1>;
    if constexpr (DP <= 160) {
      if (wk == 2) launch = launch_fwd_fusedheads_f32<DP, 2, 2>;
    }
    if constexpr (DP > 80 && DP <= 160) {
      if (wk == 4) launch = launch_fwd_fusedheads_f32<DP, 2, 4>;
    }
    return launch(static_cast<const float*>(qf), static_cast<const float*>(kf),
                  static_cast<const float*>(vf), static_cast<float*>(of),
                  static_cast<float*>(lse), batch, heads, lq, lk, d,
                  static_cast<cudaStream_t>(stream));
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
