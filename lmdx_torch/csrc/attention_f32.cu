// Entry points of the float32 attention: the float32 forms of kernels 1 to
// 5, all on the tensor cores in 3xTF32 (attention_f32_tc.cuh says what bounds
// them, how 3xTF32 keeps float32 accuracy, and how the bodies are built).
//
// - lmdx_flash_fwd_f32 replaces lmdx/nn/pallas/flash_attention.py::
//   _pallas_attention (l.107) at float32: o = softmax(q k^T / sqrt(d)) v and
//   the row LSE, q (BH, Lq, d), k/v (BH, Lk, d), o (BH, Lq, d), lse (BH, Lq),
//   all float32 row-major. Kernel attn_f32_fwd_kernel<DP, WQ, WK> (kernel
//   1-f32) from the start values (-inf, 0).
// - lmdx_flash_fwd_packed_f32 replaces flash_attention.py::
//   _pallas_attention_packed (l.211) at float32: lmdx_flash_fwd_f32's
//   function from the reference's start values (row max from -1e30, the
//   denominator clamped at 1e-30), q (B, H, Lq, d), k/v (B, H, Lk, d), lse
//   (B, H, Lq). Kernel 3-f32 is kernel 1-f32's launch from those values, on
//   the same tile (one rule, tc_fwd_kv_groups over B * H heads): the TPU
//   kernel's block-diagonal K/V of up to 3 heads filled its 128-wide matrix
//   unit, which buys nothing here (flash_fwd_packed.cu says why). On finite
//   inputs the start values never bite, so O and LSE equal
//   lmdx_flash_fwd_f32's bit for bit.
// - lmdx_flash_fwd_fusedheads_f32 replaces flash_attention.py::
//   _pallas_attention_fusedheads (l.622) at float32: the same function per
//   head on the projection layout, qf/of (B, Lq, H*d), kf/vf (B, Lk, H*d),
//   read and written in place (row stride H*d, offset head*d), lse
//   (B, H, Lq). Kernel 4-f32: attn_f32_fwd_kernel on that view. Its gradient
//   splits heads and runs lmdx_flash_bwd_f32, as the TPU side's
//   _fusedheads_bwd does.
// - lmdx_sam_attention_f32 replaces lmdx/nn/pallas/sam_attention.py::
//   _pallas_sam_attention (l.101) at float32: o = softmax(q k^T / sqrt(d) +
//   bias_h[q, k / gw] + bias_w[q, k % gw]) v over N = gh * gw tokens, the
//   bias added unscaled, no LSE. Kernel sam_f32_kernel<DP, WQ, WK> (kernel
//   5-f32): the forward body with the RelPosBias policy, the q tile's bias
//   rows staged in shared memory after the ring.
// - lmdx_flash_bwd_f32 replaces flash_attention.py::_pallas_attention_bwd
//   (l.384) at float32: dq, dk, dv from q, k, v, o, dO and the forward's LSE
//   (natural units), with delta (BH, Lq) as scratch. Kernels
//   attn_f32_bwd_dq_kernel<DP, WK> (first: delta and dQ; WK warp groups over
//   the KV tiles where its grid has fewer than 132 blocks, head dims 81 to
//   160) and attn_f32_bwd_dkdv_kernel<DP, KG, CS, QW, QS> (after it on the
//   same stream: dK and dV; the wide shape, or the split one where the wide
//   grid has fewer than 132 blocks).
// Every kernel is bound by operations at 495 / 3 = 165 TFLOP/s (3xTF32).
//
// The forward kernels' blocks on the paths (q tiles of 16 WQ rows; KV tiles
// of 32 keys, WK warp groups over them below 132 blocks) and shared memory a
// block (Q and a two-stage K/V ring; ~160-255 registers a thread hold two
// 128-thread blocks an SM, three at 160 or fewer):
// - 1-f32 and 3-f32, 8 heads: 4096 tokens (d 40, DP 40, WQ 4) 64 x 8 B
//   blocks, 512 to 4096 at batch 1 to 8 (33 KB); 1024 tokens (d 80, WQ 4)
//   16 x 8 B, 128 at batch 1 (no split above 256 rows; 63 KB); 256 tokens
//   (d 160, WQ 2) 8 x 8 B, 192 and 384 at batch 3 and 6 (102.5 KB), 64 and
//   128 at batch 1 and 2 (WK 2: 184.5 KB, 1 an SM).
// - 4-f32: the 256- and 64-token levels (d 160, WQ 2) 8 x 8 B and 2 x 8 B
//   (below 132 blocks WK 2 or 4: 184.5 KB, 1 an SM); the 77-token
//   cross-attention (3 KV tiles) at every level.
// - 5-f32, 12 heads, d 64 (DP 64): the global layers' 64 x 64 grid in q tiles
//   of 64 rows, 64 x 12 = 768 blocks an image (51 KB + 35 KB of bias rows);
//   the 14 x 14 windows in q tiles of 32 rows, 7 x 300 = 2100 blocks an image
//   (42.5 KB + 5.5 KB; the last KV tile of a window holds 4 keys).
// DP 256 (no path): 195 / 162.5 KB; it spills (the 32 x 4 accumulators of O
// and the pairs' loads), recorded by chip_smoke.py's phase 1, not gated.
//
// The tensor-core kernels declare the blocks their shared memory lets an SM
// hold (tc_blocks: two where it fits, else one); that caps none of them below
// 255 registers. Each launch sets its shared memory (above 48 KB) and returns
// cudaGetLastError.
#include "attention_f32_tc.cuh"

namespace lmdx {
namespace {

// Kernels 1-f32, 3-f32 and 4-f32: q tile blockIdx.x of head blockIdx.y of
// batch blockIdx.z. Rows lie ld floats apart: ld == d is a (B * heads, L, d)
// tensor (kernels 1-f32 and 3-f32, launched as one batch of B * H heads), a
// head L * d floats after the last; otherwise the projection layout
// (B, L, heads * d) (kernel 4-f32), a head d floats after the last.
template <int DP, int WQ, int WK>
__global__ void __launch_bounds__(32 * WQ * WK, tc_blocks(tc_fwd_smem_bytes<DP, WQ, WK>()))
attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    int heads, int Lq, int Lk, int d, int ld, float scale_log2, float m_init,
                    float l_min) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + head;
  const size_t hq = ld == d ? (size_t)Lq * d : d, hk = ld == d ? (size_t)Lk * d : d;
  const size_t bq = (size_t)b * Lq * ld + head * hq, bk = (size_t)b * Lk * ld + head * hk;
  const F32HeadView hv{q + bq, k + bk, v + bk, o + bq, lse + (size_t)bh * Lq, ld, ld, ld, ld, bh};
  attention_f32_tc_fwd_body<DP, WQ, WK>(hv, blockIdx.x * 16 * WQ, Lq, Lk, d, scale_log2, NoBias{},
                                        m_init, l_min);
}

// Kernel 5-f32: q tile blockIdx.x of batch*head blockIdx.y, (BH, N, d).
template <int DP, int WQ, int WK>
__global__ void __launch_bounds__(32 * WQ * WK, tc_blocks(tc_fwd_smem_bytes<DP, WQ, WK>()))
sam_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int N, int d,
               float scale_log2, RelPosBias bias) {
  attention_f32_tc_fwd_body<DP, WQ, WK>(f32_head_of_bhld(q, k, v, o, nullptr, blockIdx.y, N, N, d),
                                        blockIdx.x * 16 * WQ, N, N, d, scale_log2, bias,
                                        -INFINITY, 0.0f);
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

// Calls f(integral_constant WQ, integral_constant WK) with the forward's tile
// for batch * heads heads: WQ 2 at lq <= 256, else 4; WK tc_fwd_kv_groups'.
template <int DP, class F>
int with_tc_fwd_tile(int batch, int heads, int lq, int lk, int d, F&& f) {
  using W1 = std::integral_constant<int, 1>;
  using W2 = std::integral_constant<int, 2>;
  using W4 = std::integral_constant<int, 4>;
  const int wk = tc_fwd_kv_groups(batch, heads, lq, lk, d);
  if constexpr (DP > 80 && DP <= 160) {
    if (wk == 4) return f(W2{}, W4{});
  }
  if constexpr (DP <= 160) {
    if (wk == 2) return f(W2{}, W2{});
  }
  if (lq <= 256) return f(W2{}, W1{});
  return f(W4{}, W1{});
}

template <int DP, int WQ, int WK>
int launch_fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                   int batch, int heads, int lq, int lk, int d, int ld, float m_init,
                   float l_min, cudaStream_t st) {
  constexpr size_t smem = tc_fwd_smem_bytes<DP, WQ, WK>();
  const cudaError_t err = f32_set_smem(attn_f32_fwd_kernel<DP, WQ, WK>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_fwd_kernel<DP, WQ, WK>
      <<<dim3((lq + 16 * WQ - 1) / (16 * WQ), heads, batch), 32 * WQ * WK, smem, st>>>(
          q, k, v, o, lse, heads, lq, lk, d, ld, f32_scale(d) * kLog2e, m_init, l_min);
  return (int)cudaGetLastError();
}

// Kernels 1-f32, 3-f32 and 4-f32 (rows ld floats apart; attn_f32_fwd_kernel
// says how a head is found).
int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
            int heads, int lq, int lk, int d, int ld, float m_init, float l_min, void* stream) {
  return dispatch_tc_fwd_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return with_tc_fwd_tile<DP>(batch, heads, lq, lk, d, [&](auto wq, auto wk) {
      return launch_fwd_f32<DP, decltype(wq)::value, decltype(wk)::value>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), batch,
          heads, lq, lk, d, ld, m_init, l_min, static_cast<cudaStream_t>(stream));
    });
  });
}

template <int DP, int WQ, int WK>
int launch_sam_f32(const float* q, const float* k, const float* v, float* o, int bh, int n,
                   int d, const RelPosBias& bias, cudaStream_t st) {
  const size_t smem = tc_fwd_smem_bytes<DP, WQ, WK>() + sizeof(float) * bias.smem_floats(16 * WQ);
  const cudaError_t err = f32_set_smem(sam_f32_kernel<DP, WQ, WK>, smem);
  if (err != cudaSuccess) return (int)err;
  sam_f32_kernel<DP, WQ, WK><<<dim3((n + 16 * WQ - 1) / (16 * WQ), bh), 32 * WQ * WK, smem, st>>>(
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
  return fwd_f32(q, k, v, o, lse, 1, bh, lq, lk, d, d, -INFINITY, 0.0f, stream);
}

extern "C" int lmdx_flash_fwd_packed_f32(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int batch, int heads, int lq, int lk, int d,
                                         void* stream) {
  using namespace lmdx;
  if (batch <= 0 || heads <= 0 || (long long)batch * heads > 65535 ||
      !f32_args_ok(batch * heads, lq, lk, d)) {
    return (int)cudaErrorInvalidValue;
  }
  return fwd_f32(q, k, v, o, lse, 1, batch * heads, lq, lk, d, d, -1e30f, 1e-30f, stream);
}

extern "C" int lmdx_flash_fwd_fusedheads_f32(const void* qf, const void* kf, const void* vf,
                                             void* of, void* lse, int batch, int heads, int lq,
                                             int lk, int d, void* stream) {
  using namespace lmdx;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 ||
      d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  return fwd_f32(qf, kf, vf, of, lse, batch, heads, lq, lk, d, heads * d, -INFINITY, 0.0f,
                 stream);
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
  const RelPosBias bias{static_cast<const float*>(bias_h), static_cast<const float*>(bias_w), n,
                        gh, gw};
  return dispatch_tc_fwd_head_dim<160>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return with_tc_fwd_tile<DP>(1, bh, n, n, d, [&](auto wq, auto wk) {
      return launch_sam_f32<DP, decltype(wq)::value, decltype(wk)::value>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), bh, n, d, bias,
          static_cast<cudaStream_t>(stream));
    });
  });
}
