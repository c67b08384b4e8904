// SAM ViT attention with the decomposed relative-position bias.
//
// Replaces: lmdx/nn/pallas/sam_attention.py::_pallas_sam_attention (the TPU
// kernel, l.101). Computes
//   O = softmax(Q K^T / sqrt(d) + Bh[q, k / gw] + Bw[q, k % gw]) V
// for every SAM ViT-B encoder layer: the four global layers (N = 64 x 64 =
// 4096 tokens) and the eight windowed ones (N = 14 x 14 = 196). q, k, v, o:
// (BH, N, d) bf16 row-major; bias_h: (BH, N, gh) and bias_w: (BH, N, gw) f32,
// with N = gh * gw and key index k = kh * gw + kw. The bias is added
// unscaled, in f32.
//
// What bounds it on an H100. Global layers: 4 N^2 d = 4.3 GFLOP per head
// against ~2 MB of q/k/v/o and bias per head, ~2000 operations per byte:
// bound by tensor-core operations, and the (N, N) scores must never reach
// device memory (3.2 GB in f32 at a 4-image chunk). Windowed layers: N = 196
// gives ~50 operations per byte, below the card's ~295: bound by the bytes
// of q/k/v/o and the bias.
//
// Design. The TPU kernel added the bias with a one-hot matmul (an MXU
// gather) and rounded it to bf16; that idiom is not the function and is not
// carried over. Each block (one per 64-row q tile and batch*head) stages its
// q tile's bias rows in shared memory (64 x (gh + gw) f32: 32 KB at the
// global shape) and adds two values by index to each f32 score. The KV does
// not fit a block at N = 4096, so the block walks it in 64-row tiles with
// the online softmax of flash_fwd.cu: both run attention_fwd.cuh's body,
// this one with the RelPosBias policy and no LSE. The ragged tail (196 =
// 3 * 64 + 4) is masked to -inf. Products use the WMMA bf16 tiles of
// flash_common.cuh with f32 accumulation; P is rounded to bf16 for the PV
// product. Not yet done (later work): mma.sync / wgmma with accumulators in
// registers, TMA loads and a software pipeline.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

__global__ void __launch_bounds__(kThreads)
sam_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int d, int dp, float scale,
                     RelPosBias bias) {
  attention_fwd_bhld(q, k, v, o, lse, Lq, Lk, d, dp, scale, bias);
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_sam_attention(const void* q, const void* k, const void* v,
                                  const void* bias_h, const void* bias_w, void* o,
                                  int bh, int n, int d, int gh, int gw, void* stream) {
  using namespace lmdx;
  if (bh <= 0 || bh > 65535 || d <= 0 || d > 128 || d % 8 != 0 || gh <= 0 ||
      gw <= 0 || n != gh * gw) {
    return (int)cudaErrorInvalidValue;
  }
  const RelPosBias bias{static_cast<const float*>(bias_h),
                        static_cast<const float*>(bias_w), n, gh, gw};
  return launch_attention_fwd(sam_attention_kernel, q, k, v, o, nullptr, bh, n, n, d, bias,
                              stream);
}
