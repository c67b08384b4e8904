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
// carried over. Both kinds of layer run attention_fwd.cuh's body (registers,
// mma.sync, a cp.async K/V ring, the online softmax of flash_fwd.cu) with the
// RelPosBias policy and no LSE: a block stages its q tile's bias rows in
// shared memory in f32 (cp.async; 36 KB at the global shape for 64 rows) and
// every thread adds two values by index to each score of its fragment. The
// ragged tail (196 = 3 * 64 + 4) is masked to -inf.
//
// The block: one per 64-row q tile and batch*head, 4 warps, for both kinds
// of layer. At both shapes it measured faster than 128 rows on 8 warps
// (PERF.md has the times). A window
// takes 4 such blocks: each reads its own q and bias rows from device memory
// once, and the window's K and V (50 KB) once from device memory and three
// times from L2, since the four blocks of a window and head are neighbours
// in the grid and run together. The alternative, one 13-warp block holding
// all 196 -> 208 rows of a window and head, measured no faster and spilled:
// 13 warps are allotted registers as 16, 128 a thread, and this kernel wants
// 136. It was dropped. Not done: wgmma and TMA.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

using SamTile = FwdTile<4>;

template <int DP, class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
sam_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N, int d,
                     float scale, RelPosBias bias) {
  attention_fwd_bhld<DP, Tile>(q, k, v, o, nullptr, N, N, d, scale, bias);
}

template <int DP, class Tile>
int launch_sam(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
               const RelPosBias& bias, void* stream) {
  const dim3 grid((n + Tile::kBQ - 1) / Tile::kBQ, bh);
  return launch_attention_fwd<DP, Tile>(
      sam_attention_kernel<DP, Tile>, grid, bias.smem_floats(Tile::kBQ), stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, d, 1.0f / sqrtf((float)d), bias);
}

bool sam_args_ok(int bh, int n, int d, int gh, int gw) {
  return bh > 0 && bh <= 65535 && d > 0 && d <= 128 && d % 8 == 0 && gh > 0 && gw > 0 &&
         n == gh * gw;
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_sam_attention(const void* q, const void* k, const void* v,
                                  const void* bias_h, const void* bias_w, void* o,
                                  int bh, int n, int d, int gh, int gw, void* stream) {
  using namespace lmdx;
  if (!sam_args_ok(bh, n, d, gh, gw)) return (int)cudaErrorInvalidValue;
  const RelPosBias bias{static_cast<const float*>(bias_h),
                        static_cast<const float*>(bias_w), n, gh, gw};
  return dispatch_head_dim<160>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return launch_sam<DP, SamTile>(q, k, v, o, bh, n, d, bias, stream);
  });
}
