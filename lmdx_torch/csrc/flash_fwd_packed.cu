// Head-packed flash-attention forward for small head dims.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention_packed (the
// TPU kernel, l.211). Computes the same (O, LSE) as flash_fwd.cu,
// O = softmax(Q K^T / sqrt(d)) V and the row log-sum-exp of the scaled
// scores, with the reference's start values: row max from -1e30 and the
// denominator clamped at 1e-30. q: (B, H, Lq, d), k/v: (B, H, Lk, d),
// o: (B, H, Lq, d), all bf16 row-major; lse: (B, H, Lq) f32.
//
// What bounds it on an H100: the same 4 Lq Lk d operations per head against
// ~2 (Lq + 2 Lk) d bytes as flash_fwd.cu: tensor-core operations, and the
// (Lq, Lk) probabilities must never reach device memory.
//
// Design. The TPU kernel packed up to 3 heads (128 / d) into one grid step to
// fill its 128-wide matrix unit: it laid K/V out block-diagonally so that one
// contraction served the group. On Hopper that buys nothing. A tensor-core
// tile is 16 deep, so head dim 40 (padded to 48) wastes little without the
// block-diagonal copy, and grouping heads inside a block only runs them one
// after another: at batch 2 the 3-head groups left 192 long blocks on 132
// SMs, and measured slower than one head a block on the H100 (PERF.md). So
// the launch is flash_fwd.cu's: one block per (q tile, batch*head), the same
// tile (FlashTile) and attention_fwd.cuh's body (registers, mma.sync, a
// cp.async K/V ring). For finite inputs the start values never bite (every
// row's max score gives a term of 1), so O and LSE equal flash_fwd.cu's bit
// for bit; the kernel keeps its own name and launch count, as the opt-in
// path's counterpart of the reference's packed kernel.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

template <int DP, class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
flash_fwd_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int Lq, int Lk, int d, float scale) {
  attention_fwd_body<DP, Tile>(head_of_bhld(q, k, v, o, lse, blockIdx.y, Lq, Lk, d),
                               blockIdx.x * Tile::kBQ, Lq, Lk, d, scale, NoBias{}, -1e30f,
                               1e-30f);
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int batch, int heads, int lq, int lk, int d,
                                     void* stream) {
  using namespace lmdx;
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256 ||
      (long long)batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    using Tile = FlashTile<DP>;
    const dim3 grid((lq + Tile::kBQ - 1) / Tile::kBQ, batch * heads);
    return launch_attention_fwd<DP, Tile>(
        flash_fwd_packed_kernel<DP, Tile>, grid, 0, stream, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), lq, lk, d, 1.0f / sqrtf((float)d));
  });
}
