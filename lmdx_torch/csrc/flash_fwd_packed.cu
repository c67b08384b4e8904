// Head-packed flash-attention forward for small head dims.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention_packed (the
// TPU kernel, l.211). Computes the same (O, LSE) as flash_fwd.cu,
// O = softmax(Q K^T / sqrt(d)) V and the row log-sum-exp of the scaled
// scores, with the heads taken in groups of `pack` (the wrapper passes
// min(3, 128 / d); 1 for d > 64). q: (B, H, Lq, d), k/v: (B, H, Lk, d),
// o: (B, H, Lq, d), all bf16 row-major; lse: (B, H, Lq) f32.
//
// What bounds it on an H100: the same 4 Lq Lk d operations per head against
// ~2 (Lq + 2 Lk) d bytes as flash_fwd.cu: tensor-core operations, and the
// (Lq, Lk) probabilities must never reach device memory.
//
// Design. The TPU kernel packed heads to fill a 128-wide matrix unit: it
// laid K/V out block-diagonally in device memory so that one contraction
// served `pack` heads. A Hopper tensor-core tile is 16 deep, so head dim 40
// (padded to 48) wastes little and the block-diagonal copy would only add
// traffic; it is not carried over. What is kept is the grouping: one block
// serves one q tile of one group of up to `pack` heads, head after head,
// each through attention_fwd.cuh's body (registers, mma.sync, a cp.async K/V
// ring; row max from -1e30, denominator clamped at 1e-30, as the TPU
// kernel). The grid has ceil(H / pack) groups per image; the heads that pad
// the last group (8 heads, pack 3: one) are skipped, so nothing is computed
// or written for them. Fewer, longer blocks than flash_fwd.cu's one per
// head: whether that helps on this card is a measurement (PERF.md), not a
// claim.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

template <int DP, class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
flash_fwd_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int heads, int pack, int groups, int Lq,
                        int Lk, int d, float scale) {
  const int b = blockIdx.y / groups;
  const int group = blockIdx.y % groups;
  const int q0 = blockIdx.x * Tile::kBQ;
  for (int p = 0; p < pack; ++p) {
    const int head = group * pack + p;
    if (head >= heads) break;  // a head that only pads the last group
    if (p > 0) __syncthreads();  // the previous head's warps are done with shared memory
    attention_fwd_body<DP, Tile>(head_of_bhld(q, k, v, o, lse, b * heads + head, Lq, Lk, d),
                                 q0, Lq, Lk, d, scale, NoBias{}, -1e30f, 1e-30f);
  }
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int batch, int heads, int pack, int lq,
                                     int lk, int d, void* stream) {
  using namespace lmdx;
  if (batch <= 0 || heads <= 0 || pack <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (heads + pack - 1) / pack;
  if ((long long)batch * groups > 65535) return (int)cudaErrorInvalidValue;
  return dispatch_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    using Tile = FlashTile<DP>;
    const dim3 grid((lq + Tile::kBQ - 1) / Tile::kBQ, batch * groups);
    return launch_attention_fwd<DP, Tile>(
        flash_fwd_packed_kernel<DP, Tile>, grid, 0, stream, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), heads, pack, groups, lq, lk, d, 1.0f / sqrtf((float)d));
  });
}
