// Flash-attention forward for the UNet's untapped attention layers.
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention (the TPU
// kernel, l.107). Computes O = softmax(Q K^T / sqrt(d)) V and the row
// log-sum-exp LSE (in units of the scaled scores) that the backward needs.
// q: (BH, Lq, d), k/v: (BH, Lk, d), o: (BH, Lq, d), all bf16 row-major;
// lse: (BH, Lq) f32.
//
// What bounds it on an H100: at the main path's shapes (Lq = Lk = 4096,
// 1024, 256; d = 40, 80, 160) the work is 4 Lq Lk d operations against
// ~2 (Lq + 2 Lk) d bytes of input, an intensity of ~Lq / 2 operations per
// byte, far above the card's ~295 bf16 ops/byte: it is bound by tensor-core
// operations, and the (Lq, Lk) probabilities must never reach device memory.
//
// Design. The TPU kernel held the whole KV in VMEM per q-block; on Hopper
// the KV does not fit in a block's shared memory, so each block (one per q
// tile and batch*head) walks the KV in 64-row tiles with an online softmax.
// The body is attention_fwd.cuh's, with no bias (it is shared with
// sam_attention.cu): scores, probabilities and the output accumulator in
// registers, mma.sync products, K/V through a cp.async ring. The unaligned KV
// of the GLIGEN fuser (Lk = Lq + 30) is masked to -inf in the last tile, and
// head dims 40/80/160 are zero-padded to 48/80/160 on the load. The q tile
// per head dim (FlashTile) is the faster of 64 rows on 4 warps and 128 rows
// on 8 warps as measured on the card (PERF.md has both times). Not done:
// wgmma and TMA (a head's 80-byte row slice is no TMA box).
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

template <int DP, class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int d, float scale) {
  attention_fwd_bhld<DP, Tile>(q, k, v, o, lse, Lq, Lk, d, scale, NoBias{});
}

template <int DP, class Tile>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int lq, int lk, int d, void* stream) {
  const dim3 grid((lq + Tile::kBQ - 1) / Tile::kBQ, bh);
  return launch_attention_fwd<DP, Tile>(
      flash_fwd_kernel<DP, Tile>, grid, 0, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), lq, lk, d, 1.0f / sqrtf((float)d));
}

bool flash_args_ok(int bh, int lq, int lk, int d) {
  return bh > 0 && lq > 0 && lk > 0 && d > 0 && d <= 256 && bh <= 65535;
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int bh, int lq, int lk, int d,
                              void* stream) {
  using namespace lmdx;
  if (!flash_args_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  return dispatch_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return launch_flash_fwd<DP, FlashTile<DP>>(q, k, v, o, lse, bh, lq, lk, d, stream);
  });
}
