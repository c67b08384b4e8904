// Flash-attention forward on the projection layout (no head split in memory).
//
// Replaces: lmdx/nn/pallas/flash_attention.py::_pallas_attention_fusedheads
// (the TPU kernel, l.622). Computes, for every head h,
//   O[:, :, h*d:(h+1)*d] = softmax(Q_h K_h^T / sqrt(d)) V_h
// and the row log-sum-exp of the scaled scores, reading q, k, v and writing
// o exactly as the to_q/to_k/to_v projections leave them: qf, o:
// (B, Lq, H*d), kf, vf: (B, Lk, H*d), bf16 row-major; lse: (B, H, Lq) f32.
// The (B, H, L, d) copies that a head split makes never exist.
//
// What bounds it on an H100: self and fuser attention (Lk = Lq or Lq + 30,
// Lq 1024/256/64) do 4 Lq Lk d operations per head against ~4 (Lq + Lk) d
// bytes: above the card's ~295 bf16 ops/byte at Lq >= 1024, so tensor-core
// operations; the 77-token cross-attention does ~77 operations per byte of
// q and o and is bound by bytes.
//
// Design. One block per (q tile, head, image) runs attention_fwd.cuh's body
// (registers, mma.sync, a cp.async K/V ring) on pointers offset by head * d
// with a row stride of H * d, so the only change against flash_fwd.cu is the
// addressing. KV is walked in 64-row tiles, so the kernel has no KV-length
// limit of its own (the wrapper's size rule is the reference's dispatch, not
// this kernel's). A head's slice of a row is d * 2 bytes at a byte offset of
// head * d * 2 (80 bytes at d = 40): a multiple of 16 bytes, which is all
// the body's 16-byte cp.async pieces need, but not of 128, so a later TMA
// load will have to fetch whole rows. The backward splits heads and runs
// flash_bwd.cu, as the TPU side does.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

template <int DP, class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
flash_fwd_fusedheads_kernel(const bf16* __restrict__ qf, const bf16* __restrict__ kf,
                            const bf16* __restrict__ vf, bf16* __restrict__ of,
                            float* __restrict__ lse, int heads, int Lq, int Lk, int d,
                            float scale) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int hd = heads * d;
  const int bh = b * heads + head;
  const HeadView hv{qf + (size_t)b * Lq * hd + head * d,
                    kf + (size_t)b * Lk * hd + head * d,
                    vf + (size_t)b * Lk * hd + head * d,
                    of + (size_t)b * Lq * hd + head * d,
                    lse + (size_t)bh * Lq,
                    hd, hd, hd, bh};
  attention_fwd_body<DP, Tile>(hv, blockIdx.x * Tile::kBQ, Lq, Lk, d, scale, NoBias{},
                               -INFINITY, 0.0f);
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd_fusedheads(const void* qf, const void* kf, const void* vf,
                                         void* of, void* lse, int batch, int heads, int lq,
                                         int lk, int d, void* stream) {
  using namespace lmdx;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 ||
      d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_head_dim<256>(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    using Tile = FlashTile<DP>;
    const dim3 grid((lq + Tile::kBQ - 1) / Tile::kBQ, heads, batch);
    return launch_attention_fwd<DP, Tile>(
        flash_fwd_fusedheads_kernel<DP, Tile>, grid, 0, stream,
        static_cast<const bf16*>(qf), static_cast<const bf16*>(kf),
        static_cast<const bf16*>(vf), static_cast<bf16*>(of), static_cast<float*>(lse),
        heads, lq, lk, d, 1.0f / sqrtf((float)d));
  });
}
