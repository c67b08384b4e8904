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
// the KV does not fit in a block's shared memory, so each block (one per
// 64-row q tile and batch*head) walks the KV in 64-row tiles with an online
// softmax. The body is attention_fwd.cuh's, with no bias (it is shared with
// sam_attention.cu); the unaligned KV of the GLIGEN fuser (Lk = Lq + 30) is
// masked to -inf in the last tile, and head dims 40/80/160 are zero-padded
// to a multiple of 16 on load. The products use WMMA bf16 tiles with f32
// accumulation. Not yet done (later work): wgmma, TMA loads, a software
// pipeline, accumulators in registers.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int d, int dp, float scale,
                 NoBias bias) {
  attention_fwd_bhld(q, k, v, o, lse, Lq, Lk, d, dp, scale, bias);
}

}  // namespace
}  // namespace lmdx

extern "C" int lmdx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int bh, int lq, int lk, int d,
                              void* stream) {
  using namespace lmdx;
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_attention_fwd(flash_fwd_kernel, q, k, v, o, lse, bh, lq, lk, d, NoBias{},
                              stream);
}
