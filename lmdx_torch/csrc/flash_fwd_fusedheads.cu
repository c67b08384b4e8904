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
// Design. One block per (64-row q tile, head, image) runs attention_fwd.cuh's
// body on pointers offset by head * d with a row stride of H * d, so the only
// change against flash_fwd.cu is the addressing. KV is walked in 64-row
// tiles, so the kernel has no KV-length limit of its own (the wrapper's size
// rule is the reference's dispatch, not this kernel's). A head's slice of a
// row is d * 2 bytes at a byte offset of head * d * 2 (80 bytes at d = 40):
// a multiple of 16 bytes, not of 128, so a later TMA or swizzled load will
// have to fetch whole rows. The backward splits heads and runs flash_bwd.cu,
// as the TPU side does.
#include "attention_fwd.cuh"

namespace lmdx {
namespace {

__global__ void __launch_bounds__(kThreads)
flash_fwd_fusedheads_kernel(const bf16* __restrict__ qf, const bf16* __restrict__ kf,
                            const bf16* __restrict__ vf, bf16* __restrict__ of,
                            float* __restrict__ lse, int heads, int Lq, int Lk, int d,
                            int dp, float scale) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int hd = heads * d;
  const int bh = b * heads + head;
  const HeadView hv{qf + (size_t)b * Lq * hd + head * d,
                    kf + (size_t)b * Lk * hd + head * d,
                    vf + (size_t)b * Lk * hd + head * d,
                    of + (size_t)b * Lq * hd + head * d,
                    lse + (size_t)bh * Lq,
                    hd, hd, hd, bh};
  attention_fwd_body(hv, blockIdx.x * kFwdBQ, Lq, Lk, d, dp, scale, NoBias{}, -INFINITY,
                     0.0f);
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
  const int dp = round_up(d, 16);
  size_t smem = 0;
  const int err = prepare_attention_fwd(flash_fwd_fusedheads_kernel, dp, 0, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + kFwdBQ - 1) / kFwdBQ, heads, batch);
  flash_fwd_fusedheads_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qf), static_cast<const bf16*>(kf),
      static_cast<const bf16*>(vf), static_cast<bf16*>(of), static_cast<float*>(lse),
      heads, lq, lk, d, dp, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}
