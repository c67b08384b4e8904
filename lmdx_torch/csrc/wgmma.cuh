// Hopper's warpgroup matrix multiply (wgmma, sm_90a) for the port's kernels:
// the shared-memory layout they use and its descriptors, the fence / commit
// / wait of an asynchronous group, and m64nNk16 bf16 products with an f32
// accumulator for the widths the kernels use, A from registers and B from
// shared memory.
//
// Layout (the 32-byte swizzle). A tile of R rows x C columns (R a multiple
// of 8, C of 16) is kept as C / 16 column blocks of R rows x 32 bytes, one
// after another; in a block, row r lies at 32 r, and its two 16-byte halves
// swap places where bit 2 of r is set (`sw32_off`), so that any 8
// consecutive rows of one half, and any 4 rows of both, fall in distinct
// banks. One tile serves a product both ways:
// - K-major (its columns are the contraction): SBO 256 bytes (8 rows), a
//   16-deep step is the next column block (R * 32 bytes);
// - MN-major (its rows are the contraction, transposed in the instruction):
//   LBO R * 32 (the next 16 columns), SBO 256 (the next 8 rows), a 16-deep
//   step 512 bytes.
// Accumulator element i of a thread (lane = 4 g + t, warp w of the
// warpgroup) is row 16 w + g + 8 (i % 4 / 2), column 8 (i / 4) + 2 t + i % 2;
// a register A operand of 16 columns holds pairs (g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8), as mma.sync's (and as ldmatrix.x4 gives them
// from the four 8 x 8 quarters in that order).
#pragma once

#include <stdint.h>

namespace lmdx {
namespace {

// Byte offset of element (r, c) in an R-row tile kept in the 32-byte swizzle.
template <int R>
__host__ __device__ constexpr uint32_t sw32_off(int r, int c) {
  return (c >> 4) * (R * 32) + r * 32 + ((((c >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (c & 7) * 2;
}

// Descriptor of a tile at shared address `addr` (a multiple of 256): start,
// LBO and SBO in 16-byte units, layout type 3 (32-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return gmma_desc(addr, 16, 256); }

template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return gmma_desc(addr, R * 32, 256);
}

// A 16-deep step of a descriptor, in its 16-byte units.
template <int R>
__host__ __device__ constexpr uint64_t k_kstep() { return (R * 32) >> 4; }
constexpr uint64_t kMnKStep = 512 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Writes by the generic proxy (st.shared, cp.async) made visible to the
// async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, f32) = or += a (64 x 16, four bf16 pairs a thread) * b (16 x N,
// shared memory; TB 1 for an MN-major B). acc 0: d = a * b.
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<80> {
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

}  // namespace
}  // namespace lmdx
