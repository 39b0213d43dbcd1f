// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): async copies, ldmatrix and the bf16 mma.sync tile (the
// forward), and the Hopper set the backward is built from: 128-byte
// swizzled shared tiles, wgmma matrix descriptors and instructions,
// mbarriers and TMA tile loads. int8_gemm.cu takes the async copies and
// ldmatrix_x4 from here.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): in a C fragment a
// thread with lane = 4 * g + t holds rows g and g + 8, columns 2t and
// 2t + 1 of a 16 x 8 tile; the C fragments of two neighbouring 8-column
// tiles, packed to bf16, are the A fragment of one 16-deep k-step.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 128;       // head dim
constexpr int kLds = kD + 8;  // shared row stride in elements (272 B): conflict-free ldmatrix
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid = false fills the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + rows) of one (batch, head) slice of a
// [B, L, N, D] bf16 tensor into a shared tile of `rows` x kLds; rows at or
// past `limit` are zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int limit, int tid) {
  for (int c = tid; c < kRows * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < limit;
    cp_async_16(dst + r * kLds + col, ok ? src + row * row_stride + col : src,
                ok);
  }
}

// A fragment (16 rows x 16 of the reduction dim, at column k0) of a
// row-major shared tile, rows r0 .. r0 + 15.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile,
                                       int r0, int k0, int lane) {
  const int lj = lane / 8, lr = lane % 8;
  ldmatrix_x4(a[0], a[1], a[2], a[3],
              tile + (r0 + lr + (lj & 1) * 8) * kLds + k0 + (lj >> 1) * 8);
}

// B fragments of two 8-column n-tiles (n rows r0 .. r0 + 15 of the tile,
// reduction columns k0 .. k0 + 15): the tile holds B transposed, one row
// per output column ("col" operand, as K in q.K^T).
__device__ __forceinline__ void load_b_rows(uint32_t* b,
                                            const __nv_bfloat16* tile, int r0,
                                            int k0, int lane) {
  const int lj = lane / 8, lr = lane % 8;
  ldmatrix_x4(b[0], b[1], b[2], b[3],
              tile + (r0 + lr + (lj >> 1) * 8) * kLds + k0 + (lj & 1) * 8);
}

// B fragments of two 8-column n-tiles (columns n0 .. n0 + 15) for a k-step
// over tile rows k0 .. k0 + 15: the tile holds B as it is, one row per
// reduction index (as V in P.V).
__device__ __forceinline__ void load_b_cols(uint32_t* b,
                                            const __nv_bfloat16* tile, int k0,
                                            int n0, int lane) {
  const int lj = lane / 8, lr = lane % 8;
  ldmatrix_x4_trans(b[0], b[1], b[2], b[3],
                    tile + (k0 + lr + (lj & 1) * 8) * kLds + n0 + (lj >> 1) * 8);
}

// Write a warp's 16 x 128 fp32 accumulator, times `scale`, as bf16 rows
// row0 + g and row0 + g + 8 (those below `limit`) of a [L, D] slice.
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* out,
                                                long long row_stride,
                                                const float (*acc)[4],
                                                int row0, int limit,
                                                float scale, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (r0 < limit) {
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * row_stride + col) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (r1 < limit) {
      *reinterpret_cast<__nv_bfloat162*>(out + r1 * row_stride + col) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

// ------------------------------------------------------------------------
// Hopper: swizzled tiles, wgmma, mbarriers, TMA.
//
// A shared tile holds 64 rows of 128 bf16 as two halves of 64 columns. A
// half is 64 rows of 128 bytes in the 128-byte swizzle (layout type B128
// of a wgmma matrix descriptor, CU_TENSOR_MAP_SWIZZLE_128B of a tensor
// map): the 16-byte chunk c (0..7) of row r sits at r * 128 +
// ((c ^ (r % 8)) * 16). The swizzle works on address bits, so a tile
// starts at a multiple of 1,024 bytes.
//
// One tile serves a wgmma operand both ways:
// - K-major (the tile's 128 columns are the reduction index, its rows the
//   M index of A or the N index of B, as K in q'.K^T): a k-step of 16
//   columns is 32 bytes further along the swizzled row, and the second
//   half after four k-steps;
// - MN-major (the tile's rows are the reduction index, its 128 columns
//   the N index of B, as dO in P^T.dO): a k-step of 16 rows is 2,048
//   bytes further, the two halves are the leading-dimension stride apart,
//   and the instruction takes the transposed-B flag.
// In a wgmma accumulator, as in mma.sync's, warp w of the warpgroup holds
// rows 16w .. 16w + 15 and a thread with lane = 4g + t holds, for each
// 8-column chunk j, d[j][0..1] = row g, columns 8j + 2t, + 1 and
// d[j][2..3] = row g + 8; two neighbouring chunks packed to bf16 are the
// register A fragment of one k-step.

constexpr int kTileRows = 64;
constexpr int kHalfBytes = kTileRows * 128;  // one 64 x 64 bf16 half
constexpr int kTileBytes = 2 * kHalfBytes;   // one 64 x 128 bf16 tile

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr,
                                               uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) |
         (1ull << 62);  // B128
}

// K-major operand: k-step ks (0..7) of a tile at shared address `tile`.
// Groups of 8 rows are 1,024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int ks) {
  return wgmma_desc(tile + (ks >> 2) * kHalfBytes + (ks & 3) * 32, 16, 1024);
}

// MN-major B operand of 128 columns: k-step ks (0..3), 16 rows each.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int ks) {
  return wgmma_desc(tile + ks * 2048, kHalfBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma_wait that makes it valid.
template <int kChunks>
__device__ __forceinline__ void fence_acc(float (&d)[kChunks][4]) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

#define FLASH_ACC4(d, j) \
  "+f"((d)[j][0]), "+f"((d)[j][1]), "+f"((d)[j][2]), "+f"((d)[j][3])

// d (64 x 64, fp32) = a (64 x 16, shared) * b (16 x 64, shared, K-major),
// plus d when `accumulate`.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_ACC4(d, 0), FLASH_ACC4(d, 1), FLASH_ACC4(d, 2), FLASH_ACC4(d, 3),
        FLASH_ACC4(d, 4), FLASH_ACC4(d, 5), FLASH_ACC4(d, 6), FLASH_ACC4(d, 7)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16, this warp's register fragment) *
// b (16 x 128, shared, MN-major: the transposed-B flag is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_ACC4(d, 0), FLASH_ACC4(d, 1), FLASH_ACC4(d, 2), FLASH_ACC4(d, 3),
        FLASH_ACC4(d, 4), FLASH_ACC4(d, 5), FLASH_ACC4(d, 6), FLASH_ACC4(d, 7),
        FLASH_ACC4(d, 8), FLASH_ACC4(d, 9), FLASH_ACC4(d, 10),
        FLASH_ACC4(d, 11), FLASH_ACC4(d, 12), FLASH_ACC4(d, 13),
        FLASH_ACC4(d, 14), FLASH_ACC4(d, 15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_ACC4

// ---- mbarriers (shared addresses as smem_u32 gives them)

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one 64-row x 64-column half of a tile from a rank-4 tensor map over
// (D, N, L, B), at column c_d, head c_n, row c_l, batch c_b, into shared
// `dst`; completion is counted in bytes on `bar`. Rows past L arrive as
// zeros. `map` is the address of a __grid_constant__ CUtensorMap.
__device__ __forceinline__ void tma_load_half(uint32_t dst, const void* map,
                                              uint32_t bar, int c_d, int c_n,
                                              int c_l, int c_b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_d), "r"(c_n),
      "r"(c_l), "r"(c_b)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

}  // namespace flash
