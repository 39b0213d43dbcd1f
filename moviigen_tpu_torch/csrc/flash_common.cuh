// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): async copies, ldmatrix and the bf16 mma.sync tile.
// int8_gemm.cu takes the async copies and ldmatrix_x4 from here.
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

}  // namespace flash
