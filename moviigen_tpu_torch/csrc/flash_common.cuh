// Helpers shared by the hand-written kernels: async copies and ldmatrix
// (the mma.sync designs kept as yardsticks under tools/), and the Hopper
// set that the flash-attention sources (flash_fwd.cu, flash_bwd.cu) and the
// int8 GEMM (int8_gemm.cu) are built from: 128-byte swizzled shared tiles,
// wgmma matrix descriptors and instructions, mbarriers, named barriers, TMA
// tile loads and the host-side tensor-map encoders.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16, and a wgmma
// accumulator, whose warps each hold 16 rows in the same layout): a
// thread with lane = 4 * g + t holds rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column chunk; the chunks of two neighbouring 8-column
// tiles, packed to bf16, are the A fragment of one 16-deep k-step.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 128;  // head dim
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
// A shared tile holds kRows rows (64 in the backward, 128 in the forward)
// of 128 bf16 as two halves of 64 columns. A half is kRows rows of 128
// bytes in the 128-byte swizzle (layout type B128 of a wgmma matrix
// descriptor, CU_TENSOR_MAP_SWIZZLE_128B of a tensor map): the 16-byte
// chunk c (0..7) of row r sits at r * 128 + ((c ^ (r % 8)) * 16). The
// swizzle works on address bits, so a tile starts at a multiple of 1,024
// bytes, and so does any 64-row slice of it that a wgmma reads as A.
//
// One tile serves a wgmma operand both ways:
// - K-major (the tile's 128 columns are the reduction index, its rows the
//   M index of A or the N index of B, as K in q'.K^T): a k-step of 16
//   columns is 32 bytes further along the swizzled row, and the second
//   half after four k-steps;
// - MN-major (the tile's rows are the reduction index, its 128 columns
//   the N index of B, as dO in P^T.dO or V in P.V): a k-step of 16 rows
//   is 2,048 bytes further, the two halves are the leading-dimension
//   stride apart, and the instruction takes the transposed-B flag.
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

// K-major operand: k-step ks (0..7) of a tile of kRows rows at shared
// address `tile` (or of the 64 rows of it that start there). Groups of 8
// rows are 1,024 bytes apart; the leading offset is unused.
template <int kRows = kTileRows>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int ks) {
  return wgmma_desc(tile + (ks >> 2) * (kRows * 128) + (ks & 3) * 32, 16,
                    1024);
}

// MN-major B operand of 128 columns: k-step ks (0 .. kRows / 16 - 1), 16
// rows each.
template <int kRows = kTileRows>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int ks) {
  return wgmma_desc(tile + ks * 2048, kRows * 128, 1024);
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

// d (64 x 128, fp32) = a (64 x 16, shared) * b (16 x 128, shared,
// K-major), plus d when `accumulate`.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_ACC4(d, 0), FLASH_ACC4(d, 1), FLASH_ACC4(d, 2), FLASH_ACC4(d, 3),
        FLASH_ACC4(d, 4), FLASH_ACC4(d, 5), FLASH_ACC4(d, 6), FLASH_ACC4(d, 7),
        FLASH_ACC4(d, 8), FLASH_ACC4(d, 9), FLASH_ACC4(d, 10),
        FLASH_ACC4(d, 11), FLASH_ACC4(d, 12), FLASH_ACC4(d, 13),
        FLASH_ACC4(d, 14), FLASH_ACC4(d, 15)
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

template <int kChunks>
__device__ __forceinline__ void zero_acc(float (&d)[kChunks][4]) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  }
}

// Two neighbouring 8-column accumulator chunks, packed to bf16, as half
// of the register A fragment of k-step nt / 2.
template <int kSteps>
__device__ __forceinline__ void pack_chunk(uint32_t (&frag)[kSteps][4], int nt,
                                           const float (&x)[4]) {
  frag[nt / 2][(nt % 2) * 2] = pack_bf16(x[0], x[1]);
  frag[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// Makes this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma operand reads, TMA); a barrier after it orders
// them before another thread's async reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (0 is __syncthreads): `threads` of the block, a multiple
// of 32, meet at barrier `id`; bar_arrive counts this warp in and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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

// TMA: one half of a tile (the map's box: its rows x 64 columns) from a
// rank-4 tensor map over
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

// TMA: one box of a rank-2 tensor map (its rows x 128 bytes, see
// make_map_2d_s8) at column c0, row c1 into shared `dst`; completion is
// counted in bytes on `bar`. Rows and columns past the tensor arrive as
// zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
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

// ---- host: tensor maps

// cuTensorMapEncodeTiled, looked up in libcuda, which the process has
// loaded already (nothing links against it).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map over one [B, L, N, D] bf16 view, dimensions (D, N, L, B)
// with the view's strides (in elements), whose box is one swizzled half
// tile: 64 columns of `box_rows` rows of one head. Rows past L are filled
// with zeros.
inline bool make_map(CUtensorMap* map, const void* base, int batch, int rows,
                     int heads, long long sb, long long sl, long long sn,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kD / 2, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a contiguous [rows, cols] int8 matrix (cols a multiple
// of 16), whose box is one swizzled tile: `box_rows` rows (at most 256) of
// 128 bytes, the K slice of a wgmma operand read K-major. Rows and columns
// past the matrix are filled with zeros.
inline bool make_map_2d_s8(CUtensorMap* map, const void* base, int rows,
                           int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
