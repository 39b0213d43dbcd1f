// W8A8 GEMM for Hopper (sm_90a): int8 x int8 -> int32 with a fused dequant
// epilogue.
//
// Replaces the TPU kernel moviigen_tpu/ops/int8_gemm.py::_kernel (launched
// by int8_gemm_fused through pl.pallas_call). Same function:
//   out[m, n] = cast(float(sum_k xq[m, k] * wq[n, k]) * sx[m] * sw[n]
//                    (+ bias[n]))
// xq [M, K] int8 per-token quantized activations, wq [N, K] int8
// per-output-channel quantized weights (the nn.Linear layout: K contiguous
// for both operands, where the Pallas kernel takes wq as [K, N]), sx [M]
// and sw [N] fp32 scales, bias [N] fp32 or null, out [M, N] bf16 or fp32.
// The int32 sum is exact (|acc| <= 127^2 * K < 2^31 for K <= 133,000). The
// epilogue rounds as the plain version does, one operation at a time
// (__int2float_rn, two __fmul_rn, __fadd_rn: no fma contraction), so the
// two agree bit for bit.
//
// What bounds it: tensor-core operations. At the DiT's shapes (M = 15,600,
// K, N in {5120, 13824}) it does 2*M*N*K operations on M*K + N*K + 2*M*N
// bytes, 2,600-4,300 operations per byte, against a balance point of
// ~590 for int8 on this card.
//
// What the design does about it: the product runs on the tensor cores
// (mma.sync m16n8k32 s8 -> s32, no saturation), fed by ldmatrix from
// shared memory; an 8 x 16-byte ldmatrix row block of int8 is exactly the
// 8 x 4-byte-per-thread fragment the mma wants, for A and (because wq is
// kept [N, K]) for B, so no operand is transposed on the way. One block of
// 8 warps (2 along M x 4 along N) owns a 128 x 128 output tile and loops
// over K in 128-byte slices (the Pallas grid's sequential K axis), with
// the int32 accumulators (64 per thread) in registers for the whole loop:
// the int32 product never reaches device memory. Slices move through a
// 3-stage cp.async ring, rows padded by 16 bytes so that every ldmatrix is
// free of bank conflicts. Blocks are numbered so that 8 row tiles share
// each sweep over the weight's column tiles, which keeps both operands in
// L2. Ragged edges in M, N and K are zero-filled on load and masked on
// store, so any M >= 1 is served; K must be a multiple of 16 (cp.async
// moves 16 bytes) and N a multiple of 8.
// Not yet used: wgmma, TMA, warp specialisation, a coalesced store.

#include "flash_common.cuh"

namespace {

using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldmatrix_x4;

constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kBlockK = 128;           // bytes of K per stage
constexpr int kLds = kBlockK + 16;     // shared row stride in bytes
constexpr int kStages = 3;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpM = 64;             // rows per warp: 4 m-tiles of 16
constexpr int kWarpN = 32;             // columns per warp: 4 n-tiles of 8
constexpr int kGroupM = 8;             // row tiles per sweep over N
constexpr int kTileBytes = kBlockM * kLds;
constexpr int kStageBytes = 2 * kTileBytes;  // A tile + B tile
constexpr int kSmemBytes = kStages * kStageBytes;

struct Params {
  const int8_t* xq;   // [M, K]
  const int8_t* wq;   // [N, K]
  const float* sx;    // [M]
  const float* sw;    // [N]
  const float* bias;  // [N] or null
  void* out;          // [M, N]
  int m, n, k;
};

// c (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float(acc) * sx * sw (+ bias), each step rounded to nearest on its own.
__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         const float* bias, int col) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  return v;
}

__device__ __forceinline__ void store2(float* out, long long idx, float v0,
                                       float v1) {
  *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, long long idx,
                                       float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out + idx) =
      __floats2bfloat162_rn(v0, v1);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / 4;  // 0..1
  const int warp_n = warp % 4;  // 0..3

  // Output tile of this block: row tiles in groups of kGroupM, the group's
  // row tiles fastest, then the column tiles.
  const int tiles_m = (p.m + kBlockM - 1) / kBlockM;
  const int tiles_n = (p.n + kBlockN - 1) / kBlockN;
  const int per_group = kGroupM * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kBlockM;
  const int n0 = (in_group / group_m) * kBlockN;

  const int nk = (p.k + kBlockK - 1) / kBlockK;

  // One K slice of the A and the B tile -> shared stage; rows past M or N
  // and 16-byte chunks past K are zero-filled.
  auto load_stage = [&](int kt, int stage) {
    unsigned char* sa = smem + stage * kStageBytes;
    unsigned char* sb = sa + kTileBytes;
    const int k0 = kt * kBlockK;
    for (int c = tid; c < kBlockM * (kBlockK / 16); c += kThreads) {
      const int r = c / (kBlockK / 16);
      const int col = (c % (kBlockK / 16)) * 16;
      const bool in_k = k0 + col < p.k;
      const bool ok_a = in_k && m0 + r < p.m;
      const bool ok_b = in_k && n0 + r < p.n;
      cp_async_16(sa + r * kLds + col,
                  ok_a ? p.xq + static_cast<long long>(m0 + r) * p.k + k0 + col
                       : p.xq,
                  ok_a);
      cp_async_16(sb + r * kLds + col,
                  ok_b ? p.wq + static_cast<long long>(n0 + r) * p.k + k0 + col
                       : p.wq,
                  ok_b);
    }
  };

  int acc[4][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  const int lj = lane / 8, lr = lane % 8;
  // ldmatrix row addresses of this lane (see flash_common.cuh load_a and
  // load_b_rows: the same 8x8 blocks, 16 bytes wide, hold int8 here)
  const int a_off = (warp_m * kWarpM + lr + (lj & 1) * 8) * kLds + (lj >> 1) * 16;
  const int b_off = (warp_n * kWarpN + lr + (lj >> 1) * 8) * kLds + (lj & 1) * 16;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();               // ... for every thread; slice kt-1 is consumed
    if (kt + kStages - 1 < nk)
      load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sb = sa + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBlockK / 32; ++ks) {
      uint32_t a[4][4];
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i][0], a[i][1], a[i][2], a[i][3],
                    sa + a_off + i * 16 * kLds + ks * 32);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(b[j][0], b[j][1], b[j][2], b[j][3],
                    sb + b_off + j * 16 * kLds + ks * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                 b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue in registers: thread (g, t) of a 16x8 C fragment holds rows g
  // and g + 8, columns 2t and 2t + 1.
  Out* out = static_cast<Out*>(p.out);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r0 = m0 + warp_m * kWarpM + i * 16 + g;
    const int r1 = r0 + 8;
    const float sx0 = r0 < p.m ? p.sx[r0] : 0.f;
    const float sx1 = r1 < p.m ? p.sx[r1] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + warp_n * kWarpN + j * 8 + t * 2;
      if (col >= p.n) continue;  // N is even: col + 1 < N too
      const float sw0 = p.sw[col], sw1 = p.sw[col + 1];
      if (r0 < p.m)
        store2(out, static_cast<long long>(r0) * p.n + col,
               dequant(acc[i][j][0], sx0, sw0, p.bias, col),
               dequant(acc[i][j][1], sx0, sw1, p.bias, col + 1));
      if (r1 < p.m)
        store2(out, static_cast<long long>(r1) * p.n + col,
               dequant(acc[i][j][2], sx1, sw0, p.bias, col),
               dequant(acc[i][j][3], sx1, sw1, p.bias, col + 1));
    }
  }
}

template <typename Out>
int launch(const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((p.m + kBlockM - 1) / kBlockM) *
                          ((p.n + kBlockN - 1) / kBlockN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int8_gemm_kernel<Out><<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. xq [M, K] and wq [N, K] are
// contiguous int8, 16-byte aligned, K a multiple of 16 and N of 8; sx [M],
// sw [N] and bias [N] (or null) contiguous fp32; out [M, N] contiguous,
// fp32 when out_fp32 is non-zero, else bf16. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int int8_gemm_dequant(const void* xq, const void* wq,
                                 const void* sx, const void* sw,
                                 const void* bias, void* out, int m, int n,
                                 int k, int out_fp32, void* stream) {
  if (m < 0 || n < 0 || k < 0 || k % 16 != 0 || n % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.wq = static_cast<const int8_t*>(wq);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  return out_fp32 ? launch<float>(p, stream) : launch<__nv_bfloat16>(p, stream);
}
