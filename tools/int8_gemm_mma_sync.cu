// The int8 GEMM's earlier design (mma.sync, a cp.async ring), kept as the
// yardstick that chip_smoke.py and tools/int8_gemm_probe.py time beside the
// Hopper design in moviigen_tpu_torch/csrc/int8_gemm.cu. It exports the same
// C entry point with the same arguments and computes the same function, bit
// for bit; kernels.use("int8_gemm", chip_smoke.GEMM_BEFORE_SOURCE) makes the
// port's wrappers call it. The port never does.
//
// One block of 8 warps (2 along M x 4 along N) owns a 128 x 128 output tile
// and loops over K in 128-byte slices with its int32 accumulators (64 per
// thread) in registers. Slices move through a 3-stage cp.async ring, rows
// padded by 16 bytes so that every ldmatrix is free of bank conflicts; an
// 8 x 16-byte ldmatrix row block of int8 is the 8 x 4-byte-per-thread
// fragment of mma.sync m16n8k32 s8 -> s32, for A and (wq being [N, K]) for
// B. Blocks are numbered so that 8 row tiles share each sweep over the
// weight's column tiles. Ragged edges in M, N and K are zero-filled on load
// and masked on the 4- or 8-byte stores from registers.

#include "../moviigen_tpu_torch/csrc/flash_common.cuh"

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
  int bias_after_cast;
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

// With bias_after_cast, v is rounded to the output type first and the bias
// (given as that type's values) is added to it and rounded again.
__device__ __forceinline__ void store2(float* out, long long idx, float v0,
                                       float v1, const float* bias, int col,
                                       bool after) {
  if (after) {
    v0 = __fadd_rn(v0, bias[col]);
    v1 = __fadd_rn(v1, bias[col + 1]);
  }
  *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, long long idx,
                                       float v0, float v1, const float* bias,
                                       int col, bool after) {
  __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  if (after) {
    const float2 f = __bfloat1622float2(r);
    r = __floats2bfloat162_rn(__fadd_rn(f.x, bias[col]),
                              __fadd_rn(f.y, bias[col + 1]));
  }
  *reinterpret_cast<__nv_bfloat162*>(out + idx) = r;
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
  const bool after = p.bias_after_cast != 0;
  const float* fused_bias = after ? nullptr : p.bias;
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
               dequant(acc[i][j][0], sx0, sw0, fused_bias, col),
               dequant(acc[i][j][1], sx0, sw1, fused_bias, col + 1), p.bias,
               col, after);
      if (r1 < p.m)
        store2(out, static_cast<long long>(r1) * p.n + col,
               dequant(acc[i][j][2], sx1, sw0, fused_bias, col),
               dequant(acc[i][j][3], sx1, sw1, fused_bias, col + 1), p.bias,
               col, after);
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

// The entry point of csrc/int8_gemm.cu, with the same contract.
extern "C" int int8_gemm_dequant(const void* xq, const void* wq,
                                 const void* sx, const void* sw,
                                 const void* bias, void* out, int m, int n,
                                 int k, int out_fp32, int bias_after_cast,
                                 void* stream) {
  if (m < 0 || n < 0 || k < 16 || k % 16 != 0 || n % 8 != 0 ||
      (bias_after_cast && bias == nullptr))
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
  p.bias_after_cast = bias_after_cast;
  return out_fp32 ? launch<float>(p, stream) : launch<__nv_bfloat16>(p, stream);
}
