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
// and sw [N] fp32 scales, out [M, N] bf16 or fp32. The bias [N] (fp32, or
// null) is added in one of two places: in fp32 before the cast (the
// _dense_multi order), or, with bias_after_cast, after it, as
// cast(float(cast(v)) + bias) with the bias given as values of the output
// type (the _dense order: rescale, cast, then add the bias in the compute
// dtype). The int32 sum is exact (|acc| <= 127^2 * K < 2^31 for K <=
// 133,000). The epilogue rounds as the plain version does, one operation at
// a time (__int2float_rn, two __fmul_rn, __fadd_rn: no fma contraction), so
// the two agree bit for bit.
//
// What bounds it: tensor-core operations. At the DiT's shapes (M = 15,600
// or 32,760, K, N in {5120, 13824}) it does 2*M*N*K operations on M*K + N*K
// + 2*M*N bytes, 2,600-4,300 operations per byte, against a balance point of
// ~590 for int8 on this card. The int8 peak (1,979 TOP/s) is twice the
// bf16 one, so each byte of shared memory feeds twice the products it does
// in bf16, and the tiles must be as wide as wgmma allows.
//
// What the design does about it:
// - The product is wgmma m64n256k32 s32.s8.s8 (no .satfinite: the sum
//   stays exact) on 128-byte-swizzled shared tiles. For 8-bit types wgmma
//   reads both operands K-major only, which is why wq stays [N, K]. A stage
//   holds a 128-byte K slice (four k-steps of 32 bytes, the stride of a
//   bf16 k-step, so flash_common.cuh's K-major descriptors serve as they
//   are) of a 128-row A tile and a 256-row B tile: one swizzle atom wide.
// - A block owns a 128 x 256 output tile at a time: two consumer
//   warpgroups of 64 rows each hold 128 int32 accumulators a thread over
//   the whole K loop, and one producer warp keeps a ring of four TMA stages
//   (48 KB each) full, with a full and an empty mbarrier per stage.
//   setmaxnreg gives the consumers 232 registers and the producer 40.
//   Where M is small (the cross-attention's text k/v, M = 1,024), a few
//   wide tiles would leave SMs idle in the grid's last round: the launch
//   takes 128 x 128 tiles (m64n128k32, six stages) when they finish in
//   fewer rounds, counting a narrow tile's extra cost (kNarrowCost).
//   TMA fills rows past M or N and columns past K with zeros, so the loads
//   need no masks and any K % 16 == 0 is exact.
// - The grid is persistent: one block per SM walks the output tiles t,
//   t + grid, ... in grouped order (8 row tiles share each sweep over the
//   weight's column tiles, so both operands stay in L2), and the producer
//   lands the next tile's first slices while the consumers write the last
//   one out.
// - The epilogue rescales in registers and stores coalesced: each warp
//   stages 16 rows x 128 bytes at a time in its own padded slice of shared
//   memory (no bank conflicts either way), then writes them back as
//   16-byte row chunks, eight lanes to a 128-byte line; rows past M and
//   chunks past N are skipped (N % 8 == 0, so a chunk is in or out whole).
//
// tools/int8_gemm_probe.py --variants times the choices above against
// their alternatives (one tile width for every shape, shallower rings,
// stores straight from registers) on patched copies of this source.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 128;               // output rows per tile
constexpr int kBlockK = 128;               // bytes of K per stage
constexpr int kWgRows = 64;                // rows per consumer warpgroup
constexpr int kConsumers = kBlockM / kWgRows;
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's warpgroup
constexpr int kATile = kBlockM * kBlockK;  // 16 KB
constexpr int kGroupM = 8;                 // row tiles per sweep over N
// epilogue staging: per warp 16 rows of 128 bytes, padded so that the
// fragment writes and the 16-byte row reads are free of bank conflicts
// (144-byte rows for bf16's 4-byte writes, 160 for fp32's 8-byte ones)
constexpr int kEpiRows = 16;
constexpr int kEpiWarpBytes = kEpiRows * 160;
constexpr int kEpiBytes = kConsumers * 4 * kEpiWarpBytes;
// ring depths of the wide and the narrow tile
constexpr int kStagesWide = 4;
constexpr int kStagesNarrow = 6;
// registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64,512
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
// A narrow tile costs this much more than half a wide one (the B operand
// is read for half as many columns per A slice); measured on an H100 with
// tools/int8_gemm_probe.py --variants.
constexpr float kNarrowCost = 1.15f;

// The sizes that follow from the output tile's width, 256 or 128 columns.
template <int kBN>
struct Shape {
  static constexpr int kChunks = kBN / 8;  // 8-column accumulator chunks
  static constexpr int kBTile = kBN * kBlockK;
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kStages = kBN == 256 ? kStagesWide : kStagesNarrow;
  // the ring + staging + barriers; 1 KB more to start the ring on a
  // 1,024-byte boundary
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kEpiBytes + 2 * kStages * 8 + 1024;
  static_assert(kBN == 128 || kBN == 256, "tile width: 128 or 256");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

struct Params {
  const float* sx;    // [M]
  const float* sw;    // [N]
  const float* bias;  // [N] or null
  void* out;          // [M, N]
  int m, n, k;
  int bias_after_cast;
  int tiles_m, tiles_n;
};

#define INT8_ACC4(d, j) \
  "+r"((d)[j][0]), "+r"((d)[j][1]), "+r"((d)[j][2]), "+r"((d)[j][3])

// d (64 x 256, s32) += a (64 x 32, shared) * b (32 x 256, shared); both
// operands K-major, no saturation.
__device__ __forceinline__ void wgmma_s8(int (&d)[32][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p;\n"
      "}\n"
      : INT8_ACC4(d, 0), INT8_ACC4(d, 1), INT8_ACC4(d, 2), INT8_ACC4(d, 3),
        INT8_ACC4(d, 4), INT8_ACC4(d, 5), INT8_ACC4(d, 6), INT8_ACC4(d, 7),
        INT8_ACC4(d, 8), INT8_ACC4(d, 9), INT8_ACC4(d, 10), INT8_ACC4(d, 11),
        INT8_ACC4(d, 12), INT8_ACC4(d, 13), INT8_ACC4(d, 14),
        INT8_ACC4(d, 15), INT8_ACC4(d, 16), INT8_ACC4(d, 17),
        INT8_ACC4(d, 18), INT8_ACC4(d, 19), INT8_ACC4(d, 20),
        INT8_ACC4(d, 21), INT8_ACC4(d, 22), INT8_ACC4(d, 23),
        INT8_ACC4(d, 24), INT8_ACC4(d, 25), INT8_ACC4(d, 26),
        INT8_ACC4(d, 27), INT8_ACC4(d, 28), INT8_ACC4(d, 29),
        INT8_ACC4(d, 30), INT8_ACC4(d, 31)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, s32) += a (64 x 32, shared) * b (32 x 128, shared).
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : INT8_ACC4(d, 0), INT8_ACC4(d, 1), INT8_ACC4(d, 2), INT8_ACC4(d, 3),
        INT8_ACC4(d, 4), INT8_ACC4(d, 5), INT8_ACC4(d, 6), INT8_ACC4(d, 7),
        INT8_ACC4(d, 8), INT8_ACC4(d, 9), INT8_ACC4(d, 10), INT8_ACC4(d, 11),
        INT8_ACC4(d, 12), INT8_ACC4(d, 13), INT8_ACC4(d, 14),
        INT8_ACC4(d, 15)
      : "l"(a), "l"(b), "r"(1));
}

#undef INT8_ACC4

// Keeps the compiler from moving reads or writes of the accumulators
// across the wgmma instructions and waits that own them.
template <int kChunks>
__device__ __forceinline__ void fence_acc(int (&d)[kChunks][4]) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
  }
}

// Output tile t in grouped order: row tiles in groups of kGroupM, the
// group's row tiles fastest, then the column tiles of kBlockN columns.
template <int kBlockN>
struct Tile {
  int m0, n0;
  __device__ __forceinline__ Tile(const Params& p, int t) {
    const int per_group = kGroupM * p.tiles_n;
    const int group = t / per_group;
    const int first_m = group * kGroupM;
    const int group_m = min(p.tiles_m - first_m, kGroupM);
    const int in_group = t % per_group;
    m0 = (first_m + in_group % group_m) * kBlockM;
    n0 = (in_group / group_m) * kBlockN;
  }
};

// The block's shared memory: the ring, the epilogue staging, the barriers.
template <int kBN>
struct Smem {
  using S = Shape<kBN>;
  unsigned char* base;   // generic pointer to the ring
  uint32_t ring;         // its shared address
  uint32_t bar_full, bar_empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    base = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
    ring = smem_u32(base);
    bar_full = ring + S::kStages * S::kStageBytes + kEpiBytes;
    bar_empty = bar_full + 8 * S::kStages;
  }

  __device__ __forceinline__ unsigned char* staging(int warp) const {
    return base + S::kStages * S::kStageBytes + warp * kEpiWarpBytes;
  }

  // One arrival fills a stage (the producer's, with the TMA bytes); one
  // lane of each consumer warp frees it.
  __device__ __forceinline__ void init_barriers() const {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
};

// One output element from its int32 sum: the plain version's rounding,
// step by step.
template <typename Out>
struct Epi;

template <>
struct Epi<float> {
  __device__ __forceinline__ static float apply(int acc, float sx, float sw,
                                                float b, int mode) {
    float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
    // fp32 out: the cast is exact, so both bias orders are one add
    if (mode != 0) v = __fadd_rn(v, b);
    return v;
  }
  __device__ __forceinline__ static void store2(float* dst, float v0,
                                                float v1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  }
};

template <>
struct Epi<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(int acc, float sx,
                                                        float sw, float b,
                                                        int mode) {
    float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
    if (mode == 1) v = __fadd_rn(v, b);
    __nv_bfloat16 r = __float2bfloat16_rn(v);
    if (mode == 2) r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), b));
    return r;
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* dst,
                                                __nv_bfloat16 v0,
                                                __nv_bfloat16 v1) {
    __nv_bfloat162 r;
    r.x = v0;
    r.y = v1;
    *reinterpret_cast<__nv_bfloat162*>(dst) = r;
  }
};

// The tile's output for this consumer thread (rows row0 and row0 + 8 of
// its warp's 16, columns 8j + 2t, + 1 of each chunk j), rescaled and
// written. mode: 0 no bias, 1 bias before the cast, 2 after it.
template <typename Out, int kBN>
__device__ __forceinline__ void store_tile(const Params& p, int n0,
                                           const int (&acc)[kBN / 8][4],
                                           unsigned char* stage, int wrow,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
  const int mode = p.bias == nullptr ? 0 : (p.bias_after_cast ? 2 : 1);
  const int r0 = wrow + g, r1 = r0 + 8;  // global rows
  const float sx0 = r0 < p.m ? p.sx[r0] : 0.f;
  const float sx1 = r1 < p.m ? p.sx[r1] : 0.f;
  Out* out = static_cast<Out*>(p.out);
  constexpr int kPassCols = 128 / sizeof(Out);  // 64 bf16 or 32 fp32
  constexpr int kPassChunks = kPassCols / 8;
  constexpr int kStride = sizeof(Out) == 2 ? 144 : 160;
  constexpr int kPerChunk = 16 / sizeof(Out);   // columns per 16 bytes
#pragma unroll
  for (int pass = 0; pass < kBN / kPassCols; ++pass) {
#pragma unroll
    for (int c = 0; c < kPassChunks; ++c) {
      const int j = pass * kPassChunks + c;
      const int col = n0 + j * 8 + t * 2;
      float2 sw = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (col < p.n) {
        sw = *reinterpret_cast<const float2*>(p.sw + col);
        if (mode != 0) b = *reinterpret_cast<const float2*>(p.bias + col);
      }
      const int off = (c * 8 + t * 2) * static_cast<int>(sizeof(Out));
      Epi<Out>::store2(
          reinterpret_cast<Out*>(stage + g * kStride + off),
          Epi<Out>::apply(acc[j][0], sx0, sw.x, b.x, mode),
          Epi<Out>::apply(acc[j][1], sx0, sw.y, b.y, mode));
      Epi<Out>::store2(
          reinterpret_cast<Out*>(stage + (g + 8) * kStride + off),
          Epi<Out>::apply(acc[j][2], sx1, sw.x, b.x, mode),
          Epi<Out>::apply(acc[j][3], sx1, sw.y, b.y, mode));
    }
    __syncwarp();
    // 16 rows x 8 chunks of 16 bytes: four rows per step, eight lanes a row
#pragma unroll
    for (int it = 0; it < kEpiRows / 4; ++it) {
      const int r = it * 4 + lane / 8, ch = lane % 8;
      const int row = wrow + r;
      const int col = n0 + pass * kPassCols + ch * kPerChunk;
      if (row < p.m && col < p.n) {
        *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * p.n +
                                  col) =
            *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 16);
      }
    }
    __syncwarp();
  }
}

template <typename Out, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const Params p,
                     const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b) {
  using S = Shape<kBN>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<kBN> sm(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int tiles = p.tiles_m * p.tiles_n;
  const int nk = (p.k + kBlockK - 1) / kBlockK;

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full across tiles
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile<kBN> tl(p, t);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int stage = it % S::kStages;
        mbar_wait(sm.bar_empty + 8 * stage, ((it / S::kStages) & 1) ^ 1);
        const uint32_t full = sm.bar_full + 8 * stage;
        const uint32_t dst = sm.ring + stage * S::kStageBytes;
        mbar_arrive_expect(full, S::kStageBytes);
        tma_load_2d(dst, &map_a, full, kt * kBlockK, tl.m0);
        tma_load_2d(dst + kATile, &map_b, full, kt * kBlockK, tl.n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  setmaxnreg_inc<kConsumerRegs>();
  unsigned char* stage_buf = sm.staging(wg * 4 + warp);
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile<kBN> tl(p, t);
    int acc[S::kChunks][4];
#pragma unroll
    for (int j = 0; j < S::kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    }
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int stage = it % S::kStages;
      mbar_wait(sm.bar_full + 8 * stage, (it / S::kStages) & 1);
      const uint32_t a =
          sm.ring + stage * S::kStageBytes + wg * kWgRows * 128;
      const uint32_t b = sm.ring + stage * S::kStageBytes + kATile;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBlockK / 32; ++ks) {
        wgmma_s8(acc, desc_k_major<kBlockM>(a, ks), desc_k_major<kBN>(b, ks));
      }
      wgmma_commit();
      // the slice before this one has been read: free its stage
      if (kt > 0) {
        wgmma_wait<1>();
        fence_acc(acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(sm.bar_empty + 8 * ((it - 1) % S::kStages));
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.bar_empty + 8 * ((it - 1) % S::kStages));
    store_tile<Out, kBN>(p, tl.n0, acc, stage_buf,
                         tl.m0 + wg * kWgRows + warp * 16, lane);
  }
}

// Blocks of the persistent grid for `tiles` output tiles.
int grid_blocks(long long tiles, int sms) {
  return static_cast<int>(tiles < sms ? tiles : sms);
}

template <typename Out, int kBN>
int launch_shape(Params& p, const void* xq, const void* wq, int sms,
                 cudaStream_t stream) {
  using S = Shape<kBN>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<Out, kBN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  if (!make_map_2d_s8(&map_a, xq, p.m, p.k, kBlockM) ||
      !make_map_2d_s8(&map_b, wq, p.n, p.k, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tiles_m = (p.m + kBlockM - 1) / kBlockM;
  p.tiles_n = (p.n + kBN - 1) / kBN;
  const long long tiles = static_cast<long long>(p.tiles_m) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int8_gemm_kernel<Out, kBN><<<grid_blocks(tiles, sms), kThreads,
                               S::kSmemBytes, stream>>>(p, map_a, map_b);
  return static_cast<int>(cudaGetLastError());
}

// The tile width: 256 columns, unless 128 finishes in fewer rounds of the
// persistent grid once the narrow tile's extra cost is counted (small M,
// where a few wide tiles leave SMs idle in the last round).
bool narrow_tiles(const Params& p, int sms) {
  const long long tm = (p.m + kBlockM - 1) / kBlockM;
  const long long wide = tm * ((p.n + 255) / 256);
  const long long narrow = tm * ((p.n + 127) / 128);
  const float t_wide = 2.f * static_cast<float>((wide + sms - 1) / sms);
  const float t_narrow =
      kNarrowCost * static_cast<float>((narrow + sms - 1) / sms);
  return t_narrow < t_wide;
}

template <typename Out>
int launch(Params& p, const void* xq, const void* wq, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return narrow_tiles(p, sms) ? launch_shape<Out, 128>(p, xq, wq, sms, st)
                              : launch_shape<Out, 256>(p, xq, wq, sms, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. xq [M, K] and wq [N, K] are
// contiguous int8, 16-byte aligned, K a positive multiple of 16 and N a
// multiple of 8; sx [M], sw [N] and bias [N] (or null) contiguous fp32,
// 16-byte aligned; out [M, N] contiguous, fp32 when out_fp32 is non-zero,
// else bf16. With bias_after_cast the bias (not null) holds values of the
// output type and is added after the cast. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
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
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.bias_after_cast = bias_after_cast;
  return out_fp32 ? launch<float>(p, xq, wq, stream)
                  : launch<__nv_bfloat16>(p, xq, wq, stream);
}
