// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in,
// fp32 accumulate, no atomics.
//
// Replaces the TPU kernels of moviigen_tpu/ops/flash_attention.py:
//   flash_bwd_dkv_kernel  <- _flash_bwd_dkv_kernel (dV = P^T dO, dK = dS^T q')
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel  (dQ = dS K)
// launched by _flash_bwd through pl.pallas_call. Same function: with
// q' = bf16(q * bf16(scale * log2 e)) (prescaled by the caller, as
// _flash_bwd does outside Pallas), s = q' k^T in fp32, keys at or past
// k_len masked, and the forward's per-row stats m (base 2) and l,
//   P  = exp2(s - m) * (l == 0 ? 1 : 1 / l)
//   dS = P * (dO v^T - Delta),  Delta = rowsum(o * dO) (fp32, by the caller)
// then dq = scale * dS k, dk = dS^T q' / log2 e, dv = P^T dO, written
// bf16 with the scale applied to the fp32 sums. P and dS are rounded to
// bf16 to feed the tensor cores (the Pallas kernel keeps them fp32).
//
// What bounds them: tensor-core operations. dKV does 8 * N * Lq * Lk * D
// flops (four products), dQ 6 * N * Lq * Lk * D (three), on inputs of
// 2 * 2 * (Lq + Lk) * N * D bytes: ~2,000 flops per byte at L = 32,760,
// far above the card's ~295 balance point. Below the tensor cores the next
// limit is shared memory: an SM reads 128 bytes per clock, and a product
// fed per warp (mma.sync with ldmatrix) makes each of a block's warps read
// the whole tile of the other operand again.
//
// What the design does about it:
// - Every product is a wgmma. A warpgroup of four warps starts one
//   64-row product whose B tile is read from shared memory once for all
//   four; P and dS never leave registers, where the accumulator fragment
//   of S, packed to bf16, is the A fragment of the next product. Tiles
//   lie in shared memory in the 128-byte swizzle, and one copy of a tile
//   serves both of its products: K-major for S and dP, MN-major (the
//   transposed-B flag) for dV, dK and dQ (flash_common.cuh).
// - dKV: a block owns 128 keys of one (batch, head), 64 per consumer
//   warpgroup, resident in shared memory, and walks the query tiles of 64
//   rows. Per tile a warpgroup computes S^T = K q'^T and dP^T = V dO^T
//   (so P^T and dS^T land as A fragments, nothing is transposed), then
//   dV += P^T dO and dK += dS^T q'; the two 64 x 128 fp32 accumulators
//   stay in registers for the whole loop. The exp2 of one product runs
//   while the next product is in flight.
// - dQ: a block owns 128 query rows, 64 per consumer warpgroup, with
//   their q', dO tiles resident and m, 1/l, Delta in registers, and walks
//   the key tiles of 64 below k_len: S = q' K^T, dP = dO V^T, dQ += dS K.
// - Loads are TMA: a rank-4 tensor map (D, N, L, B) per operand, built
//   from the view's strides at each launch, whose box is one swizzled
//   half tile (64 rows x 64 columns); rows past L arrive as zeros. A
//   fifth warp is the producer: it keeps a ring of three (q', dO) or
//   (K, V) stages full, each with a full and an empty mbarrier, and for
//   dKV writes the stage's m, 1/l, Delta rows beside it. setmaxnreg hands
//   its registers to the consumers (24 against 240), whose 229 live
//   registers do not spill. Two consumer warpgroups in one block share
//   each stage: 160 KB of shared memory and one block per SM carry the
//   same eight computing warps as two single-warpgroup blocks would, at
//   half the loads. Measured at L = 32,760 on an H100, one warpgroup per
//   block at two blocks per SM is 3-6 % slower, a ring of two stages 5-7 %
//   slower, a ring of four no faster.
// - With few keys (the 512-token cross-attention) there are fewer
//   (key block, head, batch) triples than SMs. The caller then cuts the
//   query loop into chunks, a function of the shapes alone; block
//   (key block, chunk) writes fp32 partial sums to scratch and
//   flash_bwd_dkv_reduce_kernel adds them in chunk order, applies dK's
//   scale and writes bf16.
// The split into two kernels is the Pallas one: each output tile is owned
// by one block, or summed in a fixed order, so nothing is added atomically
// and the gradients are the same bits from run to run. Keys between k_len
// and Lk arrive non-zero and are zeroed by the explicit P = 0 mask; query
// rows past Lq arrive as zeros and get 1 / l = 0, so P = 0 (the Pallas
// version pads them with m = +1e30); a key block wholly past k_len walks
// no tile and writes zeros. The caller passes [B, L, N, D] views through
// their strides.

#include <cuda.h>
#include <dlfcn.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;               // rows per tile, queries and keys
constexpr int kConsumers = 2;           // consumer warpgroups of a block
constexpr int kBlockRows = kConsumers * kTile;  // keys (dKV), rows (dQ) per block
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's warpgroup
constexpr int kStages = 3;              // ring depth (see above)
constexpr int kStatFloats = 3 * kTile;  // m, 1/l, Delta of one query tile
constexpr int kStageBytes = 2 * kTileBytes;     // (q', dO) or (K, V)
constexpr int kBarriers = 1 + 2 * kStages;  // resident tiles; full, empty per stage
// resident tiles of both operands + the ring (+ dKV: the ring's stats) +
// barriers; 1 KB more to start the tiles on a 1,024-byte boundary
constexpr int kDqSmemBytes =
    2 * kConsumers * kTileBytes + kStages * kStageBytes + kBarriers * 8 + 1024;
constexpr int kDkvSmemBytes = kDqSmemBytes + kStages * kStatFloats * 4;
// registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 = 64,512
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

struct Params {
  const __nv_bfloat16* q;   // q' (prescaled)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* m;           // [B, N, Lq]
  const float* l;           // [B, N, Lq]
  const float* delta;       // [B, N, Lq]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* klens;         // [B] or null
  int lq, lk;
  long long sqb, sql, sqn;
  long long skb, skl, skn;
  long long svb, svl, svn;
  long long sdob, sdol, sdon;
  long long sgb, sgl, sgn;  // dq, or dk and dv (same strides)
  float out_scale;          // dq: scale; dk: 1 / log2 e
  // dKV with the query loop split over `splits` chunks: chunk c writes
  // fp32 partial sums into part_dk / part_dv [splits, B, Lk, N, D]
  int splits;
  float* part_dk;
  float* part_dv;
};

__device__ __forceinline__ int key_len(const Params& p, int b) {
  return p.klens != nullptr ? min(max(p.klens[b], 0), p.lk) : p.lk;
}

// m, 1/l (guarded at l == 0) and Delta of one query row; rows past Lq get
// 1/l = 0, so their P is exactly 0.
__device__ __forceinline__ void row_stats(const Params& p, long long base,
                                          int row, float& m, float& linv,
                                          float& delta) {
  if (row < p.lq) {
    const float l = p.l[base + row];
    m = p.m[base + row];
    linv = (l == 0.f) ? 1.f : 1.f / l;
    delta = p.delta[base + row];
  } else {
    m = 0.f;
    linv = 0.f;
    delta = 0.f;
  }
}

// Two neighbouring 8-column accumulator chunks, packed to bf16, as half
// of the register A fragment of k-step nt / 2.
__device__ __forceinline__ void pack_chunk(uint32_t (&frag)[4][4], int nt,
                                           const float (&x)[4]) {
  frag[nt / 2][(nt % 2) * 2] = pack_bf16(x[0], x[1]);
  frag[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// One query tile of dKV for one warpgroup that owns 64 keys: S^T = K q'^T
// and dP^T = V dO^T (both operands from shared memory), P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T q' with the same q' and dO
// tiles read MN-major. sK, sV, sQ, sDO are shared addresses of swizzled
// tiles; `stat` holds the tile's m, 1/l and Delta rows; key0 is the key
// of this thread's accumulator row g.
__device__ __forceinline__ void dkv_tile(uint32_t sK, uint32_t sV,
                                         uint32_t sQ, uint32_t sDO,
                                         const float* stat,
                                         float (&acc_dk)[16][4],
                                         float (&acc_dv)[16][4], int key0,
                                         int klen, bool key_masked, int t) {
  float s[8][4], dp[8][4];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    wgmma_ss_n64(s, desc_k_major(sK, ks), desc_k_major(sQ, ks), ks > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    wgmma_ss_n64(dp, desc_k_major(sV, ks), desc_k_major(sDO, ks), ks > 0);
  }
  wgmma_commit();

  wgmma_wait<1>();  // S^T has landed; dP^T may still be running
  fence_acc(s);
  uint32_t pf[4][4], dsf[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 m2 = *reinterpret_cast<const float2*>(stat + nt * 8 + t * 2);
    const float2 li2 =
        *reinterpret_cast<const float2*>(stat + kTile + nt * 8 + t * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // accumulator rows are keys (g, g + 8), columns query rows
      float pe = exp2f(s[nt][e] - ((e & 1) ? m2.y : m2.x)) *
                 ((e & 1) ? li2.y : li2.x);
      if (key_masked && key0 + (e >> 1) * 8 >= klen) pe = 0.f;
      s[nt][e] = pe;
    }
    pack_chunk(pf, nt, s[nt]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    wgmma_rs_n128(acc_dv, pf[ks], desc_mn_major(sDO, ks));
  }
  wgmma_commit();

  wgmma_wait<1>();  // dP^T has landed; dV may still be running
  fence_acc(dp);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 de2 =
        *reinterpret_cast<const float2*>(stat + 2 * kTile + nt * 8 + t * 2);
    float dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dsv[e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? de2.y : de2.x));
    }
    pack_chunk(dsf, nt, dsv);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    wgmma_rs_n128(acc_dk, dsf[ks], desc_mn_major(sQ, ks));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc_dv);
  fence_acc(acc_dk);
}

// One key tile of dQ for one warpgroup that owns 64 query rows: S = q' K^T
// and dP = dO V^T, dS in registers, dQ += dS K with the K tile read
// MN-major. rm, rlinv, rdelta: the stats of this thread's rows g, g + 8;
// n0 is the tile's first key.
__device__ __forceinline__ void dq_tile(uint32_t sQ, uint32_t sDO,
                                        uint32_t sK, uint32_t sV,
                                        const float (&rm)[2],
                                        const float (&rlinv)[2],
                                        const float (&rdelta)[2],
                                        float (&acc)[16][4], int n0, int klen,
                                        int t) {
  float s[8][4], dp[8][4];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    wgmma_ss_n64(s, desc_k_major(sQ, ks), desc_k_major(sK, ks), ks > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    wgmma_ss_n64(dp, desc_k_major(sDO, ks), desc_k_major(sV, ks), ks > 0);
  }
  wgmma_commit();

  wgmma_wait<1>();  // S has landed; dP may still be running
  fence_acc(s);
  const bool masked = n0 + kTile > klen;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pe = exp2f(s[nt][e] - rm[r]) * rlinv[r];
      if (masked && n0 + nt * 8 + t * 2 + (e & 1) >= klen) pe = 0.f;
      s[nt][e] = pe;
    }
  }
  wgmma_wait<0>();
  fence_acc(dp);
  uint32_t dsf[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dsv[e] = s[nt][e] * (dp[nt][e] - rdelta[e >> 1]);
    }
    pack_chunk(dsf, nt, dsv);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    wgmma_rs_n128(acc, dsf[ks], desc_mn_major(sK, ks));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

template <int kChunks>
__device__ __forceinline__ void zero_acc(float (&d)[kChunks][4]) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  }
}

// Write a warp's 16 x 128 fp32 accumulator as fp32 rows row0 + g and
// row0 + g + 8 (those below `limit`) of a contiguous [L, N, D] slice.
__device__ __forceinline__ void store_rows_f32(float* out,
                                               long long row_stride,
                                               const float (*acc)[4],
                                               int row0, int limit,
                                               int lane) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (r0 < limit) {
      *reinterpret_cast<float2*>(out + r0 * row_stride + col) =
          make_float2(acc[dt][0], acc[dt][1]);
    }
    if (r1 < limit) {
      *reinterpret_cast<float2*>(out + r1 * row_stride + col) =
          make_float2(acc[dt][2], acc[dt][3]);
    }
  }
}

// Both halves of the 64-row tile at row `row` of head h, batch b.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const void* map,
                                              uint32_t bar, int h, int row,
                                              int b) {
  tma_load_half(dst, map, bar, 0, h, row, b);
  tma_load_half(dst + kHalfBytes, map, bar, kD / 2, h, row, b);
}

// The block's shared memory: resident tiles, ring, barriers (and, for
// dKV, the ring's stats after them).
struct Smem {
  uint32_t resident;  // 2 * kConsumers tiles
  uint32_t ring;      // kStages x (two tiles)
  uint32_t bar_resident, bar_full, bar_empty;  // shared addresses
  float* stats;       // generic pointer, kStages x kStatFloats

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    unsigned char* base = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
    resident = smem_u32(base);
    ring = resident + 2 * kConsumers * kTileBytes;
    bar_resident = ring + kStages * kStageBytes;
    bar_full = bar_resident + 8;
    bar_empty = bar_full + 8 * kStages;
    stats = reinterpret_cast<float*>(base + 2 * kConsumers * kTileBytes +
                                     kStages * kStageBytes + kBarriers * 8);
  }

  // One arrival fills a stage (the producer's, with the TMA bytes); one
  // lane of each consumer warp frees it.
  __device__ __forceinline__ void init_barriers() const {
    mbar_init(bar_resident, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
};

// dKV: a block owns 128 keys of one (batch, head), 64 per consumer
// warpgroup, and walks the query tiles [j0, j1) of its chunk.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const Params p,
                         const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int key_blocks = (p.lk + kBlockRows - 1) / kBlockRows;
  const int n0 = (blockIdx.x % key_blocks) * kBlockRows;
  const int chunk = blockIdx.x / key_blocks;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int klen = key_len(p, b);
  const int n_qt = (p.lq + kTile - 1) / kTile;
  const int per_chunk = (n_qt + p.splits - 1) / p.splits;
  const int j0 = chunk * per_chunk;
  // every key masked: no tile to walk, the gradients are zero
  const int j1 = n0 >= klen ? j0 : min(n_qt, j0 + per_chunk);

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || j0 >= j1) return;
    if (lane == 0) {
      mbar_arrive_expect(sm.bar_resident, 2 * kConsumers * kTileBytes);
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_tile(sm.resident + c * kTileBytes, &map_k, sm.bar_resident,
                      h, n0 + c * kTile, b);
        tma_load_tile(sm.resident + (kConsumers + c) * kTileBytes, &map_v,
                      sm.bar_resident, h, n0 + c * kTile, b);
      }
    }
    const long long sbase = (static_cast<long long>(b) * gridDim.y + h) * p.lq;
    for (int j = j0; j < j1; ++j) {
      const int it = j - j0;
      const int stage = it % kStages;
      mbar_wait(sm.bar_empty + 8 * stage, ((it / kStages) & 1) ^ 1);
      float* stat = sm.stats + stage * kStatFloats;
#pragma unroll
      for (int r = lane; r < kTile; r += 32) {
        float m, linv, delta;
        row_stats(p, sbase, j * kTile + r, m, linv, delta);
        stat[r] = m;
        stat[kTile + r] = linv;
        stat[2 * kTile + r] = delta;
      }
      __syncwarp();  // the stats are written before lane 0 arrives
      if (lane == 0) {
        const uint32_t full = sm.bar_full + 8 * stage;
        const uint32_t dst = sm.ring + stage * kStageBytes;
        mbar_arrive_expect(full, kStageBytes);
        tma_load_tile(dst, &map_q, full, h, j * kTile, b);
        tma_load_tile(dst + kTileBytes, &map_do, full, h, j * kTile, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys n0 + 64 wg .. + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const int key0 = n0 + wg * kTile + warp * 16;  // this warp's first key
    const bool key_masked = n0 + (wg + 1) * kTile > klen;
    float acc_dk[kD / 8][4], acc_dv[kD / 8][4];
    zero_acc(acc_dk);
    zero_acc(acc_dv);

    if (j0 < j1) mbar_wait(sm.bar_resident, 0);
    for (int j = j0; j < j1; ++j) {
      const int it = j - j0;
      const int stage = it % kStages;
      mbar_wait(sm.bar_full + 8 * stage, (it / kStages) & 1);
      const uint32_t sQ = sm.ring + stage * kStageBytes;
      dkv_tile(sm.resident + wg * kTileBytes,
               sm.resident + (kConsumers + wg) * kTileBytes, sQ,
               sQ + kTileBytes, sm.stats + stage * kStatFloats, acc_dk,
               acc_dv, key0 + g, klen, key_masked, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.bar_empty + 8 * stage);
    }

    if (p.splits == 1) {
      __nv_bfloat16* dkg = p.dk + b * p.sgb + h * p.sgn;
      __nv_bfloat16* dvg = p.dv + b * p.sgb + h * p.sgn;
      store_rows_bf16(dkg, p.sgl, acc_dk, key0, p.lk, p.out_scale, lane);
      store_rows_bf16(dvg, p.sgl, acc_dv, key0, p.lk, 1.f, lane);
    } else {
      const long long row_stride = static_cast<long long>(gridDim.y) * kD;
      const long long off =
          ((static_cast<long long>(chunk) * gridDim.z + b) * p.lk) *
              row_stride + h * kD;
      store_rows_f32(p.part_dk + off, row_stride, acc_dk, key0, p.lk, lane);
      store_rows_f32(p.part_dv + off, row_stride, acc_dv, key0, p.lk, lane);
    }
  }
}

// Sums the chunks' partial dK and dV in chunk order, applies dK's scale
// and writes bf16: one thread per four neighbouring elements.
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_reduce_kernel(const Params p, int heads, long long quads) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= quads) return;
  const int d4 = static_cast<int>(i % (kD / 4));
  const int h = static_cast<int>((i / (kD / 4)) % heads);
  const long long row = i / (kD / 4) / heads;  // b * Lk + key
  const int key = static_cast<int>(row % p.lk);
  const int b = static_cast<int>(row / p.lk);
  float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
  for (int c = 0; c < p.splits; ++c) {
    const long long at = (c * quads + i) * 4;
    const float4 x = *reinterpret_cast<const float4*>(p.part_dk + at);
    const float4 y = *reinterpret_cast<const float4*>(p.part_dv + at);
    dk.x += x.x; dk.y += x.y; dk.z += x.z; dk.w += x.w;
    dv.x += y.x; dv.y += y.y; dv.z += y.z; dv.w += y.w;
  }
  const long long out = b * p.sgb + key * p.sgl + h * p.sgn + d4 * 4;
  const float s = p.out_scale;
  uint2 pk, pv;
  pk.x = pack_bf16(dk.x * s, dk.y * s);
  pk.y = pack_bf16(dk.z * s, dk.w * s);
  pv.x = pack_bf16(dv.x, dv.y);
  pv.y = pack_bf16(dv.z, dv.w);
  *reinterpret_cast<uint2*>(p.dk + out) = pk;
  *reinterpret_cast<uint2*>(p.dv + out) = pv;
}

// dQ: a block owns 128 query rows of one (batch, head), 64 per consumer
// warpgroup, and walks the key tiles below k_len.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const Params p,
                        const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int klen = key_len(p, b);
  const int n_tiles = (klen + kTile - 1) / kTile;

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0 || n_tiles == 0) return;
    mbar_arrive_expect(sm.bar_resident, 2 * kConsumers * kTileBytes);
    for (int c = 0; c < kConsumers; ++c) {
      tma_load_tile(sm.resident + c * kTileBytes, &map_q, sm.bar_resident, h,
                    m0 + c * kTile, b);
      tma_load_tile(sm.resident + (kConsumers + c) * kTileBytes, &map_do,
                    sm.bar_resident, h, m0 + c * kTile, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      mbar_wait(sm.bar_empty + 8 * stage, ((j / kStages) & 1) ^ 1);
      const uint32_t full = sm.bar_full + 8 * stage;
      const uint32_t dst = sm.ring + stage * kStageBytes;
      mbar_arrive_expect(full, kStageBytes);
      tma_load_tile(dst, &map_k, full, h, j * kTile, b);
      tma_load_tile(dst + kTileBytes, &map_v, full, h, j * kTile, b);
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = m0 + wg * kTile + warp * 16;  // this warp's first row
    // this thread's rows g and g + 8 of the warp's 16
    const long long sbase = (static_cast<long long>(b) * gridDim.y + h) * p.lq;
    float rm[2], rlinv[2], rdelta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_stats(p, sbase, row0 + g + r * 8, rm[r], rlinv[r], rdelta[r]);
    }
    float acc[kD / 8][4];
    zero_acc(acc);

    if (n_tiles > 0) mbar_wait(sm.bar_resident, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      mbar_wait(sm.bar_full + 8 * stage, (j / kStages) & 1);
      const uint32_t sK = sm.ring + stage * kStageBytes;
      dq_tile(sm.resident + wg * kTileBytes,
              sm.resident + (kConsumers + wg) * kTileBytes, sK,
              sK + kTileBytes, rm, rlinv, rdelta, acc, j * kTile, klen, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.bar_empty + 8 * stage);
    }
    store_rows_bf16(p.dq + b * p.sgb + h * p.sgn, p.sgl, acc, row0, p.lq,
                    p.out_scale, lane);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda, which the process has
// loaded already (nothing links against it).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map over one [B, L, N, D] bf16 view, dimensions (D, N, L, B)
// with the view's strides, whose box is one swizzled half tile: 64
// columns of 64 rows of one head. Rows past L are filled with zeros.
bool make_map(CUtensorMap* map, const void* base, int batch, int rows,
              int heads, long long sb, long long sl, long long sn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kD / 2, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* maps, const Params& p, int batch, int heads) {
  return make_map(&maps->q, p.q, batch, p.lq, heads, p.sqb, p.sql, p.sqn) &&
         make_map(&maps->k, p.k, batch, p.lk, heads, p.skb, p.skl, p.skn) &&
         make_map(&maps->v, p.v, batch, p.lk, heads, p.svb, p.svl, p.svn) &&
         make_map(&maps->dout, p.dout, batch, p.lq, heads, p.sdob, p.sdol,
                  p.sdon);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int blocks, int heads, int batch,
           const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || heads == 0 || blocks == 0) return 0;
  Maps maps;
  if (!make_maps(&maps, p, batch, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(blocks, heads, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, maps.q, maps.k, maps.v, maps.dout);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* m, const void* l,
                   const void* delta, const void* klens, int lq, int lk,
                   const long long* st, float out_scale) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.delta = static_cast<const float*>(delta);
  p.klens = static_cast<const int*>(klens);
  p.lq = lq;
  p.lk = lk;
  p.sqb = st[0]; p.sql = st[1]; p.sqn = st[2];
  p.skb = st[3]; p.skl = st[4]; p.skn = st[5];
  p.svb = st[6]; p.svl = st[7]; p.svn = st[8];
  p.sdob = st[9]; p.sdol = st[10]; p.sdon = st[11];
  p.sgb = st[12]; p.sgl = st[13]; p.sgn = st[14];
  p.out_scale = out_scale;
  p.splits = 1;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. q (prescaled), k, v, dout and
// the outputs are [B, L, N, D] bf16 with unit stride on D, every other
// stride (in elements) a multiple of 8 and a 16-byte aligned base;
// `strides` holds 15 of them, for q, k, v, dout and the output(s),
// (b, l, n) each; dk and dv share theirs. m, l and delta are fp32
// [B, N, Lq] contiguous; klens is an int32 [B] device array or null. With
// splits > 1 the dKV query loop is cut into that many chunks, whose fp32
// partial sums go through `scratch` (2 x splits x B x Lk x N x D floats)
// and are summed in chunk order by a second kernel. Each launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* m, const void* l,
                                  const void* delta, void* dk, void* dv,
                                  const void* klens, int batch, int heads,
                                  int lq, int lk, int head_dim,
                                  const long long* strides, float dk_scale,
                                  int splits, void* scratch, void* stream) {
  if (head_dim != kD || splits < 1 || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k, v, dout, m, l, delta, klens, lq, lk, strides,
                         dk_scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.splits = splits;
  const long long elems = static_cast<long long>(batch) * lk * heads * kD;
  p.part_dk = static_cast<float*>(scratch);
  p.part_dv = p.part_dk + (splits > 1 ? splits * elems : 0);
  const int key_blocks = (lk + kBlockRows - 1) / kBlockRows;
  const int err = launch(flash_bwd_dkv_kernel, kDkvSmemBytes,
                         key_blocks * splits, heads, batch, p, stream);
  if (err != 0 || splits == 1 || elems == 0) return err;
  const long long quads = elems / 4;
  flash_bwd_dkv_reduce_kernel<<<static_cast<unsigned>((quads + 255) / 256),
                                256, 0, static_cast<cudaStream_t>(stream)>>>(
      p, heads, quads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* m, const void* l,
                                 const void* delta, void* dq,
                                 const void* klens, int batch, int heads,
                                 int lq, int lk, int head_dim,
                                 const long long* strides, float dq_scale,
                                 void* stream) {
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, m, l, delta, klens, lq, lk, strides,
                         dq_scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  return launch(flash_bwd_dq_kernel, kDqSmemBytes,
                (lq + kBlockRows - 1) / kBlockRows, heads, batch, p, stream);
}
