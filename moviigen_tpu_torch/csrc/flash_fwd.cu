// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernels of moviigen_tpu/ops/flash_attention.py:
//   flash_fwd_kernel<kPlain> <- _flash_kernel
//   flash_fwd_kernel<kStats> <- _flash_kernel_stats (the custom-VJP forward)
// launched by _flash_fwd through pl.pallas_call. Same function:
//   o = softmax_2(q' k^T) v,  q' = bf16(q * bf16(scale * log2 e)),
// non-causal, base-2 online softmax, keys at or past the per-batch k_len
// masked with -1e30 (their P is 0), P rounded to bf16 before the P.V
// product, rows whose normalizer is 0 divided by 1, output written in
// bf16. With kStats it also writes each row's running max m (base 2) and
// unguarded normalizer l, fp32 [B, N, Lq], from which the backward
// kernels (flash_bwd.cu) recompute P.
//
// flash_fwd_kernel<kCarry> is the ring's step (parallel/ring.py; the JAX
// ring merges the stats kernel's normalized partials instead,
// moviigen_tpu/parallel/ring.py:87-117): it resumes the online softmax from
// a running state kept in fp32 between launches, the unnormalized
// o = sum 2^(s - m) v [B, Lq, N, D] and m, l [B, N, Lq], runs its key loop
// over the held key shard, and writes the state back in place; the last
// launch of a ring writes the bf16 output and (m, l) as kStats does. Each
// thread reads and writes only its own rows' state (m is read by the four
// threads of a quad, written by the first), so the update has no race.
// Besides l, the state keeps each quad thread's own share of it (l_part,
// [B, N, Lq, 4]), which the next launch resumes from, so l is summed in
// the one-shot kernel's order. Chained over key shards it rounds each
// output to bf16 once, as the one-shot kernel does, not once per shard;
// in natural key order over shards of whole 128-key tiles it is the
// one-shot kernel, bit for bit. The state adds 2 x 4 bytes per output
// element to each launch's traffic (read and written): 160 MB at B = 2,
// 1,950 query rows and 40 heads.
//
// What bounds it: tensor-core operations. Self-attention does
// 4 * B * N * Lq * Lk * D flops on 4 * B * L * N * D * 2 bytes, about
// 2,000 flops per byte at L = 7,800, far above the card's ~295 flops per
// byte balance point; the 512-token text cross-attention still does
// ~240-1000. The published 989 TFLOP/s assume a clock this load does not
// keep: on an H100 SXM at its 700 W limit the kernel draws the full 700 W
// at 1.53-1.59 GHz, where the tensor cores peak near 132 x 4,096 x f =
// 830-860 TFLOP/s. Next to the products, each 128-key tile costs every
// row 128 exp2 on the special-function units (16 per clock per SM): half
// the time of the tile's products, unless the two overlap.
//
// What the design does about it:
// - Both products are wgmma on 128-byte-swizzled shared tiles
//   (flash_common.cuh): S = q' K^T reads q' and K from shared memory, both
//   K-major (m64n128k16); O += P V takes P from registers, where the
//   accumulator of S, packed to bf16, is the A fragment, and V MN-major
//   (the transposed-B flag). One 64-row wgmma reads each K and V tile once
//   for four warps.
// - A work item is 128 query rows of one (batch, head). Its block has two
//   consumer warpgroups of 64 rows, each holding its 64 x 128 fp32 output,
//   m and l in registers over the item's key loop, and one producer warp
//   that lands the item's Q tile by TMA and keeps a ring of three (K, V)
//   stages of 128 keys full, each stage with a full and an empty mbarrier,
//   walking only the tiles below k_len. setmaxnreg gives the consumers 240
//   registers and the producer 24. Shared memory: Q 32 KB + 3 x 64 KB, one
//   block per SM.
// - The grid is persistent: one block per SM walks the items w, w + grid,
//   ... and the producer lands the next item's Q and first (K, V) tiles
//   while the consumers finish and write the last one: 10-14 % faster
//   than one block per item with 512 keys (four tiles an item), the same
//   with many keys. Its blocks hold every SM until the kernel ends, so a
//   kernel on another stream (NCCL's) that becomes ready meanwhile waits
//   for the end. The ring's step can leave `spare_sms` SMs free while a
//   K/V shift is in flight (flash_fwd_carry_bf16): the grid is then
//   sms - spare_sms blocks. Which block walks an item never changes the
//   item's arithmetic, so the output is the same bits at any grid.
// - The consumers prescale their own rows of the Q tile in place
//   (bf16(q * c), one rounding, as the Pallas wrapper's bf16 multiply),
//   then fence the generic-proxy writes against wgmma's async-proxy reads
//   before a barrier of their warpgroup.
// - Overlap. Each loop step of a warpgroup issues S of tile j and P V of
//   tile j - 1 back to back, then runs the softmax of tile j while P V is
//   still in flight, and retires both before the step ends (nothing is in
//   flight across a loop edge, so ptxas keeps every wgmma asynchronous).
//   The two warpgroups take turns to issue their products (two named
//   barriers), so one warpgroup's softmax runs under the other's products.
//   Measured on an H100 at 7,800 tokens, without the turns the kernel is
//   16 % slower; a ring of two stages, where the next tile can land only
//   after P V of the last one retires, 30-40 % slower.
// - Ragged edges: TMA fills rows past Lq and Lk with zeros; keys between
//   k_len and the end of their tile arrive as they are and are masked in
//   the one tile that crosses k_len; a batch entry with k_len = 0 walks
//   no tile and writes zeros (m = -1e30, l = 0), or under kCarry its
//   state as it came. The caller passes
//   [B, L, N, D] views as they are: the tensor maps are built from their
//   strides at each launch.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = 128;                // query rows per block, keys per tile
constexpr int kWgRows = 64;               // query rows per consumer warpgroup
constexpr int kConsumers = kRows / kWgRows;
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's warpgroup
constexpr int kStages = 3;                // ring depth
constexpr int kHalf = kRows * 128;        // 128 rows x 64 bf16 columns
constexpr int kTile = 2 * kHalf;          // 128 rows x 128 columns: 32 KB
constexpr int kStageBytes = 2 * kTile;    // K and V
constexpr int kBarriers = 2 + 2 * kStages;  // Q full, empty; the same per stage
// Q + the ring + barriers; 1 KB more to start the tiles on a 1,024-byte
// boundary
constexpr int kSmemBytes =
    kTile + kStages * kStageBytes + kBarriers * 8 + 1024;
// registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 = 64,512
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
// named barriers: a consumer warpgroup's own (1, 2); consumer c's turn to
// issue its products (3, 4)
constexpr int kBarWarpgroup = 1;
constexpr int kBarTurn = 3;

// What a launch writes: the output (kPlain); the output, m and l (kStats);
// the carried state, or on a ring's last step what kStats writes (kCarry).
enum Variant { kPlain, kStats, kCarry };

struct Params {
  __nv_bfloat16* o;
  float* m;          // [B, N, Lq] row max (base 2): kStats, kCarry
  float* l;          // [B, N, Lq] softmax normalizer: kStats, kCarry
  float* acc;        // [B, Lq, N, D] unnormalized output: kCarry
  float* l_part;     // [B, N, Lq, 4] each quad thread's share of l: kCarry
  const int* klens;  // [B] or null
  int batch, heads, lq, lk;
  long long sob, sol, son;
  float qscale;      // bf16(scale * log2 e), as a float
  int first, last;   // kCarry: no state to read; write the output
  int l_part_in;     // kCarry: resume the shares from l_part, not from l
};

// A block's unit of work: 128 query rows m0 .. m0 + 127 of head h, batch
// b, and the keys below klen in n_tiles tiles. Work item w counts the row
// blocks fastest, so the blocks on the card at one time share a few heads'
// K and V in L2.
struct Item {
  int m0, h, b, klen, n_tiles;

  __device__ __forceinline__ Item(const Params& p, int w) {
    const int m_blocks = (p.lq + kRows - 1) / kRows;
    m0 = (w % m_blocks) * kRows;
    h = (w / m_blocks) % p.heads;
    b = w / m_blocks / p.heads;
    klen = p.klens != nullptr ? min(max(p.klens[b], 0), p.lk) : p.lk;
    n_tiles = (klen + kRows - 1) / kRows;
  }
};

// The block's shared memory: the Q tile, the ring, the barriers.
struct Smem {
  unsigned char* q_ptr;  // generic pointer to the Q tile
  uint32_t q, ring;      // shared addresses
  uint32_t bar_q, bar_q_empty, bar_full, bar_empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    q_ptr = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
    q = smem_u32(q_ptr);
    ring = q + kTile;
    bar_q = ring + kStages * kStageBytes;
    bar_q_empty = bar_q + 8;
    bar_full = bar_q_empty + 8;
    bar_empty = bar_full + 8 * kStages;
  }

  // One arrival fills the Q tile or a stage (the producer's, with the TMA
  // bytes); one lane of each consumer warp frees it.
  __device__ __forceinline__ void init_barriers() const {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
};

// Both halves of the 128-row tile at row `row` of head h, batch b.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const void* map,
                                              uint32_t bar, int h, int row,
                                              int b) {
  tma_load_half(dst, map, bar, 0, h, row, b);
  tma_load_half(dst + kHalf, map, bar, kD / 2, h, row, b);
}

// q' = bf16(q * c) in place for warpgroup wg's 64 rows of the Q tile (8 KB
// of each half), 16 bytes per thread and step; then the fence and the
// warpgroup's barrier that order the writes before its wgmma reads.
__device__ __forceinline__ void prescale_q(unsigned char* q, int wg, int tid,
                                           float c) {
  constexpr int kChunks = 2 * kWgRows * 128 / 16;
#pragma unroll
  for (int it = 0; it < kChunks / 128; ++it) {
    const int i = it * 128 + tid;
    const int half = i / (kChunks / 2);
    uint4* ptr = reinterpret_cast<uint4*>(
        q + half * kHalf + wg * kWgRows * 128 + (i % (kChunks / 2)) * 16);
    uint4 x = *ptr;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * c, f.y * c);
    }
    *ptr = x;
  }
  fence_proxy_async();
  bar_sync(kBarWarpgroup + wg, 128);
}

// The two consumer warpgroups take turns to issue their products: consumer
// wg waits for its turn, issues, then hands the turn to the other. In each
// work item the second consumer hands consumer 0 its first turn and keeps
// its own last one, so every barrier's arrivals are matched.
struct Turns {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 1) bar_arrive(kBarTurn, 2 * 128);
  }
  __device__ __forceinline__ void wait() const {
    bar_sync(kBarTurn + wg, 2 * 128);
  }
  __device__ __forceinline__ void pass(bool last) const {
    if (!(wg == 1 && last)) bar_arrive(kBarTurn + (wg ^ 1), 2 * 128);
  }
};

// s (64 x 128) = q'_wg K^T for the warpgroup's 64 rows at `sq` and the
// 128-key tile at `sk`.
__device__ __forceinline__ void issue_s(float (&s)[16][4], uint32_t sq,
                                        uint32_t sk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    wgmma_ss_n128(s, desc_k_major<kRows>(sq, ks), desc_k_major<kRows>(sk, ks),
                  ks > 0);
  }
  wgmma_commit();
}

// o = o * alpha + P V for the 128-key V tile at `sv`.
__device__ __forceinline__ void issue_pv(float (&o)[16][4],
                                         const uint32_t (&pf)[8][4],
                                         const float (&alpha)[2],
                                         uint32_t sv) {
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
    wgmma_rs_n128(o, pf[ks], desc_mn_major<kRows>(sv, ks));
  }
  wgmma_commit();
}

// Online softmax (base 2) of one tile for this thread's rows g and g + 8:
// keys at or past klen masked when the tile crosses it (key0 = the tile's
// first key + 2t); m_run, l_run updated, alpha = exp2(m_old - m_new), P
// left in s.
__device__ __forceinline__ void softmax(float (&s)[16][4],
                                        float (&m_run)[2], float (&l_run)[2],
                                        float (&alpha)[2], int key0, int klen,
                                        bool masked) {
  if (masked) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + c * 8 + (e & 1) >= klen) s[c][e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_run[r];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx = fmaxf(mx, fmaxf(s[c][2 * r], s[c][2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = exp2f(m_run[r] - mx);
    m_run[r] = mx;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2f(s[c][e] - m_run[e >> 1]);
      if (masked && key0 + c * 8 + (e & 1) >= klen) pe = 0.f;
      s[c][e] = pe;
    }
    lsum[0] += s[c][0] + s[c][1];
    lsum[1] += s[c][2] + s[c][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + lsum[r];
}

// P (fp32, in s) packed to bf16 as the A fragments of P V.
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4],
                                       const float (&s)[16][4]) {
#pragma unroll
  for (int c = 0; c < 16; ++c) pack_chunk(pf, c, s[c]);
}

// One work item for one consumer warpgroup: S, softmax and P V over the
// item's n_tiles key tiles, which are ring tiles it0 .. it0 + n_tiles - 1;
// frees the Q tile once its last S has landed. o, m_run, l_run come in
// zeroed, or holding a carried state (the first tile's alpha rescales it),
// and leave with the item's sums.
__device__ __forceinline__ void attend(const Smem& sm, const Item& x,
                                       int it0, int wg, int lane,
                                       float (&o)[16][4], float (&m_run)[2],
                                       float (&l_run)[2]) {
  const int t = lane % 4;
  const Turns turns{wg};
  const uint32_t sq = sm.q + wg * kWgRows * 128;  // this warpgroup's rows
  uint32_t pf[kRows / 16][4];
  float alpha[2];
  auto wait_full = [&](int j) {
    const int it = it0 + j;
    mbar_wait(sm.bar_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto free_slot = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto release = [&](int j) {
    free_slot(sm.bar_empty + 8 * ((it0 + j) % kStages));
  };
  auto tile_k = [&](int j) {
    return sm.ring + ((it0 + j) % kStages) * kStageBytes;
  };

  turns.start();
  // tile 0: S only (its alpha rescales o in the next P V)
  {
    float s[16][4];
    wait_full(0);
    turns.wait();
    issue_s(s, sq, tile_k(0));
    turns.pass(x.n_tiles == 1);
    wgmma_wait<0>();
    fence_acc(s);
    softmax(s, m_run, l_run, alpha, 2 * t, x.klen, kRows > x.klen);
    pack_p(pf, s);
  }
  // tile j: S of j and P V of j - 1 issued together; the softmax of j runs
  // while P V is in flight; both retire before the step ends, and only
  // then is P of j packed over the fragments P V was reading
  for (int j = 1; j < x.n_tiles; ++j) {
    float s[16][4];
    wait_full(j);
    turns.wait();
    issue_s(s, sq, tile_k(j));
    issue_pv(o, pf, alpha, tile_k(j - 1) + kTile);
    turns.pass(j == x.n_tiles - 1);
    wgmma_wait<1>();  // S has landed; P V may still be running
    fence_acc(s);
    const int n0 = j * kRows;
    softmax(s, m_run, l_run, alpha, n0 + 2 * t, x.klen, n0 + kRows > x.klen);
    wgmma_wait<0>();
    fence_acc(o);
    release(j - 1);
    pack_p(pf, s);
  }
  // every S has landed: the producer may land the next item's Q; then the
  // last tile's P V
  free_slot(sm.bar_q_empty);
  issue_pv(o, pf, alpha, tile_k(x.n_tiles - 1) + kTile);
  wgmma_wait<0>();
  fence_acc(o);
  release(x.n_tiles - 1);
}

// This thread's share of l summed over its quad, rows g and g + 8.
__device__ __forceinline__ void quad_sum(const float (&l_run)[2],
                                         float (&l_sum)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_sum[r] = l;
  }
}

// m and l of rows row0 and row0 + 8 (those below Lq), by the quad's first
// thread (m and l are the same on its four threads).
__device__ __forceinline__ void store_stats(const Params& p, const Item& x,
                                            int row0, int t,
                                            const float (&m_run)[2],
                                            const float (&l_sum)[2]) {
  if (t != 0) return;
  const long long base = (static_cast<long long>(x.b) * p.heads + x.h) * p.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r < p.lq) {
      p.m[base + row0 + 8 * r] = m_run[r];
      p.l[base + row0 + 8 * r] = l_sum[r];
    }
  }
}

// Normalise and write this thread's rows row0 and row0 + 8 of the item
// (those below Lq); kWithStats also m and the unguarded l, as the Pallas
// _flash_kernel_stats stores them.
template <bool kWithStats>
__device__ __forceinline__ void store_rows(const Params& p, const Item& x,
                                           int row0, int t,
                                           const float (&o)[16][4],
                                           const float (&m_run)[2],
                                           const float (&l_run)[2]) {
  float l_sum[2], l_fin[2];
  quad_sum(l_run, l_sum);
#pragma unroll
  for (int r = 0; r < 2; ++r) l_fin[r] = (l_sum[r] == 0.f) ? 1.f : l_sum[r];
  __nv_bfloat16* og = p.o + x.b * p.sob + x.h * p.son;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.sol + col) =
          __floats2bfloat162_rn(o[dt][0] / l_fin[0], o[dt][1] / l_fin[0]);
    }
    if (row1 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.sol + col) =
          __floats2bfloat162_rn(o[dt][2] / l_fin[1], o[dt][3] / l_fin[1]);
    }
  }
  if constexpr (kWithStats) store_stats(p, x, row0, t, m_run, l_sum);
}

// kCarry: this thread's elements of the state [B, Lq, N, D], row `row` of
// the item's head, columns col, col + 1.
__device__ __forceinline__ float2* acc_at(const Params& p, const Item& x,
                                          int row, int col) {
  return reinterpret_cast<float2*>(
      p.acc + ((static_cast<long long>(x.b) * p.lq + row) * p.heads + x.h) *
                  kD + col);
}

// kCarry: load this thread's rows of the carried state into the registers
// the key loop works on (the layout store_rows writes them in): o, m on
// the quad's four threads, and l_run, the thread's share of l that is
// summed over the quad at the end: its own from l_part where the last
// launch kept them (l_part_in), else l on the quad's first thread and 0 on
// the other three.
__device__ __forceinline__ void load_state(const Params& p, const Item& x,
                                           int row0, int t,
                                           float (&o)[16][4],
                                           float (&m_run)[2],
                                           float (&l_run)[2]) {
  const long long base = (static_cast<long long>(x.b) * p.heads + x.h) * p.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.lq) continue;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      const float2 v = *acc_at(p, x, row, dt * 8 + t * 2);
      o[dt][2 * r] = v.x;
      o[dt][2 * r + 1] = v.y;
    }
    m_run[r] = p.m[base + row];
    if (p.l_part_in) {
      l_run[r] = p.l_part[(base + row) * 4 + t];
    } else if (t == 0) {
      l_run[r] = p.l[base + row];
    }
  }
  __syncwarp();  // every read of m before the quad's first thread writes
}

// kCarry, not the ring's last step: the state back, unnormalized, with
// every thread's share of l.
__device__ __forceinline__ void store_state(const Params& p, const Item& x,
                                            int row0, int t,
                                            const float (&o)[16][4],
                                            const float (&m_run)[2],
                                            const float (&l_run)[2]) {
  float l_sum[2];
  quad_sum(l_run, l_sum);
  const long long base = (static_cast<long long>(x.b) * p.heads + x.h) * p.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.lq) continue;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *acc_at(p, x, row, dt * 8 + t * 2) =
          make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
    }
    p.l_part[(base + row) * 4 + t] = l_run[r];
  }
  store_stats(p, x, row0, t, m_run, l_sum);
}

// Block w of the grid takes work items w, w + gridDim.x, ... (one SM's
// worth of blocks, or one block per item).
template <Variant V>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, int items,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread lands each item's Q once the last one is
    // free, and keeps the ring full across items
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    int it = 0, qi = 0;  // ring tiles and Q tiles so far
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item x(p, w);
      if (x.n_tiles == 0) continue;
      mbar_wait(sm.bar_q_empty, (qi & 1) ^ 1);
      mbar_arrive_expect(sm.bar_q, kTile);
      tma_load_tile(sm.q, &map_q, sm.bar_q, x.h, x.m0, x.b);
      ++qi;
      for (int j = 0; j < x.n_tiles; ++j, ++it) {
        const int stage = it % kStages;
        mbar_wait(sm.bar_empty + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t full = sm.bar_full + 8 * stage;
        const uint32_t dst = sm.ring + stage * kStageBytes;
        mbar_arrive_expect(full, kStageBytes);
        tma_load_tile(dst, &map_k, full, x.h, j * kRows, x.b);
        tma_load_tile(dst + kTile, &map_v, full, x.h, j * kRows, x.b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each item
  setmaxnreg_inc<kConsumerRegs>();
  int it = 0, qi = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item x(p, w);
    const int row0 = x.m0 + wg * kWgRows + warp * 16 + lane / 4;
    float o[kD / 8][4];
    zero_acc(o);
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share; summed over the quad
    if constexpr (V == kCarry) {
      if (!p.first) load_state(p, x, row0, lane % 4, o, m_run, l_run);
    }
    // an item with no key (k_len 0) keeps what it holds: zeros, or the
    // carried state as it came
    if (x.n_tiles > 0) {
      mbar_wait(sm.bar_q, qi & 1);
      prescale_q(sm.q_ptr, wg, tid % 128, p.qscale);
      attend(sm, x, it, wg, lane, o, m_run, l_run);
      it += x.n_tiles;
      ++qi;
    }
    if (V == kCarry && !p.last) {
      store_state(p, x, row0, lane % 4, o, m_run, l_run);
    } else {
      store_rows<V != kPlain>(p, x, row0, lane % 4, o, m_run, l_run);
    }
  }
}

template <Variant V>
int launch(const Params& p, const void* q, const void* k, const void* v,
           int head_dim, const long long* st, void* stream,
           int spare_sms = 0) {
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.batch == 0 || p.heads == 0 || p.lq == 0) return 0;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, p.batch, p.lq, p.heads, st[0], st[1], st[2],
                kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.lk == 0) {  // no key to read: the kernel walks no tile
    map_k = map_v = map_q;
  } else if (!make_map(&map_k, k, p.batch, p.lk, p.heads, st[3], st[4],
                       st[5], kRows) ||
             !make_map(&map_v, v, p.batch, p.lk, p.heads, st[6], st[7],
                       st[8], kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one block per SM (a block fills one), each walking several items
  const int items = (p.lq + kRows - 1) / kRows * p.heads * p.batch;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min(items, max(1, sms - max(0, spare_sms)));
  flash_fwd_kernel<V><<<blocks, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      p, items, map_q, map_k, map_v);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(void* o, void* m, void* l, const void* klens, int batch,
                   int heads, int lq, int lk, long long sob, long long sol,
                   long long son, float qscale) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = nullptr;
  p.l_part = nullptr;
  p.first = 1;
  p.last = 1;
  p.l_part_in = 0;
  p.klens = static_cast<const int*>(klens);
  p.batch = batch;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.sob = sob; p.sol = sol; p.son = son;
  p.qscale = qscale;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Tensors are [B, L, N, D] bf16
// with unit stride on D, every other stride (in elements) a multiple of 8
// and a 16-byte aligned base; klens is an int32 [B] device array or null.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const void* klens, int batch,
                              int heads, int lq, int lk, int head_dim,
                              long long sqb, long long sql, long long sqn,
                              long long skb, long long skl, long long skn,
                              long long svb, long long svl, long long svn,
                              long long sob, long long sol, long long son,
                              float qscale, void* stream) {
  const long long st[9] = {sqb, sql, sqn, skb, skl, skn, svb, svl, svn};
  const Params p = make_params(o, nullptr, nullptr, klens, batch, heads, lq,
                               lk, sob, sol, son, qscale);
  return launch<kPlain>(p, q, k, v, head_dim, st, stream);
}

// The stats variant (replaces _flash_kernel_stats): also writes m and l,
// fp32 [B, N, Lq] contiguous.
extern "C" int flash_fwd_stats_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    const void* klens, int batch, int heads, int lq, int lk, int head_dim,
    long long sqb, long long sql, long long sqn, long long skb,
    long long skl, long long skn, long long svb, long long svl,
    long long svn, long long sob, long long sol, long long son,
    float qscale, void* stream) {
  const long long st[9] = {sqb, sql, sqn, skb, skl, skn, svb, svl, svn};
  const Params p = make_params(o, m, l, klens, batch, heads, lq, lk, sob, sol,
                               son, qscale);
  return launch<kStats>(p, q, k, v, head_dim, st, stream);
}

// The ring's step (kCarry): the state acc (fp32 [B, Lq, N, D]), m, l
// (fp32 [B, N, Lq]) and l's shares l_part (fp32 [B, N, Lq, 4]), all
// contiguous, read unless `first` (l_part only with `l_part_in`; else the
// shares start from l) and written back in place; with `last`, o (bf16) =
// acc / l (1 where l = 0) and the final m, l instead of the state's acc
// and l_part (null there). The grid leaves `spare_sms` SMs free (0: a
// block on every SM).
extern "C" int flash_fwd_carry_bf16(
    const void* q, const void* k, const void* v, void* o, void* acc,
    void* m, void* l, void* l_part, const void* klens, int batch, int heads,
    int lq, int lk, int head_dim, long long sqb, long long sql,
    long long sqn, long long skb, long long skl, long long skn,
    long long svb, long long svl, long long svn, long long sob,
    long long sol, long long son, float qscale, int first, int last,
    int l_part_in, int spare_sms, void* stream) {
  const long long st[9] = {sqb, sql, sqn, skb, skl, skn, svb, svl, svn};
  Params p = make_params(o, m, l, klens, batch, heads, lq, lk, sob, sol, son,
                         qscale);
  p.acc = static_cast<float*>(acc);
  p.l_part = static_cast<float*>(l_part);
  p.first = first;
  p.last = last;
  p.l_part_in = l_part_in;
  return launch<kCarry>(p, q, k, v, head_dim, st, stream, spare_sms);
}
