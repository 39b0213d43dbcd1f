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
// far above the card's ~295 balance point.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16 bf16 -> fp32, ldmatrix from padded shared rows) and
// the L x L matrices P, dP and dS never leave the SM.
// - dKV: one block of 4 warps owns 64 keys of one (batch, head) and loops
//   over query tiles of 64 rows, double-buffered with cp.async. Each warp
//   computes its 16 keys' rows of S^T = K q'^T and dP^T = V dO^T, so P^T
//   and dS^T land in C fragments that are, packed to bf16, the A
//   fragments of dV += P^T dO and dK += dS^T q'; the two 16 x 128 fp32
//   accumulators stay in registers for the whole loop.
// - dQ: one block of 4 warps owns 64 query rows and loops over key tiles
//   of 64, double-buffered; each warp keeps its rows' m, 1/l, Delta and
//   the 16 x 128 fp32 dQ accumulator in registers.
// The split is the Pallas one: each output tile is owned by one block, so
// nothing is summed across blocks and the gradients are the same bits
// from run to run. Query rows past Lq get P = 0 (the Pallas version pads
// them with m = +1e30); a key tile wholly past k_len writes zeros to dK
// and dV. The caller passes [B, L, N, D] views through their strides.
// Not yet used: wgmma, TMA, warp specialisation.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;               // rows per tile, queries and keys
constexpr int kWarps = 4;               // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 32;                // dKV: query rows per inner step
constexpr int kTileElems = kTile * kLds;
// dKV: K, V + 2 x (q', dO) tiles + 2 x (m, 1/l, Delta) rows
constexpr int kDkvSmemBytes = 6 * kTileElems * 2 + 2 * 3 * kTile * 4;
// dQ: q', dO + 2 x (K, V) tiles
constexpr int kDqSmemBytes = 6 * kTileElems * 2;

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

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ = sV + kTileElems;        // two buffers
  __nv_bfloat16* sDO = sQ + 2 * kTileElems;   // two buffers
  float* sStat = reinterpret_cast<float*>(sDO + 2 * kTileElems);
  // sStat[buf * 3 * kTile + {0, kTile, 2 kTile} + row]: m, 1/l, Delta

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int klen = key_len(p, b);

  __nv_bfloat16* dkg = p.dk + b * p.sgb + h * p.sgn;
  __nv_bfloat16* dvg = p.dv + b * p.sgb + h * p.sgn;
  const int wkey = warp * 16;  // this warp's keys within the tile

  if (n0 >= klen) {  // every key masked: the gradients are zero
    const float zero[kD / 8][4] = {};
    store_rows_bf16(dkg, p.sgl, zero, n0 + wkey, p.lk, 1.f, lane);
    store_rows_bf16(dvg, p.sgl, zero, n0 + wkey, p.lk, 1.f, lane);
    return;
  }

  const __nv_bfloat16* qg = p.q + b * p.sqb + h * p.sqn;
  const __nv_bfloat16* dog = p.dout + b * p.sdob + h * p.sdon;
  const long long sbase = (static_cast<long long>(b) * gridDim.y + h) * p.lq;

  load_tile<kTile, kThreads>(sK, p.k + b * p.skb + h * p.skn, p.skl, n0, klen,
                             tid);
  load_tile<kTile, kThreads>(sV, p.v + b * p.svb + h * p.svn, p.svl, n0, klen,
                             tid);
  auto load_q = [&](int tile, int buf) {
    load_tile<kTile, kThreads>(sQ + buf * kTileElems, qg, p.sql, tile * kTile,
                               p.lq, tid);
    load_tile<kTile, kThreads>(sDO + buf * kTileElems, dog, p.sdol,
                               tile * kTile, p.lq, tid);
  };
  const int n_qt = (p.lq + kTile - 1) / kTile;
  load_q(0, 0);
  cp_async_commit();
  if (tid < kTile) {
    float m, linv, delta;
    row_stats(p, sbase, tid, m, linv, delta);
    sStat[tid] = m;
    sStat[kTile + tid] = linv;
    sStat[2 * kTile + tid] = delta;
  }

  float acc_dk[kD / 8][4], acc_dv[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[dt][e] = 0.f;
      acc_dv[dt][e] = 0.f;
    }
  }
  const bool key_masked = n0 + kTile > klen;

  for (int j = 0; j < n_qt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_qt) load_q(j + 1, buf ^ 1);
    cp_async_commit();
    // the next tile's stats, fetched now and stored after this tile's math
    float nm = 0.f, nlinv = 0.f, ndelta = 0.f;
    if (j + 1 < n_qt && tid < kTile) {
      row_stats(p, sbase, (j + 1) * kTile + tid, nm, nlinv, ndelta);
    }
    cp_async_wait<1>();  // tile j (and K, V) have landed
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + buf * kTileElems;
    const __nv_bfloat16* cDO = sDO + buf * kTileElems;
    const float* cM = sStat + buf * 3 * kTile;
    const float* cLinv = cM + kTile;
    const float* cDelta = cM + 2 * kTile;

#pragma unroll
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int qs0 = sub * kSub;
      // ---- S^T = K q'^T and dP^T = V dO^T: 16 keys x 32 query rows
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = 0.f;
          dp[nt][e] = 0.f;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        uint32_t ka[4], va[4];
        load_a(ka, sK, wkey, ks * 16, lane);
        load_a(va, sV, wkey, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t qb[4], db[4];
          load_b_rows(qb, cQ, qs0 + np * 16, ks * 16, lane);
          load_b_rows(db, cDO, qs0 + np * 16, ks * 16, lane);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, db[0], db[1]);
          mma_bf16(dp[2 * np + 1], va, db[2], db[3]);
        }
      }

      // ---- P^T and dS^T, packed as A fragments (16 keys x 16 rows each)
      uint32_t pf[kSub / 16][4], dsf[kSub / 16][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qs0 + nt * 8 + t * 2 + (e & 1);  // query row in tile
          const int key = n0 + wkey + g + (e >> 1) * 8;
          float pe = exp2f(s[nt][e] - cM[row]) * cLinv[row];
          if (key_masked && key >= klen) pe = 0.f;
          pv[e] = pe;
          dsv[e] = pe * (dp[nt][e] - cDelta[row]);
        }
        const int ks = nt / 2;
        const int half = (nt % 2) * 2;
        // C rows are keys (g, g + 8), columns are query rows: e = 0, 1 is
        // key g, e = 2, 3 is key g + 8
        pf[ks][half] = pack_bf16(pv[0], pv[1]);
        pf[ks][half + 1] = pack_bf16(pv[2], pv[3]);
        dsf[ks][half] = pack_bf16(dsv[0], dsv[1]);
        dsf[ks][half + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // ---- dV += P^T dO, dK += dS^T q' (16 keys x 128 dims)
#pragma unroll
      for (int ks = 0; ks < kSub / 16; ++ks) {
#pragma unroll
        for (int dd = 0; dd < kD / 16; ++dd) {
          uint32_t db[4], qb[4];
          load_b_cols(db, cDO, qs0 + ks * 16, dd * 16, lane);
          load_b_cols(qb, cQ, qs0 + ks * 16, dd * 16, lane);
          mma_bf16(acc_dv[2 * dd], pf[ks], db[0], db[1]);
          mma_bf16(acc_dv[2 * dd + 1], pf[ks], db[2], db[3]);
          mma_bf16(acc_dk[2 * dd], dsf[ks], qb[0], qb[1]);
          mma_bf16(acc_dk[2 * dd + 1], dsf[ks], qb[2], qb[3]);
        }
      }
    }

    if (j + 1 < n_qt && tid < kTile) {
      float* nM = sStat + (buf ^ 1) * 3 * kTile;
      nM[tid] = nm;
      nM[kTile + tid] = nlinv;
      nM[2 * kTile + tid] = ndelta;
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

  store_rows_bf16(dkg, p.sgl, acc_dk, n0 + wkey, p.lk, p.out_scale, lane);
  store_rows_bf16(dvg, p.sgl, acc_dv, n0 + wkey, p.lk, 1.f, lane);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kTileElems;
  __nv_bfloat16* sK = sDO + kTileElems;  // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;  // two buffers

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int klen = key_len(p, b);
  const int n_tiles = (klen + kTile - 1) / kTile;
  const int wrow = warp * 16;

  const __nv_bfloat16* kg = p.k + b * p.skb + h * p.skn;
  const __nv_bfloat16* vg = p.v + b * p.svb + h * p.svn;
  load_tile<kTile, kThreads>(sQ, p.q + b * p.sqb + h * p.sqn, p.sql, m0, p.lq,
                             tid);
  load_tile<kTile, kThreads>(sDO, p.dout + b * p.sdob + h * p.sdon, p.sdol, m0,
                             p.lq, tid);
  cp_async_commit();
  auto load_kv = [&](int tile, int buf) {
    load_tile<kTile, kThreads>(sK + buf * kTileElems, kg, p.skl, tile * kTile,
                               klen, tid);
    load_tile<kTile, kThreads>(sV + buf * kTileElems, vg, p.svl, tile * kTile,
                               klen, tid);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16
  const long long sbase = (static_cast<long long>(b) * gridDim.y + h) * p.lq;
  float rm[2], rlinv[2], rdelta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_stats(p, sbase, m0 + wrow + g + r * 8, rm[r], rlinv[r], rdelta[r]);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // q', dO and tile j have landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + buf * kTileElems;
    const __nv_bfloat16* cV = sV + buf * kTileElems;

    // ---- S = q' K^T and dP = dO V^T: 16 rows x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        dp[nt][e] = 0.f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, wrow, ks * 16, lane);
      load_a(da, sDO, wrow, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kb[4], vb[4];
        load_b_rows(kb, cK, np * 16, ks * 16, lane);
        load_b_rows(vb, cV, np * 16, ks * 16, lane);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }

    // ---- dS as A fragments (16 rows x 16 keys per k-step)
    const int n0 = j * kTile;
    const bool masked = n0 + kTile > klen;
    uint32_t dsf[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = exp2f(s[nt][e] - rm[r]) * rlinv[r];
        if (masked && n0 + nt * 8 + t * 2 + (e & 1) >= klen) pe = 0.f;
        dsv[e] = pe * (dp[nt][e] - rdelta[r]);
      }
      const int ks = nt / 2;
      const int half = (nt % 2) * 2;
      dsf[ks][half] = pack_bf16(dsv[0], dsv[1]);
      dsf[ks][half + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // ---- dQ += dS K (16 rows x 128 dims)
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int dd = 0; dd < kD / 16; ++dd) {
        uint32_t kb[4];
        load_b_cols(kb, cK, ks * 16, dd * 16, lane);
        mma_bf16(acc[2 * dd], dsf[ks], kb[0], kb[1]);
        mma_bf16(acc[2 * dd + 1], dsf[ks], kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }
  cp_async_wait<0>();  // with no key tile, q' and dO were never waited for

  store_rows_bf16(p.dq + b * p.sgb + h * p.sgn, p.sgl, acc, m0 + wrow, p.lq,
                  p.out_scale, lane);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int tiles, int heads, int batch,
           const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || heads == 0 || tiles == 0) return 0;
  dim3 grid(tiles, heads, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
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
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. q (prescaled), k, v, dout and
// the outputs are [B, L, N, D] bf16 with unit stride on D and every other
// stride (in elements) a multiple of 8; `strides` holds 15 of them, for
// q, k, v, dout and the output(s), (b, l, n) each; dk and dv share theirs.
// m, l and delta are fp32 [B, N, Lq] contiguous; klens is an int32 [B]
// device array or null. Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* m, const void* l,
                                  const void* delta, void* dk, void* dv,
                                  const void* klens, int batch, int heads,
                                  int lq, int lk, int head_dim,
                                  const long long* strides, float dk_scale,
                                  void* stream) {
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, m, l, delta, klens, lq, lk, strides,
                         dk_scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return launch(flash_bwd_dkv_kernel, kDkvSmemBytes,
                (lk + kTile - 1) / kTile, heads, batch, p, stream);
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
  return launch(flash_bwd_dq_kernel, kDqSmemBytes, (lq + kTile - 1) / kTile,
                heads, batch, p, stream);
}
