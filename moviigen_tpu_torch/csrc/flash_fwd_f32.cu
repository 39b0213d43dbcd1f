// Flash-attention forward in fp32 for Hopper (sm_90a): the CLIP tower's
// attention, on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel moviigen_tpu/ops/flash_attention.py:124
// _flash_kernel (launched by _flash_fwd through pl.pallas_call at :235)
// where it runs in fp32: the ViT-H/14 image tower of i2v calls it with
// compute_dtype = the fp32 activations (moviigen_tpu/models/clip.py:87-88),
// at [B, 257, 16, 80] (CLS + 16 x 16 patches, head_dim 80), 31 times per
// image. Same function as the Pallas kernel and flash_fwd.cu:
//   o = softmax_2(q' k^T) v,  q' = q * fp32(scale * log2 e),
// non-causal, base-2 online softmax, keys at or past the per-batch k_len
// get P = 0, rows whose normalizer is 0 divided by 1, fp32 in and out.
//
// What bounds it. At the CLIP shape one call does 4 * B * N * Lq * Lk * D
// = 0.34 GFLOP on 5.3 MB (q, k, v read once, o written once). On fp32
// FMAs that is 0.34 GFLOP / 67e12 = 5.05 us; in 3xTF32 on the tensor cores
// (three products for each) 1.02 GFLOP / 495e12 = 2.06 us; the bytes take
// 5.3 MB / 3.35e12 = 1.6 us. The first design (fp32 FMAs,
// tools/flash_fwd_f32_simple.cu) reached ~4 % of its bound: 80 blocks for
// 132 SMs, one shared load per two FMAs, two shuffles per key, each exp2
// computed four times, loads between barriers, no tensor cores.
//
// The design:
// - 3xTF32 (CUTLASS's OpMultiplyAddFastF32). Each fp32 operand x becomes
//   big = tf32(x) (to nearest) and small = x - big (exact in fp32; the
//   tensor cores read its top 19 bits, tf32 toward zero); a product is
//   big * small + small * big + big * big, accumulated in fp32 by mma.sync
//   m16n8k8 tf32. What it drops (small * small, the low bits of small) is
//   ~2^-21 of each product, fp32's own order, where one TF32 pass keeps
//   2^-11. Both products use it: S = q' k^T and O = P V (P split after the
//   exp2). q' is split once, into each row warp's fragments in shared
//   memory (138 registers a thread at D = 80, no spills at any D). S keeps
//   its two small cross terms in an accumulator of their own, which gives
//   the tensor cores twice as many independent chains.
// - Fragments with no shuffles. The reduction index of each product is
//   permuted inside each 8-wide step: the mma's k = t and k = t + 4 stand
//   for d (or key) 2t and 2t + 1. Then a thread's q' and K fragments are
//   one float2 each, and the accumulator of S (columns 2t, 2t + 1 of rows
//   g, g + 8) is exactly the thread's A fragment of P for P V.
// - A grid that fills the card: one block per (32 query rows, head,
//   batch), 4 warps: two take 16 rows each, and each of those splits every
//   K/V tile with a second warp that takes the other 32 keys. At the CLIP
//   shape that is 9 x 16 = 144 blocks of 4 warps for 132 SMs. The two key
//   halves are merged once after the key loop through shared memory
//   (their row max, normalizer and output).
// - A K/V ring in shared memory: 2 stages of 64-key tiles, filled by
//   16-byte cp.async (keys at or past k_len zero-filled) while the tile
//   before is in the products. Rows are padded against bank conflicts: K's
//   stride is 8 or 24 (mod 32) floats for its float2 loads, V's 4 or 12
//   (mod 16) for its scalar ones; a stage is 44 KB at D = 80 (with q', 108
//   KB a block), so 2 blocks fit an SM. q, k and v are read in place
//   through their strides (the CLIP's are views of one fused to_qkv output
//   [B, L, 3, N, D]).
// - The softmax in FA2 form: row max by a quad shuffle over the
//   accumulator layout, one exp2f per score, the normalizer kept per
//   thread and summed over the quad once at the end.
// - Work with no valid key is skipped: a key slice past k_len, and the
//   8-key steps past it (the 257-key case leaves one key in its last tile).
//   A batch entry with k_len = 0 gives zeros. Rows past Lq compute on
//   zeros and are not stored.
// Why not wgmma: the whole call is ~2 us of TF32 work even at the card's
// peak, and wgmma takes tf32 operands only K-major, which would force a
// transposed, doubled (big / small) copy of V in shared memory. Measured
// (tools/flash_fwd_f32_probe.py, H100 SXM, 700 W): ~20 us a call at the
// CLIP shape against fp32 SDPA's ~31; dropping a third of the products
// (one TF32 pass in S) saves under a fifth of that, and a build with no
// products still takes ~8 us (launch, the ring, the merge), so the
// products do not bound it alone. Of 64-row blocks, no key split, four
// key warps, 32-key tiles and 3- or 4-stage rings none was faster at both
// of chip_smoke.py's fp32 shapes (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 2;                // 16 query rows each
constexpr int kKeyWarps = 2;                // each takes a slice of a tile
constexpr int kRows = 16 * kRowWarps;       // query rows per block
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kSliceKeys = kKeys / kKeyWarps;
constexpr int kSliceSteps = kSliceKeys / 8;  // 8-key steps per slice
constexpr int kStages = 2;
constexpr int kThreads = 32 * kRowWarps * kKeyWarps;
// at least 12 warps an SM: at most 170 registers a thread
constexpr int kMinBlocks = (384 + kThreads - 1) / kThreads;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const int* klens;  // [B] or null
  int lq, lk;
  long long sqb, sql, sqn, skb, skl, skn, svb, svl, svn, sob, sol, son;
  float qscale;      // fp32(scale * log2 e)
};

// Shared memory, in floats: the ring (and over it, after the key loop,
// each key warp's partial rows for the merge), then the row warps' split
// q' fragments.
template <int kD>
struct Smem {
  static constexpr int kStrideK = kD + (kD % 16 == 0 ? 8 : 0);
  static constexpr int kStrideV = kD + 4;
  static constexpr int kStage = kKeys * (kStrideK + kStrideV);
  static constexpr int kPartial = kD / 2 + 4;  // o, m, l of one lane
  static constexpr int kMerge = (kKeyWarps - 1) * kRowWarps * 32 * kPartial;
  static constexpr int kRing =
      kStages * kStage > kMerge ? kStages * kStage : kMerge;
  static constexpr int kQ = 32 * kD;  // a row warp's: kD / 8 x 2 x 32 x 4
  static constexpr int kFloats = kRing + kRowWarps * kQ;
};

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), as fp32
// bits: what cvt.rna.tf32.f32 gives, on the integer pipe.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big = tf32(x) to nearest; small = x - big (exact in fp32), of which the
// tensor cores read the top 19 bits (tf32 toward zero)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp's step over its slice of a K/V tile: 16 query rows against
// kSliceKeys keys, of which the first nv are valid (kFull: all of them).
// sk, sv: the slice's first K and V rows in shared memory; qf: the row
// warp's q' fragments, big and small of k-step s at (2s, 2s + 1) x 32 +
// lane.
template <int kD, bool kFull>
__device__ __forceinline__ void slice_step(
    const float* sk, const float* sv, const uint4* qf, int nv, int lane,
    float (&o)[kD / 8][4], float (&m)[2], float (&l)[2]) {
  using L = Smem<kD>;
  constexpr int kSteps = kD / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int steps = kFull ? kSliceSteps : (nv + 7) / 8;

  // S = q' K^T: b0 = K[key 8n + g][d 8s + 2t], b1 = the next d
  float sb[kSliceSteps][4], ss[kSliceSteps][4];
#pragma unroll
  for (int n = 0; n < kSliceSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sb[n][i] = ss[n][i] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint4 b4 = qf[(2 * s) * 32 + lane];
    const uint4 s4 = qf[(2 * s + 1) * 32 + lane];
    const uint32_t qb[4] = {b4.x, b4.y, b4.z, b4.w};
    const uint32_t qs[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int n = 0; n < kSliceSteps; ++n) {
      if (kFull || n < steps) {
        const float2 x = *reinterpret_cast<const float2*>(
            sk + (8 * n + g) * L::kStrideK + 8 * s + 2 * t);
        uint32_t bb0, bb1, bs0, bs1;
        split(x.x, bb0, bs0);
        split(x.y, bb1, bs1);
        mma(ss[n], qs, bb0, bb1);
        mma(ss[n], qb, bs0, bs1);
        mma(sb[n], qb, bb0, bb1);
      }
    }
  }

  // the online softmax over the accumulator layout: element i of step n
  // is row g + 8 (i / 2), key 8n + 2t + (i % 2)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kSliceSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = kFull || 8 * n + 2 * t + (i & 1) < nv;
      sb[n][i] = valid ? sb[n][i] + ss[n][i] : kNegInf;
      mx[i >> 1] = fmaxf(mx[i >> 1], sb[n][i]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_next = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_next);
    m[r] = m_next;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[s][i] *= alpha[i >> 1];
  }
#pragma unroll
  for (int n = 0; n < kSliceSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = kFull || 8 * n + 2 * t + (i & 1) < nv;
      sb[n][i] = valid ? exp2f(sb[n][i] - m[i >> 1]) : 0.f;
      l[i >> 1] += sb[n][i];
    }
  }

  // O += P V: a = P at (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
  // of the step, b0 = V[key 8n + 2t][d 8s + g], b1 = V[key 8n + 2t + 1]
#pragma unroll
  for (int n = 0; n < kSliceSteps; ++n) {
    if (kFull || n < steps) {
      uint32_t pb[4], ps[4];
      split(sb[n][0], pb[0], ps[0]);
      split(sb[n][2], pb[1], ps[1]);
      split(sb[n][1], pb[2], ps[2]);
      split(sb[n][3], pb[3], ps[3]);
      const float* vr = sv + (8 * n + 2 * t) * L::kStrideV + g;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t bb0, bb1, bs0, bs1;
        split(vr[8 * s], bb0, bs0);
        split(vr[L::kStrideV + 8 * s], bb1, bs1);
        mma(o[s], ps, bb0, bb1);
        mma(o[s], pb, bs0, bs1);
        mma(o[s], pb, bb0, bb1);
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_f32_kernel(Params p) {
  using L = Smem<kD>;
  constexpr int kSteps = kD / 8;  // k-steps of S, 8-wide tiles of O
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rw = (tid >> 5) % kRowWarps;  // which 16 rows
  const int kw = (tid >> 5) / kRowWarps;  // which slice of each tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows + rw * 16 + g;  // and row0 + 8
  int klen = p.lk;
  if (p.klens != nullptr) klen = min(max(p.klens[b], 0), p.lk);
  const int tiles = (klen + kKeys - 1) / kKeys;

  const float* kbase = p.k + b * p.skb + h * p.skn;
  const float* vbase = p.v + b * p.svb + h * p.svn;
  auto load_tile = [&](int tile) {
    float* sk = smem + (tile % kStages) * L::kStage;
    float* sv = sk + kKeys * L::kStrideK;
    constexpr int kChunks = kD / 4;  // 16-byte chunks per row
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks;
      const int c = 4 * (e % kChunks);
      const int key = tile * kKeys + j;
      const bool valid = key < klen;
      const long long at = valid ? key : 0;  // a valid address either way
      cp_async16(sk + j * L::kStrideK + c, kbase + at * p.skl + c, valid);
      cp_async16(sv + j * L::kStrideV + c, vbase + at * p.svl + c, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s);
    cp_async_commit();
  }

  // q' split into the row warp's fragments in shared memory, by its first
  // key warp (visible to the others after the key loop's first barrier):
  // a0 / a2 = row g at d 8s + 2t / 2t + 1, a1 / a3 the same of row g + 8
  uint4* qf = reinterpret_cast<uint4*>(smem + L::kRing + rw * L::kQ);
  if (kw == 0) {
    const float* qbase = p.q + b * p.sqb + h * p.sqn;
    float2 x[2][kSteps];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool live = row < p.lq;
      const float* qrow = qbase + (long long)(live ? row : 0) * p.sql;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        x[r][s] = make_float2(0.f, 0.f);
        if (live) {
          x[r][s] = *reinterpret_cast<const float2*>(qrow + 8 * s + 2 * t);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        split(__fmul_rn(x[r][s].x, p.qscale), big[r], small[r]);
        split(__fmul_rn(x[r][s].y, p.qscale), big[r + 2], small[r + 2]);
      }
      qf[(2 * s) * 32 + lane] = make_uint4(big[0], big[1], big[2], big[3]);
      qf[(2 * s + 1) * 32 + lane] =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  }

  float o[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[s][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // rows g, g + 8, base 2
  float l[2] = {0.f, 0.f};          // this thread's share of the normalizer

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    // the tile is in, and every warp is done with the stage refilled next
    __syncthreads();
    if (tile + kStages - 1 < tiles) load_tile(tile + kStages - 1);
    cp_async_commit();

    const int nv = min(max(klen - tile * kKeys - kw * kSliceKeys, 0),
                       kSliceKeys);
    const float* sk = smem + (tile % kStages) * L::kStage
                      + kw * kSliceKeys * L::kStrideK;
    const float* sv = smem + (tile % kStages) * L::kStage
                      + kKeys * L::kStrideK + kw * kSliceKeys * L::kStrideV;
    if (nv == kSliceKeys) {
      slice_step<kD, true>(sk, sv, qf, nv, lane, o, m, l);
    } else if (nv > 0) {
      slice_step<kD, false>(sk, sv, qf, nv, lane, o, m, l);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // merge the key slices: each warp past the first leaves its rows' m, l
  // and o in shared memory (over the ring), the first folds them in
  if (kKeyWarps > 1) {
    cp_async_wait<0>();
    __syncthreads();
    if (kw > 0) {
      float* x = smem + ((kw - 1) * kRowWarps + rw) * 32 * L::kPartial;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[(4 * s + i) * 32 + lane] = o[s][i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[(kD / 2 + r) * 32 + lane] = m[r];
        x[(kD / 2 + 2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (kw > 0) return;
    for (int w = 1; w < kKeyWarps; ++w) {
      const float* x = smem + ((w - 1) * kRowWarps + rw) * 32 * L::kPartial;
      float a[2], a2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m2 = x[(kD / 2 + r) * 32 + lane];
        const float m_next = fmaxf(m[r], m2);
        a[r] = exp2f(m[r] - m_next);
        a2[r] = exp2f(m2 - m_next);
        m[r] = m_next;
        l[r] = l[r] * a[r] + x[(kD / 2 + 2 + r) * 32 + lane] * a2[r];
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[s][i] = o[s][i] * a[i >> 1]
                    + x[(4 * s + i) * 32 + lane] * a2[i >> 1];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.lq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow = p.o + b * p.sob + (long long)row * p.sol + h * p.son;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      *reinterpret_cast<float2*>(orow + 8 * s + 2 * t) =
          make_float2(o[s][2 * r] * inv, o[s][2 * r + 1] * inv);
    }
  }
}

template <int kD>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = Smem<kD>::kFloats * static_cast<int>(sizeof(float));
  static bool configured = false;  // the attribute is set once per kD
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch to report
      return static_cast<int>(err);
    }
    configured = true;
  }
  const dim3 grid((p.lq + kRows - 1) / kRows, heads, batch);
  flash_fwd_f32_kernel<kD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain C entry point (ctypes). q, k, v: fp32 [B, L, N, D] with unit
// stride on D, the other strides (in elements) multiples of 4 and the
// bases 16-byte aligned (16-byte cp.async); o: fp32 [B, Lq, N, D] likewise;
// klens: an int32 [B] device array or null. head_dim: a multiple of 8 up
// to 128. Returns the CUDA error of the launch (0 on success; 1 for a head
// dim it does not take).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, const void* klens, int batch, int heads,
                             int lq, int lk, int head_dim, long long sqb,
                             long long sql, long long sqn, long long skb,
                             long long skl, long long skn, long long svb,
                             long long svl, long long svn, long long sob,
                             long long sol, long long son, float qscale,
                             void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.klens = static_cast<const int*>(klens);
  p.lq = lq;
  p.lk = lk;
  p.sqb = sqb; p.sql = sql; p.sqn = sqn;
  p.skb = skb; p.skl = skl; p.skn = skn;
  p.svb = svb; p.svl = svl; p.svn = svn;
  p.sob = sob; p.sol = sol; p.son = son;
  p.qscale = qscale;
  if (lq == 0 || batch == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define MOVIIGEN_F32_CASE(D) \
    case D: return launch<D>(p, batch, heads, s);
    MOVIIGEN_F32_CASE(8) MOVIIGEN_F32_CASE(16) MOVIIGEN_F32_CASE(24)
    MOVIIGEN_F32_CASE(32) MOVIIGEN_F32_CASE(40) MOVIIGEN_F32_CASE(48)
    MOVIIGEN_F32_CASE(56) MOVIIGEN_F32_CASE(64) MOVIIGEN_F32_CASE(72)
    MOVIIGEN_F32_CASE(80) MOVIIGEN_F32_CASE(88) MOVIIGEN_F32_CASE(96)
    MOVIIGEN_F32_CASE(104) MOVIIGEN_F32_CASE(112) MOVIIGEN_F32_CASE(120)
    MOVIIGEN_F32_CASE(128)
#undef MOVIIGEN_F32_CASE
    default: return 1;
  }
}
