// The fp32 flash forward's first design (fp32 FMA), kept as the yardstick
// that chip_smoke.py and tools/flash_fwd_f32_probe.py time beside the
// Hopper design in moviigen_tpu_torch/csrc/flash_fwd_f32.cu. It exports the
// same C entry point with the same arguments and computes the same
// function; kernels.use("flash_fwd_f32", chip_smoke.F32_BEFORE_SOURCE)
// makes the port's wrapper call it. The port never does.
//
//   o = softmax_2(q' k^T) v,  q' = q * fp32(scale * log2 e),
// non-causal, base-2 online softmax, keys at or past the per-batch k_len
// masked (their P is 0), every product and sum a full fp32 FMA, rows whose
// normalizer is 0 divided by 1.
//
// One block per (64 query rows, head, batch), 256 threads: four threads
// per query row, each holding an interleaved quarter of the row's D
// (float2 chunks t, t + 4, t + 8, ...) of q' and of the fp32 output
// accumulator in registers. A dot product q' . k_j is four partial sums
// joined by two warp shuffles, which gives all four threads the same
// bits. K and V tiles of 64 keys are staged in shared memory between two
// barriers; keys at or past min(k_len, Lk) are not read (zeros in shared
// memory) and get P = 0. q, k and v are read in place through their
// strides. Rows past Lq compute on zeros and are not stored.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr int kParts = 4;      // threads per query row
constexpr int kThreads = kRows * kParts;
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

// kD: the head dim, a multiple of 8 up to 128. Each thread owns kC = kD / 8
// float2 chunks of a row: chunk i of part t is d = 2 * (t + 4 * i).
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Params p) {
  constexpr int kC = kD / 8;
  extern __shared__ float2 smem[];
  float2* sk = smem;                      // [kKeys][kD / 2]
  float2* sv = smem + kKeys * (kD / 2);   // [kKeys][kD / 2]

  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int row = blockIdx.x * kRows + tid / kParts;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = row < p.lq;
  int klen = p.lk;
  if (p.klens != nullptr) klen = min(max(p.klens[b], 0), p.lk);

  float2 q[kC];
  float2 acc[kC];
  {
    const float* qrow = p.q + b * p.sqb + (long long)(live ? row : 0) * p.sql
                        + h * p.sqn;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      float2 x = live ? *reinterpret_cast<const float2*>(
                            qrow + 2 * (part + kParts * i))
                      : make_float2(0.f, 0.f);
      q[i] = make_float2(x.x * p.qscale, x.y * p.qscale);
      acc[i] = make_float2(0.f, 0.f);
    }
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  const float* kbase = p.k + b * p.skb + h * p.skn;
  const float* vbase = p.v + b * p.svb + h * p.svn;
  for (int j0 = 0; j0 < klen; j0 += kKeys) {
    __syncthreads();  // the last tile is read by every thread
    for (int e = tid; e < kKeys * (kD / 2); e += kThreads) {
      const int j = e / (kD / 2);
      const int c = e % (kD / 2);
      float2 kx = make_float2(0.f, 0.f);
      float2 vx = make_float2(0.f, 0.f);
      if (j0 + j < klen) {
        kx = *reinterpret_cast<const float2*>(kbase + (j0 + j) * p.skl
                                              + 2 * c);
        vx = *reinterpret_cast<const float2*>(vbase + (j0 + j) * p.svl
                                              + 2 * c);
      }
      sk[e] = kx;
      sv[e] = vx;
    }
    __syncthreads();

    const int nk = min(kKeys, klen - j0);
    float s[kKeys];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float2* kr = sk + j * (kD / 2) + part;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float2 kx = kr[kParts * i];
        d = fmaf(q[i].x, kx.x, d);
        d = fmaf(q[i].y, kx.y, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = j < nk ? d : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_next = fmaxf(m_run, m_tile);
    const float alpha = exp2f(m_run - m_next);
    float l_tile = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float pj = j < nk ? exp2f(s[j] - m_next) : 0.f;
      l_tile += pj;
      const float2* vr = sv + j * (kD / 2) + part;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float2 vx = vr[kParts * i];
        acc[i].x = fmaf(pj, vx.x, acc[i].x);
        acc[i].y = fmaf(pj, vx.y, acc[i].y);
      }
    }
    l_run = alpha * l_run + l_tile;
    m_run = m_next;
  }

  if (!live) return;
  const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
  float* orow = p.o + b * p.sob + (long long)row * p.sol + h * p.son;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    *reinterpret_cast<float2*>(orow + 2 * (part + kParts * i)) =
        make_float2(acc[i].x * inv, acc[i].y * inv);
  }
}

template <int kD>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = 2 * kKeys * kD * static_cast<int>(sizeof(float));
  static bool configured = false;  // the attribute is set once per kD
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.lq + kRows - 1) / kRows, heads, batch);
  flash_fwd_f32_kernel<kD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain C entry point (ctypes). q, k, v: fp32 [B, L, N, D] with unit
// stride on D, the other strides (in elements) even and the bases 8-byte
// aligned; o: fp32 [B, Lq, N, D]; klens: an int32 [B] device array or null.
// head_dim: a multiple of 8 up to 128. Returns the CUDA error of the launch
// (0 on success; 1 for a head dim it does not take).
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
