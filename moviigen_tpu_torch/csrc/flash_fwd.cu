// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel moviigen_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_fwd through pl.pallas_call). Same function:
//   o = softmax_2(q' k^T) v,  q' = bf16(q * bf16(scale * log2 e)),
// non-causal, base-2 online softmax, keys at or past the per-batch k_len
// masked with -1e30, P rounded to bf16 before the P.V product, rows whose
// normalizer is 0 divided by 1, output written in bf16.
//
// What bounds it: tensor-core operations. Self-attention does
// 4 * B * N * Lq * Lk * D flops on 4 * B * L * N * D * 2 bytes, about
// 2,000 flops per byte at L = 7,800, far above the card's ~295 flops per
// byte balance point; the text cross-attention (Lk = 512) still does
// ~240-1000 flops per byte depending on Lq and is bound by compute too.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16 bf16 -> fp32), fed by ldmatrix from shared memory.
// One block of 8 warps owns 128 query rows of one (batch, head); each
// warp keeps its 16 rows of Q, the running max, the normalizer and the
// 16 x 128 fp32 output accumulator in registers for the whole key loop,
// so Q is read once and the logits never leave the SM. K/V tiles of 64
// keys are double-buffered in shared memory with cp.async, so the next
// tile's load overlaps this tile's math. Rows are padded by 16 bytes in
// shared memory, which makes every ldmatrix conflict-free. Key tiles past
// k_len are skipped; the ragged query and key edges are zero-filled on
// load and masked, so the caller passes [B, L, N, D] views as they are,
// through their strides, with no transposed or padded copies.
// Not yet used: wgmma, TMA, warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim
constexpr int kBlockM = 128;            // query rows per block
constexpr int kBlockN = 64;             // keys per tile
constexpr int kWarps = 8;               // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;            // shared row stride in elements (272 B)
constexpr int kQElems = kBlockM * kLds;
constexpr int kKVElems = kBlockN * kLds;
constexpr int kSmemBytes = (kQElems + 4 * kKVElems) * 2;  // Q + 2x(K, V)
constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* klens;  // [B] or null
  int lq, lk;
  long long sqb, sql, sqn;
  long long skb, skl, skn;
  long long svb, svl, svn;
  long long sob, sol, son;
  float qscale;      // bf16(scale * log2 e), as a float
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
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

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kQElems;       // two buffers
  __nv_bfloat16* sV = sK + 2 * kKVElems;  // two buffers

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within an 8-row group of a fragment
  const int t = lane % 4;  // column pair within a fragment
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int klen = p.lk;
  if (p.klens != nullptr) klen = min(max(p.klens[b], 0), p.lk);
  const int n_tiles = (klen + kBlockN - 1) / kBlockN;

  const __nv_bfloat16* qg = p.q + b * p.sqb + h * p.sqn;
  const __nv_bfloat16* kg = p.k + b * p.skb + h * p.skn;
  const __nv_bfloat16* vg = p.v + b * p.svb + h * p.svn;

  // ---- Q tile -> shared (rows past Lq zero-filled)
  for (int c = tid; c < kBlockM * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    const int row = m0 + r;
    const bool ok = row < p.lq;
    cp_async_16(sQ + r * kLds + col, ok ? qg + row * p.sql + col : qg, ok);
  }
  cp_async_commit();

  // K/V tile -> shared buffer; keys at or past k_len are zero-filled
  auto load_kv = [&](int tile, int buf) {
    const int n0 = tile * kBlockN;
    __nv_bfloat16* dk = sK + buf * kKVElems;
    __nv_bfloat16* dv = sV + buf * kKVElems;
    for (int c = tid; c < kBlockN * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8);
      const int col = (c % (kD / 8)) * 8;
      const int row = n0 + r;
      const bool ok = row < klen;
      cp_async_16(dk + r * kLds + col, ok ? kg + row * p.skl + col : kg, ok);
      cp_async_16(dv + r * kLds + col, ok ? vg + row * p.svl + col : vg, ok);
    }
  };

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  // ---- prescale Q in place: bf16(q * c), the product rounded once to
  // bf16 as a bf16 multiply does (the product of two bf16 values is
  // exact in fp32)
  for (int c = tid; c < kBlockM * (kD / 2); c += kThreads) {
    const int r = c / (kD / 2);
    const int col = (c % (kD / 2)) * 2;
    __nv_bfloat162* ptr = reinterpret_cast<__nv_bfloat162*>(sQ + r * kLds + col);
    const float2 f = __bfloat1622float2(*ptr);
    *ptr = __floats2bfloat162_rn(f.x * p.qscale, f.y * p.qscale);
  }
  __syncthreads();

  // ---- this warp's 16 query rows as mma A fragments, kept in registers
  const int wrow = warp * 16;
  const int lj = lane / 8;  // which 8x8 matrix this lane addresses
  const int lr = lane % 8;  // which row of it
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* ptr =
        sQ + (wrow + lr + (lj & 1) * 8) * kLds + ks * 16 + (lj >> 1) * 8;
    ldmatrix_x4(qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], ptr);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }
  // per-thread state for rows g (index 0) and g + 8 (index 1)
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + buf * kKVElems;
    const __nv_bfloat16* cV = sV + buf * kKVElems;

    // ---- s = q' k^T for 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int np = 0; np < kBlockN / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const __nv_bfloat16* ptr =
            cK + (np * 16 + lr + (lj >> 1) * 8) * kLds + ks * 16 + (lj & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, ptr);
        mma_bf16(s[2 * np], qf[ks], b0, b1);
        mma_bf16(s[2 * np + 1], qf[ks], b2, b3);
      }
    }

    // ---- key mask on the tile that crosses k_len
    const int n0 = j * kBlockN;
    const bool masked = n0 + kBlockN > klen;
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + nt * 8 + t * 2 + (e & 1) >= klen) s[nt][e] = kNegInf;
        }
      }
    }

    // ---- online softmax (base 2)
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[r] = mx;
      alpha[r] = exp2f(m_run[r] - mx);
    }

    // P as bf16 A fragments for the P.V product (the C layout of two
    // adjacent n-tiles is the A layout of one 16-key k-step)
    uint32_t pf[kBlockN / 16][4];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(s[nt][e] - m_new[e >> 1]);
        if (masked && n0 + nt * 8 + t * 2 + (e & 1) >= klen) pv[e] = 0.f;
      }
      lsum[0] += pv[0] + pv[1];
      lsum[1] += pv[2] + pv[3];
      const int ks = nt / 2;
      const int half = (nt % 2) * 2;
      pf[ks][half] = pack_bf16(pv[0], pv[1]);
      pf[ks][half + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = alpha[r] * l_run[r] + lsum[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // ---- acc += P v (16 rows x 128 dims, k-steps of 16 keys)
#pragma unroll
    for (int ks = 0; ks < kBlockN / 16; ++ks) {
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        const __nv_bfloat16* ptr =
            cV + (ks * 16 + lr + (lj & 1) * 8) * kLds + dp * 16 + (lj >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, ptr);
        mma_bf16(acc[2 * dp], pf[ks], b0, b1);
        mma_bf16(acc[2 * dp + 1], pf[ks], b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // ---- normalise and write this warp's rows
  float l_fin[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_fin[r] = (l == 0.f) ? 1.f : l;
  }
  __nv_bfloat16* og = p.o + b * p.sob + h * p.son;
  const int row0 = m0 + wrow + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.sol + col) =
          __floats2bfloat162_rn(acc[dt][0] / l_fin[0], acc[dt][1] / l_fin[0]);
    }
    if (row1 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.sol + col) =
          __floats2bfloat162_rn(acc[dt][2] / l_fin[1], acc[dt][3] / l_fin[1]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Tensors are [B, L, N, D] bf16
// with unit stride on D and every other stride (in elements) a multiple
// of 8; klens is an int32 [B] device array or null. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const void* klens, int batch,
                              int heads, int lq, int lk, int head_dim,
                              long long sqb, long long sql, long long sqn,
                              long long skb, long long skl, long long skn,
                              long long svb, long long svl, long long svn,
                              long long sob, long long sol, long long son,
                              float qscale, void* stream) {
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || heads == 0 || lq == 0) return 0;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.klens = static_cast<const int*>(klens);
  p.lq = lq;
  p.lk = lk;
  p.sqb = sqb; p.sql = sql; p.sqn = sqn;
  p.skb = skb; p.skl = skl; p.skn = skn;
  p.svb = svb; p.svl = svl; p.svn = svn;
  p.sob = sob; p.sol = sol; p.son = son;
  p.qscale = qscale;
  dim3 grid((lq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
