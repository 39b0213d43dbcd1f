// Per-token dynamic int8 quantization of the W8A8 linears' activations, in
// one pass (sm_90a).
//
// Not a Pallas kernel: the JAX package computes this function in XLA
// (moviigen_tpu/ops/quantization.py::quantize_activations), where it fuses
// into the surrounding graph; the port ran it as seven eager passes. Same
// function, for each row m of x [M, K] (bf16 or fp32):
//   sx[m] = max(max_k |x[m, k]|, 1e-8) / 127           (fp32)
//   xq[m, k] = clamp(round(x[m, k] / sx[m]), -127, 127)  (int8)
// with both divisions correctly rounded (__fdiv_rn) and round half to even
// (rintf, as jnp.round and torch.round), so that the result is the same
// bits as the plain version's and the JAX package's. A NaN in a row makes
// its sx NaN (as amax does) and that row's codes 0 (what a NaN quotient
// becomes when the plain version casts it to int8 on the card).
//
// What bounds it: bytes. It reads x once and writes xq and sx once:
// (2 or 4) * M * K + M * K + 4 * M bytes, with a handful of operations per
// element.
//
// What the design does about it: one block per row holds the whole row in
// registers from a single read (K <= 32,768; 13,824 bf16 is 27 KB): each
// of up to 1,024 threads loads up to kVecs = 4 vectors of 8 elements (16
// bytes of bf16, two 16-byte loads of fp32), neighbouring threads on
// neighbouring vectors.
// The absmax is reduced across the warp by shuffles and across warps
// through shared memory; then each thread writes its 8-element vectors as
// 8-byte stores of int8. K must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;           // elements per vector
constexpr int kVecs = 4;          // vectors per thread
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// round(x / s) clamped to [-127, 127]; a NaN quotient gives 0.
__device__ __forceinline__ uint32_t code(float x, float s) {
  const float q = __fdiv_rn(x, s);
  if (q != q) return 0u;
  const int c = static_cast<int>(fminf(fmaxf(rintf(q), -127.f), 127.f));
  return static_cast<uint32_t>(c) & 0xFFu;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int k) {
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float row_scale;
  const int nvec = k / kVec;
  const long long row0 = static_cast<long long>(blockIdx.x) * k;
  const T* src = x + row0;

  float v[kVecs][kVec];
  float amax = 0.f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      load8(src + vi * kVec, v[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        amax = fmaxf(amax, fabsf(v[i][e]));
        nan |= v[i][e] != v[i][e];
      }
    }
  }
  // fmaxf drops NaN: carry it on the side and put it back at the end
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) warp_max[warp] = nan ? __int_as_float(0x7fc00000) : amax;
  __syncthreads();
  if (warp == 0) {
    const int warps = (blockDim.x + 31) / 32;
    float m = lane < warps ? warp_max[lane] : 0.f;
    bool bad = m != m;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      const float s = bad ? __int_as_float(0x7fc00000)
                          : __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
      row_scale = s;
      sx[blockIdx.x] = s;
    }
  }
  __syncthreads();
  const float s = row_scale;
  int8_t* dst = xq + row0;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      uint2 packed;
      packed.x = code(v[i][0], s) | code(v[i][1], s) << 8 |
                 code(v[i][2], s) << 16 | code(v[i][3], s) << 24;
      packed.y = code(v[i][4], s) | code(v[i][5], s) << 8 |
                 code(v[i][6], s) << 16 | code(v[i][7], s) << 24;
      *reinterpret_cast<uint2*>(dst + vi * kVec) = packed;
    }
  }
}

template <typename T>
int launch(const void* x, void* xq, void* sx, int m, int k, void* stream) {
  const int nvec = k / kVec;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nvec > kVecs * kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nvec + kVecs - 1) / kVecs + 31) / 32 * 32;
  quantize_rows_kernel<T><<<m, threads, 0, st>>>(xp, qp, sp, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, K] contiguous, 16-byte
// aligned, fp32 when x_fp32 is non-zero, else bf16, with K a positive
// multiple of 8 and at most 32,768; xq [M, K] int8 and sx [M] fp32
// contiguous outputs, xq 8-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int quantize_act(const void* x, void* xq, void* sx, int m, int k,
                            int x_fp32, void* stream) {
  if (m < 0 || k < kVec || k % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  return x_fp32 ? launch<float>(x, xq, sx, m, k, stream)
                : launch<__nv_bfloat16>(x, xq, sx, m, k, stream);
}
