// Helpers shared by the bidirectional-LSTM kernels (bilstm_fwd.cu,
// bilstm_bwd.cu, bilstm_wgrad.cu): compute-dtype conversions, 16-byte
// stream chunks widened to f32 in shared memory, and the per-unit
// four-gate product over weights resident in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bilstm {

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive weights (the four gates of one (k, unit) pair) as f32.
// `w` is 16-byte aligned for float and 8-byte aligned for bf16.
__device__ __forceinline__ float4 load_w4(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* w) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w);
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// 16 bytes of a compute-dtype stream -> f32 values in shared memory.
__device__ __forceinline__ void store_chunk(float* dst, const uint4& r, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                                                __uint_as_float(r.z), __uint_as_float(r.w));
}
__device__ __forceinline__ void store_chunk(float* dst, const uint4& r, __nv_bfloat16) {
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                  __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(__uint_as_float(r.z << 16), __uint_as_float(r.z & 0xffff0000u),
                  __uint_as_float(r.w << 16), __uint_as_float(r.w & 0xffff0000u));
}

// acc[i][q] += sum_k v[i][k] * w[k][unit][q] over k in [0, K): the four
// gates q of one hidden unit for R rows. v rows are `ld` floats apart;
// weight row k starts at w + k * ws (ws elements, a multiple of 4) and holds
// the gates of unit u at [4u, 4u + 4). K % 4 == 0.
template <int R, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[R][4], const float* v, int ld,
                                           const T* w, int ws, int K, int unit) {
  const T* wu = w + 4 * unit;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 w0 = load_w4(wu + (size_t)(k + 0) * ws);
    const float4 w1 = load_w4(wu + (size_t)(k + 1) * ws);
    const float4 w2 = load_w4(wu + (size_t)(k + 2) * ws);
    const float4 w3 = load_w4(wu + (size_t)(k + 3) * ws);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(v + i * ld + k);
      acc[i][0] = fmaf(xv.x, w0.x, acc[i][0]);
      acc[i][1] = fmaf(xv.x, w0.y, acc[i][1]);
      acc[i][2] = fmaf(xv.x, w0.z, acc[i][2]);
      acc[i][3] = fmaf(xv.x, w0.w, acc[i][3]);
      acc[i][0] = fmaf(xv.y, w1.x, acc[i][0]);
      acc[i][1] = fmaf(xv.y, w1.y, acc[i][1]);
      acc[i][2] = fmaf(xv.y, w1.z, acc[i][2]);
      acc[i][3] = fmaf(xv.y, w1.w, acc[i][3]);
      acc[i][0] = fmaf(xv.z, w2.x, acc[i][0]);
      acc[i][1] = fmaf(xv.z, w2.y, acc[i][1]);
      acc[i][2] = fmaf(xv.z, w2.z, acc[i][2]);
      acc[i][3] = fmaf(xv.z, w2.w, acc[i][3]);
      acc[i][0] = fmaf(xv.w, w3.x, acc[i][0]);
      acc[i][1] = fmaf(xv.w, w3.y, acc[i][1]);
      acc[i][2] = fmaf(xv.w, w3.z, acc[i][2]);
      acc[i][3] = fmaf(xv.w, w3.w, acc[i][3]);
    }
  }
}

// Scatter a direction's torch-layout weight (4H, K), row g = gate * H + unit,
// into shared memory as [k][unit][gate] with rows `ws` elements apart, in
// the shared copy's type D (T itself, or f32: bf16 widens exactly). Reads
// the global matrix in order (coalesced).
template <typename D, typename T>
__device__ __forceinline__ void load_weight(D* dst, const T* src, int H, int K, int ws) {
  const int H4 = 4 * H;
  for (int idx = threadIdx.x; idx < H4 * K; idx += blockDim.x) {
    const int g = idx / K, k = idx - g * K;
    dst[(size_t)k * ws + (g % H) * 4 + g / H] = from_f32<D>(to_f32(src[idx]));
  }
}

}  // namespace bilstm
