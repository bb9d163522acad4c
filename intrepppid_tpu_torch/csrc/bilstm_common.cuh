// Helpers shared by the LSTM kernels (bilstm_fwd.cu, bilstm_bwd.cu,
// bilstm_wgrad.cu, bilstm_gates.cu, bilstm_fwd_wide.cu, bilstm_bwd_lite.cu,
// lstm_recurrence_fwd.cu, lstm_recurrence_bwd.cu,
// lstm_recurrence_wgrad.cu, and, with bilstm_mma.cuh, the tensor-core
// kernels, bilstm_bwd_lite_mma.cu and bilstm_fwd_wide_mma.cu among them on
// the wide kernels' cluster launch and barriers): compute-dtype
// conversions, 16-byte stream chunks widened to f32 in shared memory, the
// per-unit four-gate product over weights resident in shared memory, and
// the launch dispatch and barriers of the wide (cluster) kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// An f32 value rounded to the compute dtype T, as f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

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

// Load 8 consecutive elements (16 bytes of bf16, 32 of f32) as f32.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The wide kernels (bilstm_fwd_wide.cu, bilstm_bwd_lite.cu,
// lstm_recurrence_fwd.cu, lstm_recurrence_bwd.cu) split one row tile's
// hidden units over a cluster of kWideCluster blocks of H threads
// (H <= kWideMaxThreads); each thread owns one unit for R rows, with R one
// of kWideRows. Each kernel is instantiated for blocks of at most
// kWideSmallThreads threads (H <= 256: the register budget of 255 a thread
// it had before wider blocks) and of at most kWideMaxThreads (H = 257 to
// 288: 224 registers a thread); the recurrence kernels also for blocks of
// at most kRecMaxH threads (H = 289 to 1024: 64 registers a thread), whose
// weight slice no longer fits shared memory beside the h tile and is read
// from a copy in global memory (L2) instead.
constexpr int kWideCluster = 8;
constexpr int kWideSmallThreads = 256;
constexpr int kWideMaxThreads = 288;
constexpr int kRecMaxH = 1024;
constexpr int kWideRowsMask = (1 << 2) | (1 << 4) | (1 << 7) | (1 << 10);

// Call f(std::integral_constant<int, R>, T{}, std::integral_constant<int,
// kThreads>) for dtype code (0: float, 1: bfloat16), R in kWideRows and the
// block instance kThreads that takes H threads: kWideSmallThreads,
// kWideMaxThreads, or (with kGlobal, the recurrence kernels) kRecMaxH;
// cudaErrorInvalidValue for anything else.
template <bool kGlobal = false, typename F>
int dispatch_wide(int dtype, int rows, int H, F&& f) {
  auto by_threads = [&](auto r, auto t) -> int {
    if (H <= 0) return (int)cudaErrorInvalidValue;
    if (H <= kWideSmallThreads) return f(r, t, std::integral_constant<int, kWideSmallThreads>{});
    if (H <= kWideMaxThreads) return f(r, t, std::integral_constant<int, kWideMaxThreads>{});
    if constexpr (kGlobal) {
      if (H <= kRecMaxH) return f(r, t, std::integral_constant<int, kRecMaxH>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  auto by_rows = [&](auto t) -> int {
    switch (rows) {
      case 2: return by_threads(std::integral_constant<int, 2>{}, t);
      case 4: return by_threads(std::integral_constant<int, 4>{}, t);
      case 7: return by_threads(std::integral_constant<int, 7>{}, t);
      case 10: return by_threads(std::integral_constant<int, 10>{}, t);
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_rows(float{});
  if (dtype == 1) return by_rows(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// Launch `kernel` over grid (tiles * kWideCluster, dirs) in clusters of
// kWideCluster blocks along x, `threads` threads each (H for the CUDA-core
// wide kernels), `smem` bytes of dynamic
// shared memory. With `max_clusters` non-null, only report how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters).
template <typename... Params, typename... Args>
int launch_wide_dirs(void (*kernel)(Params...), int tiles, int dirs, int threads, int smem,
                     cudaStream_t stream, int* max_clusters, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kWideCluster, dirs, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) {
    cfg.gridDim = dim3(kWideCluster, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, (void*)kernel, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The two-direction launch of the layer kernels.
template <typename... Params, typename... Args>
int launch_wide(void (*kernel)(Params...), int tiles, int threads, int smem, cudaStream_t stream,
                int* max_clusters, Args... args) {
  return launch_wide_dirs(kernel, tiles, 2, threads, smem, stream, max_clusters, args...);
}

// A cluster barrier without release / acquire ordering: enough where it
// only has to keep a block from writing shared memory that another block
// of the cluster may still be reading (the reads have returned, since
// their values were used), and cheaper than cluster.sync().
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;"
               ::: "memory");
}

// The two halves of a cluster barrier with release / acquire ordering:
// what a thread wrote to shared memory (its own block's or, through
// distributed shared memory, another's) before it arrives is visible to
// every thread of the cluster once that thread's wait returns; work between
// the two halves overlaps the barrier.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The global row of local row `rl` of row tile `tile` when each of the G
// weight groups (Bg = B / G rows) is cut into ceil(Bg / BR) tiles of BR
// rows, so no tile spans two groups; -1 past the group's end.
__device__ __forceinline__ int tile_row(int tile, int rl, int BR, int Bg) {
  const int tpg = (Bg + BR - 1) / BR;
  const int in_group = (tile % tpg) * BR + rl;
  return in_group < Bg ? (tile / tpg) * Bg + in_group : -1;
}

}  // namespace bilstm
