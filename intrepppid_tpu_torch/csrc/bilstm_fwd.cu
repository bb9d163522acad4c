// Bidirectional LSTM layer forward (eval), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels that compute this function:
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _fwd_kernel_packed (via
//     _fwd_pallas_packed, with_states=False) -- the serve path at 2H == 128;
//   intrepppid_tpu/ops/lstm_pallas_layer.py   _fwd_kernel (via _fwd_pallas,
//     with_states=False) -- the same function at other widths.
//
// Function: for each direction d (0 forward, 1 reverse) and row r, step s
// reads position pos = s (d = 0) or T-1-s (d = 1) and computes
//   gates = [x_parts...](pos) @ W_ih[d]^T + bias[d] + h @ W_hh[d]^T
// (gate order i, f, g, o), then the cell update. The state moves iff
// pos < lengths[r]; otherwise it stays frozen (so the reverse direction
// stays at zero until position length-1, and rows of length 0 keep zero
// state). Every step writes the (possibly frozen) h to hs_f[pos] / hs_b[pos].
// Matmul operands are in the compute dtype (f32 or bf16) and accumulate in
// f32; h and c are f32; the recurrent operand is h rounded to the compute
// dtype, as in the JAX kernels.
//
// What bounds it on an H100: the recurrence is serial in T, so each block
// walks all T steps, and per step it does 4H * (E + H) multiply-adds per row
// on CUDA cores (f32 FMA, 67 TFLOP/s peak). At the serve shape (800 rows,
// T = 1500, E = 64 / 128, H = 64) that is ~157 + ~236 GFLOP per dispatch
// against ~2 GB of HBM traffic: operations bound it, not bytes.
//
// What the design does about it: one block per (row tile, direction), the
// direction's W_ih^T and W_hh^T resident in shared memory for the whole
// sweep (192 KB at f32 and E = 128), laid out [k][unit][gate] so one
// 16-byte load feeds the four gates of a unit. Each thread owns one hidden
// unit for kRows rows and keeps all four gates' accumulators in registers,
// so every shared-memory weight load is reused kRows times and the cell
// update stays local to the thread; h and c live in registers. h (rounded
// to the compute dtype) and the step's x tile are double-buffered in shared
// memory in f32, and the next step's x is loaded into registers while the
// current step computes, so there is one __syncthreads per step.
// Not yet done: tensor cores (wgmma), and more than one block per row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // rows owned by each thread
constexpr int kMaxChunks = 4;   // 16-byte x chunks each thread moves per step
constexpr int kMaxThreads = 256;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four gate weights of one (k, unit) pair, stored contiguously.
__device__ __forceinline__ float4 load_w4(const float* w, int idx) {
  return reinterpret_cast<const float4*>(w)[idx];
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* w, int idx) {
  const uint2 raw = reinterpret_cast<const uint2*>(w)[idx];
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// 16 bytes of x in the compute dtype -> f32 values in shared memory.
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

// Where chunk q of a step's x tile lives: the tile of part p is the
// contiguous block x_p[pos, row0:row0+BR, :], cut into 16-byte chunks.
struct XTile {
  const void* x0;
  const void* x1;
  int E0, E1, nq0, nq;
};

template <typename T>
__device__ __forceinline__ void load_x(uint4 (&xr)[kMaxChunks], const XTile& t, int pos,
                                       int row0, int B) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    xr[m] = make_uint4(0u, 0u, 0u, 0u);
    if (q < t.nq) {
      const bool p0 = q < t.nq0;
      const int Ep = p0 ? t.E0 : t.E1;
      const int elem = (p0 ? q : q - t.nq0) * V;
      if (row0 + elem / Ep < B) {
        const T* base = static_cast<const T*>(p0 ? t.x0 : t.x1);
        xr[m] = __ldg(reinterpret_cast<const uint4*>(base + ((size_t)pos * B + row0) * Ep + elem));
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_x(float* xs, const uint4 (&xr)[kMaxChunks], const XTile& t,
                                        int E) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    if (q < t.nq) {
      const bool p0 = q < t.nq0;
      const int Ep = p0 ? t.E0 : t.E1;
      const int elem = (p0 ? q : q - t.nq0) * V;
      const int rl = elem / Ep;
      const int col = elem - rl * Ep + (p0 ? 0 : t.E0);
      store_chunk(xs + rl * E + col, xr[m], T());
    }
  }
}

// acc[i][k] += sum_e v[i][e] * w[e][unit][k] over e in [0, K); v rows are
// `ld` floats apart, K % 4 == 0.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][4], const float* v, int ld,
                                           const T* w, int K, int H, int unit) {
#pragma unroll 2
  for (int e = 0; e < K; e += 4) {
    const float4 w0 = load_w4(w, (e + 0) * H + unit);
    const float4 w1 = load_w4(w, (e + 1) * H + unit);
    const float4 w2 = load_w4(w, (e + 2) * H + unit);
    const float4 w3 = load_w4(w, (e + 3) * H + unit);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(v + i * ld + e);
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

// grid (ceil(B / BR), 2), block H * RG threads with BR = RG * kRows.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_layer_fwd_kernel(XTile xt, const int* __restrict__ lengths, const T* __restrict__ w_ih,
                        const T* __restrict__ w_hh, const float* __restrict__ bias,
                        T* __restrict__ hs_f, T* __restrict__ hs_b, float* __restrict__ hn,
                        float* __restrict__ cn, int T_steps, int B, int H) {
  const int E = xt.E0 + xt.E1;
  const int H4 = 4 * H;
  const int d = blockIdx.y;
  const int unit = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  const int BR = (blockDim.x / H) * kRows;
  const int row0 = blockIdx.x * BR;
  const int rl0 = rg * kRows;  // first local row of this thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_ih_s = reinterpret_cast<T*>(smem);  // [E][H][4]
  size_t off = align16((size_t)E * H4 * sizeof(T));
  T* w_hh_s = reinterpret_cast<T*>(smem + off);  // [H][H][4]
  off += align16((size_t)H * H4 * sizeof(T));
  float* x_s = reinterpret_cast<float*>(smem + off);  // [2][BR][E]
  off += (size_t)2 * BR * E * sizeof(float);
  float* h_s = reinterpret_cast<float*>(smem + off);  // [2][BR][H]

  // Global weights are (4H, K) row-major with row g = gate * H + unit.
  // Read them in order (coalesced) and scatter into the [k][unit][gate]
  // layout once per block.
  const T* wi = w_ih + (size_t)d * H4 * E;
  for (int idx = threadIdx.x; idx < H4 * E; idx += blockDim.x) {
    const int g = idx / E, k = idx - g * E;
    w_ih_s[((size_t)k * H + g % H) * 4 + g / H] = wi[idx];
  }
  const T* wh = w_hh + (size_t)d * H4 * H;
  for (int idx = threadIdx.x; idx < H4 * H; idx += blockDim.x) {
    const int g = idx / H, k = idx - g * H;
    w_hh_s[((size_t)k * H + g % H) * 4 + g / H] = wh[idx];
  }
  for (int idx = threadIdx.x; idx < BR * H; idx += blockDim.x) h_s[idx] = 0.0f;

  float bi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bi[k] = bias[d * H4 + k * H + unit];
  int len[kRows];
  float h[kRows], c[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + rl0 + i;
    len[i] = r < B ? lengths[r] : 0;
    h[i] = 0.0f;
    c[i] = 0.0f;
  }

  uint4 xr[kMaxChunks];
  if (T_steps > 0) {
    load_x<T>(xr, xt, d ? T_steps - 1 : 0, row0, B);
    store_x<T>(x_s, xr, xt, E);
  }
  __syncthreads();

  T* out = d ? hs_b : hs_f;
  for (int s = 0; s < T_steps; ++s) {
    const int buf = s & 1;
    const int pos = d ? T_steps - 1 - s : s;
    if (s + 1 < T_steps) load_x<T>(xr, xt, d ? pos - 1 : pos + 1, row0, B);

    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = bi[k];
    }
    accumulate<T>(acc, x_s + ((size_t)buf * BR + rl0) * E, E, w_ih_s, E, H, unit);
    accumulate<T>(acc, h_s + ((size_t)buf * BR + rl0) * H, H, w_hh_s, H, H, unit);

    float* h_next = h_s + (size_t)(buf ^ 1) * BR * H;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float ig = sigmoidf_(acc[i][0]);
      const float fg = sigmoidf_(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoidf_(acc[i][3]);
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * tanhf(c_new);
      if (pos < len[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      const T hq = from_f32<T>(h[i]);
      h_next[(rl0 + i) * H + unit] = to_f32(hq);
      const int r = row0 + rl0 + i;
      if (r < B) out[((size_t)pos * B + r) * H + unit] = hq;
    }
    if (s + 1 < T_steps) store_x<T>(x_s + (size_t)(buf ^ 1) * BR * E, xr, xt, E);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + rl0 + i;
    if (r < B) {
      hn[((size_t)d * B + r) * H + unit] = h[i];
      cn[((size_t)d * B + r) * H + unit] = c[i];
    }
  }
}

template <typename T>
int launch(const void* x0, const void* x1, int E0, int E1, const int* lengths, const void* w_ih,
           const void* w_hh, const float* bias, void* hs_f, void* hs_b, float* hn, float* cn,
           int T_steps, int B, int H, int threads, int smem, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int BR = (threads / H) * kRows;
  XTile xt{x0, x1, E0, E1, BR * E0 / V, BR * (E0 + E1) / V};
  cudaError_t err = cudaFuncSetAttribute(bilstm_layer_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BR - 1) / BR, 2);
  bilstm_layer_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      xt, lengths, static_cast<const T*>(w_ih), static_cast<const T*>(w_hh), bias,
      static_cast<T*>(hs_f), static_cast<T*>(hs_b), hn, cn, T_steps, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_rows_per_thread() { return kRows; }
int bilstm_max_chunks() { return kMaxChunks; }
int bilstm_max_threads() { return kMaxThreads; }

const char* bilstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype 0: float32, 1: bfloat16. Returns a cudaError_t (0 on success).
int bilstm_layer_fwd(int dtype, const void* x0, const void* x1, int E0, int E1,
                     const void* lengths, const void* w_ih, const void* w_hh, const void* bias,
                     void* hs_f, void* hs_b, void* hn, void* cn, int T_steps, int B, int H,
                     int threads, int smem, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  const float* b = static_cast<const float*>(bias);
  float* hn_f = static_cast<float*>(hn);
  float* cn_f = static_cast<float*>(cn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f, hs_b, hn_f, cn_f, T_steps, B,
                         H, threads, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f, hs_b, hn_f, cn_f,
                                 T_steps, B, H, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
