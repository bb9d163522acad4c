// Bidirectional LSTM layer forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels that compute this function:
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _fwd_kernel_packed (via
//     _fwd_pallas_packed) -- at 2H == 128: with_states=False on the serve
//     path (eval variant), with_states=True in training (train variant,
//     which also emits the cell-state stream for the backward);
//   intrepppid_tpu/ops/lstm_pallas_layer.py   _fwd_kernel (via _fwd_pallas)
//     -- the same function at other widths.
//
// Function: for each direction d (0 forward, 1 reverse) and row r, step s
// reads position pos = s (d = 0) or T-1-s (d = 1) and computes
//   gates = [x_parts...](pos) @ W_ih[d]^T + bias[d] + h @ W_hh[d, g]^T
// (gate order i, f, g, o; g = r / (B / G), the row's weight group), then the
// cell update. The state moves iff pos < lengths[r]; otherwise it stays
// frozen (so the reverse direction stays at zero until position length-1,
// and rows of length 0 keep zero state). Every step writes the (possibly
// frozen) h to hs_f[pos] / hs_b[pos], and in the train variant c to
// cs_f[pos] / cs_b[pos], both in the compute dtype. Matmul operands are in
// the compute dtype (f32 or bf16) and accumulate in f32; h and c are f32;
// the recurrent operand is h rounded to the compute dtype, as in the JAX
// kernels.
//
// What bounds it on an H100: the recurrence is serial in T, so each block
// walks all T steps, and per step it does 4H * (E + H) multiply-adds per row
// on CUDA cores (f32 FMA, 67 TFLOP/s peak). At the serve shape (800 rows,
// T = 1500, E = 64 / 128, H = 64) that is ~157 + ~236 GFLOP per dispatch
// against ~2 GB of HBM traffic: operations bound it, not bytes.
//
// What the design does about it: one block per (row tile, direction), the
// direction's W_ih^T and its group's W_hh^T resident in shared memory for
// the whole sweep (192 KB at f32 and E = 128), laid out [k][unit][gate] so
// one 16-byte load feeds the four gates of a unit. A row tile never spans
// two weight groups (the wrapper pads each group to whole tiles). Each
// thread owns one hidden unit for R rows (R = 4, or 2 when that fills more
// SMs in one wave: 400 train rows give 100 blocks instead of 50) and keeps
// all four gates' accumulators in registers, so every shared-memory weight
// load is reused R times and the cell update stays local to the thread; h
// and c live in registers. h (rounded to the compute dtype) and the step's x tile are
// double-buffered in shared memory in f32, and the next step's x is loaded
// into registers while the current step computes, so there is one
// __syncthreads per step.
// Shapes it keeps: the bf16 shapes bilstm_fwd_mma.cu is not instantiated
// for (E = H = 80 among them: layer 0 of the bf16 model at embedding 80);
// f32 up to H = 80 goes to bilstm_fwd_f32.cu and bf16 at H <= 64 to
// bilstm_fwd_mma.cu, both on the tensor cores (ops/lstm_cuda.py:fwd_kernel),
// and f32 at E = H = 80 reaches this kernel by name only.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

constexpr int kMaxRows = 4;     // rows owned by each thread: 2 or 4
constexpr int kMaxChunks = 4;   // 16-byte x chunks each thread moves per step
constexpr int kMaxThreads = 256;

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

// grid (ceil(B / BR), 2), block H * RG threads with BR = RG * R.
// cs_f / cs_b are null in the eval variant.
template <int R, typename T>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_layer_fwd_kernel(XTile xt, const int* __restrict__ lengths, const T* __restrict__ w_ih,
                        const T* __restrict__ w_hh, const float* __restrict__ bias,
                        T* __restrict__ hs_f, T* __restrict__ hs_b, T* __restrict__ cs_f,
                        T* __restrict__ cs_b, float* __restrict__ hn, float* __restrict__ cn,
                        int T_steps, int B, int H, int G) {
  const int E = xt.E0 + xt.E1;
  const int H4 = 4 * H;
  const int d = blockIdx.y;
  const int unit = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  const int BR = (blockDim.x / H) * R;
  const int row0 = blockIdx.x * BR;
  const int rl0 = rg * R;  // first local row of this thread
  const int group = row0 / (B / G);

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_ih_s = reinterpret_cast<T*>(smem);  // [E][H][4]
  size_t off = align16((size_t)E * H4 * sizeof(T));
  T* w_hh_s = reinterpret_cast<T*>(smem + off);  // [H][H][4]
  off += align16((size_t)H * H4 * sizeof(T));
  float* x_s = reinterpret_cast<float*>(smem + off);  // [2][BR][E]
  off += (size_t)2 * BR * E * sizeof(float);
  float* h_s = reinterpret_cast<float*>(smem + off);  // [2][BR][H]

  load_weight<T, T>(w_ih_s, w_ih + (size_t)d * H4 * E, H, E, H4);
  load_weight<T, T>(w_hh_s, w_hh + ((size_t)d * G + group) * H4 * H, H, H, H4);
  for (int idx = threadIdx.x; idx < BR * H; idx += blockDim.x) h_s[idx] = 0.0f;

  float bi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bi[k] = bias[d * H4 + k * H + unit];
  int len[R];
  float h[R], c[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
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
  T* cout = d ? cs_b : cs_f;
  for (int s = 0; s < T_steps; ++s) {
    const int buf = s & 1;
    const int pos = d ? T_steps - 1 - s : s;
    if (s + 1 < T_steps) load_x<T>(xr, xt, d ? pos - 1 : pos + 1, row0, B);

    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = bi[k];
    }
    accumulate<R, T>(acc, x_s + ((size_t)buf * BR + rl0) * E, E, w_ih_s, H4, E, unit);
    accumulate<R, T>(acc, h_s + ((size_t)buf * BR + rl0) * H, H, w_hh_s, H4, H, unit);

    float* h_next = h_s + (size_t)(buf ^ 1) * BR * H;
#pragma unroll
    for (int i = 0; i < R; ++i) {
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
      if (r < B) {
        out[((size_t)pos * B + r) * H + unit] = hq;
        if (cout) cout[((size_t)pos * B + r) * H + unit] = from_f32<T>(c[i]);
      }
    }
    if (s + 1 < T_steps) store_x<T>(x_s + (size_t)(buf ^ 1) * BR * E, xr, xt, E);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + rl0 + i;
    if (r < B) {
      hn[((size_t)d * B + r) * H + unit] = h[i];
      cn[((size_t)d * B + r) * H + unit] = c[i];
    }
  }
}

template <int R, typename T>
int launch(const void* x0, const void* x1, int E0, int E1, const int* lengths, const void* w_ih,
           const void* w_hh, const float* bias, void* hs_f, void* hs_b, void* cs_f, void* cs_b,
           float* hn, float* cn, int T_steps, int B, int H, int G, int threads, int smem,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int BR = (threads / H) * R;
  XTile xt{x0, x1, E0, E1, BR * E0 / V, BR * (E0 + E1) / V};
  cudaError_t err = cudaFuncSetAttribute(bilstm_layer_fwd_kernel<R, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BR - 1) / BR, 2);
  bilstm_layer_fwd_kernel<R, T><<<grid, threads, smem, stream>>>(
      xt, lengths, static_cast<const T*>(w_ih), static_cast<const T*>(w_hh), bias,
      static_cast<T*>(hs_f), static_cast<T*>(hs_b), static_cast<T*>(cs_f),
      static_cast<T*>(cs_b), hn, cn, T_steps, B, H, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows_per_thread, const void* x0, const void* x1, int E0, int E1,
                const int* lengths, const void* w_ih, const void* w_hh, const float* bias,
                void* hs_f, void* hs_b, void* cs_f, void* cs_b, float* hn, float* cn,
                int T_steps, int B, int H, int G, int threads, int smem, cudaStream_t stream) {
  if (rows_per_thread == 4)
    return launch<4, T>(x0, x1, E0, E1, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, hn,
                        cn, T_steps, B, H, G, threads, smem, stream);
  if (rows_per_thread == 2)
    return launch<2, T>(x0, x1, E0, E1, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, hn,
                        cn, T_steps, B, H, G, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int bilstm_rows_per_thread() { return kMaxRows; }
int bilstm_max_chunks() { return kMaxChunks; }
int bilstm_max_threads() { return kMaxThreads; }

const char* bilstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype 0: float32, 1: bfloat16. rows_per_thread 2 or 4. w_hh is (2, G,
// 4H, H) with B % G == 0 and each weight group's B / G rows a whole number
// of row tiles (or G == 1). cs_f / cs_b null selects the eval variant.
// Returns a cudaError_t (0 on success).
int bilstm_layer_fwd(int dtype, const void* x0, const void* x1, int E0, int E1,
                     const void* lengths, const void* w_ih, const void* w_hh, const void* bias,
                     void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn, void* cn,
                     int T_steps, int B, int H, int G, int rows_per_thread, int threads,
                     int smem, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  const float* b = static_cast<const float*>(bias);
  float* hn_f = static_cast<float*>(hn);
  float* cn_f = static_cast<float*>(cn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(rows_per_thread, x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f, hs_b,
                              cs_f, cs_b, hn_f, cn_f, T_steps, B, H, G, threads, smem, st);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows_per_thread, x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f,
                                      hs_b, cs_f, cs_b, hn_f, cn_f, T_steps, B, H, G, threads,
                                      smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
