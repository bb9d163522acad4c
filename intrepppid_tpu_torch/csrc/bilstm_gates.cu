// Input projection of a bidirectional LSTM layer, hand-written for Hopper
// (sm_90a).
//
// Replaces the input-gate product that the TPU kernels form in their own
// body:
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _xg2 (:255-283), called by
//     _fwd_kernel (row 3, via _fwd_pallas) and _bwd_kernel with
//     fused_input=True (row 4, via _bwd_pallas);
// and the lite backward's recompute of the same gates (_input_gates,
// :808-823, which the JAX package leaves to XLA). On this card a layer
// whose weights do not fit one block's shared memory ("wide" route,
// ops/lstm_cuda.py:layer_route) takes its input gates from this kernel in
// the forward and again in the backward, so both see the same f32 values.
//
// Function: for each direction d, time step t and row b,
//   xg[d, t, b, :] = sum over parts p of x_p[t, b, :] @ W_ih[d, :, cols(p)]^T
//                    + bias[d]
// with compute-dtype operands (f32 or bf16), f32 accumulation (in the
// order of the concatenated input columns), the f32 bias added last, and
// an f32 (2, T, B, 4H) output. It is a GEMM per direction: M = T * B rows,
// N = 4H gate columns, K = E input columns, both operands K-contiguous.
//
// What bounds it on an H100: at the scaled train shape (M = 600,000, N =
// 1024, K = 256 or 512) it does 2 * M * N * K multiply-adds per layer
// against ~5 GB of f32 output: operations bound it, at the 67 TFLOP/s of
// f32 on CUDA cores.
//
// Design: a plain tiled shared-memory product on CUDA cores. Block
// (row tile, column tile, direction) owns a 128 x 128 output tile; 256
// threads each keep an 8 x 8 register tile (two 4-wide strips per axis, so
// the shared-memory reads are 16-byte and conflict-free). K advances 16
// columns at a time through two shared-memory buffers: the next slice is
// fetched into registers while the current one is multiplied, one barrier
// per slice. A 16-column slice lies inside one input part (each part's
// width is a multiple of 16).
// Every shape now takes a tensor-core kernel (ops/lstm_cuda.py:
// gates_kernel): bilstm_gates_mma.cu in bf16, bilstm_gates_f32.cu in f32
// (three tf32 passes); this kernel is reached by name only, to time it
// beside them.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // output (gate) columns per block
constexpr int kBK = 16;   // input columns per slice
constexpr int kThreads = 256;

struct Parts {
  const void* x[2];
  int E[2];
};

// grid (ceil(M / 128), N / 128, 2), block kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_gates_kernel(Parts xp, const T* __restrict__ w_ih, const float* __restrict__ bias,
                    float* __restrict__ xg, int M, int N) {
  const int E = xp.E[0] + xp.E[1];
  const int d = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const T* w = w_ih + (size_t)d * N * E;

  __shared__ __align__(16) float a_s[2][kBK][kBM];
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  // staging: thread -> tile row lr, 8 consecutive input columns at lk
  const int lr = threadIdx.x >> 1;
  const int lk = (threadIdx.x & 1) * 8;
  // compute: rows {4ty..4ty+3, 64+4ty..}, columns {4tx..4tx+3, 64+4tx..}
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float av[8], bv[8];
  auto fetch = [&](int k0) {
    const int p = k0 < xp.E[0] ? 0 : 1;
    const int kp = k0 - (p ? xp.E[0] : 0);
    const int m = m0 + lr;
    if (m < M) {
      load8(av, static_cast<const T*>(xp.x[p]) + (size_t)m * xp.E[p] + kp + lk);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) av[j] = 0.0f;
    }
    load8(bv, w + (size_t)(n0 + lr) * E + k0 + lk);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a_s[buf][lk + j][lr] = av[j];
      b_s[buf][lk + j][lr] = bv[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = E / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[buf][k][64 + 4 * tx]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = xg + (size_t)d * M * N;
  const float* bd = bias + (size_t)d * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + 4 * tx;
      const float4 b = *reinterpret_cast<const float4*>(bd + n);
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
          make_float4(acc[i][4 * half] + b.x, acc[i][4 * half + 1] + b.y,
                      acc[i][4 * half + 2] + b.z, acc[i][4 * half + 3] + b.w);
    }
  }
}

template <typename T>
int launch(Parts xp, const void* w_ih, const float* bias, float* xg, int M, int N,
           cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, N / kBN, 2);
  bilstm_gates_kernel<T><<<grid, kThreads, 0, stream>>>(xp, static_cast<const T*>(w_ih), bias,
                                                         xg, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_gates_tile_n() { return kBN; }
int bilstm_gates_tile_k() { return kBK; }

const char* bilstm_gates_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype 0: float32, 1: bfloat16. x0 (T, B, E0); x1 (T, B, E1) or null with
// E1 = 0; w_ih (2, 4H, E0 + E1); bias (2, 4H) f32; xg (2, T, B, 4H) f32.
// Needs 4H % 128 == 0 and E0, E1 multiples of 16. Returns a cudaError_t
// (0 on success).
int bilstm_gates(int dtype, const void* x0, const void* x1, int E0, int E1, const void* w_ih,
                 const void* bias, void* xg, int T_steps, int B, int H, void* stream) {
  const Parts xp{{x0, x1}, {E0, E1}};
  const int M = T_steps * B;
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(xg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xp, w_ih, b, out, M, 4 * H, st);
  if (dtype == 1) return launch<__nv_bfloat16>(xp, w_ih, b, out, M, 4 * H, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
