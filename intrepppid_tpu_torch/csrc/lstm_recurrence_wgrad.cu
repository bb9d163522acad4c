// Recurrent weight gradient of the masked LSTM recurrence over time-major
// gates, hand-written for Hopper (sm_90a).
//
// Replaces the dW accumulation inside the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (the dw_scr sums at
//     :243-264, via _bwd_pallas, :274).
//
// Function: from the forward's hs (T, D, B, H) f32 and the sweep's gate
// cotangents dxg (T, D, B, 4H) f32 (ops/lstm_cuda.py:lstm_recurrence_bwd), for each
// direction d and weight group g (rows [g * B/G, (g+1) * B/G)):
//   dw[d, g] = sum_{s >= 1, b in g} round(hs[s-1, d, b, :])^T (x)
//                                   round(dxg[s, d, b, :])          (H, 4H)
// with round() to the compute dtype and f32 sums. Step 0's h_prev is zero
// and adds nothing; hs is indexed at s-1, no shifted copy is built.
//
// Why a second launch and not the sweep: the TPU kernel sums dW in VMEM
// scratch across its sequential time grid. Here the sweep's row tiles run
// in parallel, and its blocks' shared memory holds the resident weights;
// one group's dW (1 MB in f32 at H = 256) fits neither beside them nor in
// registers. So the sweep writes dxg once (it is the op's output anyway)
// and this kernel reduces over the T * B rows.
//
// What bounds it on an H100: 4H * H multiply-adds per (row, step, direction)
// on CUDA cores in f32 against reading hs and dxg once (20 H bytes):
// operations from H = 64 up, bytes at H = 32.
//
// Design: a split-K product. Block (split, output
// tile, d * G + g) owns a 64 x 64 tile of dw[d, g] and the rows (s, b) of
// its time split and group; 256 threads each keep a 4 x 4 register tile.
// Chunks of 32 rows of dxg and h_prev are rounded and staged in shared
// memory and reduced as outer products. Every block writes its partial
// tile (no atomics); the wrapper sums the partials over the splits in a
// fixed order, so the result does not depend on the order blocks run, and
// rounds to w's dtype last.
// The tensor-core kernels took every width over (lstm_recurrence_wgrad_mma.cu
// in bf16, lstm_recurrence_wgrad_f32.cu in f32, three tf32 passes); this one
// is reached by name only, to time it beside them.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

constexpr int kTile = 64;   // output tile edge (h_prev columns x gate columns)
constexpr int kChunk = 32;  // rows staged per shared-memory chunk
constexpr int kThreads = 256;

// 8 consecutive f32 values rounded to T, as f32.
template <typename T>
__device__ __forceinline__ void load8_rounded(float (&v)[8], const float* p) {
  load8(v, p);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = round_to<T>(v[i]);
}

// grid (splits, 4H/64 * ceil(H/64), D * G), block kThreads.
// partial: (splits, D, G, H, 4H) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_recurrence_wgrad_kernel(const float* __restrict__ hs, const float* __restrict__ dxg,
                             float* __restrict__ partial, int T_steps, int D, int B, int H,
                             int G) {
  const int H4 = 4 * H;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int d = blockIdx.z / G;
  const int g = blockIdx.z % G;
  const int Bg = B / G;
  const int mtiles = H4 / kTile;
  const int m0 = (blockIdx.y % mtiles) * kTile;  // gate columns
  const int k0 = (blockIdx.y / mtiles) * kTile;  // h_prev columns

  // this block's rows: s in [s0, s1) of the steps 1 .. T-1, b in group g
  const int s0 = 1 + (int)((long long)(T_steps - 1) * split / nsplit);
  const int s1 = 1 + (int)((long long)(T_steps - 1) * (split + 1) / nsplit);
  const int nrows = (s1 - s0) * Bg;

  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float b_s[kChunk][kTile];

  const int tm = threadIdx.x % 16;  // gate columns m0 + 4 tm .. +3
  const int tk = threadIdx.x / 16;  // h_prev columns k0 + 4 tk .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // staging: thread -> chunk row lr, 8 columns at lc
  const int lr = threadIdx.x / 8;
  const int lc = (threadIdx.x % 8) * 8;
  for (int n0 = 0; n0 < nrows; n0 += kChunk) {
    float av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = bv[i] = 0.0f;
    const int n = n0 + lr;
    if (n < nrows) {
      const int s = s0 + n / Bg;
      const int b = g * Bg + n % Bg;
      load8_rounded<T>(av, dxg + (((size_t)s * D + d) * B + b) * H4 + m0 + lc);
      if (k0 + lc < H)
        load8_rounded<T>(bv, hs + (((size_t)(s - 1) * D + d) * B + b) * H + k0 + lc);
    }
    *reinterpret_cast<float4*>(&a_s[lr][lc]) = make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(&a_s[lr][lc + 4]) = make_float4(av[4], av[5], av[6], av[7]);
    *reinterpret_cast<float4*>(&b_s[lr][lc]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
    *reinterpret_cast<float4*>(&b_s[lr][lc + 4]) = make_float4(bv[4], bv[5], bv[6], bv[7]);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[r][4 * tm]);
      const float4 bb = *reinterpret_cast<const float4*>(&b_s[r][4 * tk]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + (((size_t)split * D + d) * G + g) * H * H4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 4 * tk + j;
    if (k < H)
      *reinterpret_cast<float4*>(out + (size_t)k * H4 + m0 + 4 * tm) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  }
}

template <typename T>
int launch(const float* hs, const float* dxg, float* partial, int T_steps, int D, int B, int H,
           int G, int splits, cudaStream_t stream) {
  const dim3 grid(splits, (4 * H / kTile) * ((H + kTile - 1) / kTile), D * G);
  lstm_recurrence_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(hs, dxg, partial, T_steps, D,
                                                                  B, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_recurrence_wgrad_tile() { return kTile; }

const char* lstm_recurrence_wgrad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: float32, 1: bfloat16 (the rounding of both operands). hs
// (T, D, B, H) f32; dxg (T, D, B, 4H) f32; partial (splits, D, G, H, 4H)
// f32. Needs 4H % 64 == 0, H % 8 == 0, B % G == 0 and T >= 1. Returns a
// cudaError_t (0 on success).
int lstm_recurrence_wgrad(int dtype, const void* hs, const void* dxg, void* partial, int D,
                          int T_steps, int B, int H, int G, int splits, void* stream) {
  const float* h = static_cast<const float*>(hs);
  const float* dg = static_cast<const float*>(dxg);
  float* out = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, dg, out, T_steps, D, B, H, G, splits, st);
  if (dtype == 1) return launch<__nv_bfloat16>(h, dg, out, T_steps, D, B, H, G, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
