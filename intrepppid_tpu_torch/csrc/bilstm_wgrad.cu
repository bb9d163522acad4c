// Bidirectional LSTM layer weight gradients, hand-written for Hopper
// (sm_90a).
//
// Replaces the weight-gradient products inside the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _bwd_kernel_packed (the dwih /
//     dw accumulations at :719-735), with the per-tile partial sums of
//     reduce_packed_grads (:956) and _reduce_dw_tiles
//     (lstm_pallas_layer.py:709) summed after the kernel.
//
// Function: from the sweep's gate-cotangent stream dgc (2, T, B, 4H) in the
// compute dtype (bilstm_bwd.cu), for each direction d and weight group g
// (rows [g * B/G, (g+1) * B/G)):
//   dW_ih[d]    = sum_{t, b}      dgc[d, t, b, :] (x) x[t, b, :]
//   dW_hh[d, g] = sum_{t, b in g} dgc[d, t, b, :] (x) h_prev[d, t, b, :]
// with x the concat of the 1-2 input parts and h_prev the forward stream at
// the previous position (hs_f[t-1] for d = 0, hs_b[t+1] for d = 1, zero past
// the ends). Operands are compute-dtype values, products accumulate in f32.
//
// Why a second launch and not the sweep: the TPU kernel accumulates these in
// VMEM scratch across its sequential time grid. On Hopper the sweep's block
// already holds the resident weights (up to ~200 KB of the 227 KB of shared
// memory) and the f32 accumulators (64 KB for dW_hh plus 128 KB for layer
// 1's dW_ih) fit neither beside them nor in registers. So the sweep writes
// dgc once, and this kernel reduces over the T * B rows.
//
// What bounds it on an H100: 2 * 4H * (E + H) multiply-adds per (row, step,
// direction) on CUDA cores in f32 (67 TFLOP/s) against reading dgc, x and h
// once: operations bound it.
//
// Design: a split-K product. Block (split, output tile, d * G + g) owns a
// 64 x 64 tile of one source's output (x part 0, x part 1 or h_prev) and the
// rows (t, b) of its time split and weight group; 256 threads each keep a
// 4 x 4 register tile. Chunks of 32 rows of dgc and the source are staged in
// shared memory in f32 and reduced as outer products. Every block writes
// its partial tile (no atomics, so the result does not depend on the order
// blocks run); the wrapper sums the partials over the splits (and, for
// dW_ih, over the groups).
// Not yet done: tensor cores (mma / wgmma) and multi-stage copies. They
// are in bilstm_wgrad_mma.cu (bf16, H % 8 == 0) and bilstm_wgrad_f32.cu
// (f32, H % 32 == 0, three tf32 passes), which take those shapes over; this
// kernel keeps f32 at the other widths, e.g. H = 80 (where the f32 kernel's
// 128 x 128 tiles would do 384 x 256 of work for 320 x 160 of result), and
// runs bf16 only when asked for by name, as the yardstick of the
// tensor-core one.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

constexpr int kTile = 64;     // output tile edge (gates x source columns)
constexpr int kChunk = 32;    // rows staged per shared-memory chunk
constexpr int kThreads = 256;

struct Sources {
  const void* src[3];  // x part 0, x part 1 (or null), hidden stream per direction below
  const void* hs_b;    // direction 1's hidden stream (src[2] is direction 0's)
  int W[3];            // widths: E0, E1 (0 if absent), H
  int col0[3];         // column offset of each source in the partial tile row
  int ntiles[3];       // 64-column tiles per source
};

// grid (splits, 4H/64 * sum(ntiles), 2 * G), block kThreads.
// partial: (splits, 2, G, 4H, Wtot) f32, Wtot = E0 + E1 + H.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_wgrad_kernel(const T* __restrict__ dgc, Sources srcs, float* __restrict__ partial,
                    int T_steps, int B, int H, int G, int Wtot) {
  const int H4 = 4 * H;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int d = blockIdx.z / G;
  const int g = blockIdx.z % G;
  const int Bg = B / G;
  const int mtiles = H4 / kTile;
  const int m0 = (blockIdx.y % mtiles) * kTile;
  int kt = blockIdx.y / mtiles;
  int s = 0;
  while (s < 2 && kt >= srcs.ntiles[s]) kt -= srcs.ntiles[s++];
  const int W = srcs.W[s];
  const int k0 = kt * kTile;
  const T* src = static_cast<const T*>(s == 2 && d == 1 ? srcs.hs_b : srcs.src[s]);
  const int shift = s == 2 ? (d ? 1 : -1) : 0;  // h_prev: the previous position

  // this block's rows: t in [t0, t1), b in group g
  const int t0 = (int)((long long)T_steps * split / nsplit);
  const int t1 = (int)((long long)T_steps * (split + 1) / nsplit);
  const int nrows = (t1 - t0) * Bg;

  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float b_s[kChunk][kTile];

  const int tm = threadIdx.x % 16;  // gates m0 + 4 tm .. +3
  const int tk = threadIdx.x / 16;  // columns k0 + 4 tk .. +3
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
      const int t = t0 + n / Bg;
      const int b = g * Bg + n % Bg;
      load8(av, dgc + (((size_t)d * T_steps + t) * B + b) * H4 + m0 + lc);
      const int ts = t + shift;
      if (k0 + lc < W && ts >= 0 && ts < T_steps)
        load8(bv, src + ((size_t)ts * B + b) * W + k0 + lc);
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

  float* out = partial + (((size_t)split * 2 + d) * G + g) * H4 * Wtot;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * tk + j;
      if (k < W) out[(size_t)m * Wtot + srcs.col0[s] + k] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* dgc, Sources srcs, float* partial, int T_steps, int B, int H, int G,
           int splits, cudaStream_t stream) {
  const int Wtot = srcs.W[0] + srcs.W[1] + srcs.W[2];
  const dim3 grid(splits, (4 * H / kTile) * (srcs.ntiles[0] + srcs.ntiles[1] + srcs.ntiles[2]),
                  2 * G);
  bilstm_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(dgc), srcs,
                                                        partial, T_steps, B, H, G, Wtot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_wgrad_tile() { return kTile; }

const char* bilstm_wgrad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype 0: float32, 1: bfloat16. dgc (2, T, B, 4H); x0 (T, B, E0); x1
// (T, B, E1) or null with E1 = 0; hs_f / hs_b (T, B, H); partial (splits,
// 2, G, 4H, E0 + E1 + H) f32. Needs 4H % 64 == 0 and every width % 8 == 0.
// Returns a cudaError_t (0 on success).
int bilstm_wgrad(int dtype, const void* dgc, const void* x0, const void* x1, int E0, int E1,
                 const void* hs_f, const void* hs_b, void* partial, int T_steps, int B, int H,
                 int G, int splits, void* stream) {
  Sources srcs;
  srcs.src[0] = x0;
  srcs.src[1] = x1;
  srcs.src[2] = hs_f;
  srcs.hs_b = hs_b;
  srcs.W[0] = E0;
  srcs.W[1] = E1;
  srcs.W[2] = H;
  srcs.col0[0] = 0;
  srcs.col0[1] = E0;
  srcs.col0[2] = E0 + E1;
  for (int i = 0; i < 3; ++i) srcs.ntiles[i] = (srcs.W[i] + kTile - 1) / kTile;
  float* out = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(dgc, srcs, out, T_steps, B, H, G, splits, st);
  if (dtype == 1) return launch<__nv_bfloat16>(dgc, srcs, out, T_steps, B, H, G, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
