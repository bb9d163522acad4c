// Bidirectional LSTM layer weight gradients, f32 compute dtype: the
// tensor-core variant in three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_wgrad.cu (which keeps the f32 shapes this kernel
// does not take) and bilstm_wgrad_mma.cu (bf16), the weight-gradient
// products inside the TPU kernels
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _bwd_kernel_packed (the dwih /
//     dw accumulations at :719-735, reduced by reduce_packed_grads at :956),
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel (:436; dW_hh of the
//     lite mode at large H, reduced by _reduce_dw_tiles at :709),
// with their per-tile partial sums summed after the kernel.
//
// Function (the contract of ops/lstm.py:bidir_layer_wgrad): for each
// direction d and weight group g (rows [g * B/G, (g+1) * B/G)),
//   dW_ih[d]    = sum_{t, b}      dgc[d, t, b, :] (x) x[t, b, :]
//   dW_hh[d, g] = sum_{t, b in g} dgc[d, t, b, :] (x) h_prev[d, t, b, :]
// with x the concat of the 1-2 input parts and h_prev hs_f[t-1] (d = 0) or
// hs_b[t+1] (d = 1), zero past the ends. f32 operands, f32 sums.
//
// What bounds it on an H100: a tall-K GEMM per (d, g): M = 4H gate rows,
// N = E + H source columns, K = the (t, b) rows of the group (120,000 at the
// train shape). In f32 that is operations, ~47 ms for the scaled step's
// layer 0 and one E = 512 layer on the CUDA cores (67 TFLOP/s), ~19 ms at
// the 3xTF32 rate on the tensor cores (495 / 3 TFLOP/s).
//
// Design: bilstm_wgrad_mma.cu's, carried to f32:
//   * each f32 product as three tf32 products on mma.sync m16n8k8,
//     big.small + small.big + big.big (split_tf32 in bilstm_mma.cuh: a mask
//     and a subtract), ~2e-6 relative a product, where one tf32 pass keeps
//     ~1e-3 and misses the f32 tolerance; each fragment is split once after
//     it is loaded, not once per mma, and the shared tiles stay plain f32
//     (split while staging, each stage would take twice the memory);
//   * both operands are MN-major in memory (a dgc row holds 4H gates, a
//     source row W columns) and ldmatrix has no 32-bit transposed form, so
//     fragments come from 32-bit shared loads; the row stride is 8 mod 32
//     floats, so lanes (g, t) of a fragment (rows k t, columns g) hit 32
//     distinct banks;
//   * block tile 128 gate rows x 128 source columns of the concatenated
//     [x0 | x1 | h_prev] row, 8 warps of 64 x 32; the tile's source columns
//     are picked per 16-byte chunk, so one tile may span two sources and the
//     h_prev shift is a row offset of one position, with cp.async's zero
//     fill past the ends;
//   * K-tiles of 32 rows through a four-stage cp.async ring (139 KB: one
//     block an SM, whose 8 warps carry 128 accumulator registers each), one
//     barrier a K-tile. The tensor cores add into a K-tile's own
//     accumulators (12 mma deep), which are then added to the running f32
//     sums: the long chain over the group's rows is plain f32 additions,
//     rounded to nearest, and not the tensor core's accumulation;
//   * split-K: block (tile, split, d * G + g) owns rows
//     [rows * split / splits, rows * (split + 1) / splits) of the group and
//     writes its f32 partial tile, empty ranges included, so every partial
//     element is written; no atomics, so the result does not depend on the
//     order blocks run. The wrapper sums the partials over the splits (and,
//     for dW_ih, the groups).

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kTileM = 128;  // gate rows per block
constexpr int kTileN = 128;  // source columns per block
constexpr int kTileK = 32;   // (t, b) rows per K-tile
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStride = kTileM + 8;  // shared row stride (f32): 8 mod 32
static_assert(kTileM == kTileN, "one chunk mapping serves both tiles");
static_assert(kStride % 32 == 8, "conflict-free fragment loads");
constexpr int kSmemHalf = kStages * kTileK * kStride * 4;  // bytes of each operand's ring

struct Args {
  const float* dgc;    // (2, T, B, 4H)
  const float* x[2];   // (T, B, E0), (T, B, E1) or null
  const float* hs[2];  // (T, B, H) per direction
  float* partial;      // (splits, 2, G, 4H, E0 + E1 + H)
  int E0, E1, T, B, H, G;
};

// grid (m tiles * n tiles, splits, 2 * G), block kThreads.
__global__ void __launch_bounds__(kThreads, 1) bilstm_wgrad_f32_kernel(const Args a) {
  const int H4 = 4 * a.H, E = a.E0 + a.E1, Wtot = E + a.H;
  const int mtiles = H4 / kTileM;
  const int m0 = (blockIdx.x % mtiles) * kTileM;
  const int n0 = (blockIdx.x / mtiles) * kTileN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int d = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int Bg = a.B / a.G, B = a.B, T = a.T;
  const long long rows = (long long)T * Bg;
  const long long n_begin = rows * split / splits;
  const long long n_end = rows * (split + 1) / splits;
  const int nk = (int)((n_end - n_begin + kTileK - 1) / kTileK);

  // [stage][k][gate] dgc rows, then [stage][k][column] source rows
  extern __shared__ __align__(16) unsigned char smem[];
  float (*A_s)[kTileK][kStride] = reinterpret_cast<float (*)[kTileK][kStride]>(smem);
  float (*B_s)[kTileK][kStride] = reinterpret_cast<float (*)[kTileK][kStride]>(smem + kSmemHalf);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: gate rows 64 wm.., columns 32 wn..

  // copies: thread -> 16-byte chunk c (4 floats) of rows r0, r0 + 8, .. of each K-tile
  const int c = tid & 31, r0 = tid >> 5;
  // the source of this thread's B chunk (columns n0 + 4c .. +3)
  const int col = n0 + 4 * c;
  const float* src = a.dgc;  // any mapped address when the chunk is past Wtot
  int width = 0, shift = 0, scol = 0;
  if (col < a.E0) {
    src = a.x[0]; width = a.E0; scol = col;
  } else if (col < E) {
    src = a.x[1]; width = a.E1; scol = col - a.E0;
  } else if (col < Wtot) {
    src = a.hs[d]; width = a.H; scol = col - E; shift = d ? 1 : -1;
  }
  const float* dg = a.dgc + (size_t)d * T * B * H4 + m0 + 4 * c;
  // each copied row's (t, b in the group) and its index in the group
  constexpr int kRowsPer = kTileK / 8;
  int t_of[kRowsPer], b_of[kRowsPer];
  long long n_of[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    n_of[i] = n_begin + r0 + 8 * i;
    t_of[i] = (int)(n_of[i] / Bg);
    b_of[i] = (int)(n_of[i] - (long long)t_of[i] * Bg);
  }
  const int step_t = kTileK / Bg, step_b = kTileK - step_t * Bg;
  const int brow0 = g * Bg;
  const uint32_t a_dst = smem_u32(&A_s[0][r0][4 * c]);
  const uint32_t b_dst = smem_u32(&B_s[0][r0][4 * c]);
  constexpr uint32_t kStageBytes = kTileK * kStride * 4;
  constexpr uint32_t kRowBytes = 8 * kStride * 4;

  auto load_tile = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const bool real = n_of[i] < n_end;
      const int t = t_of[i], b = brow0 + b_of[i];
      const uint32_t off = stage * kStageBytes + i * kRowBytes;
      cp_async16(a_dst + off, real ? dg + ((size_t)t * B + b) * H4 : a.dgc, real);
      const int ts = t + shift;
      const bool ok = real && width > 0 && ts >= 0 && ts < T;
      cp_async16(b_dst + off, ok ? src + ((size_t)ts * B + b) * width + scol : a.dgc, ok);
      // the same row 32 rows on
      n_of[i] += kTileK;
      t_of[i] += step_t;
      b_of[i] += step_b;
      if (b_of[i] >= Bg) {
        b_of[i] -= Bg;
        ++t_of[i];
      }
    }
  };

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]: the running sums
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // fragment loads (bilstm_mma.cuh:mma_tf32): A (gate rows g, g + 8; k t,
  // t + 4) is A_s[k][m], B (k t, t + 4; column g) is B_s[k][n]
  const float* a_ld = &A_s[0][t4][64 * wm + q];
  const float* b_ld = &B_s[0][t4][32 * wn + q];

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // K-tile kt landed; every warp is past K-tile kt - 1
    if (kt + kStages - 1 < nk) load_tile((kt + kStages - 1) % kStages);
    cp_async_commit();
    const int st = (kt % kStages) * kTileK * kStride;
    float part[4][4][4];  // this K-tile's sums
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const int k0 = st + 8 * ks * kStride;
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(b_ld[k0 + 8 * j], bb[j][0], bs[j][0]);
        split_tf32(b_ld[k0 + 4 * kStride + 8 * j], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a_ld[k0 + 16 * i], a_ld[k0 + 16 * i + 8],
                             a_ld[k0 + 4 * kStride + 16 * i], a_ld[k0 + 4 * kStride + 16 * i + 8]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) split_tf32(av[v], ab[v], as[v]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[i][j], ab, bs[j][0], bs[j][1]);
          mma_tf32(part[i][j], as, bb[j][0], bb[j][1]);
          mma_tf32(part[i][j], ab, bb[j][0], bb[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  }
  cp_async_wait<0>();

  // lane (q, t4) holds gate rows q and q + 8, columns 2 t4 and 2 t4 + 1 of
  // each m16 x n8 accumulator
  float* out = a.partial + (((size_t)split * 2 + d) * a.G + g) * H4 * Wtot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 32 * wn + 8 * j + 2 * t4;
    if (n >= Wtot) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 64 * wm + 16 * i + q;
      *reinterpret_cast<float2*>(out + (size_t)m * Wtot + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * Wtot + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

extern "C" {

int bilstm_wgrad_f32_tile_m() { return kTileM; }
int bilstm_wgrad_f32_tile_n() { return kTileN; }
int bilstm_wgrad_f32_tile_k() { return kTileK; }
int bilstm_wgrad_f32_stages() { return kStages; }
int bilstm_wgrad_f32_smem() { return 2 * kSmemHalf; }

const char* bilstm_wgrad_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. dgc (2, T, B, 4H); x0 (T, B, E0); x1
// (T, B, E1) or null with E1 = 0; hs_f / hs_b (T, B, H); partial (splits,
// 2, G, 4H, E0 + E1 + H) f32, every element written. Needs H % 32 == 0,
// E0 > 0, E0 % 8 == E1 % 8 == 0, B % G == 0, T * B > 0.
// Returns a cudaError_t (0 on success).
int bilstm_wgrad_f32(const void* dgc, const void* x0, const void* x1, int E0, int E1,
                     const void* hs_f, const void* hs_b, void* partial, int T_steps, int B, int H,
                     int G, int splits, void* stream) {
  if (H <= 0 || H % 32 || E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 || (E1 > 0) != (x1 != nullptr) ||
      G <= 0 || B <= 0 || B % G || T_steps <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dgc = static_cast<const float*>(dgc);
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.hs[0] = static_cast<const float*>(hs_f);
  a.hs[1] = static_cast<const float*>(hs_b);
  a.partial = static_cast<float*>(partial);
  a.E0 = E0; a.E1 = E1; a.T = T_steps; a.B = B; a.H = H; a.G = G;
  const int ntiles = (E0 + E1 + H + kTileN - 1) / kTileN;
  const dim3 grid((4 * H / kTileM) * ntiles, splits, 2 * G);
  constexpr int kSmem = 2 * kSmemHalf;
  cudaError_t err = cudaFuncSetAttribute(bilstm_wgrad_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  bilstm_wgrad_f32_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
