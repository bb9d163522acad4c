// Recurrent weight gradient of the masked LSTM recurrence over time-major
// gates, bf16 compute dtype: the tensor-core variant, hand-written for
// Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_wgrad.cu (which keeps f32), the dW
// accumulation inside the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (the dw_scr sums at
//     :243-264, via _bwd_pallas, :274).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_wgrad): from
// the forward's hs (T, D, B, H) f32 and the sweep's gate cotangents dxg
// (T, D, B, 4H) f32, for each direction d and weight group g (rows
// [g * B/G, (g+1) * B/G)):
//   dw[d, g] = sum_{s >= 1, b in g} round(hs[s-1, d, b, :])^T (x)
//                                   round(dxg[s, d, b, :])          (H, 4H)
// with round() to bf16 and f32 sums. Step 0's h_prev is zero and adds
// nothing; hs is read at s-1 by a row offset, no shifted copy is built.
//
// What bounds it on an H100: a tall-K GEMM per (d, g): M = H, N = 4H,
// K = (T-1) * B/G rows (119,920 at the train shape). Both operands arrive
// in f32 and each row is read once from HBM (20 H bytes a row): at H = 64
// ~26 operations a byte, far under the ~295 at which the bf16 tensor cores
// rather than HBM become the limit. Bytes bound it.
//
// Design: the split-K GEMM of bilstm_wgrad_mma.cu over the op's f32 streams.
//   * block tile 64 h columns x 128 gate columns, 8 warps of 32 x 32;
//     mma.sync m16n8k16 (bf16 operands, f32 accumulators; bilstm_mma.cuh).
//     Both operands are MN-major in memory (an hs row holds H columns, a
//     dxg row 4H gates), so ldmatrix.trans forms both fragments from
//     row-major shared tiles;
//   * the staging is what differs: cp.async cannot convert, so a K-tile of
//     64 rows comes from HBM into registers as 16-byte f32 loads, is
//     rounded to bf16 pairs, and is stored to one of two shared stages. The
//     next K-tile's loads are issued right after that store, so they fly
//     while the current one multiplies; one barrier a K-tile;
//   * a block's rows are one contiguous range of its group's (s >= 1, b)
//     rows (s-major, b in the group); each thread walks its rows' (s, b)
//     by a fixed step per K-tile, with no division in the loop;
//   * split-K: block (tile, split, d * G + g) owns rows
//     [rows * split / splits, rows * (split + 1) / splits) of the group and
//     writes its f32 partial tile, empty ranges included; no atomics, so
//     the result does not depend on the order blocks run. The wrapper sums
//     the partials over the splits in a fixed order. Columns past H (H = 32
//     and the last tile of H % 64 == 32) are staged as zeros and not
//     written.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kTileM = 64;   // h columns per block
constexpr int kTileN = 128;  // gate columns per block
constexpr int kTileK = 64;   // (s, b) rows per K-tile
constexpr int kThreads = 256;
constexpr int kRowSlots = kTileK / (kThreads / 32);  // rows each thread stages: 8
constexpr int kStrideA = kTileM + 8;   // shared row strides (bf16): ldmatrix without conflicts
constexpr int kStrideB = kTileN + 8;
constexpr int kStageA = kTileK * kStrideA;  // elements
constexpr int kStageB = kTileK * kStrideB;
constexpr int kSmem = 2 * (kStageA + kStageB) * 2;  // two stages, bytes

struct Args {
  const float* hs;   // (T, D, B, H)
  const float* dxg;  // (T, D, B, 4H)
  float* partial;    // (splits, D, G, H, 4H)
  int T, D, B, H, G;
};

// Two f32 values -> bf16x2 and a pair of them stored as 8 bytes.
__device__ __forceinline__ void store4(bf16* dst, const float4& v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// grid (m tiles * n tiles, splits, D * G), block kThreads.
__global__ void __launch_bounds__(kThreads, 2) lstm_recurrence_wgrad_mma_kernel(const Args a) {
  const int H = a.H, H4 = 4 * H, D = a.D, B = a.B;
  const int mtiles = (H + kTileM - 1) / kTileM;
  const int m0 = (blockIdx.x % mtiles) * kTileM;
  const int n0 = (blockIdx.x / mtiles) * kTileN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int d = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int Bg = B / a.G;
  const long long rows = (long long)(a.T - 1) * Bg;
  const long long n_begin = rows * split / splits;
  const long long n_end = rows * (split + 1) / splits;
  const int nk = (int)((n_end - n_begin + kTileK - 1) / kTileK);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* A_s = reinterpret_cast<bf16*>(smem);  // [stage][k][h column]
  bf16* B_s = A_s + 2 * kStageA;              // [stage][k][gate]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane & 7, lm = lane >> 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: h columns 32 wm.., gates 32 wn..

  // staging: this thread's K-tile rows are warp + 8 i (i < kRowSlots). It
  // loads 16 bytes of dxg at gates n0 + 4 lane of each, and 16 bytes of hs
  // at h columns m0 + 4 (lane % 16) of the rows with i % 2 == lane / 16
  const int r0 = warp;
  const int ac = lane & 15, ai = lane >> 4;
  const bool a_col = m0 + 4 * ac < H;
  int s_of[kRowSlots], b_of[kRowSlots];
#pragma unroll
  for (int i = 0; i < kRowSlots; ++i) {
    const long long n = n_begin + r0 + 8 * i;
    s_of[i] = 1 + (int)(n / Bg);
    b_of[i] = (int)(n - (long long)(s_of[i] - 1) * Bg);
  }
  long long n_row = n_begin + r0;  // row of slot 0; slot i is 8 i further
  const int step_s = kTileK / Bg, step_b = kTileK - step_s * Bg;
  const int brow0 = g * Bg;
  const float* hs_d = a.hs + (size_t)d * B * H + m0 + 4 * ac;
  const float* dxg_d = a.dxg + (size_t)d * B * H4 + n0 + 4 * lane;
  const size_t hs_step = (size_t)D * B * H, dxg_step = (size_t)D * B * H4;

  float4 ra[kRowSlots / 2], rb[kRowSlots];
  auto load = [&]() {
#pragma unroll
    for (int i = 0; i < kRowSlots; ++i) {
      const bool real = n_row + 8 * i < n_end;
      const size_t b = brow0 + b_of[i];
      rb[i] = real ? __ldg(reinterpret_cast<const float4*>(
                         dxg_d + (size_t)s_of[i] * dxg_step + b * H4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      if ((i & 1) == ai)
        ra[i >> 1] = real && a_col ? __ldg(reinterpret_cast<const float4*>(
                                         hs_d + (size_t)(s_of[i] - 1) * hs_step + b * H))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      // the same slot one K-tile on
      s_of[i] += step_s;
      b_of[i] += step_b;
      if (b_of[i] >= Bg) {
        b_of[i] -= Bg;
        ++s_of[i];
      }
    }
    n_row += kTileK;
  };
  auto store = [&](int stage) {
    bf16* as = A_s + stage * kStageA + 4 * ac;
    bf16* bs = B_s + stage * kStageB + 4 * lane;
#pragma unroll
    for (int i = 0; i < kRowSlots; ++i) {
      store4(bs + (r0 + 8 * i) * kStrideB, rb[i]);
      if ((i & 1) == ai) store4(as + (r0 + 8 * i) * kStrideA, ra[i >> 1]);
    }
  };

  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // ldmatrix.trans row addresses: A matrix lm covers k + 8 (lm >> 1), h
  // columns + 8 (lm & 1) (fragments a0..a3); B matrix lm covers k + 8
  // (lm & 1), gates + 8 (lm >> 1) (b0, b1 of two n8 tiles)
  const uint32_t a_ld = smem_u32(A_s + (8 * (lm >> 1) + lr) * kStrideA + 32 * wm + 8 * (lm & 1));
  const uint32_t b_ld = smem_u32(B_s + (8 * (lm & 1) + lr) * kStrideB + 32 * wn + 8 * (lm >> 1));

  if (nk > 0) load();
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    store(stage);
    if (kt + 1 < nk) load();
    // K-tile kt is in place; every warp is past K-tile kt - 1, whose stage
    // the next store overwrites
    __syncthreads();
    const uint32_t sa = a_ld + stage * kStageA * 2, sb = b_ld + stage * kStageB * 2;
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(af[i], sa + (uint32_t)((16 * ks * kStrideA + 16 * i) * 2));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bfr[jj], sb + (uint32_t)((16 * ks * kStrideB + 16 * jj) * 2));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
  }

  // lane (q, t4) holds h columns q and q + 8, gates 2 t4 and 2 t4 + 1 of
  // each m16 x n8 accumulator
  const int q = lane >> 2, t4 = lane & 3;
  float* out = a.partial + (((size_t)split * D + d) * a.G + g) * H * H4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 32 * wm + 16 * i + q + 8 * half;
      if (m >= H) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 32 * wn + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + (size_t)m * H4 + n) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

int lstm_recurrence_wgrad_mma_tile_m() { return kTileM; }
int lstm_recurrence_wgrad_mma_tile_n() { return kTileN; }
int lstm_recurrence_wgrad_mma_tile_k() { return kTileK; }
int lstm_recurrence_wgrad_mma_smem() { return kSmem; }

const char* lstm_recurrence_wgrad_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. hs (T, D, B, H) f32; dxg (T, D, B, 4H)
// f32; partial (splits, D, G, H, 4H) f32, every element written. Needs
// H % 32 == 0, B % G == 0, T >= 2, D, B, splits > 0. Returns a cudaError_t
// (0 on success).
int lstm_recurrence_wgrad_mma(const void* hs, const void* dxg, void* partial, int D, int T_steps,
                              int B, int H, int G, int splits, void* stream) {
  if (H <= 0 || H % 32 || D <= 0 || G <= 0 || B <= 0 || B % G || T_steps < 2 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.hs = static_cast<const float*>(hs);
  a.dxg = static_cast<const float*>(dxg);
  a.partial = static_cast<float*>(partial);
  a.T = T_steps; a.D = D; a.B = B; a.H = H; a.G = G;
  const dim3 grid(((H + kTileM - 1) / kTileM) * (4 * H / kTileN), splits, D * G);
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_wgrad_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_wgrad_mma_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
