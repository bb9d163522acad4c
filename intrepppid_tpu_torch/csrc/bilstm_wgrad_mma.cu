// Bidirectional LSTM layer weight gradients, bf16 compute dtype: the
// tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_wgrad.cu (which keeps f32 at H % 32 != 0), the
// weight-gradient products inside the TPU kernels
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
// hs_b[t+1] (d = 1), zero past the ends. bf16 operands, f32 sums.
//
// What bounds it on an H100: it is a tall-K GEMM per (d, g): M = 4H gate
// rows, N = E + H source columns, K = the (t, b) rows of the group (120,000
// at the train shape). Each operand row is read once from HBM. At H = 64
// that is ~85 operations per byte, under the ~295 at which the bf16 tensor
// cores rather than HBM become the limit: bytes bound it. At H = 256
// (N = 512-768) operations do.
//
// Design:
//   * bf16 operands to the tensor cores (mma.sync m16n8k16, f32
//     accumulators; bilstm_mma.cuh). Both operands are MN-major in memory
//     (a dgc row holds 4H gates contiguous, a source row W columns), so
//     ldmatrix.trans forms both fragments from row-major shared tiles: no
//     transposed copy anywhere;
//   * block tile 128 gate rows x 128 source columns of the concatenated
//     [x0 | x1 | h_prev] row, 8 warps of 64 x 32; the tile's source columns
//     are picked per 16-byte chunk, so one tile may span two sources and
//     the h_prev shift is a row offset of one position, with cp.async's zero
//     fill past the ends;
//   * K-tiles of 32 rows through a four-stage cp.async ring, one barrier a
//     K-tile. A block's rows are one contiguous range of its group's (t, b)
//     rows (t-major, b in the group): a K-tile spans a few positions of one
//     group and never two groups;
//   * gate rows in 128-row M tiles, the last one masked where 4H is not a
//     multiple of 128 (H % 32 != 0: H = 16, 48, 80, which padding reaches
//     from many embeddings): cp.async zero-fills its dgc chunks past 4H
//     (H % 8 == 0, so a chunk of 8 gates never straddles 4H), a warp whose
//     64 rows lie wholly past 4H skips its products, and rows past 4H are
//     not stored. At H = 80 (4H = 320 = 2.5 tiles) the third tile's upper
//     warps idle: 384 rows of tiles for 320 of result, where 64-row tiles
//     would cover 320 exactly but halve each block's reuse of the source
//     tile;
//   * split-K: block (tile, split, d * G + g) owns rows
//     [rows * split / splits, rows * (split + 1) / splits) of the group and
//     writes its f32 partial tile, empty ranges included, so every partial
//     element is written; no atomics, so the result does not depend on the
//     order blocks run. The wrapper sums the partials over the splits (and,
//     for dW_ih, the groups). The blocks of one (split, d, g) are adjacent
//     in launch order and share their dgc and source rows through L2.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kTileM = 128;  // gate rows per block
constexpr int kTileN = 128;  // source columns per block
constexpr int kTileK = 32;   // (t, b) rows per K-tile
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStride = kTileM + 8;  // shared row stride (bf16): ldmatrix without conflicts
static_assert(kTileM == kTileN, "one chunk mapping serves both tiles");
constexpr int kSmemHalf = kStages * kTileK * kStride * 2;  // bytes of each operand's ring

struct Args {
  const bf16* dgc;    // (2, T, B, 4H)
  const bf16* x[2];   // (T, B, E0), (T, B, E1) or null
  const bf16* hs[2];  // (T, B, H) per direction
  float* partial;     // (splits, 2, G, 4H, E0 + E1 + H)
  int E0, E1, T, B, H, G;
};

// grid (m tiles * n tiles, splits, 2 * G), block kThreads.
__global__ void __launch_bounds__(kThreads, 2) bilstm_wgrad_mma_kernel(const Args a) {
  const int H4 = 4 * a.H, E = a.E0 + a.E1, Wtot = E + a.H;
  const int mtiles = (H4 + kTileM - 1) / kTileM;
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
  bf16 (*A_s)[kTileK][kStride] = reinterpret_cast<bf16 (*)[kTileK][kStride]>(smem);
  bf16 (*B_s)[kTileK][kStride] = reinterpret_cast<bf16 (*)[kTileK][kStride]>(smem + kSmemHalf);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, lr = lane & 7, lm = lane >> 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: gate rows 64 wm.., columns 32 wn..

  // copies: thread -> 16-byte chunk c of rows r and r + 16 of each K-tile
  const int c = tid & 15, r0 = tid >> 4;
  // the source of this thread's B chunk (columns n0 + 8c .. +7)
  const int col = n0 + 8 * c;
  const bf16* src = a.dgc;  // any mapped address when the chunk is past Wtot
  int width = 0, shift = 0, scol = 0;
  if (col < a.E0) {
    src = a.x[0]; width = a.E0; scol = col;
  } else if (col < E) {
    src = a.x[1]; width = a.E1; scol = col - a.E0;
  } else if (col < Wtot) {
    src = a.hs[d]; width = a.H; scol = col - E; shift = d ? 1 : -1;
  }
  const bf16* dg = a.dgc + (size_t)d * T * B * H4 + m0 + 8 * c;
  const bool a_row = m0 + 8 * c < H4;  // this thread's dgc chunk holds gates below 4H
  // whether this warp's 64 gate rows reach below 4H (warp-uniform)
  const bool live = m0 + 64 * wm < H4;
  // each copied row's (t, b in the group) and its index in the group
  int t_of[2], b_of[2];
  long long n_of[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    n_of[i] = n_begin + r0 + 16 * i;
    t_of[i] = (int)(n_of[i] / Bg);
    b_of[i] = (int)(n_of[i] - (long long)t_of[i] * Bg);
  }
  const int step_t = kTileK / Bg, step_b = kTileK - step_t * Bg;
  const int brow0 = g * Bg;
  const uint32_t a_dst = smem_u32(&A_s[0][r0][8 * c]);
  const uint32_t b_dst = smem_u32(&B_s[0][r0][8 * c]);
  constexpr uint32_t kStageBytes = kTileK * kStride * 2;
  constexpr uint32_t kHalfBytes = 16 * kStride * 2;

  auto load_tile = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool real = n_of[i] < n_end;
      const int t = t_of[i], b = brow0 + b_of[i];
      const uint32_t off = stage * kStageBytes + i * kHalfBytes;
      cp_async16(a_dst + off, real && a_row ? dg + ((size_t)t * B + b) * H4 : a.dgc,
                 real && a_row);
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

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // ldmatrix.trans row addresses: A matrix lm covers k + 8 (lm >> 1), gate
  // rows + 8 (lm & 1) (fragments a0..a3); B matrix lm covers k + 8 (lm & 1),
  // columns + 8 (lm >> 1) (b0, b1 of two n8 tiles)
  const uint32_t a_ld = smem_u32(&A_s[0][8 * (lm >> 1) + lr][64 * wm + 8 * (lm & 1)]);
  const uint32_t b_ld = smem_u32(&B_s[0][8 * (lm & 1) + lr][32 * wn + 8 * (lm >> 1)]);

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
    const uint32_t st = (kt % kStages) * kStageBytes;
    if (!live) continue;
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      uint32_t bf[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bf[jj], b_ld + st + (uint32_t)((16 * ks * kStride + 16 * jj) * 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, a_ld + st + (uint32_t)((16 * ks * kStride + 16 * i) * 2));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af, bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // lane (q, t4) holds gate rows q and q + 8, columns 2 t4 and 2 t4 + 1 of
  // each m16 x n8 accumulator
  const int q = lane >> 2, t4 = lane & 3;
  float* out = a.partial + (((size_t)split * 2 + d) * a.G + g) * H4 * Wtot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 32 * wn + 8 * j + 2 * t4;
    if (n >= Wtot) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 64 * wm + 16 * i + q;
      if (m >= H4) continue;  // 4H % 32 == 0: an m16 tile lies wholly below or past 4H
      *reinterpret_cast<float2*>(out + (size_t)m * Wtot + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * Wtot + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

extern "C" {

int bilstm_wgrad_mma_tile_m() { return kTileM; }
int bilstm_wgrad_mma_tile_n() { return kTileN; }
int bilstm_wgrad_mma_tile_k() { return kTileK; }
int bilstm_wgrad_mma_stages() { return kStages; }
int bilstm_wgrad_mma_smem() { return 2 * kSmemHalf; }

const char* bilstm_wgrad_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. dgc (2, T, B, 4H); x0 (T, B, E0); x1
// (T, B, E1) or null with E1 = 0; hs_f / hs_b (T, B, H); partial (splits,
// 2, G, 4H, E0 + E1 + H) f32, every element written. Needs H % 8 == 0,
// E0 > 0, E0 % 8 == E1 % 8 == 0, B % G == 0, T * B > 0.
// Returns a cudaError_t (0 on success).
int bilstm_wgrad_mma(const void* dgc, const void* x0, const void* x1, int E0, int E1,
                     const void* hs_f, const void* hs_b, void* partial, int T_steps, int B, int H,
                     int G, int splits, void* stream) {
  if (H <= 0 || H % 8 || E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 || (E1 > 0) != (x1 != nullptr) ||
      G <= 0 || B <= 0 || B % G || T_steps <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dgc = static_cast<const bf16*>(dgc);
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.hs[0] = static_cast<const bf16*>(hs_f);
  a.hs[1] = static_cast<const bf16*>(hs_b);
  a.partial = static_cast<float*>(partial);
  a.E0 = E0; a.E1 = E1; a.T = T_steps; a.B = B; a.H = H; a.G = G;
  const int ntiles = (E0 + E1 + H + kTileN - 1) / kTileN;
  const dim3 grid(((4 * H + kTileM - 1) / kTileM) * ntiles, splits, 2 * G);
  constexpr int kSmem = 2 * kSmemHalf;
  cudaError_t err = cudaFuncSetAttribute(bilstm_wgrad_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  bilstm_wgrad_mma_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
