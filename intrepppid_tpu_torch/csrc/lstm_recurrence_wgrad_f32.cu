// Recurrent weight gradient of the masked LSTM recurrence over time-major
// gates, f32 compute dtype: the tensor-core variant in three tf32 passes,
// hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_wgrad_mma.cu (bf16), the dW accumulation
// inside the TPU kernel (lstm_recurrence_wgrad.cu, on the CUDA cores, is
// reached by name only)
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (the dw_scr sums at
//     :243-264, via _bwd_pallas, :274).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_wgrad): from
// the forward's hs (T, D, B, H) f32 and the sweep's gate cotangents dxg
// (T, D, B, 4H) f32, for each direction d and weight group g (rows
// [g * B/G, (g+1) * B/G)):
//   dw[d, g] = sum_{s >= 1, b in g} hs[s-1, d, b, :]^T (x) dxg[s, d, b, :]
// with f32 operands and f32 sums. Step 0's h_prev is zero and adds
// nothing; hs is read at s-1 by a row offset, no shifted copy is built.
//
// What bounds it on an H100: a tall-K GEMM per (d, g): M = H, N = 4H,
// K = (T-1) * B/G rows (119,920 at the train shape). On the tensor cores in
// three tf32 passes (495 / 3 TFLOP/s) the operations take ~0.24 ms a layer
// at H = 64 and ~0.95 ms at H = 128; reading hs and dxg once (20 H bytes a
// row) takes ~0.46 ms and ~0.92 ms. Bytes bound it at H = 64, the two
// nearly tie at 128; on the CUDA cores (67 TFLOP/s) operations bound it
// from H = 64 up.
//
// Design: lstm_recurrence_wgrad_mma.cu's block tile and row map with
// bilstm_wgrad_f32.cu's arithmetic:
//   * block tile 64 h columns x TN gate columns (TN = 128: 8 warps of
//     32 x 32, one block an SM, whose warps carry 64 running and 64 K-tile
//     accumulators each; TN = 64: warps of 32 x 16, two blocks an SM, the
//     dispatch's tile: it took 0.87 / 3.34 ms at H = 64 / 128 on one layer
//     of the train shape against 0.99 / 3.85 in turns on an H100,
//     ops/lstm_cuda.py:REC_WGRAD_F32_TILE_N);
//   * each product as three tf32 products on mma.sync m16n8k8,
//     big.small + small.big + big.big (split_tf32 in bilstm_mma.cuh), each
//     fragment split once after it is loaded; fragments come from 32-bit
//     shared loads (both operands are MN-major in memory and ldmatrix has
//     no 32-bit transposed form), with both operands' shared row stride 8
//     mod 32 floats, so lanes (g, t) of a fragment hit 32 distinct banks;
//   * nothing is rounded, so the K-tiles (32 rows) come straight from HBM
//     through a cp.async ring of f32 rows, as many stages, up to four, as
//     fit the blocks an SM; columns past H (the last tile of H % 64 == 32)
//     and rows past the block's range come from cp.async's zero fill. One
//     barrier a K-tile. Row r of a K-tile is copied by warp r % 8: its
//     16 + TN / 4 chunks of 16 bytes (hs, then dxg) are dealt over the
//     lanes, one or two a lane;
//   * the tensor cores add into a K-tile's own accumulators (12 mma deep),
//     which are then added to the running f32 sums: the long chain over the
//     group's rows is plain f32 additions, rounded to nearest;
//   * a block's rows are one contiguous range of its group's (s >= 1, b)
//     rows (s-major, b in the group); each thread walks its rows' (s, b) by
//     a fixed step per K-tile, with no division in the loop;
//   * split-K: block (tile, split, d * G + g) owns rows
//     [rows * split / splits, rows * (split + 1) / splits) of the group and
//     writes its f32 partial tile, empty ranges included; no atomics, so
//     the result does not depend on the order blocks run. The wrapper sums
//     the partials over the splits in a fixed order. Columns past H are not
//     written.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kTileM = 64;  // h columns per block
constexpr int kTileK = 32;  // (s, b) rows per K-tile
constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kSmSmem = 233472;      // shared memory of an SM (bytes)
constexpr int kBlockReserve = 1024;  // what the card keeps of it for each block

// Blocks an SM, row strides, cp.async stages and shared memory of the
// 64 x TN tile.
template <int TN>
struct Tile {
  static constexpr int kBlocks = TN == 128 ? 1 : 2;
  static constexpr int kStrideA = kTileM + 8, kStrideB = TN + 8;  // f32: 8 mod 32
  static constexpr int kStageBytes = kTileK * (kStrideA + kStrideB) * 4;
  static constexpr int kFit = (kSmSmem / kBlocks - kBlockReserve) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStrideA % 32 == 8 && kStrideB % 32 == 8, "conflict-free fragment loads");
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(TN == 64 || TN == 128, "the built tiles");
};

struct Args {
  const float* hs;   // (T, D, B, H)
  const float* dxg;  // (T, D, B, 4H)
  float* partial;    // (splits, D, G, H, 4H)
  int T, D, B, H, G;
};

// grid (m tiles * n tiles, splits, D * G), block kThreads.
template <int TN>
__global__ void __launch_bounds__(kThreads, Tile<TN>::kBlocks)
    lstm_recurrence_wgrad_f32_kernel(const Args a) {
  using Cfg = Tile<TN>;
  constexpr int kStages = Cfg::kStages, SA = Cfg::kStrideA, SB = Cfg::kStrideB;
  constexpr int WM = kTileM / 2, WN = TN / 4;  // warp tile
  constexpr int MI = WM / 16, NJ = WN / 8;     // m16 and n8 tiles a warp
  constexpr int CA = kTileM / 4, CB = TN / 4;  // 16-byte chunks of a row of each operand
  constexpr int RC = (CA + CB + 31) / 32;      // chunks a lane copies of a row
  const int H = a.H, H4 = 4 * H, D = a.D, B = a.B;
  const int mtiles = (H + kTileM - 1) / kTileM;
  const int m0 = (blockIdx.x % mtiles) * kTileM;
  const int n0 = (blockIdx.x / mtiles) * TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int d = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int Bg = B / a.G;
  const long long rows = (long long)(a.T - 1) * Bg;
  const long long n_begin = rows * split / splits;
  const long long n_end = rows * (split + 1) / splits;
  const int nk = (int)((n_end - n_begin + kTileK - 1) / kTileK);

  // [stage][k][h column] hs rows, then [stage][k][gate] dxg rows
  extern __shared__ __align__(16) unsigned char smem[];
  float (*A_s)[kTileK][SA] = reinterpret_cast<float (*)[kTileK][SA]>(smem);
  float (*B_s)[kTileK][SB] =
      reinterpret_cast<float (*)[kTileK][SB]>(smem + kStages * kTileK * SA * 4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: h columns WM wm.., gates WN wn..

  // copies: warp r0 takes rows r0, r0 + 8, .. of each K-tile; lane c the
  // 16-byte chunks c + 32 j of the row's CA hs chunks (h columns m0 + 4 c)
  // then CB dxg chunks (gates n0 + 4 (c - CA))
  const int r0 = warp;
  bool c_copy[RC], c_ok[RC];
  const float* c_src[RC];  // the chunk's column in direction d's row 0 of step 0
  size_t c_step[RC];       // elements from one step to the next
  int c_width[RC], c_shift[RC];
  uint32_t c_dst[RC];    // shared address of the chunk in stage 0's row r0
  uint32_t c_stage[RC];  // bytes from one stage of its operand to the next
  uint32_t c_rows8[RC];  // bytes from row r to row r + 8
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    const int c = lane + 32 * j;
    c_copy[j] = c < CA + CB;
    if (c < CA) {
      c_ok[j] = m0 + 4 * c < H;
      c_src[j] = a.hs + (size_t)d * B * H + m0 + 4 * c;
      c_step[j] = (size_t)D * B * H;
      c_width[j] = H;
      c_shift[j] = -1;  // h_prev: the row at step s - 1
      c_dst[j] = smem_u32(&A_s[0][r0][4 * c]);
      c_stage[j] = kTileK * SA * 4;
      c_rows8[j] = 8 * SA * 4;
    } else {
      const int cb = c < CA + CB ? c - CA : 0;
      c_ok[j] = true;  // 4H is a multiple of TN
      c_src[j] = a.dxg + (size_t)d * B * H4 + n0 + 4 * cb;
      c_step[j] = (size_t)D * B * H4;
      c_width[j] = H4;
      c_shift[j] = 0;
      c_dst[j] = smem_u32(&B_s[0][r0][4 * cb]);
      c_stage[j] = kTileK * SB * 4;
      c_rows8[j] = 8 * SB * 4;
    }
  }
  // each copied row's step s, its row b in the group, and its index there
  constexpr int kRowsPer = kTileK / 8;
  int s_of[kRowsPer], b_of[kRowsPer];
  long long n_of[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    n_of[i] = n_begin + r0 + 8 * i;
    s_of[i] = 1 + (int)(n_of[i] / Bg);
    b_of[i] = (int)(n_of[i] - (long long)(s_of[i] - 1) * Bg);
  }
  const int step_s = kTileK / Bg, step_b = kTileK - step_s * Bg;
  const int brow0 = g * Bg;

  auto load_tile = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const bool real = n_of[i] < n_end;
      const size_t b = brow0 + b_of[i];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        if (!c_copy[j]) continue;
        const bool ok = real && c_ok[j];
        cp_async16(c_dst[j] + stage * c_stage[j] + i * c_rows8[j],
                   ok ? c_src[j] + (size_t)(s_of[i] + c_shift[j]) * c_step[j] + b * c_width[j]
                      : a.dxg,
                   ok);
      }
      // the same row 32 rows on
      n_of[i] += kTileK;
      s_of[i] += step_s;
      b_of[i] += step_b;
      if (b_of[i] >= Bg) {
        b_of[i] -= Bg;
        ++s_of[i];
      }
    }
  };

  float acc[MI][NJ][4];  // [m16 tile][n8 tile][fragment]: the running sums
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // fragment loads (bilstm_mma.cuh:mma_tf32): A (h columns g, g + 8; k t,
  // t + 4) is A_s[k][m], B (k t, t + 4; gate g) is B_s[k][n]
  const float* a_ld = &A_s[0][t4][WM * wm + q];
  const float* b_ld = &B_s[0][t4][WN * wn + q];

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
    const int sa = (kt % kStages) * kTileK * SA, sb = (kt % kStages) * kTileK * SB;
    float part[MI][NJ][4];  // this K-tile's sums
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const int ka = sa + 8 * ks * SA, kb = sb + 8 * ks * SB;
      uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split_tf32(b_ld[kb + 8 * j], bb[j][0], bs[j][0]);
        split_tf32(b_ld[kb + 4 * SB + 8 * j], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float av[4] = {a_ld[ka + 16 * i], a_ld[ka + 16 * i + 8],
                             a_ld[ka + 4 * SA + 16 * i], a_ld[ka + 4 * SA + 16 * i + 8]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) split_tf32(av[v], ab[v], as[v]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(part[i][j], ab, bs[j][0], bs[j][1]);
          mma_tf32(part[i][j], as, bb[j][0], bb[j][1]);
          mma_tf32(part[i][j], ab, bb[j][0], bb[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  }
  cp_async_wait<0>();

  // lane (q, t4) holds h columns q and q + 8, gates 2 t4 and 2 t4 + 1 of
  // each m16 x n8 accumulator
  float* out = a.partial + (((size_t)split * D + d) * a.G + g) * H * H4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + WM * wm + 16 * i + q + 8 * half;
      if (m >= H) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + WN * wn + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + (size_t)m * H4 + n) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <int TN>
int launch(const Args& a, int splits, cudaStream_t stream) {
  constexpr int kSmem = Tile<TN>::kSmem;
  const dim3 grid(((a.H + kTileM - 1) / kTileM) * (4 * a.H / TN), splits, a.D * a.G);
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_wgrad_f32_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_wgrad_f32_kernel<TN><<<grid, kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int TN>
int occupancy() {
  int blocks = 0;
  constexpr int kSmem = Tile<TN>::kSmem;
  if (cudaFuncSetAttribute(lstm_recurrence_wgrad_f32_kernel<TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lstm_recurrence_wgrad_f32_kernel<TN>, kThreads, kSmem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

int lstm_recurrence_wgrad_f32_tile_m() { return kTileM; }
int lstm_recurrence_wgrad_f32_tile_k() { return kTileK; }
int lstm_recurrence_wgrad_f32_blocks_128() { return Tile<128>::kBlocks; }
int lstm_recurrence_wgrad_f32_blocks_64() { return Tile<64>::kBlocks; }
int lstm_recurrence_wgrad_f32_smem_128() { return Tile<128>::kSmem; }
int lstm_recurrence_wgrad_f32_smem_64() { return Tile<64>::kSmem; }

const char* lstm_recurrence_wgrad_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blocks of the 64 x tile_n tile's kernel the card holds on one SM, or -1
// for a tile that is not built or a failed query.
int lstm_recurrence_wgrad_f32_occupancy(int tile_n) {
  if (tile_n == 128) return occupancy<128>();
  if (tile_n == 64) return occupancy<64>();
  return -1;
}

// The compute dtype is float32. hs (T, D, B, H) f32; dxg (T, D, B, 4H)
// f32; partial (splits, D, G, H, 4H) f32, every element written. tile_n
// is the block tile's gate columns, 128 or 64. Needs H % 32 == 0,
// B % G == 0, T >= 2, D, B, splits > 0. Returns a cudaError_t (0 on
// success).
int lstm_recurrence_wgrad_f32(const void* hs, const void* dxg, void* partial, int D, int T_steps,
                              int B, int H, int G, int splits, int tile_n, void* stream) {
  if (H <= 0 || H % 32 || D <= 0 || G <= 0 || B <= 0 || B % G || T_steps < 2 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.hs = static_cast<const float*>(hs);
  a.dxg = static_cast<const float*>(dxg);
  a.partial = static_cast<float*>(partial);
  a.T = T_steps; a.D = D; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_n == 128) return launch<128>(a, splits, st);
  if (tile_n == 64) return launch<64>(a, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
