// Bidirectional LSTM layer weight gradients, f32 compute dtype: the
// tensor-core variant in three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_wgrad_mma.cu (bf16), the weight-gradient products
// inside the TPU kernels
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
//   * two block tiles of the concatenated [x0 | x1 | h_prev] row, 8 warps
//     as 2 x 4 (gate rows x source columns), templated on the tile:
//     - where H % 32 == 0, 128 gate rows x 128 source columns, warps of
//       64 x 32, a four-stage ring (139 KB: one block an SM, whose 8 warps
//       carry 128 accumulator registers each);
//     - where H % 32 == 16 (4H = 64, 192, 320: a 128-row tile would run
//       past the gates), 64 gate rows, which divide 4H, x the whole row
//       E + H rounded up to 32 columns (to 160; past it 160-column tiles),
//       warps of 32 x 8-40: 40 accumulators a set at the widest, where
//       the 128 x 128 tile at 4H = 320, E + H = 160 would do 1.92 x the
//       result's work; as many stages, up to four, as let two blocks share
//       an SM (three at 160 columns, 92 KB), and launch bounds for two
//       (128 registers a thread);
//     a tile's gate rows past 4H and columns past E + H come from
//     cp.async's zero fill and are not stored. Each operand has its own
//     chunk map: row r of a K-tile is copied by warp r % 8, lane c taking
//     the 16-byte chunks c and c + 32 of the row that the tile has; the
//     source of a column chunk is picked per chunk, so one tile may span
//     two sources, and the h_prev shift is a row offset of one position,
//     with cp.async's zero fill past the ends. Both operands' shared rows
//     are the tile's width plus 8 floats, 8 mod 32;
//   * K-tiles of 32 rows through the cp.async ring, one barrier a K-tile.
//     The tensor cores add into a K-tile's own
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

constexpr int kTileK = 32;    // (t, b) rows per K-tile
constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kSmSmem = 233472;     // shared memory of an SM (bytes)
constexpr int kBlockReserve = 1024;  // what the card keeps of it for each block
constexpr int kWideTile = 128;      // the H % 32 == 0 tile: 128 x 128
constexpr int kNarrowM = 64;        // the H % 32 == 16 tile's gate rows
constexpr int kNarrowMaxN = 160;    // and its widest source columns

// Blocks an SM, cp.async stages and shared memory of the TM x TN tile.
template <int TM, int TN>
struct Tile {
  static constexpr int kBlocks = TM == kNarrowM ? 2 : 1;
  static constexpr int kStrideA = TM + 8, kStrideB = TN + 8;  // f32: 8 mod 32
  static constexpr int kStageBytes = kTileK * (kStrideA + kStrideB) * 4;
  static constexpr int kFit = (kSmSmem / kBlocks - kBlockReserve) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStrideA % 32 == 8 && kStrideB % 32 == 8, "conflict-free fragment loads");
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(TM % 32 == 0 && TN % 32 == 0 && TN <= 256, "two 32-chunk rounds a row at most");
};

struct Args {
  const float* dgc;    // (2, T, B, 4H)
  const float* x[2];   // (T, B, E0), (T, B, E1) or null
  const float* hs[2];  // (T, B, H) per direction
  float* partial;      // (splits, 2, G, 4H, E0 + E1 + H)
  int E0, E1, T, B, H, G;
};

// grid (m tiles * n tiles, splits, 2 * G), block kThreads.
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, Tile<TM, TN>::kBlocks)
    bilstm_wgrad_f32_kernel(const Args a) {
  using Cfg = Tile<TM, TN>;
  constexpr int kStages = Cfg::kStages, SA = Cfg::kStrideA, SB = Cfg::kStrideB;
  constexpr int WM = TM / 2, WN = TN / 4;   // warp tile
  constexpr int MI = WM / 16, NJ = WN / 8;  // m16 and n8 tiles a warp
  constexpr int CA = TM / 4, CB = TN / 4;   // 16-byte chunks of a row of each operand
  constexpr int RB = (CB + 31) / 32;        // chunk rounds of a B row
  const int H4 = 4 * a.H, E = a.E0 + a.E1, Wtot = E + a.H;
  const int mtiles = (H4 + TM - 1) / TM;
  const int m0 = (blockIdx.x % mtiles) * TM;
  const int n0 = (blockIdx.x / mtiles) * TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int d = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int Bg = a.B / a.G, B = a.B, T = a.T;
  const long long rows = (long long)T * Bg;
  const long long n_begin = rows * split / splits;
  const long long n_end = rows * (split + 1) / splits;
  const int nk = (int)((n_end - n_begin + kTileK - 1) / kTileK);

  // [stage][k][gate] dgc rows, then [stage][k][column] source rows
  extern __shared__ __align__(16) unsigned char smem[];
  float (*A_s)[kTileK][SA] = reinterpret_cast<float (*)[kTileK][SA]>(smem);
  float (*B_s)[kTileK][SB] =
      reinterpret_cast<float (*)[kTileK][SB]>(smem + kStages * kTileK * SA * 4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: gate rows WM wm.., columns WN wn..

  // copies: warp r0 takes rows r0, r0 + 8, .. of each K-tile; lane c the
  // 16-byte chunks (4 floats) c (A: gate columns m0 + 4c, where c < CA) and
  // c + 32j (B: source columns n0 + 4(c + 32j), where c + 32j < CB)
  const int c = lane, r0 = warp;
  const bool a_copy = c < CA && m0 + 4 * c < H4;
  bool b_copy[RB];
  const float* src[RB];
  int width[RB], shift[RB], scol[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int col = n0 + 4 * (c + 32 * j);
    b_copy[j] = c + 32 * j < CB;
    src[j] = a.dgc;  // any mapped address when the chunk is past Wtot
    width[j] = 0; shift[j] = 0; scol[j] = 0;
    if (col < a.E0) {
      src[j] = a.x[0]; width[j] = a.E0; scol[j] = col;
    } else if (col < E) {
      src[j] = a.x[1]; width[j] = a.E1; scol[j] = col - a.E0;
    } else if (col < Wtot) {
      src[j] = a.hs[d]; width[j] = a.H; scol[j] = col - E; shift[j] = d ? 1 : -1;
    }
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
  const uint32_t a_dst = smem_u32(&A_s[0][r0][4 * (c < CA ? c : 0)]);
  const uint32_t b_dst = smem_u32(&B_s[0][r0][4 * (c < CB ? c : 0)]);
  constexpr uint32_t kStageA = kTileK * SA * 4, kStageB = kTileK * SB * 4;

  auto load_tile = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const bool real = n_of[i] < n_end;
      const int t = t_of[i], b = brow0 + b_of[i];
      if (c < CA) {
        const bool ok = real && a_copy;
        cp_async16(a_dst + stage * kStageA + i * 8 * SA * 4,
                   ok ? dg + ((size_t)t * B + b) * H4 : a.dgc, ok);
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (!b_copy[j]) continue;
        const int tj = t + shift[j];
        const bool ok = real && width[j] > 0 && tj >= 0 && tj < T;
        cp_async16(b_dst + stage * kStageB + (i * 8 * SB + 128 * j) * 4,
                   ok ? src[j] + ((size_t)tj * B + b) * width[j] + scol[j] : a.dgc, ok);
      }
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

  float acc[MI][NJ][4];  // [m16 tile][n8 tile][fragment]: the running sums
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // fragment loads (bilstm_mma.cuh:mma_tf32): A (gate rows g, g + 8; k t,
  // t + 4) is A_s[k][m], B (k t, t + 4; column g) is B_s[k][n]
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

  // lane (q, t4) holds gate rows q and q + 8, columns 2 t4 and 2 t4 + 1 of
  // each m16 x n8 accumulator; 4H and E + H are multiples of 8, so a pair
  // of columns and a 16-row block are stored whole or not at all
  float* out = a.partial + (((size_t)split * 2 + d) * a.G + g) * H4 * Wtot;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = n0 + WN * wn + 8 * j + 2 * t4;
    if (n >= Wtot) continue;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + WM * wm + 16 * i + q;
      if (m >= H4) continue;
      *reinterpret_cast<float2*>(out + (size_t)m * Wtot + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * Wtot + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <int TM, int TN>
int launch(const Args& a, int splits, cudaStream_t stream) {
  constexpr int kSmem = Tile<TM, TN>::kSmem;
  const int mtiles = (4 * a.H + TM - 1) / TM;
  const int ntiles = (a.E0 + a.E1 + a.H + TN - 1) / TN;
  cudaError_t err = cudaFuncSetAttribute(bilstm_wgrad_f32_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  bilstm_wgrad_f32_kernel<TM, TN><<<dim3(mtiles * ntiles, splits, 2 * a.G), kThreads, kSmem,
                                    stream>>>(a);
  return (int)cudaGetLastError();
}

template <int TM, int TN>
int occupancy() {
  int blocks = 0;
  constexpr int kSmem = Tile<TM, TN>::kSmem;
  if (cudaFuncSetAttribute(bilstm_wgrad_f32_kernel<TM, TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bilstm_wgrad_f32_kernel<TM, TN>,
                                                    kThreads, kSmem) != cudaSuccess)
    return -1;
  return blocks;
}

struct Launch {
  const Args& a;
  int splits;
  cudaStream_t stream;
  template <int TM, int TN> int run() const { return launch<TM, TN>(a, splits, stream); }
};
struct Occupancy {
  template <int TM, int TN> int run() const { return occupancy<TM, TN>(); }
};

// f.run<TM, TN>() for the built tile (tm, tn), `other` for another. The
// narrow tile's widths are 32-160 in steps of 32; 128 x 160 is built too, to
// be timed against them.
template <typename F>
int with_tile(int tm, int tn, const F& f, int other) {
  if (tm == kWideTile && tn == kWideTile) return f.template run<kWideTile, kWideTile>();
  if (tm == kWideTile && tn == kNarrowMaxN) return f.template run<kWideTile, kNarrowMaxN>();
  if (tm == kNarrowM) {
    switch (tn) {
      case 32: return f.template run<kNarrowM, 32>();
      case 64: return f.template run<kNarrowM, 64>();
      case 96: return f.template run<kNarrowM, 96>();
      case 128: return f.template run<kNarrowM, 128>();
      case 160: return f.template run<kNarrowM, 160>();
    }
  }
  return other;
}

}  // namespace

extern "C" {

int bilstm_wgrad_f32_tile_m() { return kWideTile; }
int bilstm_wgrad_f32_tile_n() { return kWideTile; }
int bilstm_wgrad_f32_tile_k() { return kTileK; }
int bilstm_wgrad_f32_stages() { return Tile<kWideTile, kWideTile>::kStages; }
int bilstm_wgrad_f32_smem() { return Tile<kWideTile, kWideTile>::kSmem; }
int bilstm_wgrad_f32_narrow_m() { return kNarrowM; }
int bilstm_wgrad_f32_narrow_max_n() { return kNarrowMaxN; }
int bilstm_wgrad_f32_narrow_blocks() { return Tile<kNarrowM, kNarrowMaxN>::kBlocks; }
int bilstm_wgrad_f32_narrow_smem() { return Tile<kNarrowM, kNarrowMaxN>::kSmem; }

const char* bilstm_wgrad_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blocks of the (tm, tn) tile's kernel the card holds on one SM, or -1 for
// a tile that is not built or a failed query.
int bilstm_wgrad_f32_occupancy(int tm, int tn) {
  return with_tile(tm, tn, Occupancy{}, -1);
}

// The compute dtype is float32. dgc (2, T, B, 4H); x0 (T, B, E0); x1
// (T, B, E1) or null with E1 = 0; hs_f / hs_b (T, B, H); partial (splits,
// 2, G, 4H, E0 + E1 + H) f32, every element written. (tile_m, tile_n) is
// one of the built tiles: 128 x 128 or 128 x 160, 64 x 32-160 in steps of
// 32. Needs H % 16 == 0, E0 > 0, E0 % 8 == E1 % 8 == 0, B % G == 0,
// T * B > 0. Returns a cudaError_t (0 on success).
int bilstm_wgrad_f32(const void* dgc, const void* x0, const void* x1, int E0, int E1,
                     const void* hs_f, const void* hs_b, void* partial, int T_steps, int B, int H,
                     int G, int splits, int tile_m, int tile_n, void* stream) {
  if (H <= 0 || H % 16 || E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 || (E1 > 0) != (x1 != nullptr) ||
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_tile(tile_m, tile_n, Launch{a, splits, st}, (int)cudaErrorInvalidValue);
}

}  // extern "C"
