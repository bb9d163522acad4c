// Bidirectional LSTM layer recurrence over the input gates, bf16 compute
// dtype, for layers whose weights fit no block: the tensor-core variant,
// hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_wide.cu (which keeps the widths this kernel
// does not take) and bilstm_fwd_wide_f32.cu (f32), together with
// bilstm_gates_mma.cu (the input
// projection), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _fwd_kernel (via _fwd_pallas,
//     :376) -- the wide route's recurrence (ops/lstm_cuda.py:layer_route;
//     the scaled configuration's H = 256, and H = 128), with_states=False
//     (eval variant, cs null) and True (train variant: also the cell streams).
//
// Function (the contract of ops/lstm.py:bidir_recurrence): for each
// direction d (0 forward, 1 reverse) and row r, step s reads position
// pos = s (d = 0) or T-1-s (d = 1) and computes
//   gates = xg[d, pos, r] + round(h) @ W_hh[d, g]^T
// (xg the f32 input gates, gate order i, f, g, o; g = r / (B / G), the row's
// weight group), then the cell update; the state moves iff pos <
// lengths[r]. Every step writes the (possibly frozen) h to hs_f[pos] /
// hs_b[pos] and, in the train variant, c to cs_f[pos] / cs_b[pos], both
// bf16; h and c are f32 and the recurrent operand is h rounded to bf16.
//
// What bounds it on an H100: the roofline bound is bytes (the f32 xg read
// once, ~3.7 ms for the scaled step's layer 0 and one E = 512 layer); the
// product is far below it on the tensor cores. What governs is the serial
// chain of a step, T times: one product over the block's W_hh slice, the
// cell maths, and the exchange of the new h between the blocks of a cluster.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes):
//   * the split of bilstm_fwd_wide.cu: a cluster of 8 blocks per (row tile,
//     direction); block k owns hidden units [k H/8, (k+1) H/8) and keeps
//     their 4H/8 gate rows of W_hh[d, g] resident, ONE bf16 copy (64 KB at
//     H = 256, not the 128 KB f32 copy of the CUDA-core kernel), gate rows
//     permuted so that a lane holds a unit's four gates, rows padded by 8
//     elements (ldmatrix conflict-free);
//   * the gate product on mma.sync m16n8k16, swapped (the weights are the
//     16-row A operand, 8 rows of the tile the n8 operand), from the
//     tile's whole h in bf16; 8 warps: warp w takes the 8 units 8 (w % UG)
//     .. of the block's UG groups and every (8 / UG)-th n8 tile, so the
//     cell maths needs no exchange. The product starts from zero and xg is
//     added after it, the order of bilstm_bwd_lite_mma.cu's recompute and of
//     the plain twin;
//   * the tile's h is double-buffered in every block: step s reads buffer
//     s % 2 and pushes the block's new h into buffer (s + 1) % 2 of all 8
//     blocks through distributed shared memory, 16-byte stores of a row's
//     units staged first in shared memory; so ONE cluster barrier a step
//     suffices (a block pushes into buffer s % 2 at step s + 1 only after
//     every block has arrived at step s's barrier, i.e. finished reading it);
//   * between the barrier's arrive and its wait the step's hs / cs stores
//     leave, 16 bytes a thread from the staged tile; the next step's f32 xg
//     slice is loaded into registers, in the accumulator's fragment layout,
//     right after the cell maths, a whole step ahead of its use;
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32;
//   * a tile stops at its longest row: past it the forward direction writes
//     its frozen state, the reverse direction zeros (its state before its
//     first real step);
//   * row tiles of BR in {16, 32, 40, 64, 80} rows (multiples of the n8
//     tile), each weight group cut into its own tiles; ops/lstm_cuda.py
//     picks BR by waves (cudaOccupancyMaxActiveClusters) and shared memory.
//     A step costs a fixed latency (product chain, barrier, pushes) plus a
//     share a row, so the tiles whose shared memory leaves room for two
//     blocks an SM are compiled for two (blocks_per_sm): one block's product
//     runs while the other waits on its barrier, and at H = 256 the 32-row
//     tile puts 30 clusters on the card at once, the scaled shapes in one wave.
// The eval and train variants run the same code for h: they give the same
// hs bits. This kernel takes H = 128 and 256 (whole 8-unit groups in each
// block, and 8 warps split evenly over them).
//
// H = 160, 192, 224 and 288 (every bf16 layer of 129-256 units that pads to
// them, and of 257-288 units, padded to 288; both layers of the two-layer
// models at embedding 160 and 272) take a second kernel of the same design,
// bilstm_fwd_wide_mma_uneven_kernel:
//   * the H / 8 unit groups split unevenly over the cluster's blocks, 2 / 3 at
//     160, 3 at 192, 3 / 4 at 224, 4 / 5 at 288
//     (lstm_recurrence_wide_mma.cuh:unit_groups), so the 8 warps cannot
//     take the groups evenly (at 192 neither: 3 groups over 8 warps). The
//     work of a block is its UG x NT items
//     (unit group, n8 row tile), each a unit's four gates for 8 rows in one
//     lane (no exchange). They are dealt out over all 8 warps as contiguous
//     runs in group-major order: warp w takes items [w N / 8, (w + 1) N / 8)
//     of the N = UG NT, at most ceil(MG NT / 8) items of at most two groups
//     (MG = ceil(H / 64), the most groups a block owns). So every warp works
//     in the gate product and the cell. (bilstm_bwd_lite_mma.cu's uneven
//     instance gives warp w < UG one group over every n8 tile instead, which
//     idles 3-4 warps in its gate product.)
//   * the weights stay resident: the bf16 slice of the largest block (MG
//     groups, 32 MG gate rows of H + 8); with the two h tiles and the staging
//     of 8 MG units, 57,856 / 68,096 / 94,208 B at 32-row tiles at 160 / 192
//     / 224, so two blocks fit an SM (blocks_per_sm_u), and 138,752 B at 288:
//     one block an SM (no tile fits two there);
//   * the gate product's weight fragments of the next round load while the
//     current round's products run (pipelined_rounds, two fragment buffers).
//     At one block an SM (288) a round is a k32 step of both of a warp's
//     groups (two fragment sets a buffer, within the 255 registers of a
//     thread). At two blocks an SM (160-224) a thread has 128 registers, and
//     a round is a k32 step of ONE group (SEGS = 1: the rounds go step 0
//     group 0, step 0 group 1, step 1 group 0, ...; a warp of one group
//     skips the second group's rounds), which halves the fragments held;
//     the other block's products cover the shorter rounds;
//   * row tiles of 16, 32 and 40 rows, at most 4 items a warp. At the train
//     step's 400 rows in 5 groups 32-row tiles make 30 clusters: at 160-224
//     one wave at two blocks an SM (as the even kernel at 256), at 288 two
//     waves of 15. 64- and 80-row tiles (5-7 items a warp at 288) fit
//     shared memory but not the registers: with the fragments loaded right
//     before their products the 80-row tile spilled and took 21.39 ms a
//     layer in one wave against 15.93 for 32 rows in two (chip_smoke.py
//     phase widths, PERF.md), so they are not built.

#include <cooperative_groups.h>

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"
#include "lstm_recurrence_wide_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // bf16 elements of padding on weight, h and staging rows

// Dynamic shared memory of the <H, BR> instance (bytes), in layout order:
// the permuted W_hh slice, two h tiles, the staged new h and c of the block.
__host__ __device__ constexpr int smem_w(int H) { return 4 * (H / 8) * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_h(int H, int BR) { return 2 * BR * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_stage(int H, int BR) {
  return 2 * BR * (H / 8 + kPad) * 2;
}
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_w(H) + smem_h(H, BR) + smem_stage(H, BR);
}

struct Args {
  const float* xg;  // (2, T, B, 4H)
  const int* lengths;
  const bf16* w_hh;  // (2, G, 4H, H)
  bf16* hs[2];       // per direction, (T, B, H)
  bf16* cs[2];       // null: the eval variant
  float* hn;         // (2, B, H)
  float* cn;
  int T, B, G;
};

// Blocks an SM that the <H, BR> instance is compiled for: two where two fit
// the SM's shared memory (228 KB, 1 KB of it reserved a block), so that one
// block's product runs while the other waits on its cluster barrier.
__host__ __device__ constexpr int blocks_per_sm(int H, int BR) {
  return 2 * (smem_bytes(H, BR) + 1024) <= 233472 ? 2 : 1;
}

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads threads.
template <int H, int BR>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(H, BR))
    bilstm_fwd_wide_mma_kernel(const Args a) {
  constexpr int U = H / kWideCluster, U4 = 4 * U, H4 = 4 * H;
  constexpr int UG = U / 8;               // 8-unit groups a block owns
  constexpr int NT = BR / 8;              // n8 tiles of the row tile
  constexpr int NG = kWarps / UG;         // warps that share a unit group
  constexpr int GI = (NT + NG - 1) / NG;  // n8 tiles of a warp
  constexpr int KS = H + kPad;            // weight / h row stride (bf16)
  constexpr int SS = U + kPad;            // staging row stride (bf16)
  constexpr int HC = H / 8;               // 16-byte chunks of a weight row
  constexpr int UC = U / 8;               // 16-byte chunks of a row's slice of units
  constexpr int NCH = (BR * UC + kThreads - 1) / kThreads;
  constexpr int W_AT = 0;
  constexpr int H_AT = W_AT + smem_w(H);
  constexpr int ST_AT = H_AT + smem_h(H, BR);
  static_assert(U % 8 == 0 && kWarps % UG == 0 && BR % 8 == 0, "shape");
  static_assert(smem_bytes(H, BR) == ST_AT + smem_stage(H, BR), "layout");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B;
  const int Bg = B / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;
  bf16* hs = a.hs[d];
  bf16* cs = a.cs[d];
  const bool train = cs != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  bf16* h_s = reinterpret_cast<bf16*>(smem + H_AT);  // [2][BR][KS]
  bf16* hst = reinterpret_cast<bf16*>(smem + ST_AT);  // [BR][SS]: the block's new h
  bf16* cst = hst + BR * SS;                           // [BR][SS]: its new c

  // stage this block's 4U gate rows of W_hh[d, group], permuted: row p =
  // 32 * (ul / 8) + 8 * gate + ul % 8 holds gate `gate` of local unit ul
  {
    const bf16* w = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    for (int idx = tid; idx < U4 * HC; idx += kThreads) {
      const int p = idx / HC, c = idx - p * HC;
      const int ul = 8 * (p >> 5) + (p & 7), q = (p & 31) >> 3;
      cp_async16(smem0 + W_AT + (uint32_t)((p * KS + 8 * c) * 2),
                 w + ((size_t)q * H + rank * U + ul) * H + 8 * c, true);
    }
    cp_async_commit();
  }
  // the first step's h: zero
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < BR * KS / 8; idx += kThreads) reinterpret_cast<uint4*>(h_s)[idx] = zero4;

  // the tile's longest row bounds the positions that do any work; every
  // block of the cluster finds the same maxlen, so they take the same barriers
  int maxlen = 0;
  for (int rl = 0; rl < BR; ++rl) {
    const int r = tile_row(tile, rl, BR, Bg);
    if (r >= 0) maxlen = max(maxlen, min(a.lengths[r], T));
  }

  // this thread's 16-byte chunks of the staged tiles (tile row idx / UC,
  // units 8 (idx % UC) ..): -1 past the group's end, -2 no chunk
  int crow[NCH];
  uint4 hv[NCH], cv[NCH];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int idx = tid + m * kThreads;
    crow[m] = idx < BR * UC ? tile_row(tile, idx / UC, BR, Bg) : -2;
    hv[m] = zero4;
    cv[m] = zero4;
  }
  auto store_chunks = [&](int pos) {
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (crow[m] < 0) continue;
      const int c = (tid + m * kThreads) % UC;
      const size_t at = ((size_t)pos * B + crow[m]) * H + rank * U + 8 * c;
      *reinterpret_cast<uint4*>(hs + at) = hv[m];
      if (train) *reinterpret_cast<uint4*>(cs + at) = cv[m];
    }
  };
  // the reverse direction meets positions [maxlen, T) first, with its state still zero
  if (d == 1)
    for (int pos = maxlen; pos < T; ++pos) store_chunks(pos);

  // lane (g, t) of warp w: unit ul = 8 ug + g of the block, n8 tiles
  // ng + NG j, tile rows 8 nt + 2t + i
  const int ug = warp % UG, ng = warp / UG;
  const int ul = 8 * ug + g, unit = rank * U + ul;
  int row[GI][2], len[GI][2];
  float h[GI][2], c[GI][2], xv[GI][2][4];
#pragma unroll
  for (int j = 0; j < GI; ++j) {
    const int nt = ng + NG * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = nt < NT ? tile_row(tile, 8 * nt + 2 * t + i, BR, Bg) : -1;
      row[j][i] = r;
      len[j][i] = r >= 0 ? a.lengths[r] : 0;
      h[j][i] = 0.0f;
      c[j][i] = 0.0f;
    }
  }
  const float* xgd = a.xg + (size_t)d * T * B * H4;
  // the four gates of this lane's unit and rows at `pos`, into registers
  auto load_xg = [&](int pos) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row[j][i];
        const float* src = xgd + ((size_t)pos * B + (r >= 0 ? r : 0)) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[j][i][q] = r >= 0 ? __ldg(src + q * H) : 0.0f;
      }
  };
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;
  if (maxlen > 0) load_xg(pos0);

  // gate product: A rows 32 ug + 16 mt + lr + 8 (lm & 1), columns k0 + 8 (lm >> 1);
  // B: h tile rows 8 nt + lr, columns k0 + 8 lm (two k16 steps a load)
  const uint32_t a_gate =
      smem0 + W_AT + (uint32_t)(((32 * ug + lr + 8 * (lm & 1)) * KS + 8 * (lm >> 1)) * 2);
  const uint32_t b_gate = (uint32_t)(((8 * ng + lr) * KS + 8 * lm) * 2);
  float acc[GI][2][4];
  auto gate_mma = [&](int buf) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.0f;
    const uint32_t b_base = smem0 + H_AT + (uint32_t)(buf * BR * KS * 2) + b_gate;
    uint32_t fa[2][2][2][4];  // [buffer][k16 half][mt]
    auto load_a = [&](uint32_t (&f)[2][2][4], int r) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(f[kh][mt], a_gate + (uint32_t)((16 * mt * KS + 32 * r + 16 * kh) * 2));
    };
    load_a(fa[0], 0);
#pragma unroll
    for (int r = 0; r < H / 32; ++r) {
      uint32_t(&f)[2][2][4] = fa[r & 1];
      if (r + 1 < H / 32) load_a(fa[(r + 1) & 1], r + 1);
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (ng + NG * j >= NT) continue;
        uint32_t b[4];
        ldmatrix_x4(b, b_base + (uint32_t)((8 * NG * j * KS + 32 * r) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[j][mt], f[kh][mt], b[2 * kh], b[2 * kh + 1]);
      }
    }
  };

  cp_async_wait<0>();
  __syncthreads();  // W_hh's slice and the zero h tile are in place
  cluster.sync();   // every block of the cluster runs (its shared memory takes pushes)

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    const int buf = s & 1;
    gate_mma(buf);

    // the cell: lane (g, t) holds the four gates of unit `ul` for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      const int nt = ng + NG * j;
      if (nt >= NT) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ig = fast_sigmoid(xv[j][i][0] + acc[j][0][i]);
        const float fg = fast_sigmoid(xv[j][i][1] + acc[j][0][2 + i]);
        const float gg = fast_tanh(xv[j][i][2] + acc[j][1][i]);
        const float og = fast_sigmoid(xv[j][i][3] + acc[j][1][2 + i]);
        const float c_new = fg * c[j][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (pos < len[j][i]) {
          c[j][i] = c_new;
          h[j][i] = h_new;
        }
        const int rl = 8 * nt + 2 * t + i;
        hst[rl * SS + ul] = __float2bfloat16_rn(h[j][i]);
        if (train) cst[rl * SS + ul] = __float2bfloat16_rn(c[j][i]);
      }
    }
    if (s + 1 < maxlen) load_xg(pos + dpos);
    __syncthreads();  // the block's new h (and c) tile is staged

#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (crow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / UC, cc = idx - rl * UC;
      hv[m] = *reinterpret_cast<const uint4*>(hst + rl * SS + 8 * cc);
      if (train) cv[m] = *reinterpret_cast<const uint4*>(cst + rl * SS + 8 * cc);
      if (s + 1 < maxlen) {
        // the next step's h tile of every block of the cluster
        bf16* dst = h_s + ((buf ^ 1) * BR + rl) * KS + rank * U + 8 * cc;
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k)
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, k)) = hv[m];
      }
    }
    cluster_arrive_release();  // this block's pushes of step s are written
    store_chunks(pos);
    cluster_wait_acquire();  // every block's pushes landed; every block is past this step
  }

  // the forward direction's state is frozen past the tile's longest row
  if (d == 0)
    for (int p = maxlen; p < T; ++p) store_chunks(p);
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row[j][i];
      if (r < 0) continue;
      a.hn[((size_t)d * B + r) * H + unit] = h[j][i];
      a.cn[((size_t)d * B + r) * H + unit] = c[j][i];
    }
}

// ------------------------------- H = 160, 192, 224, 288: uneven group split
// Dynamic shared memory of the uneven instance <H, BR> (bytes), in layout
// order: the W_hh slice, the two h tiles and the staging, each per-block
// width sized for the block that owns the most groups, MG = ceil(H / 64).
__host__ __device__ constexpr int uneven_groups(int H) { return (H + 63) / 64; }
__host__ __device__ constexpr int smem_w_u(int H) { return 32 * uneven_groups(H) * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_stage_u(int H, int BR) {
  return 2 * BR * (8 * uneven_groups(H) + kPad) * 2;
}
__host__ __device__ constexpr int smem_bytes_u(int H, int BR) {
  return smem_w_u(H) + smem_h(H, BR) + smem_stage_u(H, BR);
}
// Blocks an SM the uneven instance <H, BR> is compiled for: two where two
// fit the SM's shared memory (160-224), else one (288).
__host__ __device__ constexpr int blocks_per_sm_u(int H, int BR) {
  return 2 * (smem_bytes_u(H, BR) + 1024) <= 233472 ? 2 : 1;
}

// One round of the gate product's weight fragments: [group of the round][k16 half][m16 half].
template <int SEGS>
struct UnevenFrag {
  uint32_t a[SEGS][2][2][4];
};

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads threads.
template <int H, int BR>
__global__ void __launch_bounds__(kThreads, blocks_per_sm_u(H, BR))
    bilstm_fwd_wide_mma_uneven_kernel(const Args a) {
  constexpr int MG = uneven_groups(H);  // most unit groups a block owns
  // groups whose fragments a round holds: both at one block an SM, one at two
  constexpr int SEGS = blocks_per_sm_u(H, BR) == 1 ? 2 : 1;
  constexpr int ROUNDS = (H / 32) * (2 / SEGS);
  constexpr int UM = 8 * MG;            // most units a block owns
  constexpr int H4 = 4 * H;
  constexpr int NT = BR / 8;                              // n8 tiles of the row tile
  constexpr int GI = (MG * NT + kWarps - 1) / kWarps;     // most items a warp takes
  constexpr int KS = H + kPad;                            // weight / h row stride (bf16)
  constexpr int SS = UM + kPad;                           // staging row stride (bf16)
  constexpr int HC = H / 8;                               // 16-byte chunks of a weight row
  constexpr int NCH = (BR * MG + kThreads - 1) / kThreads;
  constexpr int W_AT = 0;
  constexpr int H_AT = W_AT + smem_w_u(H);
  constexpr int ST_AT = H_AT + smem_h(H, BR);
  static_assert(H % 32 == 0 && BR % 8 == 0 && GI <= NT + 1 && GI <= 4, "shape");
  static_assert(smem_bytes_u(H, BR) == ST_AT + smem_stage_u(H, BR), "layout");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B;
  const int Bg = B / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;
  bf16* hs = a.hs[d];
  bf16* cs = a.cs[d];
  const bool train = cs != nullptr;
  // this block's unit groups [glo, ghi): UG groups, U units from unit0
  int glo, ghi;
  recwide::unit_groups(H, rank, glo, ghi);
  const int UG = ghi - glo, U = 8 * UG, U4 = 4 * U, unit0 = 8 * glo;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  bf16* h_s = reinterpret_cast<bf16*>(smem + H_AT);  // [2][BR][KS]
  bf16* hst = reinterpret_cast<bf16*>(smem + ST_AT);  // [BR][SS]: the block's new h
  bf16* cst = hst + BR * SS;                           // [BR][SS]: its new c

  // stage this block's 4U gate rows of W_hh[d, group], permuted: row p =
  // 32 * (ul / 8) + 8 * gate + ul % 8 holds gate `gate` of local unit ul
  {
    const bf16* w = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    for (int idx = tid; idx < U4 * HC; idx += kThreads) {
      const int p = idx / HC, c = idx - p * HC;
      const int ul = 8 * (p >> 5) + (p & 7), q = (p & 31) >> 3;
      cp_async16(smem0 + W_AT + (uint32_t)((p * KS + 8 * c) * 2),
                 w + ((size_t)q * H + unit0 + ul) * H + 8 * c, true);
    }
    cp_async_commit();
  }
  // the first step's h: zero
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < BR * KS / 8; idx += kThreads) reinterpret_cast<uint4*>(h_s)[idx] = zero4;

  // the tile's longest row bounds the positions that do any work; every
  // block of the cluster finds the same maxlen, so they take the same barriers
  int maxlen = 0;
  for (int rl = 0; rl < BR; ++rl) {
    const int r = tile_row(tile, rl, BR, Bg);
    if (r >= 0) maxlen = max(maxlen, min(a.lengths[r], T));
  }

  // this thread's 16-byte chunks of the staged tiles (tile row idx / UG,
  // units 8 (idx % UG) ..): -1 past the group's end, -2 no chunk
  int crow[NCH];
  uint4 hv[NCH], cv[NCH];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int idx = tid + m * kThreads;
    crow[m] = idx < BR * UG ? tile_row(tile, idx / UG, BR, Bg) : -2;
    hv[m] = zero4;
    cv[m] = zero4;
  }
  auto store_chunks = [&](int pos) {
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (crow[m] < 0) continue;
      const int c = (tid + m * kThreads) % UG;
      const size_t at = ((size_t)pos * B + crow[m]) * H + unit0 + 8 * c;
      *reinterpret_cast<uint4*>(hs + at) = hv[m];
      if (train) *reinterpret_cast<uint4*>(cs + at) = cv[m];
    }
  };
  // the reverse direction meets positions [maxlen, T) first, with its state still zero
  if (d == 1)
    for (int pos = maxlen; pos < T; ++pos) store_chunks(pos);

  // the items: the block's UG NT (unit group, n8 tile) pairs in group-major
  // order; warp w takes the run [i0, i0 + ni), of group ug0 (n0 items) and
  // then ug0 + 1. Lane (g, t) of item j: local unit ul[j] = 8 ug + g, tile
  // rows 8 nt[j] + 2t + i
  const int N = UG * NT;
  const int i0 = warp * N / kWarps, ni = (warp + 1) * N / kWarps - i0;
  const int ug0 = i0 / NT, n0 = min(ni, NT * (ug0 + 1) - i0);
  const bool two = ni > n0;  // warp-uniform: a second group
  int nt[GI], ul[GI], row[GI][2], len[GI][2];
  float h[GI][2], c[GI][2], xv[GI][2][4];
#pragma unroll
  for (int j = 0; j < GI; ++j) {
    const int ug = j < n0 ? ug0 : ug0 + 1;
    nt[j] = i0 + j - NT * ug;
    ul[j] = 8 * ug + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = j < ni ? tile_row(tile, 8 * nt[j] + 2 * t + i, BR, Bg) : -1;
      row[j][i] = r;
      len[j][i] = r >= 0 ? a.lengths[r] : 0;
      h[j][i] = 0.0f;
      c[j][i] = 0.0f;
    }
  }
  const float* xgd = a.xg + (size_t)d * T * B * H4;
  // the four gates of each item's unit and rows at `pos`, into registers
  auto load_xg = [&](int pos) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row[j][i];
        const float* src = xgd + ((size_t)pos * B + (r >= 0 ? r : 0)) * H4 + unit0 + ul[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[j][i][q] = r >= 0 ? __ldg(src + q * H) : 0.0f;
      }
  };
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;
  if (maxlen > 0) load_xg(pos0);

  // gate product: A rows 32 ug + 16 mt + lr + 8 (lm & 1), columns k0 + 8 (lm >> 1)
  // of group ug0 (segment 0) and ug0 + 1 (segment 1, 32 rows on); B: h tile
  // rows 8 nt + lr, columns k0 + 8 lm (two k16 steps a load)
  const uint32_t a_gate =
      smem0 + W_AT + (uint32_t)(((32 * ug0 + lr + 8 * (lm & 1)) * KS + 8 * (lm >> 1)) * 2);
  const uint32_t b_gate = (uint32_t)((lr * KS + 8 * lm) * 2);
  float acc[GI][2][4];
  auto gate_mma = [&](int buf) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.0f;
    const uint32_t b_base = smem0 + H_AT + (uint32_t)(buf * BR * KS * 2) + b_gate;
    // round r: k32 step r of both groups (SEGS = 2), or k32 step r / 2 of group r % 2
    auto load = [&](UnevenFrag<SEGS>& f, int r) {
      const int k = SEGS == 2 ? r : r >> 1;
#pragma unroll
      for (int s = 0; s < SEGS; ++s) {
        const int sg = SEGS == 2 ? s : r & 1;
        if (sg == 1 && !two) continue;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(f.a[s][kh][mt],
                        a_gate + (uint32_t)(((32 * sg + 16 * mt) * KS + 32 * k + 16 * kh) * 2));
      }
    };
    auto use = [&](const UnevenFrag<SEGS>& f, int r) {
      const int k = SEGS == 2 ? r : r >> 1;
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (j >= ni) continue;
        const int sg = j < n0 ? 0 : 1;
        if (SEGS == 1 && sg != (r & 1)) continue;
        uint32_t b[4];
        ldmatrix_x4(b, b_base + (uint32_t)((8 * nt[j] * KS + 32 * k) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (SEGS == 1 || sg == 0)
              mma_bf16(acc[j][mt], f.a[0][kh][mt], b[2 * kh], b[2 * kh + 1]);
            else
              mma_bf16(acc[j][mt], f.a[SEGS - 1][kh][mt], b[2 * kh], b[2 * kh + 1]);
          }
      }
    };
    pipelined_rounds<UnevenFrag<SEGS>>(ROUNDS, load, use);
  };

  cp_async_wait<0>();
  __syncthreads();  // W_hh's slice and the zero h tile are in place
  cluster.sync();   // every block of the cluster runs (its shared memory takes pushes)

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    const int buf = s & 1;
    gate_mma(buf);

    // the cell: lane (g, t) holds the four gates of unit ul[j], rows 2t, 2t + 1 of n8 tile nt[j]
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ig = fast_sigmoid(xv[j][i][0] + acc[j][0][i]);
        const float fg = fast_sigmoid(xv[j][i][1] + acc[j][0][2 + i]);
        const float gg = fast_tanh(xv[j][i][2] + acc[j][1][i]);
        const float og = fast_sigmoid(xv[j][i][3] + acc[j][1][2 + i]);
        const float c_new = fg * c[j][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (pos < len[j][i]) {
          c[j][i] = c_new;
          h[j][i] = h_new;
        }
        const int rl = 8 * nt[j] + 2 * t + i;
        hst[rl * SS + ul[j]] = __float2bfloat16_rn(h[j][i]);
        if (train) cst[rl * SS + ul[j]] = __float2bfloat16_rn(c[j][i]);
      }
    }
    if (s + 1 < maxlen) load_xg(pos + dpos);
    __syncthreads();  // the block's new h (and c) tile is staged

#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (crow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / UG, cc = idx - rl * UG;
      hv[m] = *reinterpret_cast<const uint4*>(hst + rl * SS + 8 * cc);
      if (train) cv[m] = *reinterpret_cast<const uint4*>(cst + rl * SS + 8 * cc);
      if (s + 1 < maxlen) {
        // the next step's h tile of every block of the cluster
        bf16* dst = h_s + ((buf ^ 1) * BR + rl) * KS + unit0 + 8 * cc;
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k)
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, k)) = hv[m];
      }
    }
    cluster_arrive_release();  // this block's pushes of step s are written
    store_chunks(pos);
    cluster_wait_acquire();  // every block's pushes landed; every block is past this step
  }

  // the forward direction's state is frozen past the tile's longest row
  if (d == 0)
    for (int p = maxlen; p < T; ++p) store_chunks(p);
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row[j][i];
      if (r < 0) continue;
      a.hn[((size_t)d * B + r) * H + unit0 + ul[j]] = h[j][i];
      a.cn[((size_t)d * B + r) * H + unit0 + ul[j]] = c[j][i];
    }
}

template <int H, int BR>
int launch(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_fwd_wide_mma_kernel<H, BR>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

template <int H, int BR>
int launch_uneven(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes_u(H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_fwd_wide_mma_uneven_kernel<H, BR>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

template <int H>
int launch_rows(int rows, const Args& a, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch<H, 16>(a, tiles, smem, st, mc);
    case 32: return launch<H, 32>(a, tiles, smem, st, mc);
    case 40: return launch<H, 40>(a, tiles, smem, st, mc);
    case 64: return launch<H, 64>(a, tiles, smem, st, mc);
    case 80: return launch<H, 80>(a, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H>
int launch_rows_uneven(int rows, const Args& a, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch_uneven<H, 16>(a, tiles, smem, st, mc);
    case 32: return launch_uneven<H, 32>(a, tiles, smem, st, mc);
    case 40: return launch_uneven<H, 40>(a, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int bilstm_fwd_wide_mma_cluster() { return kWideCluster; }
int bilstm_fwd_wide_mma_threads() { return kThreads; }
int bilstm_fwd_wide_mma_pad() { return kPad; }
// the row tiles of the instance for uneven groups, as a mask of rows / 8
int bilstm_fwd_wide_mma_uneven_rows() { return (1 << 2) | (1 << 4) | (1 << 5); }
// the widths of the instance for uneven groups, as a mask of H / 32
int bilstm_fwd_wide_mma_uneven_widths() { return (1 << 5) | (1 << 6) | (1 << 7) | (1 << 9); }

const char* bilstm_fwd_wide_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `rows` is the row tile (16, 32, 40, 64 or
// 80; 16, 32 or 40 at H = 160, 192, 224 and 288) and `smem` its dynamic
// shared memory, as ops/lstm_cuda.py:wide_smem("fwd_mma", ...) computes it
// (refused otherwise). xg (2, T, B, 4H) f32; lengths (B,) int32; w_hh (2, G,
// 4H, H); hs_f, hs_b (and cs_f, cs_b, both null for the eval variant) (T, B,
// H) bf16; hn, cn (2, B, H) f32. H = 128 or 256, and 160, 192, 224 and 288
// (the instance for uneven unit groups); each of the G weight groups
// (B / G rows) is cut into its own tiles of `rows` rows: `tiles` =
// G * ceil(B / G / rows). With max_clusters non-null, nothing is launched:
// it receives how many clusters the card holds at once. Returns a
// cudaError_t (0 on success).
int bilstm_fwd_wide_mma(int rows, const void* xg, const void* lengths, const void* w_hh,
                        void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn, void* cn,
                        int T_steps, int B, int H, int G, int tiles, int smem, void* stream,
                        int* max_clusters) {
  if (G <= 0 || B % G || (cs_f == nullptr) != (cs_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = static_cast<const bf16*>(w_hh);
  a.hs[0] = static_cast<bf16*>(hs_f); a.hs[1] = static_cast<bf16*>(hs_b);
  a.cs[0] = static_cast<bf16*>(cs_f); a.cs[1] = static_cast<bf16*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256) return launch_rows<256>(rows, a, tiles, smem, st, max_clusters);
  if (H == 128) return launch_rows<128>(rows, a, tiles, smem, st, max_clusters);
  if (H == 160) return launch_rows_uneven<160>(rows, a, tiles, smem, st, max_clusters);
  if (H == 192) return launch_rows_uneven<192>(rows, a, tiles, smem, st, max_clusters);
  if (H == 224) return launch_rows_uneven<224>(rows, a, tiles, smem, st, max_clusters);
  if (H == 288) return launch_rows_uneven<288>(rows, a, tiles, smem, st, max_clusters);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
