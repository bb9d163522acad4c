// Bidirectional LSTM layer backward sweep over the input-gate streams, bf16
// compute dtype, for layers whose weights fit no block: the tensor-core
// variant, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd_lite.cu (which no dispatch names since this
// kernel took bf16 at 160-224: it stays for timing by name), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel with
//     fused_input=False (via _bwd_pallas_lite, :723) -- the lite backward
//     of the large-H plan (the scaled configuration's H = 256);
// and, with bilstm_gates_mma.cu before it and the input-side products and
// bilstm_wgrad_mma.cu after it (ops/lstm_stack.py), _bwd_kernel with
// fused_input=True (via _bwd_pallas, :603) at H = 128.
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep_lite): block
// (row tile, direction d) walks the positions in the reverse of that
// direction's forward order carrying dh and dc (f32). Per step and row:
// gates = xg[d, pos] + h_prev @ W_hh[d, g]^T (xg the f32 input gates, h_prev
// the bf16 forward stream at the previous position, zero past the ends),
// c_new = f * c_prev + i * g with c_prev from the bf16 cell stream, dh += the
// 0-2 bf16 dy streams (summed in f32), the masked dgates (f32, the mask
// rules of lstm_pallas_layer.py:519-536) to the (2, T, B, 4H) output, and
// dh = round(dgates) @ W_hh[d, g] (+ dh passed through where masked), dc =
// masked ? dc : dc_t * f.
//
// What bounds it on an H100: the roofline bound is bytes (the f32 xg in and
// dgates out), 3.6 ms a layer at the scaled shape; the products are far
// below it on the tensor cores. What governs is the serial chain of a step,
// T times: the cell maths, two products over W_hh's slice, and one exchange
// of partial dh sums between the blocks of a cluster.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes):
//   * the split of bilstm_bwd_lite.cu: a cluster of 8 blocks per (row tile,
//     direction), block k owns hidden units [k H/8, (k+1) H/8) and keeps
//     their 4H/8 gate rows of W_hh[d, g] resident, ONE bf16 copy (64 KB at
//     H = 256), gate rows permuted so that a lane holds a unit's four gates,
//     rows padded by 8 elements (ldmatrix conflict-free);
//   * both products on mma.sync m16n8k16, swapped (the weights are the
//     16-row A operand, 8 rows of the tile the n8 operand): the gate
//     recompute W_slice . h_prev^T reads the slice through ldmatrix, the
//     partial dh = W_slice^T . round(dgates)^T through ldmatrix.trans;
//   * 8 warps: for the gates, warp w takes the 8 units 8 (w % UG) .. of the
//     block's UG groups and every (8 / UG)-th n8 tile, so the cell maths
//     needs no exchange; for dh, warp w takes H / 128 m16 tiles of the H
//     units and every n8 tile;
//   * each block forms a partial dh over all H units from its own gate
//     columns (f32); the owner of a unit sums the 8 partials in rank order
//     through distributed shared memory, so the result does not depend on
//     timing. The partials are double-buffered, so ONE cluster barrier a
//     step suffices (a block writes buffer s % 2 only after every block has
//     passed the barrier of step s - 1, i.e. finished reading step s - 2's);
//   * the gate recompute needs no dh: the next step's product runs between
//     the barrier's arrive and its wait, hiding the barrier;
//   * the step's tiles arrive by cp.async a step ahead: the f32 xg slice,
//     c_prev and dy (one buffer, refilled right after the cell maths) and
//     h_prev (two buffers, two steps ahead);
//   * the cell uses ex2 / rcp (bilstm_mma.cuh);
//   * a tile skips the positions at or past its longest row: there dgates
//     is zero (written up front) and dh only gathers dy, which the forward
//     direction's sweep adds up before its first real step (the reverse
//     direction meets those positions last, where dh is dead);
//   * row tiles of BR in {16, 32, 40, 80} rows (multiples of the n8 tile),
//     each weight group cut into its own tiles; ops/lstm_cuda.py picks BR by
//     waves (cudaOccupancyMaxActiveClusters) and shared memory.
// This kernel takes H = 128 and 256 (8-unit groups per block: H % 64 == 0,
// and the dh product's m16 tiles split evenly over 8 warps: H % 128 == 0).
// bilstm_bwd_lite.cu keeps bf16 at 128 and 160-256 by name only.
//
// H = 160, 192, 224 and 288 (the widths whose n = H / 8 unit groups do not
// split evenly over the cluster, or whose dh product's m16 tiles do not
// split evenly over 8 warps: layer 0 of the bf16 models at embedding
// 160-224, every bf16 layer of 257-288 units, padded to 288) take a second
// kernel of the same design, bilstm_bwd_lite_mma_uneven_kernel:
//   * block k owns groups [k n / 8, (k + 1) n / 8)
//     (lstm_recurrence_wide_mma.cuh:unit_groups): 2 or 3 a block at 160, 3
//     at 192, 3 or 4 at 224, 4 or 5 at 288; the slowest block sets the pace
//     through the cluster barriers;
//   * the gate product and the cell: the block's UG x NT (unit group, n8
//     tile) items are dealt over all 8 warps (lstm_recurrence_wide_mma.cuh:
//     deal_items, as in bilstm_bwd_lite_f32.cu), each warp's items inside
//     one group, so the cell needs no exchange:
//     group q gets 8 / UG warps (the first 8 % UG groups one more), which
//     split its NT tiles. A 3-group block deals its warps 3, 3 and 2, so at
//     32-row tiles no warp takes more than two items, where "warp w takes
//     group w" left 5 of 8 warps idle and 3 with four;
//   * the dh product (K the block's own 32 UG gate columns): the warp of
//     rank r takes the m16 tiles r, r + 8, .. of the H / 16, its warps
//     ranked by their gate items, the fewest first, then by index
//     (deal_items' dh_rank): the 10, 12 and 14 tiles at 160, 192 and 224
//     give their second tiles to the warps with one gate item;
//   * the weights stay resident: the bf16 slice of the largest block (5
//     groups, 160 gate rows of 288 + 8) is 94,720 B. Two buffers of the f32
//     partial dh (2 x 288 x 40 x 4 B) would leave room for 16-row tiles
//     only at 288 (50 clusters, 4 waves at the train step's 400 rows in 5
//     groups), so the partial is single and a step takes two cluster
//     barriers, as in lstm_recurrence_bwd_wide_mma.cu: a block writes step
//     s's partial only after every block has read step s - 1's (arrived at
//     right after the read, waited on after the cell and the dh product, by
//     when the other blocks, which read at the top of the step, have
//     arrived). That fits 32-row tiles at 218,112 B: 30 clusters at the
//     train step's shape, of which an H100 holds 15 at once
//     (cudaOccupancyMaxActiveClusters, one block an SM): two waves. At 160,
//     192 and 224 two buffers would fit too (129,024 / 149,504 / 192,512 B
//     at 32 rows against 103,424 / 118,784 / 156,672 with one), but one
//     block an SM and two waves hold either way, so the widths keep one
//     schedule;
//   * the last step forms no dh; the partials are read through 32-bit
//     `mapa` addresses.
// The C entry also launches this kernel at H = 256 (4 groups a block, two
// warps each) when its shared memory asks for it, so that the two kernels
// can be timed in turns at the scaled step's shape: whether one kernel
// could serve every width (PERF.md).

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
constexpr int kPad = 8;    // bf16 elements of padding on weight, h and dgates rows
constexpr int kXgPad = 4;  // f32 elements of padding on xg rows

// Row stride (f32) of the partial dh buffer: at least BR and 8 mod 32, so the
// float2 writes and reads of a half warp (8 units x 4 row pairs) are
// conflict-free.
__host__ __device__ constexpr int part_stride(int BR) { return BR + (40 - BR % 32) % 32; }

// Dynamic shared memory of the <H, BR> instance (bytes), in layout order.
__host__ __device__ constexpr int smem_w(int H) { return 4 * (H / 8) * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_hp(int H, int BR) { return 2 * BR * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_xg(int H, int BR) { return BR * (H / 2 + kXgPad) * 4; }
__host__ __device__ constexpr int smem_cs(int H, int BR) { return BR * (H / 8) * 2; }
__host__ __device__ constexpr int smem_dg(int H, int BR) { return BR * (H / 2 + kPad) * 2; }
__host__ __device__ constexpr int smem_part(int H, int BR) { return 2 * H * part_stride(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_w(H) + smem_hp(H, BR) + smem_xg(H, BR) + 3 * smem_cs(H, BR) + smem_dg(H, BR) +
         smem_part(H, BR);
}

struct Args {
  const float* xg;  // (2, T, B, 4H)
  const int* lengths;
  const bf16* w_hh;      // (2, G, 4H, H)
  const bf16* hs[2];     // per direction, (T, B, H)
  const bf16* cs[2];
  const bf16* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // (2, B, H) or null (zero)
  const float* dcn;
  float* dgates;  // (2, T, B, 4H)
  int T, B, G;
};

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads threads.
template <int H, int BR>
__global__ void __launch_bounds__(kThreads, 1) bilstm_bwd_lite_mma_kernel(const Args a) {
  constexpr int U = H / kWideCluster, U4 = 4 * U, H4 = 4 * H;
  constexpr int UG = U / 8;            // 8-unit groups a block owns
  constexpr int NT = BR / 8;           // n8 tiles of the row tile
  constexpr int NG = kWarps / UG;      // warps that share a unit group in the gate product
  constexpr int GI = (NT + NG - 1) / NG;  // gate items (n8 tiles) of a warp
  constexpr int MTW = H / 16 / kWarps;    // m16 tiles of the dh product a warp owns
  constexpr int KS = H + kPad;         // weight / h_prev row stride (bf16)
  constexpr int XS = U4 + kXgPad;      // xg row stride (f32)
  constexpr int DS = U4 + kPad;        // dgates tile row stride (bf16)
  constexpr int PS = part_stride(BR);  // partial dh row stride (f32)
  constexpr int HC = H / 8;            // 16-byte chunks of an h row; also of an xg row slice
  constexpr int NCH = (BR * HC + kThreads - 1) / kThreads;
  constexpr int UC = U / 8;            // 16-byte chunks of a c_prev / dy row slice
  constexpr int NCH2 = (BR * UC + kThreads - 1) / kThreads;
  constexpr int W_AT = 0;
  constexpr int HP_AT = W_AT + smem_w(H);
  constexpr int XG_AT = HP_AT + smem_hp(H, BR);
  constexpr int CS_AT = XG_AT + smem_xg(H, BR);
  constexpr int DY_AT = CS_AT + smem_cs(H, BR);
  constexpr int DG_AT = DY_AT + 2 * smem_cs(H, BR);
  constexpr int PART_AT = DG_AT + smem_dg(H, BR);
  static_assert(U % 8 == 0 && MTW >= 1 && H % 128 == 0 && BR % 8 == 0, "shape");
  static_assert(smem_bytes(H, BR) == PART_AT + smem_part(H, BR), "layout");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B, ny = a.ny;
  const int Bg = B / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  const float* xg_s = reinterpret_cast<const float*>(smem + XG_AT);
  const bf16* cs_s = reinterpret_cast<const bf16*>(smem + CS_AT);
  const bf16* dy_s = reinterpret_cast<const bf16*>(smem + DY_AT);
  bf16* dg_s = reinterpret_cast<bf16*>(smem + DG_AT);
  float* part_s = reinterpret_cast<float*>(smem + PART_AT);  // [2][H][PS]

  // the tile's longest row bounds the positions that do any work: step s
  // works on position s (d = 1) or maxlen - 1 - s (d = 0); every block of
  // the cluster finds the same maxlen, so they take the same barriers
  int maxlen = 0;
  for (int rl = 0; rl < BR; ++rl) {
    const int r = tile_row(tile, rl, BR, Bg);
    if (r >= 0) maxlen = max(maxlen, min(a.lengths[r], T));
  }
  float* dgd = a.dgates + (size_t)d * T * B * H4;

  // positions [maxlen, T): this block's dgates columns are zero
  {
    constexpr int per_row = U4 / 4;  // float4 chunks of the block's columns
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int idx = tid; idx < (T - maxlen) * BR * per_row; idx += kThreads) {
      const int pi = idx / (BR * per_row), rem = idx - pi * (BR * per_row);
      const int rl = rem / per_row, c = rem - rl * per_row;
      const int r = tile_row(tile, rl, BR, Bg);
      if (r < 0) continue;
      const int q = c / (U / 4), cu = (c - q * (U / 4)) * 4;
      *reinterpret_cast<float4*>(dgd + ((size_t)(maxlen + pi) * B + r) * H4 + q * H + rank * U +
                                 cu) = zero;
    }
  }
  if (maxlen == 0) return;  // no step: no barrier, no exchange

  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;
  const bf16* hs = a.hs[d];
  const bf16* cs = a.cs[d];
  const float* xgd = a.xg + (size_t)d * T * B * H4;

  // this thread's 16-byte chunks of a step's tiles: h_prev and the xg slice
  // (chunk idx: tile row idx / HC, column chunk idx % HC), c_prev and dy
  // (row idx / UC); the rows are fixed for the whole sweep
  int hrow[NCH], crow[NCH2];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int idx = tid + m * kThreads;
    hrow[m] = idx < BR * HC ? tile_row(tile, idx / HC, BR, Bg) : -2;
  }
#pragma unroll
  for (int m = 0; m < NCH2; ++m) {
    const int idx = tid + m * kThreads;
    crow[m] = idx < BR * UC ? tile_row(tile, idx / UC, BR, Bg) : -2;
  }
  // h_prev for the gates at `pos`, into buffer `buf`
  auto fetch_h = [&](int buf, int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
    const uint32_t base = smem0 + HP_AT + (uint32_t)(buf * BR * KS * 2);
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (hrow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / HC, c = idx - rl * HC;
      const bool ok = in_t && hrow[m] >= 0;
      cp_async16(base + (uint32_t)((rl * KS + 8 * c) * 2),
                 ok ? hs + ((size_t)ppos * B + hrow[m]) * H + 8 * c : hs, ok);
    }
  };
  // the xg slice, c_prev and the dy streams at `pos`
  auto fetch_step = [&](int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (hrow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / HC, c = idx - rl * HC;
      const int q = c / (U / 4), cu = (c - q * (U / 4)) * 4;
      const bool ok = hrow[m] >= 0;
      cp_async16(smem0 + XG_AT + (uint32_t)((rl * XS + q * U + cu) * 4),
                 ok ? xgd + ((size_t)pos * B + hrow[m]) * H4 + q * H + rank * U + cu : xgd, ok);
    }
#pragma unroll
    for (int m = 0; m < NCH2; ++m) {
      if (crow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / UC, c = (idx - rl * UC) * 8;
      const bool real = crow[m] >= 0;
      const bool ok = real && in_t;
      cp_async16(smem0 + CS_AT + (uint32_t)((rl * U + c) * 2),
                 ok ? cs + ((size_t)ppos * B + crow[m]) * H + rank * U + c : cs, ok);
      for (int k = 0; k < ny; ++k)
        cp_async16(smem0 + DY_AT + (uint32_t)(((k * BR + rl) * U + c) * 2),
                   real ? a.dy[d][k] + ((size_t)pos * B + crow[m]) * H + rank * U + c : cs,
                   real);
    }
  };

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
  }
  fetch_h(0, pos0);
  if (maxlen > 1) fetch_h(1, pos0 + dpos);
  fetch_step(pos0);
  cp_async_commit();

  // gate items: warp w owns unit group ug (units 8 ug .. 8 ug + 7 of the
  // block) and n8 tiles ng, ng + NG, ..; lane (g, t) the unit 8 ug + g and
  // tile rows 8 nt + 2t + i
  const int ug = warp % UG, ng = warp / UG;
  const int ul = 8 * ug + g, unit = rank * U + ul;
  int row[GI][2], len[GI][2];
  float dh[GI][2], dc[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j) {
    const int nt = ng + NG * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = nt < NT ? tile_row(tile, 8 * nt + 2 * t + i, BR, Bg) : -1;
      row[j][i] = r;
      len[j][i] = r >= 0 ? a.lengths[r] : 0;
      const size_t at = ((size_t)d * B + (r >= 0 ? r : 0)) * H + unit;
      dh[j][i] = (r >= 0 && a.dhn) ? a.dhn[at] : 0.0f;
      dc[j][i] = (r >= 0 && a.dcn) ? a.dcn[at] : 0.0f;
      // the forward direction's sweep starts at T - 1: past the tile's
      // longest row a step only adds dy to dh, in the same order as the full sweep
      if (d == 0 && r >= 0 && ny > 0) {
        for (int pos = T - 1; pos >= maxlen; --pos) {
          float dyv = 0.0f;
          for (int k = 0; k < ny; ++k)
            dyv += __bfloat162float(a.dy[0][k][((size_t)pos * B + r) * H + unit]);
          dh[j][i] += dyv;
        }
      }
    }
  }

  const uint32_t W_u32 = smem0 + W_AT;
  // gate product: A rows 32 ug + 16 mt + lr + 8 (lm & 1), columns k0 + 8 (lm >> 1);
  // B: h_prev tile rows 8 nt + lr, columns k0 + 8 lm (two k16 steps a load)
  const uint32_t a_gate = W_u32 + (uint32_t)(((32 * ug + lr + 8 * (lm & 1)) * KS + 8 * (lm >> 1)) * 2);
  const uint32_t b_gate = (uint32_t)(((8 * ng + lr) * KS + 8 * lm) * 2);
  float acc[GI][2][4];
  auto gate_mma = [&](int buf) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.0f;
    const uint32_t b_base = smem0 + HP_AT + (uint32_t)(buf * BR * KS * 2) + b_gate;
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
  // dh product: A = W_slice^T, stored rows (gate rows) 8 (lm >> 1) + lr,
  // columns (units) 16 mt + 8 (lm & 1), through ldmatrix.trans; B: dgates
  // tile rows 8 nt + lr, columns p0 + 8 lm
  const uint32_t a_dh =
      W_u32 + (uint32_t)(((8 * (lm >> 1) + lr) * KS + 16 * MTW * warp + 8 * (lm & 1)) * 2);
  const uint32_t b_dh = smem0 + DG_AT + (uint32_t)((lr * DS + 8 * lm) * 2);
  auto dh_mma = [&](float* part) {
    float c[MTW][NT][4];
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) c[mi][nt][v] = 0.0f;
    uint32_t fa[2][2][MTW][4];  // [buffer][k16 half][mt]
    auto load_a = [&](uint32_t (&f)[2][MTW][4], int r) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mi = 0; mi < MTW; ++mi)
          ldmatrix_x4_trans(f[kh][mi], a_dh + (uint32_t)(((32 * r + 16 * kh) * KS + 16 * mi) * 2));
    };
    load_a(fa[0], 0);
#pragma unroll
    for (int r = 0; r < U4 / 32; ++r) {
      uint32_t(&f)[2][MTW][4] = fa[r & 1];
      if (r + 1 < U4 / 32) load_a(fa[(r + 1) & 1], r + 1);
      uint32_t b[2][4];
      ldmatrix_x4(b[0], b_dh + (uint32_t)(32 * r * 2));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt + 1 < NT) ldmatrix_x4(b[(nt + 1) & 1], b_dh + (uint32_t)((8 * (nt + 1) * DS + 32 * r) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            mma_bf16(c[mi][nt], f[kh][mi], b[nt & 1][2 * kh], b[nt & 1][2 * kh + 1]);
      }
    }
    // rows g and g + 8 of m16 tile mt are units 16 mt + g (+ 8), columns
    // 2t, 2t + 1 of n8 tile nt are tile rows 8 nt + 2t (+ 1)
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) {
      const int u = 16 * (MTW * warp + mi) + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(part + u * PS + 8 * nt + 2 * t) =
            make_float2(c[mi][nt][0], c[mi][nt][1]);
        *reinterpret_cast<float2*>(part + (u + 8) * PS + 8 * nt + 2 * t) =
            make_float2(c[mi][nt][2], c[mi][nt][3]);
      }
    }
  };

  cp_async_wait<0>();
  __syncthreads();  // W, h_prev of the first two steps, the first step's tiles
  gate_mma(0);

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s > 0) {
      // dh of this step: the 8 partials of the previous step, in rank order
      cluster_wait_acquire();
      const float* prev = part_s + ((s - 1) & 1) * H * PS + unit * PS + 2 * t;
      float2 p[GI][kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) {
        const float* src = cluster.map_shared_rank(prev, k);
#pragma unroll
        for (int j = 0; j < GI; ++j)
          if (ng + NG * j < NT)
            p[j][k] = *reinterpret_cast<const float2*>(src + 8 * (ng + NG * j));
      }
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (ng + NG * j >= NT) continue;
        float s0 = p[j][0].x, s1 = p[j][0].y;
#pragma unroll
        for (int k = 1; k < kWideCluster; ++k) {
          s0 += p[j][k].x;
          s1 += p[j][k].y;
        }
        dh[j][0] = s0 + dh[j][0];  // dh holds what the masked rows passed through
        dh[j][1] = s1 + dh[j][1];
      }
      cp_async_wait<0>();
      __syncthreads();  // this step's xg, c_prev and dy (and the next h_prev) landed
    }

    // the cell: lane (g, t) holds the four gates of unit `ul` for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      const int nt = ng + NG * j;
      if (nt >= NT) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * nt + 2 * t + i;
        const float* xv = xg_s + rl * XS + ul;
        const float ig = fast_sigmoid(xv[0] + acc[j][0][i]);
        const float fg = fast_sigmoid(xv[U] + acc[j][0][2 + i]);
        const float gg = fast_tanh(xv[2 * U] + acc[j][1][i]);
        const float og = fast_sigmoid(xv[3 * U] + acc[j][1][2 + i]);
        const float cprev = __bfloat162float(cs_s[rl * U + ul]);
        float dyv = 0.0f;
        for (int k = 0; k < ny; ++k) dyv += __bfloat162float(dy_s[(k * BR + rl) * U + ul]);
        const float c_new = fg * cprev + ig * gg;
        const float dht = dh[j][i] + dyv;
        const float tc = fast_tanh(c_new);
        const float dct = dc[j][i] + dht * og * (1.0f - tc * tc);
        const bool m = pos < len[j][i];
        float g4[4];
        g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
        g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
        g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
        g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
        dc[j][i] = m ? dct * fg : dc[j][i];
        dh[j][i] = m ? 0.0f : dht;  // passed through to the next step where masked
        if (row[j][i] >= 0) {
          float* dst = dgd + ((size_t)pos * B + row[j][i]) * H4 + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) dst[q * H] = g4[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[rl * DS + 32 * ug + 8 * q + g] = __float2bfloat16_rn(g4[q]);
      }
    }
    __syncthreads();  // the dgates tile is complete; every warp is past this step's tiles
    if (s + 1 < maxlen) fetch_step(pos + dpos);
    if (s + 2 < maxlen) fetch_h(s & 1, pos + 2 * dpos);
    cp_async_commit();

    dh_mma(part_s + (s & 1) * H * PS);
    cluster_arrive_release();  // this block's partial of step s is written
    if (s + 1 < maxlen) gate_mma((s + 1) & 1);
  }
  cluster_wait_acquire();  // every block is done reading this block's partials
}

// ------------------------------ H = 160, 192, 224, 288: uneven group split
// Dynamic shared memory of the uneven instance <H, BR> (bytes): sized for
// the block that owns the most groups, MG = ceil(H / 64); one partial buffer.
__host__ __device__ constexpr int uneven_groups(int H) { return (H + 63) / 64; }
__host__ __device__ constexpr int smem_w_u(int H) { return 32 * uneven_groups(H) * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_xg_u(int H, int BR) {
  return BR * (32 * uneven_groups(H) + kXgPad) * 4;
}
__host__ __device__ constexpr int smem_cs_u(int H, int BR) { return BR * 8 * uneven_groups(H) * 2; }
__host__ __device__ constexpr int smem_dg_u(int H, int BR) {
  return BR * (32 * uneven_groups(H) + kPad) * 2;
}
__host__ __device__ constexpr int smem_part_u(int H, int BR) { return H * part_stride(BR) * 4; }
__host__ __device__ constexpr int smem_bytes_u(int H, int BR) {
  return smem_w_u(H) + smem_hp(H, BR) + smem_xg_u(H, BR) + 3 * smem_cs_u(H, BR) +
         smem_dg_u(H, BR) + smem_part_u(H, BR);
}

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads threads.
template <int H, int BR>
__global__ void __launch_bounds__(kThreads, 1) bilstm_bwd_lite_mma_uneven_kernel(const Args a) {
  constexpr int MG = uneven_groups(H);  // most unit groups a block owns
  constexpr int UM = 8 * MG;            // most units a block owns
  constexpr int H4 = 4 * H;
  constexpr int NT = BR / 8;                          // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;                    // fewest warps the deal gives a group
  constexpr int GI = (NT + WPG - 1) / WPG;            // most gate items a warp takes
  constexpr int MT = H / 16;                          // m16 tiles of units (dh product)
  constexpr int MTW = (MT + kWarps - 1) / kWarps;     // most of them a warp owns
  constexpr int KS = H + kPad;                        // weight / h_prev row stride (bf16)
  constexpr int XS = 4 * UM + kXgPad;                 // xg row stride (f32)
  constexpr int DS = 4 * UM + kPad;                   // dgates tile row stride (bf16)
  constexpr int PS = part_stride(BR);                 // partial dh row stride (f32)
  constexpr int HC = H / 8;                           // 16-byte chunks of an h row
  constexpr int NCH = (BR * HC + kThreads - 1) / kThreads;
  constexpr int NCX = (BR * UM + kThreads - 1) / kThreads;  // of the xg slice
  constexpr int NCC = (BR * MG + kThreads - 1) / kThreads;  // of a c_prev / dy slice
  constexpr int W_AT = 0;
  constexpr int HP_AT = W_AT + smem_w_u(H);
  constexpr int XG_AT = HP_AT + smem_hp(H, BR);
  constexpr int CS_AT = XG_AT + smem_xg_u(H, BR);
  constexpr int DY_AT = CS_AT + smem_cs_u(H, BR);
  constexpr int DG_AT = DY_AT + 2 * smem_cs_u(H, BR);
  constexpr int PART_AT = DG_AT + smem_dg_u(H, BR);
  static_assert(H % 32 == 0 && MG <= kWarps && BR % 8 == 0 && WPG >= 1, "shape");
  static_assert(smem_bytes_u(H, BR) == PART_AT + smem_part_u(H, BR), "layout");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B, ny = a.ny;
  const int Bg = B / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;
  // this block's unit groups [glo, ghi): UG groups, U units from unit0
  int glo, ghi;
  recwide::unit_groups(H, rank, glo, ghi);
  const int UG = ghi - glo, U = 8 * UG, U4 = 4 * U, unit0 = 8 * glo;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  const float* xg_s = reinterpret_cast<const float*>(smem + XG_AT);
  const bf16* cs_s = reinterpret_cast<const bf16*>(smem + CS_AT);
  const bf16* dy_s = reinterpret_cast<const bf16*>(smem + DY_AT);
  bf16* dg_s = reinterpret_cast<bf16*>(smem + DG_AT);
  float* part_s = reinterpret_cast<float*>(smem + PART_AT);  // [H][PS]

  // the tile's longest row bounds the positions that do any work (as in
  // bilstm_bwd_lite_mma_kernel)
  int maxlen = 0;
  for (int rl = 0; rl < BR; ++rl) {
    const int r = tile_row(tile, rl, BR, Bg);
    if (r >= 0) maxlen = max(maxlen, min(a.lengths[r], T));
  }
  float* dgd = a.dgates + (size_t)d * T * B * H4;

  // positions [maxlen, T): this block's dgates columns are zero
  {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int idx = tid; idx < (T - maxlen) * BR * U; idx += kThreads) {
      const int pi = idx / (BR * U), rem = idx - pi * (BR * U);
      const int rl = rem / U, c = rem - rl * U;
      const int r = tile_row(tile, rl, BR, Bg);
      if (r < 0) continue;
      const int q = c / (U / 4), cu = (c - q * (U / 4)) * 4;
      *reinterpret_cast<float4*>(dgd + ((size_t)(maxlen + pi) * B + r) * H4 + q * H + unit0 +
                                 cu) = zero;
    }
  }
  if (maxlen == 0) return;  // no step: no barrier, no exchange

  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;
  const bf16* hs = a.hs[d];
  const bf16* cs = a.cs[d];
  const float* xgd = a.xg + (size_t)d * T * B * H4;

  // this thread's 16-byte chunks of a step's tiles (rows fixed for the
  // sweep): h_prev (HC a row), the xg slice (U a row), c_prev and dy (UG)
  int hrow[NCH], xrow[NCX], crow[NCC];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int idx = tid + m * kThreads;
    hrow[m] = idx < BR * HC ? tile_row(tile, idx / HC, BR, Bg) : -2;
  }
#pragma unroll
  for (int m = 0; m < NCX; ++m) {
    const int idx = tid + m * kThreads;
    xrow[m] = idx < BR * U ? tile_row(tile, idx / U, BR, Bg) : -2;
  }
#pragma unroll
  for (int m = 0; m < NCC; ++m) {
    const int idx = tid + m * kThreads;
    crow[m] = idx < BR * UG ? tile_row(tile, idx / UG, BR, Bg) : -2;
  }
  // h_prev for the gates at `pos`, into buffer `buf`
  auto fetch_h = [&](int buf, int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
    const uint32_t base = smem0 + HP_AT + (uint32_t)(buf * BR * KS * 2);
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      if (hrow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / HC, c = idx - rl * HC;
      const bool ok = in_t && hrow[m] >= 0;
      cp_async16(base + (uint32_t)((rl * KS + 8 * c) * 2),
                 ok ? hs + ((size_t)ppos * B + hrow[m]) * H + 8 * c : hs, ok);
    }
  };
  // the xg slice, c_prev and the dy streams at `pos`
  auto fetch_step = [&](int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
#pragma unroll
    for (int m = 0; m < NCX; ++m) {
      if (xrow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / U, c = idx - rl * U;
      const int q = c / (U / 4), cu = (c - q * (U / 4)) * 4;
      const bool ok = xrow[m] >= 0;
      cp_async16(smem0 + XG_AT + (uint32_t)((rl * XS + q * U + cu) * 4),
                 ok ? xgd + ((size_t)pos * B + xrow[m]) * H4 + q * H + unit0 + cu : xgd, ok);
    }
#pragma unroll
    for (int m = 0; m < NCC; ++m) {
      if (crow[m] == -2) continue;
      const int idx = tid + m * kThreads, rl = idx / UG, c = (idx - rl * UG) * 8;
      const bool real = crow[m] >= 0;
      const bool ok = real && in_t;
      cp_async16(smem0 + CS_AT + (uint32_t)((rl * UM + c) * 2),
                 ok ? cs + ((size_t)ppos * B + crow[m]) * H + unit0 + c : cs, ok);
      for (int k = 0; k < ny; ++k)
        cp_async16(smem0 + DY_AT + (uint32_t)(((k * BR + rl) * UM + c) * 2),
                   real ? a.dy[d][k] + ((size_t)pos * B + crow[m]) * H + unit0 + c : cs, real);
    }
  };

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
  }
  fetch_h(0, pos0);
  if (maxlen > 1) fetch_h(1, pos0 + dpos);
  fetch_step(pos0);
  cp_async_commit();

  // gate items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group
  // ug (units 8 ug .. 8 ug + 7 of the block); lane (g, t) of item j holds
  // the unit 8 ug + g for tile rows 8 (nt0 + j) + 2t + i. The deal: group q
  // gets 8 / UG warps, the first 8 % UG groups one more, which split its NT
  // tiles; the dh product ranks the warps by their gate items, the fewest
  // first, then by index (lstm_recurrence_wide_mma.cuh:deal_items).
  const recwide::ItemDeal deal = recwide::deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni, dh_rank = deal.dh_rank;
  const int ul = 8 * ug + g, unit = unit0 + ul;
  int row[GI][2], len[GI][2];
  float dh[GI][2], dc[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = j < ni ? tile_row(tile, 8 * (nt0 + j) + 2 * t + i, BR, Bg) : -1;
      row[j][i] = r;
      len[j][i] = r >= 0 ? a.lengths[r] : 0;
      const size_t at = ((size_t)d * B + (r >= 0 ? r : 0)) * H + (r >= 0 ? unit : 0);
      dh[j][i] = (r >= 0 && a.dhn) ? a.dhn[at] : 0.0f;
      dc[j][i] = (r >= 0 && a.dcn) ? a.dcn[at] : 0.0f;
      // the forward direction's sweep starts at T - 1: past the tile's
      // longest row a step only adds dy to dh, in the same order as the full sweep
      if (d == 0 && r >= 0 && ny > 0) {
        for (int pos = T - 1; pos >= maxlen; --pos) {
          float dyv = 0.0f;
          for (int k = 0; k < ny; ++k)
            dyv += __bfloat162float(a.dy[0][k][((size_t)pos * B + r) * H + unit]);
          dh[j][i] += dyv;
        }
      }
    }

  const uint32_t W_u32 = smem0 + W_AT;
  // gate product: A rows 32 ug + 16 mt + lr + 8 (lm & 1), columns k0 + 8 (lm >> 1);
  // B: h_prev tile rows 8 (nt0 + j) + lr, columns k0 + 8 lm (two k16 steps a load)
  const uint32_t a_gate = W_u32 + (uint32_t)(((32 * ug + lr + 8 * (lm & 1)) * KS +
                                              8 * (lm >> 1)) * 2);
  const uint32_t b_gate = (uint32_t)(((8 * nt0 + lr) * KS + 8 * lm) * 2);
  float acc[GI][2][4];
  auto gate_mma = [&](int buf) {
    if (ni == 0) return;
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.0f;
    const uint32_t b_base = smem0 + HP_AT + (uint32_t)(buf * BR * KS * 2) + b_gate;
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
        if (j >= ni) continue;
        uint32_t b[4];
        ldmatrix_x4(b, b_base + (uint32_t)((8 * j * KS + 32 * r) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[j][mt], f[kh][mt], b[2 * kh], b[2 * kh + 1]);
      }
    }
  };
  // dh product: A = W_slice^T, stored rows (gate rows) 8 (lm >> 1) + lr,
  // columns (units) 16 m + 8 (lm & 1) of this warp's m16 tiles m = dh_rank
  // + 8 j, through ldmatrix.trans; B: dgates tile rows 8 nt + lr, columns
  // p0 + 8 lm; K: the block's 32 UG gate rows
  const int nmt = MT > dh_rank ? min(MTW, (MT - dh_rank + kWarps - 1) / kWarps) : 0;
  const uint32_t a_dh = W_u32 + (uint32_t)(((8 * (lm >> 1) + lr) * KS + 16 * dh_rank +
                                            8 * (lm & 1)) * 2);
  const uint32_t b_dh = smem0 + DG_AT + (uint32_t)((lr * DS + 8 * lm) * 2);
  float c[MTW][NT][4];
  auto dh_mma = [&]() {
#pragma unroll
    for (int j = 0; j < MTW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) c[j][nt][v] = 0.0f;
    uint32_t fa[2][2][MTW][4];  // [buffer][k16 half][m16 tile]
    auto load_a = [&](uint32_t (&f)[2][MTW][4], int r) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int j = 0; j < MTW; ++j)
          if (j < nmt)
            ldmatrix_x4_trans(f[kh][j], a_dh + (uint32_t)(((32 * r + 16 * kh) * KS +
                                                           16 * kWarps * j) * 2));
    };
    load_a(fa[0], 0);
#pragma unroll
    for (int r = 0; r < MG; ++r) {
      if (r >= UG) break;
      uint32_t(&f)[2][MTW][4] = fa[r & 1];
      if (r + 1 < UG) load_a(fa[(r + 1) & 1], r + 1);
      uint32_t b[2][4];
      ldmatrix_x4(b[0], b_dh + (uint32_t)(32 * r * 2));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt + 1 < NT)
          ldmatrix_x4(b[(nt + 1) & 1], b_dh + (uint32_t)((8 * (nt + 1) * DS + 32 * r) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int j = 0; j < MTW; ++j)
            if (j < nmt)
              mma_bf16(c[j][nt], f[kh][j], b[nt & 1][2 * kh], b[nt & 1][2 * kh + 1]);
      }
    }
  };

  cp_async_wait<0>();
  __syncthreads();  // W, h_prev of the first two steps, the first step's tiles
  gate_mma(0);
  const uint32_t part_u32 = smem_u32(part_s);

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s > 0) {
      // dh of this step: the 8 partials of the previous step, in rank order
      cluster_wait_acquire();
      if (ni > 0) {
        uint32_t rank_base[kWideCluster];
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k) rank_base[k] = recwide::mapa_u32(part_u32, k);
#pragma unroll
        for (int j = 0; j < GI; ++j) {
          if (j >= ni) continue;
          const uint32_t off = (uint32_t)((unit * PS + 8 * (nt0 + j) + 2 * t) * 4);
          float2 p[kWideCluster];
#pragma unroll
          for (int k = 0; k < kWideCluster; ++k) p[k] = recwide::ld_dsmem_f2(rank_base[k] + off);
          float s0 = p[0].x, s1 = p[0].y;
#pragma unroll
          for (int k = 1; k < kWideCluster; ++k) {
            s0 += p[k].x;
            s1 += p[k].y;
          }
          dh[j][0] = s0 + dh[j][0];  // dh holds what the masked rows passed through
          dh[j][1] = s1 + dh[j][1];
        }
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");  // done reading
      cp_async_wait<0>();
      __syncthreads();  // this step's xg, c_prev and dy (and the next h_prev) landed
    }

    // the cell: lane (g, t) holds the four gates of unit `ul` for rows 2t,
    // 2t + 1 of n8 tile nt0 + j
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * (nt0 + j) + 2 * t + i;
        const float* xv = xg_s + rl * XS + ul;
        const float ig = fast_sigmoid(xv[0] + acc[j][0][i]);
        const float fg = fast_sigmoid(xv[U] + acc[j][0][2 + i]);
        const float gg = fast_tanh(xv[2 * U] + acc[j][1][i]);
        const float og = fast_sigmoid(xv[3 * U] + acc[j][1][2 + i]);
        const float cprev = __bfloat162float(cs_s[rl * UM + ul]);
        float dyv = 0.0f;
        for (int k = 0; k < ny; ++k) dyv += __bfloat162float(dy_s[(k * BR + rl) * UM + ul]);
        const float c_new = fg * cprev + ig * gg;
        const float dht = dh[j][i] + dyv;
        const float tc = fast_tanh(c_new);
        const float dct = dc[j][i] + dht * og * (1.0f - tc * tc);
        const bool m = pos < len[j][i];
        float g4[4];
        g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
        g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
        g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
        g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
        dc[j][i] = m ? dct * fg : dc[j][i];
        dh[j][i] = m ? 0.0f : dht;  // passed through to the next step where masked
        if (row[j][i] >= 0) {
          float* dst = dgd + ((size_t)pos * B + row[j][i]) * H4 + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) dst[q * H] = g4[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[rl * DS + 32 * ug + 8 * q + g] = __float2bfloat16_rn(g4[q]);
      }
    }
    if (s + 1 == maxlen) break;  // the last step's dh is dead
    __syncthreads();  // the dgates tile is complete; every warp is past this step's tiles
    fetch_step(pos + dpos);
    if (s + 2 < maxlen) fetch_h(s & 1, pos + 2 * dpos);
    cp_async_commit();

    dh_mma();
    if (s > 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s - 1's
    // rows g and g + 8 of m16 tile m are units 16 m + g (+ 8), columns 2t,
    // 2t + 1 of n8 tile nt are tile rows 8 nt + 2t (+ 1)
#pragma unroll
    for (int j = 0; j < MTW; ++j) {
      if (j >= nmt) continue;
      const int u = 16 * (dh_rank + kWarps * j) + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(part_s + u * PS + 8 * nt + 2 * t) =
            make_float2(c[j][nt][0], c[j][nt][1]);
        *reinterpret_cast<float2*>(part_s + (u + 8) * PS + 8 * nt + 2 * t) =
            make_float2(c[j][nt][2], c[j][nt][3]);
      }
    }
    cluster_arrive_release();  // this block's partial of step s is written
    gate_mma((s + 1) & 1);
  }
  // every block is done reading this block's partials before it exits
  if (maxlen > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int H, int BR>
int launch(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_bwd_lite_mma_kernel<H, BR>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

template <int H, int BR>
int launch_uneven(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes_u(H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_bwd_lite_mma_uneven_kernel<H, BR>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

// The uneven instances by row tile: 16 and 32.
template <int H>
int launch_uneven_rows(int rows, const Args& a, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch_uneven<H, 16>(a, tiles, smem, st, mc);
    case 32: return launch_uneven<H, 32>(a, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int bilstm_bwd_lite_mma_cluster() { return kWideCluster; }
int bilstm_bwd_lite_mma_threads() { return kThreads; }
int bilstm_bwd_lite_mma_pad() { return kPad; }
int bilstm_bwd_lite_mma_xg_pad() { return kXgPad; }

const char* bilstm_bwd_lite_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `rows` is the row tile (16, 32, 40 or 80;
// 80 at H = 128 only; 16 or 32 at H = 160, 192, 224 and 288) and `smem` its
// dynamic shared memory, as ops/lstm_cuda.py:wide_smem("lite_mma", ...)
// computes it (refused otherwise); at H = 256, 16 or 32 rows, the shared
// memory of the uneven instance (wide_smem("lite_mma_uneven", ...))
// launches that one. xg (2, T, B, 4H) f32; w_hh (2, G, 4H, H);
// hs_f, hs_b, cs_f, cs_b and the dy streams (T, B, H) bf16 (dy*1 may be
// null, ny = 0-2 streams per direction); dhn / dcn (2, B, H) f32 or null
// (zero); dgates (2, T, B, 4H) f32. H = 128, 160, 192, 224, 256 or 288;
// each of the G weight groups (B / G rows) is cut into its own tiles of
// `rows` rows: `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int bilstm_bwd_lite_mma(int rows, const void* xg, const void* lengths, const void* w_hh,
                        const void* hs_f, const void* hs_b, const void* cs_f, const void* cs_b,
                        const void* dyf0, const void* dyf1, const void* dyb0, const void* dyb1,
                        int ny, const void* dhn, const void* dcn, void* dgates, int T_steps,
                        int B, int H, int G, int tiles, int smem, void* stream,
                        int* max_clusters) {
  if (ny < 0 || ny > 2 || G <= 0 || B % G) return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = in(w_hh);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = static_cast<const float*>(dhn);
  a.dcn = static_cast<const float*>(dcn);
  a.dgates = static_cast<float*>(dgates);
  a.T = T_steps; a.B = B; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 128:
      switch (rows) {
        case 16: return launch<128, 16>(a, tiles, smem, st, max_clusters);
        case 32: return launch<128, 32>(a, tiles, smem, st, max_clusters);
        case 40: return launch<128, 40>(a, tiles, smem, st, max_clusters);
        case 80: return launch<128, 80>(a, tiles, smem, st, max_clusters);
        default: break;
      }
      break;
    case 256:
      // the uneven instance by its shared memory: timed against this one
      if ((rows == 16 || rows == 32) && smem == smem_bytes_u(256, rows))
        return launch_uneven_rows<256>(rows, a, tiles, smem, st, max_clusters);
      switch (rows) {
        case 16: return launch<256, 16>(a, tiles, smem, st, max_clusters);
        case 32: return launch<256, 32>(a, tiles, smem, st, max_clusters);
        case 40: return launch<256, 40>(a, tiles, smem, st, max_clusters);
        default: break;
      }
      break;
    case 160: return launch_uneven_rows<160>(rows, a, tiles, smem, st, max_clusters);
    case 192: return launch_uneven_rows<192>(rows, a, tiles, smem, st, max_clusters);
    case 224: return launch_uneven_rows<224>(rows, a, tiles, smem, st, max_clusters);
    case 288: return launch_uneven_rows<288>(rows, a, tiles, smem, st, max_clusters);
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
