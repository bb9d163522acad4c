// Bidirectional LSTM layer backward sweep over the input-gate streams, f32
// compute dtype, for layers whose weights fit no block: the tensor-core
// variant in three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd_lite.cu (which keeps the f32 widths this kernel
// does not take), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel with
//     fused_input=False (via _bwd_pallas_lite, :723) -- the lite backward
//     of the large-H plan (the scaled configuration's H = 256);
// and, with bilstm_gates_f32.cu before it and the input-side products and
// bilstm_wgrad_f32.cu after it (ops/lstm_stack.py), _bwd_kernel with
// fused_input=True (via _bwd_pallas, :603) at H = 128; for compute dtype
// float32 at H = 128, 160, 192, 224, 256 and 288 (ops/lstm_cuda.py:lite_kernel).
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep_lite with the
// compute dtype f32, where round() is the identity): block (row tile,
// direction d) walks the positions in the reverse of that direction's
// forward order carrying dh and dc. Per step and row: gates = xg[d, pos] +
// h_prev @ W_hh[d, g]^T (h_prev the forward stream at the previous position:
// hs_f[pos - 1] for d = 0, hs_b[pos + 1] for d = 1, zero past the ends),
// c_new = f * c_prev + i * g with c_prev from the cell stream at that
// position, dh += the 0-2 dy streams (summed in f32), the masked dgates
// (the mask rules of lstm_pallas_layer.py:519-536: pos >= length gets 0 and
// passes dh and dc through) to the (2, T, B, 4H) output, and dh = dgates @
// W_hh[d, g] (+ dh passed through where masked), dc = masked ? dc : dc_t * f.
//
// What bounds it on an H100: the two products, 16 H^2 flops per row and
// step, in three tf32 passes at 495/3 TFLOP/s (9.65 ms a layer at H = 288,
// 400 rows, T = 1500), over the f32 streams (xg in, dgates out, the
// forward's streams and dy). What governs is the serial chain of a step, T
// times: the dh product, the exchange of partial sums within the cluster,
// the cell, the gate product. One tf32 pass misses the f32 agreement by
// 3-4 x, so every product is big.big + big.small + small.big.
//
// Design: the schedule of the recurrence op's f32 sweep past 288,
// lstm_recurrence_bwd_wide_f32.cu, on the lite operands, whose layout the
// bf16 lite sweep bilstm_bwd_lite_mma.cu reads:
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / 8, (k + 1) n / 8) of the n = H / 8 unit
//     groups (lstm_recurrence_wide_mma.cuh:unit_groups): 2 a block at
//     H = 128, 2 or 3 at 160, 3 at 192, 3 or 4 at 224, 4 at 256, 4 or 5 at
//     288;
//   * the weights are not resident: a block's f32 W_hh slice (186,880 B at
//     288 and 5 groups) leaves no room for the tiles. Both products read
//     one L2-resident f32 copy of W_hh^T in mma fragment order
//     (lstm_recurrence_wide_f32.cuh; ops/lstm_cuda.py:recurrence_f32_weights
//     of w_hh transposed, 1.33 MB a (d, g) at 288, 13.3 MB for the train
//     step's 10), split into big and small in registers, the dh product's
//     fragments transposed by movmatrix;
//   * the gate product and the cell: the block's UG x NT (unit group, n8
//     tile) items, each a unit's four gates for 8 rows in one lane, are
//     dealt over all 8 warps, each warp's items inside one group (whose
//     fragments it loads once a chunk for all of them): group q gets 8 / UG
//     warps (the first 8 % UG groups one more), which split its NT tiles.
//     With "warp w takes group w" 6 of 8 warps would idle at H = 128. At
//     32-row tiles: one item a warp at 128, two at 256; at 288 two, and
//     four on warps 6 and 7 of a 5-group block (not warps 0 and 1, which
//     take the dh product's third m16 tile). Runs that spanned two groups
//     (bilstm_fwd_wide_mma.cu's deal: at most three items a warp, the
//     fragments of both groups) took 1.08 x the time at 288. Four k16
//     chunks of fragments are in flight, two where a warp may take four
//     items (the registers);
//   * the dh product: warp w takes the m16 tiles of units w, w + 8, .. (of
//     H / 16), each over the block's UG groups of gate columns (K = 32 UG),
//     into a partial dh over all H units per block; the owner of a unit sums
//     the 8 partials in rank order through distributed shared memory
//     (32-bit `mapa` addresses), so the result does not depend on timing.
//     One partial buffer and two cluster barriers a step: a block writes
//     step s's partial only after every block has read step s - 1's;
//   * the gate recompute needs no dh: the next step's product runs at the
//     end of a step, after the block publishes its partial; its h_prev tile
//     (f32, one buffer, cp.async, zeros past the ends), its xg (straight
//     into the accumulators), c_prev and dy (registers) are loaded before
//     the dh product, so their latency hides behind it;
//   * a tile skips the positions at or past its longest row: there dgates
//     is zero (written up front) and dh only gathers dy, which the forward
//     direction's sweep adds up before its first real step (the reverse
//     direction meets those positions last, where dh is dead);
//   * row tiles BR in {16, 32}; f32 h_prev + dgates + partial take 107,520 B
//     at H = 288 and 32 rows (94,208 at 256, 49,152 at 128). ops/lstm_cuda.py
//     (wide_plan("lite_f32", ...)) picks the fewest waves, then the smallest
//     tile: at the train step's 400 rows in 5 groups 32-row tiles make 30
//     clusters, two waves of 15 (one block an SM: the registers, 232-255 a
//     thread; the 32-row 288 instance spills 36 B, the others nothing).
// At 288 a step costs about twice what it does at 256: the 5-group blocks
// carry 1.25 x the items, and the dh product's 18 m16 tiles leave warps 0-1
// with 3 of them (15 items against 8 at 256) (PERF.md, chip_smoke.py phase
// widths).
// At 160, 192 and 224 the cluster splits the 20, 24 and 28 unit groups 2 or
// 3, 3, and 3 or 4 a block (the MG = 3 instance takes 160 and 192, MG = 4
// 224, as 256); the slowest block sets the pace through the cluster
// barriers. A 3-group block deals its 8 warps 3, 3 and 2 to its groups, so
// at 32-row tiles warps 2, 5, 6 and 7 take two items and the others one;
// the dh product's 10, 12 and 14 m16 tiles leave 2, 4 and 6 warps a second
// tile. The dh product takes its warps in order of their gate items (the
// fewest first, then by index: dh_rank), so the warps with the fewest gate
// items take its extra tiles (at 192 warps 0, 1, 3 and 4, one item each);
// at 128, 256 and 288 that order is the warps' own. The two products are
// separated by block barriers, so a step costs the largest load of each;
// the order evens what each warp does in a whole step.
// This kernel takes H = 128, 160, 192, 224, 256 and 288; the f32 wide width
// 96 keeps bilstm_bwd_lite_f32_resident.cu (W_hh resident in one block), and
// bilstm_bwd_lite.cu takes the f32 widths 160-224 by name only.

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_f32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;

struct Args {
  const float* xg;       // (2, T, B, 4H)
  const int* lengths;    // (B,)
  const uint4* wf;       // the f32 fragment copy of W_hh^T (2, G, H, 4H)
  const float* hs[2];    // per direction, (T, B, H)
  const float* cs[2];
  const float* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // (2, B, H) or null (zero)
  const float* dcn;
  float* dgates;  // (2, T, B, 4H)
  int T, B, H, G;
};

// Dynamic shared memory of the <BR> instance at H (bytes), in layout order:
// the f32 h_prev tile, the block's f32 dgates tile (32 gate columns for each
// of its at most ceil(H / 64) unit groups) and the f32 partial dh of all H
// units.
__host__ __device__ constexpr int smem_h(int H, int BR) { return BR * (H + kFPad) * 4; }
__host__ __device__ constexpr int smem_dg(int H, int BR) {
  return BR * (32 * max_block_groups(H) + kFPad) * 4;
}
__host__ __device__ constexpr int smem_part(int H, int BR) { return H * part_stride_f32(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_h(H, BR) + smem_dg(H, BR) + smem_part(H, BR);
}

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads
// threads; MG = max_block_groups(H).
template <int BR, int MG>
__global__ void __launch_bounds__(kThreads, 1) bilstm_bwd_lite_f32_kernel(const Args a) {
  constexpr int NT = BR / 8;         // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;   // fewest warps a unit group gets
  constexpr int GI = (NT + WPG - 1) / WPG;  // most items a warp takes
  constexpr int MTW = (MG + 1) / 2;  // most m16 tiles of units a warp takes (ceil(H / 128))
  // k16 chunks of gate-product fragments in flight (two where a warp may
  // take a whole group's items: the registers)
  constexpr int P = WPG == 1 ? kGateChunks : 2 * kGateChunks;
  constexpr int PS = part_stride_f32(BR);
  static_assert(BR % 8 == 0 && WPG >= 1, "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H, ny = a.ny;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  int glo, ghi;
  unit_groups(H, rank, glo, ghi);
  const int UG = ghi - glo, U = 8 * UG, unit0 = 8 * glo;
  const int KS = H + kFPad, DS = 32 * MG + kFPad;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hb = reinterpret_cast<float*>(smem);                    // [BR][KS]
  float* dg_s = hb + BR * KS;                                    // [BR][DS], columns permuted
  float* part = reinterpret_cast<float*>(smem + smem_h(H, BR) + smem_dg(H, BR));  // [H][PS]
  const uint32_t smem0 = smem_u32(smem);

  // the tile's longest row bounds the positions that do any work: step s
  // works on position s (d = 1) or maxlen - 1 - s (d = 0); every block of
  // the cluster finds the same maxlen, so they take the same barriers
  int maxlen = 0;
  for (int rl = 0; rl < tr.nrows; ++rl) maxlen = max(maxlen, min(a.lengths[tr.row0 + rl], T));
  float* dgd = a.dgates + (size_t)d * T * B * H4;
  // positions [maxlen, T): this block's dgates columns are zero
  {
    const int per_row = U, per_gate = U / 4;  // float4 chunks
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int idx = tid; idx < (T - maxlen) * tr.nrows * per_row; idx += kThreads) {
      const int pi = idx / (tr.nrows * per_row), rem = idx - pi * (tr.nrows * per_row);
      const int rl = rem / per_row, c = rem - rl * per_row;
      const int q = c / per_gate, cu = (c - q * per_gate) * 4;
      *reinterpret_cast<float4*>(dgd + ((size_t)(maxlen + pi) * B + tr.row0 + rl) * H4 + q * H +
                                 unit0 + cu) = zero;
    }
  }
  if (maxlen == 0) return;  // no step: no barrier, no exchange

  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;
  const float* hs = a.hs[d];
  const float* cs = a.cs[d];
  const float* xgd = a.xg + (size_t)d * T * B * H4;

  // gate items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group
  // ug: group q gets 8 / UG warps, the first 8 % UG groups one more (so at
  // 288 the 5-group blocks' last two groups get one warp each, warps 6 and
  // 7), which split its NT tiles. Lane (g, t) of item j holds `unit` for tile
  // rows 8 (nt0 + j) + 2t + i. The dh product's warp order: by gate items,
  // the fewest first, then by index (lstm_recurrence_wide_mma.cuh:deal_items)
  const ItemDeal deal = deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni, dh_rank = deal.dh_rank;
  const int unit = unit0 + 8 * ug + g;
  const uint64_t pol = evict_last_policy();
  const uint4* wdg = a.wf + (size_t)(d * a.G + tr.group) * (H / 8) * (H / 8) * 64 + lane;
  const uint4* wa = wdg + (size_t)(glo + ug) * (H / 8) * 64;  // the group's fragments
  int len[GI][2];
  float dh[GI][2], dc[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 8 * (nt0 + j) + 2 * t + i;
      const bool real = j < ni && rl < tr.nrows;
      const int r = tr.row0 + (real ? rl : 0);
      len[j][i] = real ? a.lengths[r] : 0;
      const size_t at = ((size_t)d * B + r) * H + (real ? unit : 0);
      dh[j][i] = (real && a.dhn) ? a.dhn[at] : 0.0f;
      dc[j][i] = (real && a.dcn) ? a.dcn[at] : 0.0f;
      // the forward direction's sweep starts at T - 1: past the tile's
      // longest row a step only adds dy to dh, in the same order as the full sweep
      if (d == 0 && real && ny > 0) {
        for (int pos = T - 1; pos >= maxlen; --pos) {
          float dyv = 0.0f;
          for (int k = 0; k < ny; ++k) dyv += a.dy[0][k][((size_t)pos * B + r) * H + unit];
          dh[j][i] += dyv;
        }
      }
    }
  }

  // h_prev of the gates at `pos` into hb, asynchronously (zeros past the
  // ends and past the group's rows)
  auto fetch_h = [&](int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
    const float* src = hs + ((size_t)(in_t ? ppos : 0) * B + tr.row0) * H;
    const int HC = H / 4;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const bool ok = in_t && rl < tr.nrows;
      cp_async16(smem0 + (uint32_t)((rl * KS + 4 * cc) * 4),
                 ok ? src + (size_t)rl * H + 4 * cc : hs, ok);
    }
    cp_async_commit();
  };

  // the cell operands at `pos`: xg into the accumulators, c_prev, the dy sum
  float acc[GI][2][4], cpv[GI][2], dyv[GI][2];
  auto load_step = [&](int pos) {
    const int ppos = pos + hshift;
    const bool in_t = ppos >= 0 && ppos < T;
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * (nt0 + j) + 2 * t + i;
        const bool real = rl < tr.nrows;
        const size_t r = tr.row0 + (real ? rl : 0);
        const float* src = xgd + ((size_t)pos * B + r) * H4 + unit;
        acc[j][0][i] = real ? __ldcs(src) : 0.0f;
        acc[j][0][2 + i] = real ? __ldcs(src + H) : 0.0f;
        acc[j][1][i] = real ? __ldcs(src + 2 * H) : 0.0f;
        acc[j][1][2 + i] = real ? __ldcs(src + 3 * H) : 0.0f;
        cpv[j][i] = (real && in_t) ? __ldcs(cs + ((size_t)ppos * B + r) * H + unit) : 0.0f;
        float v = 0.0f;
        for (int k = 0; k < ny; ++k)
          if (real) v += __ldcs(a.dy[d][k] + ((size_t)pos * B + r) * H + unit);
        dyv[j][i] = v;
      }
    }
  };

  // The gate product of the warp's items over K = H (H / 16 k16 chunks),
  // three tf32 passes: A from the weight copy of its group through P slots
  // (gate_prefetch fills them with chunks 0 .. P-1, each is refilled P
  // chunks ahead after its use), B from the h_prev tile.
  uint4 ra[P][2][2];  // [slot][kh][mt]
  const int K16 = H / 16;
  auto gate_prefetch = [&]() {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < K16) chunk_load(ra[i], wa, i, pol);
  };
  const float* h_lane = hb + g * KS + 4 * t;
  auto gate_mma = [&]() {
#pragma unroll 1
    for (int c0 = 0; c0 < K16; c0 += P) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int c = c0 + i;
        if (c >= K16) continue;
        // the items' h_prev inputs of the chunk, split where they are used
        float4 hv[GI];
#pragma unroll
        for (int j = 0; j < GI; ++j)
          if (j < ni)
            hv[j] = *reinterpret_cast<const float4*>(h_lane + 8 * (nt0 + j) * KS + 16 * c);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t ab[4], as[4];
            split4(ra[i][kh][mt], ab, as);
#pragma unroll
            for (int j = 0; j < GI; ++j) {
              if (j >= ni) continue;
              uint32_t b0, b1, s0, s1;
              split_tf32(kh ? hv[j].z : hv[j].x, b0, s0);
              split_tf32(kh ? hv[j].w : hv[j].y, b1, s1);
              mma3(acc[j][mt], ab, as, b0, b1, s0, s1);
            }
          }
        if (c + P < K16) chunk_load(ra[i], wa, c + P, pol);
      }
    }
  };

  // The dh product of one step: for each m16 tile m = dh_rank + 8 j of the
  // units, c (units x tile rows) = sum over the block's gate columns, A the
  // gate fragments of group glo + ug at chunk m transposed in registers
  // (dh_fragment: row g is unit 16 m + 4 (g >> 1) + (g & 1), row g + 8 the
  // unit two further; K slot t (t + 4) gate column 16 mt + 8 hi + 2t (+ 1)
  // of the group, where the cell stored it in the dgates tile). An item is
  // one (m16 tile, group); two are in flight in rf (dh_prefetch fills them
  // before the cell, each is refilled two items ahead). Each tile's sums go
  // to the partial buffer once its last group is in.
  const int nmt = H / 16 > dh_rank ? min(MTW, (H / 16 - dh_rank + kWarps - 1) / kWarps) : 0;
  const int nit = nmt * UG;
  uint4 rf[2][2][2];  // [slot][kh][mt]
  auto dh_load = [&](uint4 (&r)[2][2], int it) {
    const int j = it / UG, ug = it - j * UG;
    chunk_load(r, wdg + (size_t)(glo + ug) * (H / 8) * 64, dh_rank + kWarps * j, pol);
  };
  auto dh_prefetch = [&]() {
    if (nit > 0) dh_load(rf[0], 0);
    if (nit > 1) dh_load(rf[1], 1);
  };
  const float* dg_lane = dg_s + g * DS + 4 * t;
  auto dh_use = [&](const uint4 (&r)[2][2], int ug, float (&c)[NT][4]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float4 bv[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        bv[n] = *reinterpret_cast<const float4*>(dg_lane + 8 * n * DS + 32 * ug + 16 * mt);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t ab[4], as[4];
        dh_fragment(r[0][mt], r[1][mt], hi, ab, as);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1, s0, s1;
          split_tf32(hi ? bv[n].z : bv[n].x, b0, s0);
          split_tf32(hi ? bv[n].w : bv[n].y, b1, s1);
          mma3(c[n], ab, as, b0, b1, s0, s1);
        }
      }
    }
  };
  auto dh_mma = [&]() {
    float c[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) c[n][v] = 0.0f;
#pragma unroll 1
    for (int it0 = 0; it0 < nit; it0 += 2) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int it = it0 + sl;
        if (it >= nit) continue;
        const int j = it / UG, ug = it - j * UG;
        dh_use(rf[sl], ug, c);
        if (it + 2 < nit) dh_load(rf[sl], it + 2);
        if (ug == UG - 1) {
          const int u = 16 * (dh_rank + kWarps * j) + 4 * (g >> 1) + (g & 1);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            *reinterpret_cast<float2*>(part + u * PS + 8 * n + 2 * t) =
                make_float2(c[n][0], c[n][1]);
            *reinterpret_cast<float2*>(part + (u + 2) * PS + 8 * n + 2 * t) =
                make_float2(c[n][2], c[n][3]);
#pragma unroll
            for (int v = 0; v < 4; ++v) c[n][v] = 0.0f;
          }
        }
      }
    }
  };

  // the first step's gates
  load_step(pos0);
  fetch_h(pos0);
  if (ni > 0) gate_prefetch();
  cp_async_wait<0>();
  __syncthreads();
  if (ni > 0) gate_mma();
  const uint32_t part_u32 = smem_u32(part);

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s > 0) {
      // dh of this step: the 8 partials of the previous step, in rank order
      cluster_wait_acquire();
      uint32_t rank_base[kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) rank_base[k] = mapa_u32(part_u32, k);
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (j >= ni) continue;
        const uint32_t off = (uint32_t)((unit * PS + 8 * (nt0 + j) + 2 * t) * 4);
        float2 p[kWideCluster];
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k) p[k] = ld_dsmem_f2(rank_base[k] + off);
        float s0 = p[0].x, s1 = p[0].y;
#pragma unroll
        for (int k = 1; k < kWideCluster; ++k) {
          s0 += p[k].x;
          s1 += p[k].y;
        }
        dh[j][0] = s0 + dh[j][0];  // dh holds what the masked rows passed through
        dh[j][1] = s1 + dh[j][1];
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");  // done reading
    }
    if (s + 1 < maxlen) dh_prefetch();  // this step's dh product's first weight fragments

    // the cell: lane (g, t) holds the four gates of `unit` for rows 2t, 2t + 1
    // of n8 tile nt0 + j
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
      // gate q of the group's unit g sits at column 16 (q >> 1) + 4 (g >> 1)
      // + 2 (q & 1) + (g & 1) of its 32 (the dh product's K order)
      float* dg_w = dg_s + 32 * ug + 4 * (g >> 1) + (g & 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * (nt0 + j) + 2 * t + i;
        const float ig = fast_sigmoid(acc[j][0][i]);
        const float fg = fast_sigmoid(acc[j][0][2 + i]);
        const float gg = fast_tanh(acc[j][1][i]);
        const float og = fast_sigmoid(acc[j][1][2 + i]);
        const float cprev = cpv[j][i];
        const float c_new = fg * cprev + ig * gg;
        const float dht = dh[j][i] + dyv[j][i];
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
        if (rl < tr.nrows) {
          float* dst = dgd + ((size_t)pos * B + tr.row0 + rl) * H4 + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) __stcs(dst + q * H, g4[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_w[rl * DS + 16 * (q >> 1) + 2 * (q & 1)] = g4[q];
      }
    }
    if (s + 1 == maxlen) break;  // the last step's dh is dead
    __syncthreads();  // the dgates tile is complete; every warp is past this step's gates (hb)
    fetch_h(pos + dpos);  // the next step's h_prev and cell operands, during the dh product
    load_step(pos + dpos);
    if (s > 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s - 1's
    dh_mma();
    cluster_arrive_release();  // this block's partial of step s is written

    if (ni > 0) gate_prefetch();
    cp_async_wait<0>();
    __syncthreads();  // hb holds the next step's h_prev
    if (ni > 0) gate_mma();
  }
  // every block is done reading this block's partials before it exits
  if (maxlen > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int BR, int MG>
int launch(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR) || max_block_groups(a.H) != MG) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_bwd_lite_f32_kernel<BR, MG>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

template <int MG>
int launch_rows(int rows, const Args& a, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch<16, MG>(a, tiles, smem, st, mc);
    case 32: return launch<32, MG>(a, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The widths and row tiles the kernel is instantiated for.
constexpr int kWidths[6] = {128, 160, 192, 224, 256, 288};
constexpr int kRows = (1 << 2) | (1 << 4);  // 16, 32, as bit rows / 8

}  // namespace

extern "C" {

int bilstm_bwd_lite_f32_cluster() { return kWideCluster; }
int bilstm_bwd_lite_f32_threads() { return kThreads; }
int bilstm_bwd_lite_f32_pad() { return kFPad; }
int bilstm_bwd_lite_f32_rows() { return kRows; }
// the widths as a bit mask of H / 32 (every width is a multiple of 32)
int bilstm_bwd_lite_f32_widths() {
  int mask = 0;
  for (int h : kWidths) mask |= 1 << (h / 32);
  return mask;
}

const char* bilstm_bwd_lite_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `rows` is the row tile (16 or 32) and `smem`
// its dynamic shared memory, as ops/lstm_cuda.py:wide_smem("lite_f32", ...)
// computes it (refused otherwise). xg (2, T, B, 4H) f32; lengths (B,) int32;
// wf the f32 fragment copy of W_hh^T (ops/lstm_cuda.py:recurrence_f32_weights
// of w_hh (2, G, 4H, H) transposed to (2, G, H, 4H)); hs_f, hs_b, cs_f, cs_b
// and the dy streams (T, B, H) f32 (dy*1 may be null, ny = 0-2 streams per
// direction); dhn / dcn (2, B, H) f32 or null (zero); dgates (2, T, B, 4H)
// f32. H is one of kWidths; each of the G weight groups (B / G rows) is cut
// into its own tiles of `rows` rows: `tiles` = G * ceil(B / G / rows). With
// max_clusters non-null, nothing is launched: it receives how many clusters
// the card holds at once. Returns a cudaError_t (0 on success).
int bilstm_bwd_lite_f32(int rows, const void* xg, const void* lengths, const void* wf,
                        const void* hs_f, const void* hs_b, const void* cs_f, const void* cs_b,
                        const void* dyf0, const void* dyf1, const void* dyb0, const void* dyb1,
                        int ny, const void* dhn, const void* dcn, void* dgates, int T_steps,
                        int B, int H, int G, int tiles, int smem, void* stream,
                        int* max_clusters) {
  if (ny < 0 || ny > 2 || G <= 0 || B % G) return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  Args a;
  a.xg = in(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.wf = static_cast<const uint4*>(wf);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = in(dhn);
  a.dcn = in(dcn);
  a.dgates = static_cast<float*>(dgates);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 128: return launch_rows<2>(rows, a, tiles, smem, st, max_clusters);
    case 160:
    case 192: return launch_rows<3>(rows, a, tiles, smem, st, max_clusters);
    case 224:
    case 256: return launch_rows<4>(rows, a, tiles, smem, st, max_clusters);
    case 288: return launch_rows<5>(rows, a, tiles, smem, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
