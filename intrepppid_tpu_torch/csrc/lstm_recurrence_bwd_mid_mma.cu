// Backward sweep of the masked LSTM recurrence over precomputed,
// time-major input gates, bf16 compute dtype, at H = 96 to 288: the
// tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_bwd_mid_f32.cu (f32 at these widths), with
// lstm_recurrence_wgrad_mma.cu after it (the dW sums), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence, for compute dtype bfloat16
// and H = 96, 128, ..., 288 (ops/lstm_cuda.py:recurrence_sweep_kernel): a
// one-layer bf16 model at embedding 128 on the recurrence backend, and the
// padded widths past 64 there (embedding 80 runs at 96).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_sweep): block
// (row tile, direction d) walks s = T-1 .. 0 carrying dh and dc (f32, from
// dhn / dcn). Per step and row r:
//   * gates = xg[s, d, r] + round_bf16(h_prev) @ w[d, g], h_prev =
//     hs[s-1, d, r] and c_prev = cs[s-1, d, r] (both f32, zero at s = 0;
//     c_prev is used unrounded); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates (f32) by the rules of lstm_pallas.py:210-228: a step with
//     valid[s, d, r] == 0 (the mask is data and may have holes: every step
//     is computed) gets dgates = 0 and passes dh and dc through;
//     dxg[s, d, r] = dgates, unrounded;
//   * dh = round_bf16(dgates) @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
// The partial sums of dh are added in rank order, so two runs give the
// same bits.
//
// What bounds it on an H100: the bytes (xg, hs, cs, dhs in, dxg out: 44 H
// bytes per row and step, 2.0 ms at H = 128, 400 rows, D = 2, T = 1500);
// the two products (16 H^2 flops per row and step) take a third of that
// at the bf16 rate. What governs is the serial chain of a step, T times:
// the dh product, the exchange of partial sums within the cluster, the
// cell, the gate product.
//
// Design: the schedule of the op's f32 sweep at these widths,
// lstm_recurrence_bwd_mid_f32.cu, in one bf16 pass on the operands and
// weight copy of the bf16 sweep past 288, lstm_recurrence_bwd_wide_mma.cu:
//   * a cluster of CL blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / CL, (k + 1) n / CL) of the n = H / 8 unit
//     groups; CL is 4 (96-256) or 8 (96-288), each its own instances, and
//     ops/lstm_cuda.py (recurrence_mid_mma_plan) names it by width;
//   * the block's share of the op's bf16 fragment copy of w
//     (lstm_recurrence_wide_mma.cuh; ops/lstm_cuda.py:recurrence_mma_weights)
//     is copied once into shared memory: ceil(H / 8 / CL) groups x H x 64
//     bytes (32 KB at 128 with 4 groups a block, 128 KB at 256 with 8), so
//     neither product waits on L2 on a step's chain;
//   * both products on mma.sync m16n8k16 bf16 with f32 sums; the gate
//     product's B is the bf16 h_prev tile (ldmatrix), the dh product's B the
//     block's bf16 dgates tile (ldmatrix) and its A the gate fragments
//     transposed in registers (movmatrix);
//   * the gate product and the cell: the block's UG x NT (unit group, n8
//     tile) items, each a unit's four gates for 8 rows in one lane, dealt
//     over the 8 warps, each warp's items inside one group
//     (lstm_recurrence_wide_mma.cuh:deal_items);
//   * the dh product: warp w (in the deal's dh order) takes the m16 tiles of
//     units w, w + 8, .. (of H / 16), each over the block's UG groups of
//     gate columns, into a partial dh over all H units; the owner of a unit
//     sums the CL partials in rank order through distributed shared memory.
//     One partial buffer and two cluster barriers a step;
//   * the gate recompute needs no dh: step s - 1's product runs at the end
//     of step s, after the block publishes its partial; its h_prev tile is
//     copied (cp.async, f32) a step ahead and rounded to bf16 in shared
//     memory after step s's cell; its xg (straight into the accumulators),
//     c_prev, dhs and the mask bytes are loaded before the dh product, so
//     their latency hides behind it; where a warp takes at most two items,
//     earlier still, into a second register set at the top of step s,
//     before the exchange and the cell (faster in turns at 256, even at
//     128). A cp.async ring of them was not built: at 160-288 a stage of the
//     block's xg, c_prev and dhs columns does not fit beside the share;
//   * row tiles BR in {16, 32}; the plan takes the cluster size by width
//     and the fewest waves, then the smallest tile (at 256 with 4-block
//     clusters only 16 rows fit).

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;
typedef __nv_bfloat16 bf16;

constexpr int kMinMidH = 96;
constexpr int kMaxMidH = 288;

struct Args {
  const float* xg;       // (T, D, B, 4H)
  const uint8_t* valid;  // (T, D, B)
  const uint4* wg;       // the bf16 weight copy (above)
  const float* hs;       // (T, D, B, H)
  const float* cs;
  const float* dhs;  // (T, D, B, H) or null (zero)
  const float* dhn;  // (D, B, H) or null (zero)
  const float* dcn;
  float* dxg;  // (T, D, B, 4H)
  int T, B, H, G;
};

// The most unit groups one block of a CL-block cluster owns at H.
__host__ __device__ constexpr int mid_groups(int H, int CL) { return (H / 8 + CL - 1) / CL; }
// Row stride (f32) of the partial dh buffer: at least BR and 8 mod 16, so
// the float2 writes and reads of a half warp are conflict-free.
__host__ __device__ constexpr int part_stride(int BR) { return BR + ((8 - BR) % 16 + 16) % 16; }

// Dynamic shared memory (bytes), in layout order: the block's weight
// fragments, the f32 h_prev tile, its bf16 rounding, the block's bf16
// dgates tile (32 gate columns a group) and the f32 partial dh of all H units.
__host__ __device__ constexpr int smem_w(int H, int CL) { return mid_groups(H, CL) * H * 64; }
__host__ __device__ constexpr int smem_hf(int H, int BR) { return BR * H * 4; }
__host__ __device__ constexpr int smem_hb(int H, int BR) { return BR * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_dg(int H, int BR, int CL) {
  return BR * (32 * mid_groups(H, CL) + kPad) * 2;
}
__host__ __device__ constexpr int smem_part(int H, int BR) { return H * part_stride(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR, int CL) {
  return smem_w(H, CL) + smem_hf(H, BR) + smem_hb(H, BR) + smem_dg(H, BR, CL) +
         smem_part(H, BR);
}

// grid (tiles * CL, D) in clusters of CL, kThreads threads; MG the most
// groups a block owns at the instance's widths.
template <int CL, int BR, int MG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_bwd_mid_mma_kernel(const Args a) {
  constexpr int NT = BR / 8;                // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;          // fewest warps a unit group gets
  constexpr int GI = (NT + WPG - 1) / WPG;  // most items a warp takes
  // most m16 tiles of units a warp takes in the dh product: ceil(H / 128)
  constexpr int MTW = (MG * 8 * CL + 127) / 128;
  constexpr int PS = part_stride(BR);
  static_assert(BR % 8 == 0 && WPG >= 1 && (CL == 4 || CL == 8), "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / CL;
  const int d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  const int glo = rank * (H / 8) / CL, ghi = (rank + 1) * (H / 8) / CL;
  const int UG = ghi - glo, unit0 = 8 * glo;
  const int K16 = H / 16, KS = H + kPad, DS = 32 * MG + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);  // [UG][K16][2][32]
  float* hf = reinterpret_cast<float*>(smem + smem_w(H, CL));                      // [BR][H]
  bf16* hb = reinterpret_cast<bf16*>(smem + smem_w(H, CL) + smem_hf(H, BR));       // [BR][KS]
  bf16* dg_s = hb + BR * KS;                                                       // [BR][DS]
  float* part = reinterpret_cast<float*>(smem + smem_w(H, CL) + smem_hf(H, BR) +
                                         smem_hb(H, BR) + smem_dg(H, BR, CL));     // [H][PS]
  const uint32_t hf_u32 = smem_u32(hf);

  // the block's share of the weight copy: its UG groups of (d, group)
  const uint4* wdg = a.wg + ((size_t)(d * a.G + tr.group) * (H / 8) + glo) * K16 * 64;
  for (int idx = tid; idx < UG * K16 * 64; idx += kThreads) w_s[idx] = __ldg(wdg + idx);

  // gate items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group
  // ug; lane (g, t) of item j holds `unit` for tile rows 8 (nt0 + j) + 2t + i
  const ItemDeal deal = deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni, dh_rank = deal.dh_rank;
  const int unit = unit0 + 8 * ug + g;
  const uint4* wa = w_s + (size_t)ug * K16 * 64 + lane;
  float dh[GI][2], dc[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 8 * (nt0 + j) + 2 * t + i;
      const bool real = j < ni && rl < tr.nrows;
      const size_t at = ((size_t)d * B + tr.row0 + (real ? rl : 0)) * H + (real ? unit : 0);
      dh[j][i] = (real && a.dhn) ? a.dhn[at] : 0.0f;
      dc[j][i] = (real && a.dcn) ? a.dcn[at] : 0.0f;
    }

  // h_prev of the gates at step s (hs[s - 1]) into hf, asynchronously
  auto fetch_h = [&](int s) {
    const float* src = a.hs + (((size_t)(s - 1) * D + d) * B + tr.row0) * H;
    const int HC = H / 4;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const bool real = rl < tr.nrows;
      cp_async16(hf_u32 + (uint32_t)((rl * H + 4 * cc) * 4),
                 real ? src + (size_t)rl * H + 4 * cc : a.hs, real);
    }
    cp_async_commit();
  };
  // hf rounded to bf16 into hb
  auto round_h = [&]() {
    const int HC = H / 8;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const float4 x = *reinterpret_cast<const float4*>(hf + rl * H + 8 * cc);
      const float4 y = *reinterpret_cast<const float4*>(hf + rl * H + 8 * cc + 4);
      *reinterpret_cast<uint4*>(hb + rl * KS + 8 * cc) =
          make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w), pack_bf16x2(y.x, y.y),
                     pack_bf16x2(y.z, y.w));
    }
  };

  // step s's cell operands: xg into the accumulators (xa), c_prev, dhs, the
  // mask. EARLY (where a warp takes at most two items, so registers allow a
  // second set): step s - 1's are loaded into the n* set at the top of step
  // s, before the exchange and the cell, and taken into the working set
  // after the cell; otherwise straight into the working set after the cell
  constexpr bool EARLY = GI <= 2;
  float acc[GI][2][4], cpv[GI][2], dyv[GI][2];
  bool vv[GI][2];
  float nacc[GI][2][4], ncpv[GI][2], ndyv[GI][2];
  bool nvv[GI][2];
  auto load_step = [&](int s, float (&xa)[GI][2][4], float (&cp)[GI][2], float (&dy)[GI][2],
                       bool (&vm)[GI][2]) {
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
    const size_t pbase = ((size_t)(s - 1) * D + d) * B + tr.row0;  // used only when s > 0
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * (nt0 + j) + 2 * t + i;
        const bool real = rl < tr.nrows;
        const size_t r = real ? rl : 0;
        const float* src = a.xg + (base + r) * H4 + unit;
        xa[j][0][i] = real ? __ldcs(src) : 0.0f;
        xa[j][0][2 + i] = real ? __ldcs(src + H) : 0.0f;
        xa[j][1][i] = real ? __ldcs(src + 2 * H) : 0.0f;
        xa[j][1][2 + i] = real ? __ldcs(src + 3 * H) : 0.0f;
        cp[j][i] = (real && s > 0) ? __ldcs(a.cs + (pbase + r) * H + unit) : 0.0f;
        dy[j][i] = (real && a.dhs) ? __ldcs(a.dhs + (base + r) * H + unit) : 0.0f;
        vm[j][i] = real && __ldg(a.valid + base + r) != 0;
      }
    }
  };
  auto take_step = [&]() {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[j][mt][i] = nacc[j][mt][i];
          acc[j][mt][2 + i] = nacc[j][mt][2 + i];
        }
        cpv[j][i] = ncpv[j][i];
        dyv[j][i] = ndyv[j][i];
        vv[j][i] = nvv[j][i];
      }
  };

  // The gate product of the warp's items over K = H: A the group's resident
  // fragments (k16 step kk, m16 half mt at kk * 64 + mt * 32 lanes' worth),
  // B the bf16 h_prev tile through ldmatrix (a k32 step of an n8 tile).
  const uint32_t b_gate = smem_u32(hb) + (uint32_t)(((8 * nt0 + lr) * KS + 8 * lm) * 2);
  auto gate_mma = [&]() {
#pragma unroll 2
    for (int k2 = 0; k2 < H / 32; ++k2) {
      uint4 f[4];  // [2 kh + mt]
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = wa[k2 * 128 + q * 32];
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (j >= ni) continue;
        uint32_t b[4];
        ldmatrix_x4(b, b_gate + (uint32_t)((8 * j * KS + 32 * k2) * 2));
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_a4(acc[j][mt], f[2 * kh + mt], b[2 * kh], b[2 * kh + 1]);
      }
    }
  };

  // The dh product of one step: for each m16 tile m = dh_rank + 8 j of the
  // units, c (units x tile rows) = sum over the block's gate columns; A the
  // fragments of local group q at k16 step m (both halves mt) transposed in
  // registers (rows: units 16 m + g, + 8; K: the group's permuted gate rows
  // 16 mt ..), B the dgates tile's columns 32 q + 16 mt .. through ldmatrix.
  // An item is one (m16 tile, group); the next item's fragments are loaded
  // before this one's products. Each tile's sums go to the partial buffer
  // once its last group is in.
  const int nmt = H / 16 > dh_rank ? min(MTW, (H / 16 - dh_rank + kWarps - 1) / kWarps) : 0;
  const int nit = nmt * UG;
  const uint32_t b_dh = smem_u32(dg_s) + (uint32_t)((lr * DS + 8 * lm) * 2);
  auto dh_load = [&](uint4& f0, uint4& f1, int it) {
    const int j = it / UG, q = it - j * UG;
    const uint4* p = w_s + ((size_t)q * K16 + dh_rank + kWarps * j) * 64 + lane;
    f0 = p[0];
    f1 = p[32];
  };
  auto dh_mma = [&]() {
    float c[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) c[n][v] = 0.0f;
    uint4 nf0, nf1;
    if (nit > 0) dh_load(nf0, nf1, 0);
#pragma unroll 1
    for (int it = 0; it < nit; ++it) {
      const int j = it / UG, q = it - j * UG;
      const uint4 f[2] = {nf0, nf1};
      if (it + 1 < nit) dh_load(nf0, nf1, it + 1);
      uint32_t b[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        ldmatrix_x4(b[n], b_dh + (uint32_t)((8 * n * DS + 32 * q) * 2));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint4 at = make_uint4(movmatrix_trans(f[mt].x), movmatrix_trans(f[mt].z),
                                    movmatrix_trans(f[mt].y), movmatrix_trans(f[mt].w));
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_a4(c[n], at, b[n][2 * mt], b[n][2 * mt + 1]);
      }
      if (q == UG - 1) {
        const int u = 16 * (dh_rank + kWarps * j) + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<float2*>(part + u * PS + 8 * n + 2 * t) =
              make_float2(c[n][0], c[n][1]);
          *reinterpret_cast<float2*>(part + (u + 8) * PS + 8 * n + 2 * t) =
              make_float2(c[n][2], c[n][3]);
#pragma unroll
          for (int v = 0; v < 4; ++v) c[n][v] = 0.0f;
        }
      }
    }
  };

  // the first step's gates: h_prev = hs[T - 2] (none at T = 1)
  if (T > 1) {
    fetch_h(T - 1);
    cp_async_wait<0>();
  }
  __syncthreads();  // hf holds hs[T - 2]; the weight share is in
  if (T > 1) round_h();
  __syncthreads();  // hb holds step T - 1's h_prev; hf is free
  if (T > 2) fetch_h(T - 2);
  load_step(T - 1, acc, cpv, dyv, vv);
  if (T > 1 && ni > 0) gate_mma();
  const uint32_t part_u32 = smem_u32(part);

  for (int s = T - 1; s >= 0; --s) {
    if (EARLY && s > 0) load_step(s - 1, nacc, ncpv, ndyv, nvv);
    if (s < T - 1) {
      // dh of this step: the CL partials of step s + 1, in rank order
      cluster_wait_acquire();
      uint32_t rank_base[CL];
#pragma unroll
      for (int k = 0; k < CL; ++k) rank_base[k] = mapa_u32(part_u32, k);
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (j >= ni) continue;
        const uint32_t off = (uint32_t)((unit * PS + 8 * (nt0 + j) + 2 * t) * 4);
        float2 p[CL];
#pragma unroll
        for (int k = 0; k < CL; ++k) p[k] = ld_dsmem_f2(rank_base[k] + off);
        float s0 = p[0].x, s1 = p[0].y;
#pragma unroll
        for (int k = 1; k < CL; ++k) {
          s0 += p[k].x;
          s1 += p[k].y;
        }
        dh[j][0] = s0 + dh[j][0];  // dh holds what the masked rows passed through
        dh[j][1] = s1 + dh[j][1];
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");  // done reading
    }

    // the cell: lane (g, t) holds the four gates of `unit` for rows 2t, 2t + 1
    // of n8 tile nt0 + j
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
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
        const bool m = vv[j][i];
        float g4[4];
        g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
        g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
        g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
        g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
        dc[j][i] = m ? dct * fg : dc[j][i];
        dh[j][i] = m ? 0.0f : dht;  // passed through to the next step where masked
        if (rl < tr.nrows) {
          float* dst = a.dxg + (base + rl) * H4 + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) __stcs(dst + q * H, g4[q]);
        }
        // gate q of the group's unit g is permuted row 8 q + g of its 32
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dg_s[rl * DS + 32 * ug + 8 * q + g] = __float2bfloat16_rn(g4[q]);
      }
    }
    if (s == 0) break;  // the last step's dh is dead
    if (s > 1) {
      // step s - 1's h_prev (hs[s - 2], fetched a step ahead), rounded: hb is
      // free once every warp is past step s's gates
      cp_async_wait<0>();
      __syncthreads();  // hf landed for every thread's copies
      round_h();
    }
    __syncthreads();  // the dgates tile and hb are complete; hf is free
    if (s > 2) fetch_h(s - 2);
    // step s - 1's cell operands, during the dh product
    if (EARLY)
      take_step();
    else
      load_step(s - 1, acc, cpv, dyv, vv);
    if (s < T - 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s + 1's
    dh_mma();
    cluster_arrive_release();  // this block's partial of step s is written
    if (s > 1 && ni > 0) gate_mma();  // step 0's gates are its xg alone
  }
  // every block is done reading this block's partials before it exits
  if (T > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int CL, int BR, int MG>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR, CL) || mid_groups(a.H, CL) != MG)
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_recurrence_bwd_mid_mma_kernel<CL, BR, MG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CL, D, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) {
    cfg.gridDim = dim3(CL, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, (void*)kernel, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CL, int MG>
int launch_rows(int rows, const Args& a, int D, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch<CL, 16, MG>(a, D, tiles, smem, st, mc);
    case 32: return launch<CL, 32, MG>(a, D, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instances, as bit masks of H / 32 for each cluster size: 8-block
// clusters at every width (2-5 groups a block), 4-block ones at 96-256
// (3-8 groups a block: at 288 a block's 9 groups outnumber its warps).
// Row tiles 16 and 32 each (at 256 with 4-block clusters the 32-row tile
// does not fit shared memory, and the plan refuses it).
constexpr int kWidths8 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8) | (1 << 9);
constexpr int kWidths4 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8);
constexpr int kRows = (1 << 2) | (1 << 4);  // 16, 32, as bit rows / 8

}  // namespace

extern "C" {

int lstm_recurrence_bwd_mid_mma_threads() { return kThreads; }
int lstm_recurrence_bwd_mid_mma_pad() { return kPad; }
int lstm_recurrence_bwd_mid_mma_min_h() { return kMinMidH; }
int lstm_recurrence_bwd_mid_mma_max_h() { return kMaxMidH; }
int lstm_recurrence_bwd_mid_mma_rows() { return kRows; }
int lstm_recurrence_bwd_mid_mma_widths8() { return kWidths8; }
int lstm_recurrence_bwd_mid_mma_widths4() { return kWidths4; }

const char* lstm_recurrence_bwd_mid_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `cluster` (4 or 8) is the blocks a
// cluster, `rows` the row tile (16 or 32), `smem` the dynamic shared
// memory, as ops/lstm_cuda.py:recurrence_mid_mma_smem("bwd", ...) computes
// it (refused otherwise, and so is a combination with no instance). xg
// (T, D, B, 4H) f32; valid (T, D, B) uint8; wg the bf16 weight copy of w
// (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_mma_weights); hs, cs, dhs
// (T, D, B, H) f32 (dhs may be null: zero); dhn / dcn (D, B, H) f32 or null
// (zero); dxg (T, D, B, 4H) f32. H % 32 == 0, 96 <= H <= 288, B % G == 0,
// T >= 1; each of the G weight groups (B / G rows) is cut into its own
// tiles of `rows` rows: `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd_mid_mma(int cluster, int rows, const void* xg, const void* valid,
                                const void* wg, const void* hs, const void* cs, const void* dhs,
                                const void* dhn, const void* dcn, void* dxg, int D, int T_steps,
                                int B, int H, int G, int tiles, int smem, void* stream,
                                int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinMidH || H > kMaxMidH ||
      (max_clusters == nullptr && T_steps < 1))
    return (int)cudaErrorInvalidValue;
  const int bit = 1 << (H / 32);
  const int mask = cluster == 4 ? kWidths4 : cluster == 8 ? kWidths8 : 0;
  if (!(mask & bit)) return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.valid = static_cast<const uint8_t*>(valid);
  a.wg = static_cast<const uint4*>(wg);
  a.hs = static_cast<const float*>(hs);
  a.cs = static_cast<const float*>(cs);
  a.dhs = static_cast<const float*>(dhs);
  a.dhn = static_cast<const float*>(dhn);
  a.dcn = static_cast<const float*>(dcn);
  a.dxg = static_cast<float*>(dxg);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mg = mid_groups(H, cluster);
  if (cluster == 4) {
    switch (mg) {
      case 3: return launch_rows<4, 3>(rows, a, D, tiles, smem, st, max_clusters);
      case 4: return launch_rows<4, 4>(rows, a, D, tiles, smem, st, max_clusters);
      case 5: return launch_rows<4, 5>(rows, a, D, tiles, smem, st, max_clusters);
      case 6: return launch_rows<4, 6>(rows, a, D, tiles, smem, st, max_clusters);
      case 7: return launch_rows<4, 7>(rows, a, D, tiles, smem, st, max_clusters);
      case 8: return launch_rows<4, 8>(rows, a, D, tiles, smem, st, max_clusters);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (mg) {
    case 2: return launch_rows<8, 2>(rows, a, D, tiles, smem, st, max_clusters);
    case 3: return launch_rows<8, 3>(rows, a, D, tiles, smem, st, max_clusters);
    case 4: return launch_rows<8, 4>(rows, a, D, tiles, smem, st, max_clusters);
    case 5: return launch_rows<8, 5>(rows, a, D, tiles, smem, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
