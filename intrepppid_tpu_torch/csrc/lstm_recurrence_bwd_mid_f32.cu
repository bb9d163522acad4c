// Backward sweep of the masked LSTM recurrence over precomputed,
// time-major input gates, f32 compute dtype, at H = 96 to 288: the
// tensor-core variant in three tf32 passes, hand-written for Hopper
// (sm_90a).
//
// Replaces, like lstm_recurrence_bwd_mid_mma.cu (bf16 at these widths),
// with lstm_recurrence_wgrad.cu after it (the dW sums), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence, for compute dtype float32 and
// H = 96, 128, ..., 288 (ops/lstm_cuda.py:recurrence_sweep_kernel): a
// one-layer model at embedding 128 on the recurrence backend, and the
// padded widths past 64 there.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_sweep with the
// compute dtype f32, where round() is the identity): block (row tile,
// direction d) walks s = T-1 .. 0 carrying dh and dc (f32, from dhn / dcn).
// Per step and row r:
//   * gates = xg[s, d, r] + h_prev @ w[d, g], h_prev = hs[s-1, d, r] and
//     c_prev = cs[s-1, d, r] (zero at s = 0); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates by the rules of lstm_pallas.py:210-228: a step with
//     valid[s, d, r] == 0 (the mask is data and may have holes: every step
//     is computed) gets dgates = 0 and passes dh and dc through;
//     dxg[s, d, r] = dgates;
//   * dh = dgates @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
// The partial sums of dh are added in rank order, so two runs give the
// same bits.
//
// What bounds it on an H100: the two products, 16 H^2 flops per row and
// step, in three tf32 passes at 495/3 TFLOP/s (2.0 ms at H = 128, 400 rows,
// D = 2, T = 1500, where the f32 streams, 44 H bytes per row and step, take
// about as long; 7.6 ms at 256, operations). What governs is the serial
// chain of a step, T times: the dh product, the exchange of partial sums
// within the cluster, the cell, the gate product. One tf32 pass keeps ~3
// decimal digits, which misses the f32 agreement (1e-4 x max(1, max|ref|))
// by 3-4 x, so every product is big.big + big.small + small.big.
//
// Design: the schedule of the layer's f32 lite sweep, bilstm_bwd_lite_f32.cu,
// on the op's operands (time-major (T, D, B, .) streams, a mask of bytes,
// one dhs stream), with the weight fragments resident in shared memory:
//   * a cluster of CL blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / CL, (k + 1) n / CL) of the n = H / 8 unit
//     groups; CL is 8, or 4 where a block's share fits (fewer blocks a
//     cluster: half as many partials to add, and at the train step's 400
//     rows one wave of clusters where 8-block clusters take two: 14.92
//     against 18.05 ms at H = 128, 30.44 against 35.36 at 192, in turns on
//     an H100, PERF.md); the plan takes 4 at 96-192;
//   * the block's share of the op's f32 fragment copy of w
//     (lstm_recurrence_wide_f32.cuh; ops/lstm_cuda.py:recurrence_f32_weights,
//     the copy the f32 forward past 288 reads) is copied once into shared
//     memory (MG x H x 128 bytes: 64 KB at 128 with 4 groups a block, 128 KB
//     at 256 with 4), so neither product waits on L2 on a step's chain. At
//     288 the share (180 KB) and the tiles do not fit: the fragments are read
//     from L2 as in the lite sweep (evict_last), and the by-name L2 instances
//     at the other widths time the difference;
//   * both products on mma.sync m16n8k8 tf32, each fragment split into big
//     and small in registers (a mask and a subtraction a value); the dh
//     product's fragments transposed 8x8 block by 8x8 block by movmatrix;
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
//     of step s, after the block publishes its partial; its h_prev tile (f32,
//     cp.async), its xg (straight into the accumulators), c_prev, dhs and
//     the mask bytes are loaded before the dh product, so their latency
//     hides behind it;
//   * row tiles BR in {16, 32}; ops/lstm_cuda.py (recurrence_mid_f32_plan)
//     takes the cluster size by width and the fewest waves, then the
//     smallest tile.

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_f32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;

constexpr int kMinMidH = 96;
constexpr int kMaxMidH = 288;

struct Args {
  const float* xg;       // (T, D, B, 4H)
  const uint8_t* valid;  // (T, D, B)
  const uint4* wf;       // the f32 weight copy (above)
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

// Dynamic shared memory (bytes), in layout order: the block's weight
// fragments (resident instances), the f32 h_prev tile, the block's f32
// dgates tile (32 gate columns a group) and the f32 partial dh of all H units.
__host__ __device__ constexpr int smem_w(int H, int CL, bool res) {
  return res ? mid_groups(H, CL) * H * 128 : 0;
}
__host__ __device__ constexpr int smem_h(int H, int BR) { return BR * (H + kFPad) * 4; }
__host__ __device__ constexpr int smem_dg(int H, int BR, int CL) {
  return BR * (32 * mid_groups(H, CL) + kFPad) * 4;
}
__host__ __device__ constexpr int smem_part(int H, int BR) { return H * part_stride_f32(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR, int CL, bool res) {
  return smem_w(H, CL, res) + smem_h(H, BR) + smem_dg(H, BR, CL) + smem_part(H, BR);
}

// grid (tiles * CL, D) in clusters of CL, kThreads threads; MG the most
// groups a block owns at the instance's widths; RES: the fragments resident.
template <int CL, int BR, int MG, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_bwd_mid_f32_kernel(const Args a) {
  constexpr int NT = BR / 8;         // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;   // fewest warps a unit group gets
  constexpr int GI = (NT + WPG - 1) / WPG;  // most items a warp takes
  // most m16 tiles of units a warp takes in the dh product: ceil(H / 128)
  constexpr int MTW = (MG * 8 * CL + 127) / 128;
  // k16 chunks of gate-product fragments in flight: shared memory's latency
  // needs two; from L2 four where a warp has fewer than a whole group's items
  constexpr int P = (RES || WPG == 1) ? kGateChunks : 2 * kGateChunks;
  constexpr int PS = part_stride_f32(BR);
  static_assert(BR % 8 == 0 && WPG >= 1 && (CL == 4 || CL == 8), "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / CL;
  const int d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  const int glo = rank * (H / 8) / CL, ghi = (rank + 1) * (H / 8) / CL;
  const int UG = ghi - glo, unit0 = 8 * glo;
  const int KS = H + kFPad, DS = 32 * MG + kFPad;
  const int KK = H / 8;  // k8 steps of the inputs: a group's fragments are KK * 64 lanes' worth

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);  // [UG][KK][2][32], resident instances
  float* hb = reinterpret_cast<float*>(smem + smem_w(H, CL, RES));  // [BR][KS]
  float* dg_s = hb + BR * KS;                                        // [BR][DS], columns permuted
  float* part = dg_s + BR * DS;                                      // [H][PS]
  const uint32_t hb_u32 = smem_u32(hb);

  const uint64_t pol = evict_last_policy();
  const uint4* wdg = a.wf + ((size_t)(d * a.G + tr.group) * KK + glo) * KK * 64;
  if (RES) {
    for (int idx = tid; idx < UG * KK * 64; idx += kThreads) w_s[idx] = ldg_weight(wdg + idx, pol);
  }
  // the fragments of local group ug, this lane's
  auto group_frags = [&](int ug) -> const uint4* {
    return (RES ? w_s : wdg) + (size_t)ug * KK * 64 + lane;
  };
  // the four fragments of k16 chunk c of one group (k8 step 2c + kh, m16 half mt)
  auto chunk = [&](uint4 (&r)[2][2], const uint4* p, int c) {
    p += (size_t)c * 128;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        r[kh][mt] = RES ? p[kh * 64 + mt * 32] : ldg_weight(p + kh * 64 + mt * 32, pol);
  };

  // gate items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group
  // ug (lstm_recurrence_wide_mma.cuh:deal_items); lane (g, t) of item j
  // holds `unit` for tile rows 8 (nt0 + j) + 2t + i
  const ItemDeal deal = deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni, dh_rank = deal.dh_rank;
  const int unit = unit0 + 8 * ug + g;
  const uint4* wa = group_frags(ug);
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

  // h_prev of the gates at step s (hs[s - 1]) into hb, asynchronously
  auto fetch_h = [&](int s) {
    const float* src = a.hs + (((size_t)(s - 1) * D + d) * B + tr.row0) * H;
    const int HC = H / 4;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const bool real = rl < tr.nrows;
      cp_async16(hb_u32 + (uint32_t)((rl * KS + 4 * cc) * 4),
                 real ? src + (size_t)rl * H + 4 * cc : a.hs, real);
    }
    cp_async_commit();
  };

  // step s's cell operands: xg into the accumulators, c_prev, dhs, the mask
  float acc[GI][2][4], cpv[GI][2], dyv[GI][2];
  bool vv[GI][2];
  auto load_step = [&](int s) {
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
        acc[j][0][i] = real ? __ldcs(src) : 0.0f;
        acc[j][0][2 + i] = real ? __ldcs(src + H) : 0.0f;
        acc[j][1][i] = real ? __ldcs(src + 2 * H) : 0.0f;
        acc[j][1][2 + i] = real ? __ldcs(src + 3 * H) : 0.0f;
        cpv[j][i] = (real && s > 0) ? __ldcs(a.cs + (pbase + r) * H + unit) : 0.0f;
        dyv[j][i] = (real && a.dhs) ? __ldcs(a.dhs + (base + r) * H + unit) : 0.0f;
        vv[j][i] = real && __ldg(a.valid + base + r) != 0;
      }
    }
  };

  // The gate product of the warp's items over K = H (H / 16 k16 chunks),
  // three tf32 passes: A from the group's fragments through P slots
  // (gate_prefetch fills them with chunks 0 .. P-1, each is refilled P
  // chunks ahead after its use), B from the h_prev tile.
  uint4 ra[P][2][2];  // [slot][kh][mt]
  const int K16 = H / 16;
  auto gate_prefetch = [&]() {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < K16) chunk(ra[i], wa, i);
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
        if (c + P < K16) chunk(ra[i], wa, c + P);
      }
    }
  };

  // The dh product of one step: for each m16 tile m = dh_rank + 8 j of the
  // units, c (units x tile rows) = sum over the block's gate columns, A the
  // gate fragments of local group ug at chunk m transposed in registers
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
    const int j = it / UG, q = it - j * UG;
    chunk(r, group_frags(q), dh_rank + kWarps * j);
  };
  auto dh_prefetch = [&]() {
    if (nit > 0) dh_load(rf[0], 0);
    if (nit > 1) dh_load(rf[1], 1);
  };
  const float* dg_lane = dg_s + g * DS + 4 * t;
  auto dh_use = [&](const uint4 (&r)[2][2], int q, float (&c)[NT][4]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float4 bv[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        bv[n] = *reinterpret_cast<const float4*>(dg_lane + 8 * n * DS + 32 * q + 16 * mt);
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
        const int j = it / UG, q = it - j * UG;
        dh_use(rf[sl], q, c);
        if (it + 2 < nit) dh_load(rf[sl], it + 2);
        if (q == UG - 1) {
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

  // the first step's gates: h_prev = hs[T - 2] (none at T = 1)
  load_step(T - 1);
  if (T > 1) fetch_h(T - 1);
  cp_async_wait<0>();
  __syncthreads();  // hb holds hs[T - 2]; the resident fragments are in
  if (T > 1 && ni > 0) {
    gate_prefetch();
    gate_mma();
  }
  const uint32_t part_u32 = smem_u32(part);

  for (int s = T - 1; s >= 0; --s) {
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
    if (s > 0) dh_prefetch();  // this step's dh product's first weight fragments

    // the cell: lane (g, t) holds the four gates of `unit` for rows 2t, 2t + 1
    // of n8 tile nt0 + j
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
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
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_w[rl * DS + 16 * (q >> 1) + 2 * (q & 1)] = g4[q];
      }
    }
    if (s == 0) break;  // the last step's dh is dead
    __syncthreads();  // the dgates tile is complete; every warp is past this step's gates (hb)
    if (s > 1) fetch_h(s - 1);  // step s - 1's h_prev and cell operands, during the dh product
    load_step(s - 1);
    if (s < T - 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s + 1's
    dh_mma();
    cluster_arrive_release();  // this block's partial of step s is written

    if (s > 1) {  // step 0's gates are its xg alone
      if (ni > 0) gate_prefetch();
      cp_async_wait<0>();
      __syncthreads();  // hb holds hs[s - 2]
      if (ni > 0) gate_mma();
    }
  }
  // every block is done reading this block's partials before it exits
  if (T > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int CL, int BR, int MG, bool RES>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR, CL, RES) || mid_groups(a.H, CL) != MG)
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_recurrence_bwd_mid_f32_kernel<CL, BR, MG, RES>;
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

template <int CL, int MG, bool RES>
int launch_rows(int rows, const Args& a, int D, int tiles, int smem, cudaStream_t st, int* mc) {
  switch (rows) {
    case 16: return launch<CL, 16, MG, RES>(a, D, tiles, smem, st, mc);
    case 32: return launch<CL, 32, MG, RES>(a, D, tiles, smem, st, mc);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instances, as bit masks of H / 32 for each (cluster, resident): the
// 8-block cluster at every width, with the fragments resident up to 256
// (at 288 they do not fit) and from L2 at every width; the 4-block cluster
// resident at 96-192 (past it a block's share and the tiles do not fit:
// 231,424 B at 192 and 32 rows). Row tiles 16 and 32 each.
constexpr int kResident8 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8);
constexpr int kL2_8 = kResident8 | (1 << 9);
constexpr int kResident4 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6);
constexpr int kRows = (1 << 2) | (1 << 4);  // 16, 32, as bit rows / 8

}  // namespace

extern "C" {

int lstm_recurrence_bwd_mid_f32_threads() { return kThreads; }
int lstm_recurrence_bwd_mid_f32_pad() { return kFPad; }
int lstm_recurrence_bwd_mid_f32_min_h() { return kMinMidH; }
int lstm_recurrence_bwd_mid_f32_max_h() { return kMaxMidH; }
int lstm_recurrence_bwd_mid_f32_rows() { return kRows; }
int lstm_recurrence_bwd_mid_f32_resident8() { return kResident8; }
int lstm_recurrence_bwd_mid_f32_l2_8() { return kL2_8; }
int lstm_recurrence_bwd_mid_f32_resident4() { return kResident4; }

const char* lstm_recurrence_bwd_mid_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `cluster` (4 or 8) is the blocks a
// cluster, `resident` (1 or 0) whether the fragments are copied into
// shared memory, `rows` the row tile (16 or 32), `smem` the dynamic shared
// memory, as ops/lstm_cuda.py:recurrence_mid_f32_smem computes it (refused
// otherwise, and so is a combination with no instance). xg (T, D, B, 4H)
// f32; valid (T, D, B) uint8; wf the f32 weight copy of w (D, G, H, 4H)
// (ops/lstm_cuda.py:recurrence_f32_weights); hs, cs, dhs (T, D, B, H) f32
// (dhs may be null: zero); dhn / dcn (D, B, H) f32 or null (zero); dxg
// (T, D, B, 4H) f32. H % 32 == 0, 96 <= H <= 288, B % G == 0, T >= 1; each
// of the G weight groups (B / G rows) is cut into its own tiles of `rows`
// rows: `tiles` = G * ceil(B / G / rows). With max_clusters non-null,
// nothing is launched: it receives how many clusters the card holds at
// once. Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd_mid_f32(int cluster, int resident, int rows, const void* xg,
                                const void* valid, const void* wf, const void* hs,
                                const void* cs, const void* dhs, const void* dhn,
                                const void* dcn, void* dxg, int D, int T_steps, int B, int H,
                                int G, int tiles, int smem, void* stream, int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinMidH || H > kMaxMidH ||
      (max_clusters == nullptr && T_steps < 1))
    return (int)cudaErrorInvalidValue;
  const int bit = 1 << (H / 32);
  const int mask = cluster == 4 ? (resident ? kResident4 : 0)
                                : cluster == 8 ? (resident ? kResident8 : kL2_8) : 0;
  if (!(mask & bit)) return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.valid = static_cast<const uint8_t*>(valid);
  a.wf = static_cast<const uint4*>(wf);
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
      case 3: return launch_rows<4, 3, true>(rows, a, D, tiles, smem, st, max_clusters);
      case 4: return launch_rows<4, 4, true>(rows, a, D, tiles, smem, st, max_clusters);
      case 5: return launch_rows<4, 5, true>(rows, a, D, tiles, smem, st, max_clusters);
      case 6: return launch_rows<4, 6, true>(rows, a, D, tiles, smem, st, max_clusters);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (resident) {
    switch (mg) {
      case 2: return launch_rows<8, 2, true>(rows, a, D, tiles, smem, st, max_clusters);
      case 3: return launch_rows<8, 3, true>(rows, a, D, tiles, smem, st, max_clusters);
      case 4: return launch_rows<8, 4, true>(rows, a, D, tiles, smem, st, max_clusters);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (mg) {
    case 2: return launch_rows<8, 2, false>(rows, a, D, tiles, smem, st, max_clusters);
    case 3: return launch_rows<8, 3, false>(rows, a, D, tiles, smem, st, max_clusters);
    case 4: return launch_rows<8, 4, false>(rows, a, D, tiles, smem, st, max_clusters);
    case 5: return launch_rows<8, 5, false>(rows, a, D, tiles, smem, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
