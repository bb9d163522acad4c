// Backward sweep of the masked LSTM recurrence over precomputed,
// time-major input gates, bf16 compute dtype, past 288 units: the
// tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like the op's other sweeps (f32, and the widths up to 288),
// with lstm_recurrence_wgrad_mma.cu after it (the dW sums), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence, for compute dtype bfloat16
// and H = 320 to 1024 (H % 32 == 0; ops/lstm_cuda.py:recurrence_sweep_kernel).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_sweep): block
// (row tile, direction d) walks s = T-1 .. 0 carrying dh and dc (f32, from
// dhn / dcn). Per step and row r:
//   * gates = xg[s, d, r] + round_bf16(h_prev) @ w[d, g], h_prev = hs[s-1, d, r]
//     and c_prev = cs[s-1, d, r] (both f32, zero at s = 0; c_prev is used
//     unrounded); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates (f32) by the rules of lstm_pallas.py:210-228: a step with
//     valid[s, d, r] == 0 (the mask is data and may have holes: every step
//     is computed) gets dgates = 0 and passes dh and dc through;
//     dxg[s, d, r] = dgates, unrounded;
//   * dh = round_bf16(dgates) @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
//
// What bounds it on an H100: the bytes (xg, hs, cs, dhs in, dxg out: about
// 44 H bytes per row and step, 1.6 ms at H = 512, 400 rows, T = 300); the
// two products (16 H^2 flops per row and step) are under that on the
// tensor cores. What governs is the serial chain of a step, T times: the
// dh product, the exchange of partial sums within the cluster, the cell.
//
// Design (lstm_recurrence_wide_mma.cuh has the split and the weight copy):
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block,
//     block k owning H / 64 groups of 8 units and their gate columns, as in
//     lstm_recurrence_fwd_wide_mma.cu;
//   * both products on mma.sync m16n8k16, A read from the L2-resident bf16
//     weight copy straight into registers, once a step for the whole tile:
//     the gate recompute (permuted gate rows of the warp's groups x h_prev^T)
//     is the forward's product; the partial dh = w_slice^T . round(dgates)^T
//     over all H units from the block's own gate columns takes the same
//     fragments transposed in registers (movmatrix), warp w owning m16 tiles
//     w, w + 8, .. of the units, B the block's bf16 dgates tile through
//     ldmatrix;
//   * the gate recompute needs no dh: step s - 1's runs right after step s's
//     partial is published, between the barrier's arrive and its wait;
//     its h_prev tile is copied (cp.async, f32) a step ahead and rounded to
//     bf16 in shared memory after step s's cell, under the barrier the dh
//     product needs anyway; its xg goes straight into the accumulators
//     (sums: xg, then the products in k order);
//   * each product's first weight fragments are loaded before the work
//     that precedes it (the dh product's before the cell, the gates' before
//     the partial's publication), so their latency hides;
//   * the owner of a unit sums the 8 partials in rank order through
//     distributed shared memory (32-bit cluster addresses mapped each step:
//     `mapa`), so the result does not depend on timing.
//     The partial buffer (H x the row tile, f32: 80 KB at H = 512 and 32
//     rows) is single: a block writes step s's only after every block has
//     read step s + 1's (a second barrier a step, its wait after the cell
//     and the dh product, so it overlaps them);
//   * the cell uses ex2 / rcp (bilstm_mma.cuh);
//   * row tiles BR in {16, 32} up to H = 512 and {16} past it, each weight
//     group cut into its own tiles; ops/lstm_cuda.py picks the fewest waves,
//     then the smallest tile (a step's cost grows with its rows). Shared
//     memory would take 40 rows at H = 512 and 48 at 320, but those
//     instances spill and ran slower than 32 rows at every width tried.
// Widths: H % 32 == 0 from 320 to kRecMaxH = 1024 (past 512 two groups a
// warp, whose weight blocks no longer stay in L2 at the train step's 5
// groups: HBM's rate).

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;
typedef __nv_bfloat16 bf16;

struct Args {
  const float* xg;       // (T, D, B, 4H)
  const uint8_t* valid;  // (T, D, B)
  const uint4* wg;       // the weight copy (lstm_recurrence_wide_mma.cuh)
  const float* hs;       // (T, D, B, H)
  const float* cs;
  const float* dhs;  // (T, D, B, H) or null (zero)
  const float* dhn;  // (D, B, H) or null (zero)
  const float* dcn;
  float* dxg;  // (T, D, B, 4H)
  int T, B, H, G;
};

// Row stride (f32) of the partial dh buffer: at least BR and 8 mod 16, so
// the float2 writes and reads of a half warp (8 units x 4 row pairs) are
// conflict-free.
__host__ __device__ constexpr int part_stride(int BR) { return BR + ((8 - BR) % 16 + 16) % 16; }

// Dynamic shared memory of the <BR> instance at H (bytes), in layout order:
// the f32 h_prev tile, its bf16 rounding, the block's bf16 dgates tile and
// the f32 partial dh of all H units.
__host__ __device__ constexpr int smem_hf(int H, int BR) { return BR * H * 4; }
__host__ __device__ constexpr int smem_hb(int H, int BR) { return BR * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_dg(int H, int BR) {
  return BR * (32 * max_block_groups(H) + kPad) * 2;
}
__host__ __device__ constexpr int smem_part(int H, int BR) { return H * part_stride(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_hf(H, BR) + smem_hb(H, BR) + smem_dg(H, BR) + smem_part(H, BR);
}

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, kThreads threads.
template <int BR, int MUG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_bwd_wide_mma_kernel(const Args a) {
  constexpr int NT = BR / 8;
  constexpr int P = kGateInFlight;
  constexpr int MTW = 4 * MUG;         // m16 tiles of units a warp owns in the dh product
  constexpr int HALVES = MTW / 4;      // dh items a k32 step: 4 m16 tiles each
  constexpr int PS = part_stride(BR);
  static_assert(BR % 8 == 0 && MUG >= 1 && MUG <= kMaxGroups, "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  int glo, ghi;
  unit_groups(H, rank, glo, ghi);
  const int UGk = ghi - glo;
  const int KS = H + kPad, DS = 32 * max_block_groups(H) + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hf = reinterpret_cast<float*>(smem);                              // [BR][H]
  bf16* hb = reinterpret_cast<bf16*>(smem + smem_hf(H, BR));               // [BR][KS]
  bf16* dg_s = hb + BR * KS;                                               // [BR][DS]
  float* part = reinterpret_cast<float*>(smem + smem_hf(H, BR) + smem_hb(H, BR) +
                                         smem_dg(H, BR));                  // [H][PS]
  const uint32_t smem0 = smem_u32(smem);

  // gate items: this warp's groups (local w + 8 j, global glo + w + 8 j);
  // lane (g, t) holds unit 8 (glo + w + 8 j) + g for tile rows 8 nt + 2t + i
  const int nug = warp < UGk ? min(MUG, (UGk - warp + kWarps - 1) / kWarps) : 0;
  const uint64_t pol = evict_last_policy();
  const uint4* wdg = a.wg + (size_t)(d * a.G + tr.group) * (H / 8) * (H / 16) * 64 + lane;
  const uint4* wa[MUG];
  int unit[MUG];
#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    const int ugg = glo + warp + kWarps * j;
    wa[j] = wdg + (size_t)ugg * (H / 16) * 64;
    unit[j] = 8 * ugg + g;
  }
  // dh items: this warp's m16 tiles of units, warp + 8 j
  const int nmt = H / 16 > warp ? min(MTW, (H / 16 - warp + kWarps - 1) / kWarps) : 0;

  float dh[MUG][NT][2], dc[MUG][NT][2];
#pragma unroll
  for (int j = 0; j < MUG; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * nt + 2 * t + i;
        const bool real = j < nug && rl < tr.nrows;
        const size_t at = ((size_t)d * B + tr.row0 + (real ? rl : 0)) * H + (real ? unit[j] : 0);
        dh[j][nt][i] = (real && a.dhn) ? a.dhn[at] : 0.0f;
        dc[j][nt][i] = (real && a.dcn) ? a.dcn[at] : 0.0f;
      }

  // h_prev of the gates at step s (hs[s - 1]) into hf, asynchronously
  auto fetch_h = [&](int s) {
    const float* src = a.hs + (((size_t)(s - 1) * D + d) * B + tr.row0) * H;
    const int HC = H / 4;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const bool real = rl < tr.nrows;
      cp_async16(smem0 + (uint32_t)((rl * H + 4 * cc) * 4),
                 real ? src + (size_t)rl * H + 4 * cc : a.hs, real);
    }
    cp_async_commit();
  };
  // hf rounded to bf16 into hb (zero: the gates of step 0)
  auto round_h = [&](bool zero) {
    const int HC = H / 8;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!zero) {
        const float4 x = *reinterpret_cast<const float4*>(hf + rl * H + 8 * cc);
        const float4 y = *reinterpret_cast<const float4*>(hf + rl * H + 8 * cc + 4);
        v = make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w), pack_bf16x2(y.x, y.y),
                       pack_bf16x2(y.z, y.w));
      }
      *reinterpret_cast<uint4*>(hb + rl * KS + 8 * cc) = v;
    }
  };

  // step s's cell operands: xg into the accumulators, c_prev, dhs, the mask
  float acc[MUG][NT][2][4], cpv[MUG][NT][2], dyv[MUG][NT][2];
  uint8_t vv[NT][2];
  auto load_step = [&](int s) {
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
    const size_t pbase = ((size_t)(s - 1) * D + d) * B + tr.row0;  // used only when s > 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * nt + 2 * t + i;
        const bool real = rl < tr.nrows;
        vv[nt][i] = real ? __ldg(a.valid + base + rl) : (uint8_t)0;
#pragma unroll
        for (int j = 0; j < MUG; ++j) {
          if (j >= nug) continue;
          const float* src = a.xg + (base + rl) * H4 + unit[j];
          acc[j][nt][0][i] = real ? __ldcs(src) : 0.0f;
          acc[j][nt][0][2 + i] = real ? __ldcs(src + H) : 0.0f;
          acc[j][nt][1][i] = real ? __ldcs(src + 2 * H) : 0.0f;
          acc[j][nt][1][2 + i] = real ? __ldcs(src + 3 * H) : 0.0f;
          cpv[j][nt][i] = (real && s > 0) ? __ldcs(a.cs + (pbase + rl) * H + unit[j]) : 0.0f;
          dyv[j][nt][i] = (real && a.dhs) ? __ldcs(a.dhs + (base + rl) * H + unit[j]) : 0.0f;
        }
      }
  };

  const uint32_t b_gate = smem0 + (uint32_t)(smem_hf(H, BR) + (lr * KS + 8 * lm) * 2);
  const uint32_t b_dh = smem_u32(dg_s) + (uint32_t)((lr * DS + 8 * lm) * 2);

  // the dh product of one step: c[j][nt] (units 16 (warp + 8 j) + g (+ 8),
  // tile rows 8 nt + 2t (+ 1)) = sum over the block's gate columns; A the
  // gate fragments (group glo + ug, kk = the m16 tile, both halves mt)
  // transposed in registers. An item is a k32 step (one group) for 4 m16
  // tiles; two items are in flight in ra2 (dh_prefetch fills them with
  // items 0 and 1 before the cell, each is refilled two items ahead).
  constexpr int STEP = 2 / HALVES;  // k32 steps a round of the two slots
  float cacc[MTW][NT][4];
  uint4 ra2[2][4][2];  // [slot][m16 tile of the item][mt]
  auto dh_load = [&](uint4 (&r)[4][2], int ug, int half) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * half + jj;
      if (j >= nmt) continue;
      const uint4* p = wdg + ((size_t)(glo + ug) * (H / 16) + warp + kWarps * j) * 64;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) r[jj][mt] = ldg_weight(p + 32 * mt, pol);
    }
  };
  auto dh_prefetch = [&]() {
#pragma unroll
    for (int it = 0; it < 2; ++it)
      if (it / HALVES < UGk) dh_load(ra2[it], it / HALVES, it % HALVES);
  };
  auto dh_mma = [&]() {
#pragma unroll
    for (int j = 0; j < MTW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) cacc[j][nt][v] = 0.0f;
    if (nmt == 0) return;
#pragma unroll 1
    for (int ug0 = 0; ug0 < UGk; ug0 += STEP) {
#pragma unroll
      for (int uu = 0; uu < STEP; ++uu) {
        const int ug = ug0 + uu;
        if (ug >= UGk) continue;
        uint32_t b[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldmatrix_x4(b[nt], b_dh + (uint32_t)((8 * nt * DS + 32 * ug) * 2));
#pragma unroll
        for (int half = 0; half < HALVES; ++half) {
          const int slot = uu * HALVES + half;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * half + jj;
            if (j >= nmt) continue;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const uint4 f = ra2[slot][jj][mt];
              // rows: units of the m16 tile; columns: gate rows 16 mt .. of group ug
              const uint4 at = make_uint4(movmatrix_trans(f.x), movmatrix_trans(f.z),
                                          movmatrix_trans(f.y), movmatrix_trans(f.w));
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_a4(cacc[j][nt], at, b[nt][2 * mt], b[nt][2 * mt + 1]);
            }
          }
          const int nit = ug * HALVES + half + 2;
          if (nit / HALVES < UGk) dh_load(ra2[slot], nit / HALVES, half);
        }
      }
    }
  };

  // the first step's gates: h_prev = hs[T - 2]
  uint4 ra[P][MUG][4];  // the gate product's weight fragments in flight
  gate_prefetch<MUG, P>(ra, wa, nug, H / 32, pol);
  if (T > 1) {
    fetch_h(T - 1);
    cp_async_wait<0>();
    __syncthreads();
  }
  round_h(T == 1);
  __syncthreads();  // hb holds step T - 1's h_prev; hf is free
  if (T > 2) fetch_h(T - 2);
  load_step(T - 1);
  if (nug > 0) gate_mma<MUG, NT, P>(acc, ra, wa, nug, b_gate, KS, H / 32, pol);
  const uint32_t part_u32 = smem_u32(part);

  for (int s = T - 1; s >= 0; --s) {
    if (s < T - 1) {
      // dh of this step: the 8 partials of step s + 1, in rank order
      cluster_wait_acquire();
      uint32_t rank_base[kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) rank_base[k] = mapa_u32(part_u32, k);
#pragma unroll
      for (int j = 0; j < MUG; ++j) {
        if (j >= nug) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t off = (uint32_t)((unit[j] * PS + 8 * nt + 2 * t) * 4);
          float2 p[kWideCluster];
#pragma unroll
          for (int k = 0; k < kWideCluster; ++k) p[k] = ld_dsmem_f2(rank_base[k] + off);
          float s0 = p[0].x, s1 = p[0].y;
#pragma unroll
          for (int k = 1; k < kWideCluster; ++k) {
            s0 += p[k].x;
            s1 += p[k].y;
          }
          dh[j][nt][0] = s0 + dh[j][nt][0];  // dh holds what the masked rows passed through
          dh[j][nt][1] = s1 + dh[j][nt][1];
        }
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");  // done reading
    }
    if (s > 0) dh_prefetch();  // this step's dh product's first weight fragments

    // the cell: lane (g, t) holds the four gates of its unit for rows 2t, 2t + 1
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
#pragma unroll
    for (int j = 0; j < MUG; ++j) {
      if (j >= nug) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = 8 * nt + 2 * t + i;
          const float ig = fast_sigmoid(acc[j][nt][0][i]);
          const float fg = fast_sigmoid(acc[j][nt][0][2 + i]);
          const float gg = fast_tanh(acc[j][nt][1][i]);
          const float og = fast_sigmoid(acc[j][nt][1][2 + i]);
          const float cprev = cpv[j][nt][i];
          const float c_new = fg * cprev + ig * gg;
          const float dht = dh[j][nt][i] + dyv[j][nt][i];
          const float tc = fast_tanh(c_new);
          const float dct = dc[j][nt][i] + dht * og * (1.0f - tc * tc);
          const bool m = vv[nt][i] != 0;
          float g4[4];
          g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
          g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
          g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
          g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
          dc[j][nt][i] = m ? dct * fg : dc[j][nt][i];
          dh[j][nt][i] = m ? 0.0f : dht;  // passed through to the next step where masked
          if (rl < tr.nrows) {
            float* dst = a.dxg + (base + rl) * H4 + unit[j];
#pragma unroll
            for (int q = 0; q < 4; ++q) __stcs(dst + q * H, g4[q]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dg_s[rl * DS + 32 * (warp + kWarps * j) + 8 * q + g] = __float2bfloat16_rn(g4[q]);
        }
    }
    if (s == 0) break;
    // step s - 1's h_prev (hs[s - 2], fetched a step ahead), rounded: hb is
    // free since step s's gates
    cp_async_wait<0>();
    __syncthreads();  // hf landed for every thread's copies
    round_h(s == 1);
    __syncthreads();  // the dgates tile and hb are complete; hf is free
    if (s > 2) fetch_h(s - 2);

    dh_mma();
    gate_prefetch<MUG, P>(ra, wa, nug, H / 32, pol);  // step s - 1's gates
    if (s < T - 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s + 1's
#pragma unroll
    for (int j = 0; j < MTW; ++j) {
      if (j >= nmt) continue;
      const int u = 16 * (warp + kWarps * j) + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(part + u * PS + 8 * nt + 2 * t) =
            make_float2(cacc[j][nt][0], cacc[j][nt][1]);
        *reinterpret_cast<float2*>(part + (u + 8) * PS + 8 * nt + 2 * t) =
            make_float2(cacc[j][nt][2], cacc[j][nt][3]);
      }
    }
    cluster_arrive_release();  // this block's partial of step s is written

    load_step(s - 1);
    if (nug > 0) gate_mma<MUG, NT, P>(acc, ra, wa, nug, b_gate, KS, H / 32, pol);
  }
  // every block is done reading this block's partials before it exits
  if (T > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int BR, int MUG>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide_dirs(lstm_recurrence_bwd_wide_mma_kernel<BR, MUG>, tiles, D, kThreads,
                          smem, stream, max_clusters, a);
}

// The row tiles each weight-group count is instantiated for, as bit BR / 8.
constexpr int kRows1 = (1 << 2) | (1 << 4);  // 16, 32
constexpr int kRows2 = (1 << 2);             // 16

}  // namespace

extern "C" {

int lstm_recurrence_bwd_wide_mma_cluster() { return kWideCluster; }
int lstm_recurrence_bwd_wide_mma_threads() { return kThreads; }
int lstm_recurrence_bwd_wide_mma_pad() { return kPad; }
int lstm_recurrence_bwd_wide_mma_min_h() { return kMinH; }
int lstm_recurrence_bwd_wide_mma_max_h() { return kRecMaxH; }
int lstm_recurrence_bwd_wide_mma_rows1() { return kRows1; }
int lstm_recurrence_bwd_wide_mma_rows2() { return kRows2; }

const char* lstm_recurrence_bwd_wide_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `rows` is the row tile (16 or 32 up to
// H = 512, 16 past it) and `smem` its dynamic shared memory, as
// ops/lstm_cuda.py:recurrence_wide_mma_smem("bwd", ...) computes it
// (refused otherwise). xg (T, D, B, 4H) f32; valid (T, D, B) uint8; wg the
// weight copy of w (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_mma_weights);
// hs, cs, dhs (T, D, B, H) f32 (dhs may be null: zero); dhn / dcn (D, B, H)
// f32 or null (zero); dxg (T, D, B, 4H) f32. H % 32 == 0, 320 <= H <= 1024,
// B % G == 0; `tiles` as for lstm_recurrence_fwd_wide_mma. With
// max_clusters non-null, nothing is launched (see
// lstm_recurrence_fwd_wide_mma). Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd_wide_mma(int rows, const void* xg, const void* valid, const void* wg,
                                 const void* hs, const void* cs, const void* dhs,
                                 const void* dhn, const void* dcn, void* dxg, int D,
                                 int T_steps, int B, int H, int G, int tiles, int smem,
                                 void* stream, int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinH || H > kRecMaxH)
    return (int)cudaErrorInvalidValue;
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
  if (warp_groups(H) == 1) {
    switch (rows) {
      case 16: return launch<16, 1>(a, D, tiles, smem, st, max_clusters);
      case 32: return launch<32, 1>(a, D, tiles, smem, st, max_clusters);
      default: break;
    }
  } else if (rows == 16) {
    return launch<16, 2>(a, D, tiles, smem, st, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
