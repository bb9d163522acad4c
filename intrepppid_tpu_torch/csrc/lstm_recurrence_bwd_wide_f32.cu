// Backward sweep of the masked LSTM recurrence over precomputed,
// time-major input gates, f32 compute dtype, past 288 units: the
// tensor-core variant in three tf32 passes, hand-written for Hopper
// (sm_90a).
//
// Replaces, like the op's other sweeps (bf16, and the widths up to 288),
// with lstm_recurrence_wgrad.cu after it (the dW sums), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence, for compute dtype float32
// and H = 320 to 1024 (H % 32 == 0; ops/lstm_cuda.py:recurrence_sweep_kernel).
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
//
// What bounds it on an H100: the two products, 16 H^2 flops per row and
// step, in three tf32 passes at 495/3 TFLOP/s (6.1 ms at H = 512, 400 rows,
// T = 300), over the f32 streams (44 H bytes per row and step, 1.6 ms).
// What governs is the serial chain of a step, T times: the dh product, the
// exchange of partial sums within the cluster, the cell, the gate product.
// One tf32 pass keeps ~3 decimal digits, which misses the f32 agreement
// (1e-4 x max(1, max|ref|)) by 3-4 x, so every product is big.big +
// big.small + small.big (split_tf32, bilstm_mma.cuh): about 20 bits.
//
// Design (lstm_recurrence_wide_mma.cuh has the split; the bf16 sweep
// lstm_recurrence_bwd_wide_mma.cu the schedule this kernel keeps;
// lstm_recurrence_wide_f32.cuh the fragment loads, the three-pass products
// and the dh transpose, shared with the f32 forward past 288 and the f32
// lite sweep):
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block,
//     block k owning groups [k n / 8, (k + 1) n / 8) of the n = H / 8 unit
//     groups and their gate columns (5 or 6 a block at H = 352);
//   * both products on mma.sync m16n8k8 tf32, A read from an L2-resident
//     f32 copy of the weights in fragment order (one copy, split into big
//     and small in registers: a mask and a subtraction a value), 16 bytes a
//     lane: [D][G][H / 8 groups][H / 8 k8 steps][2 m16 halves][32 lanes][4]
//     (ops/lstm_cuda.py:recurrence_f32_weights). 4 MB a (d, g) at H = 512:
//     40 MB for the train step's 10, under the card's 50 MB L2, where a
//     copy pre-split into big and small would be 80 MB, past it. The loads
//     carry an L2 evict_last policy, so the streams pass L2 around it;
//   * the K order within each k16 chunk is permuted so that lane (g, t)
//     holds inputs 4t .. 4t + 3 of the chunk (k8 step 2c: 4t, 4t + 1; step
//     2c + 1: 4t + 2, 4t + 3): the gate product's B (the f32 h_prev tile)
//     is one 16-byte shared load a chunk and n8 tile, and each 8x8 block of
//     a fragment holds a row's two inputs 2t', 2t' + 1 in one lane, which
//     is the layout movmatrix transposes. The dh product needs the same
//     weights transposed (units as rows, gate columns as K): each 8x8 f32
//     block is transposed in registers as two b16 halves (two movmatrix and
//     four byte permutes), so one copy serves both products. The block's
//     dgates tile is stored with its gate columns in the matching order
//     (one 16-byte shared load per m16 half and n8 tile);
//   * the gate recompute needs no dh: step s - 1's product runs at the end
//     of step s, after the block publishes its partial; its h_prev tile
//     (f32, one buffer) is copied (cp.async) during the dh product. Its xg
//     goes straight into the accumulators; all three passes accumulate in
//     one f32 accumulator;
//   * each product's first weight fragments are loaded before the work
//     that precedes it (the dh product's before the cell, two items of one
//     m16 tile of units and group in flight; the gates' after the partial
//     is published, two k16 chunks in flight);
//   * the owner of a unit sums the 8 partials in rank order through
//     distributed shared memory (32-bit `mapa` addresses), so the result
//     does not depend on timing. One partial buffer: a block writes step
//     s's only after every block has read step s + 1's (a second cluster
//     barrier a step, arrived at right after the read, waited on after the
//     cell);
//   * the cell uses ex2 / rcp (bilstm_mma.cuh);
//   * row tiles BR in {16, 32} up to H = 512 and {16} past it (two groups a
//     warp), each weight group cut into its own tiles; ops/lstm_cuda.py
//     picks the fewest waves, then the smallest tile (a step's cost grows
//     with its rows). At H = 512 the 32-row block takes 184,320 B, and an
//     H100 holds 15 such clusters at once (cudaOccupancyMaxActiveClusters):
//     the train step's 30 (400 rows in 5 groups, D = 2) run in two waves.
// Widths: H % 32 == 0 from 320 to kRecMaxH = 1024 (past 512 the weight
// copies of the train step's 5 groups no longer stay in L2: HBM's rate).

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_f32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;

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

// Dynamic shared memory of the <BR> instance at H (bytes), in layout order:
// the f32 h_prev tile, the block's f32 dgates tile (32 gate columns a
// group) and the f32 partial dh of all H units.
__host__ __device__ constexpr int smem_h(int H, int BR) { return BR * (H + kFPad) * 4; }
__host__ __device__ constexpr int smem_dg(int H, int BR) {
  return BR * (32 * max_block_groups(H) + kFPad) * 4;
}
__host__ __device__ constexpr int smem_part(int H, int BR) { return H * part_stride_f32(BR) * 4; }
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_h(H, BR) + smem_dg(H, BR) + smem_part(H, BR);
}

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, kThreads threads.
template <int BR, int MUG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_bwd_wide_f32_kernel(const Args a) {
  constexpr int NT = BR / 8;
  constexpr int P = kGateChunks;
  constexpr int MTW = 4 * MUG;  // m16 tiles of units a warp owns in the dh product
  constexpr int PS = part_stride_f32(BR);
  static_assert(BR % 8 == 0 && MUG >= 1 && MUG <= kMaxGroups, "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  int glo, ghi;
  unit_groups(H, rank, glo, ghi);
  const int UGk = ghi - glo;
  const int KS = H + kFPad, DS = 32 * max_block_groups(H) + kFPad;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hb = reinterpret_cast<float*>(smem);                    // [BR][KS]
  float* dg_s = hb + BR * KS;                                    // [BR][DS], columns permuted
  float* part = reinterpret_cast<float*>(smem + smem_h(H, BR) + smem_dg(H, BR));  // [H][PS]
  const uint32_t smem0 = smem_u32(smem);

  // gate items: this warp's groups (local w + 8 j, global glo + w + 8 j);
  // lane (g, t) holds unit 8 (glo + w + 8 j) + g for tile rows 8 nt + 2t + i
  const int nug = warp < UGk ? min(MUG, (UGk - warp + kWarps - 1) / kWarps) : 0;
  const uint64_t pol = evict_last_policy();
  const uint4* wdg = a.wf + (size_t)(d * a.G + tr.group) * (H / 8) * (H / 8) * 64 + lane;
  const uint4* wa[MUG];
  int unit[MUG];
#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    const int ugg = glo + warp + kWarps * j;
    wa[j] = wdg + (size_t)ugg * (H / 8) * 64;
    unit[j] = 8 * ugg + g;
  }
  // dh items: this warp's m16 tiles of units warp + 8 j (j < nmt), each over
  // the block's UGk groups
  const int nmt = H / 16 > warp ? min(MTW, (H / 16 - warp + kWarps - 1) / kWarps) : 0;
  const int nit = nmt * UGk;

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

  // h_prev of the gates at step s (hs[s - 1]) into hb, asynchronously
  auto fetch_h = [&](int s) {
    const float* src = a.hs + (((size_t)(s - 1) * D + d) * B + tr.row0) * H;
    const int HC = H / 4;
    for (int idx = tid; idx < BR * HC; idx += kThreads) {
      const int rl = idx / HC, cc = idx - rl * HC;
      const bool real = rl < tr.nrows;
      cp_async16(smem0 + (uint32_t)((rl * KS + 4 * cc) * 4),
                 real ? src + (size_t)rl * H + 4 * cc : a.hs, real);
    }
    cp_async_commit();
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

  const float* hb_lane = hb + g * KS + 4 * t;
  const float* dg_lane = dg_s + g * DS + 4 * t;

  // The dh product of one step: for each m16 tile m = warp + 8 j of the
  // units, c (units x tile rows) = sum over the block's gate columns; A the
  // gate fragments (group glo + ug, k8 steps 2m and 2m + 1, both m16 halves)
  // transposed 8x8 block by 8x8 block in registers (an f32 block as its two
  // b16 halves through movmatrix): row g of the result is unit
  // 16m + 4(g >> 1) + (g & 1), row g + 8 the unit two further, and K slot
  // t (t + 4) gate column 16 mt + 8 hi + 2t (+ 1) of the group, which is
  // where the cell stored it in the dgates tile. An item is one (m16 tile,
  // group): four fragments; two items are in flight in rf (dh_prefetch
  // fills them with items 0 and 1 before the cell, each is refilled two
  // items ahead). Each tile's sums go to the partial buffer once its last
  // group is in.
  uint4 rf[2][2][2];  // [slot][kh][mt]
  auto dh_load = [&](uint4 (&r)[2][2], int it) {
    const int j = it / UGk, ug = it - j * UGk;
    chunk_load(r, wdg + (size_t)(glo + ug) * (H / 8) * 64, warp + kWarps * j, pol);
  };
  auto dh_prefetch = [&]() {
    if (nit > 0) dh_load(rf[0], 0);
    if (nit > 1) dh_load(rf[1], 1);
  };
  auto dh_use = [&](const uint4 (&r)[2][2], int ug, float (&c)[NT][4]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float4 bv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        bv[nt] = *reinterpret_cast<const float4*>(dg_lane + 8 * nt * DS + 32 * ug + 16 * mt);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t ab[4], as[4];
        dh_fragment(r[0][mt], r[1][mt], hi, ab, as);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0, b1, s0, s1;
          split_tf32(hi ? bv[nt].z : bv[nt].x, b0, s0);
          split_tf32(hi ? bv[nt].w : bv[nt].y, b1, s1);
          mma3(c[nt], ab, as, b0, b1, s0, s1);
        }
      }
    }
  };
  auto dh_mma = [&]() {
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) c[nt][v] = 0.0f;
#pragma unroll 1
    for (int it0 = 0; it0 < nit; it0 += 2) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int it = it0 + sl;
        if (it >= nit) continue;
        const int j = it / UGk, ug = it - j * UGk;
        dh_use(rf[sl], ug, c);
        if (it + 2 < nit) dh_load(rf[sl], it + 2);
        if (ug == UGk - 1) {
          const int u = 16 * (warp + kWarps * j) + 4 * (g >> 1) + (g & 1);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            *reinterpret_cast<float2*>(part + u * PS + 8 * nt + 2 * t) =
                make_float2(c[nt][0], c[nt][1]);
            *reinterpret_cast<float2*>(part + (u + 2) * PS + 8 * nt + 2 * t) =
                make_float2(c[nt][2], c[nt][3]);
#pragma unroll
            for (int v = 0; v < 4; ++v) c[nt][v] = 0.0f;
          }
        }
      }
    }
  };

  // the first step's gates: h_prev = hs[T - 2] (none at T = 1)
  uint4 ra[P][MUG][2][2];  // the gate product's weight fragments in flight
  load_step(T - 1);
  if (T > 1) {
    fetch_h(T - 1);
    gate_prefetch_f32<MUG, P>(ra, wa, nug, H / 16, pol);
    cp_async_wait<0>();
    __syncthreads();
    if (nug > 0) gate_mma_f32<MUG, NT, P>(acc, ra, wa, nug, hb_lane, KS, H / 16, pol);
  }
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
      // gate q of the group's unit g sits at column 16 (q >> 1) + 4 (g >> 1)
      // + 2 (q & 1) + (g & 1) of its 32 (the dh product's K order)
      float* dg_w = dg_s + 32 * (warp + kWarps * j) + 4 * (g >> 1) + (g & 1);
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
          for (int q = 0; q < 4; ++q) dg_w[rl * DS + 16 * (q >> 1) + 2 * (q & 1)] = g4[q];
        }
    }
    if (s == 0) break;
    __syncthreads();  // the dgates tile is complete; every warp is past step s's gates (hb)
    if (s > 1) fetch_h(s - 1);  // step s - 1's h_prev, during the dh product
    if (s < T - 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // all read s + 1's
    dh_mma();
    cluster_arrive_release();  // this block's partial of step s is written

    load_step(s - 1);
    if (s > 1) {  // step 0's gates are its xg alone
      gate_prefetch_f32<MUG, P>(ra, wa, nug, H / 16, pol);
      cp_async_wait<0>();
      __syncthreads();  // hb holds hs[s - 2]
      if (nug > 0) gate_mma_f32<MUG, NT, P>(acc, ra, wa, nug, hb_lane, KS, H / 16, pol);
    }
  }
  // every block is done reading this block's partials before it exits
  if (T > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int BR, int MUG>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide_dirs(lstm_recurrence_bwd_wide_f32_kernel<BR, MUG>, tiles, D, kThreads,
                          smem, stream, max_clusters, a);
}

// The row tiles each weight-group count is instantiated for, as bit BR / 8.
constexpr int kRows1 = (1 << 2) | (1 << 4);  // 16, 32
constexpr int kRows2 = (1 << 2);             // 16

}  // namespace

extern "C" {

int lstm_recurrence_bwd_wide_f32_cluster() { return kWideCluster; }
int lstm_recurrence_bwd_wide_f32_threads() { return kThreads; }
int lstm_recurrence_bwd_wide_f32_pad() { return kFPad; }
int lstm_recurrence_bwd_wide_f32_min_h() { return kMinH; }
int lstm_recurrence_bwd_wide_f32_max_h() { return kRecMaxH; }
int lstm_recurrence_bwd_wide_f32_rows1() { return kRows1; }
int lstm_recurrence_bwd_wide_f32_rows2() { return kRows2; }

const char* lstm_recurrence_bwd_wide_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `rows` is the row tile (16 or 32 up to
// H = 512, 16 past it) and `smem` its dynamic shared memory, as
// ops/lstm_cuda.py:recurrence_wide_f32_smem computes it (refused
// otherwise). xg (T, D, B, 4H) f32; valid (T, D, B) uint8; wf the f32
// weight copy of w (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_f32_weights);
// hs, cs, dhs (T, D, B, H) f32 (dhs may be null: zero); dhn / dcn (D, B, H)
// f32 or null (zero); dxg (T, D, B, 4H) f32. H % 32 == 0, 320 <= H <= 1024,
// B % G == 0; each of the G weight groups (B / G rows) is cut into its own
// tiles of `rows` rows: `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd_wide_f32(int rows, const void* xg, const void* valid, const void* wf,
                                 const void* hs, const void* cs, const void* dhs,
                                 const void* dhn, const void* dcn, void* dxg, int D,
                                 int T_steps, int B, int H, int G, int tiles, int smem,
                                 void* stream, int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinH || H > kRecMaxH)
    return (int)cudaErrorInvalidValue;
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
