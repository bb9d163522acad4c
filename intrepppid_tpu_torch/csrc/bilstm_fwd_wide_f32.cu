// Bidirectional LSTM layer recurrence over the input gates, f32 compute
// dtype, for layers whose weights fit no block: the tensor-core variant in
// three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_wide.cu (the CUDA-core kernel, which keeps the
// f32 widths this kernel does not take and is reached here by name) and
// bilstm_fwd_wide_mma.cu (bf16), together with bilstm_gates_f32.cu (the
// input projection), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _fwd_kernel (via _fwd_pallas,
//     :376) -- the wide route's recurrence (ops/lstm_cuda.py:layer_route),
//     with_states=False (eval variant, cs null) and True (train variant:
//     also the cell streams), for compute dtype float32 at H = 128, 160,
//     192, 224, 256 and 288 (ops/lstm_cuda.py:wide_fwd_kernel).
//
// Function (the contract of ops/lstm.py:bidir_recurrence with the compute
// dtype f32, where round() is the identity): for each direction d (0
// forward, 1 reverse) and row r, step s reads position pos = s (d = 0) or
// T-1-s (d = 1) and computes
//   gates = h @ W_hh[d, g]^T + xg[d, pos, r]
// (the product from zero, xg added after it; gate order i, f, g, o;
// g = r / (B / G), the row's weight group), then the cell update; the state
// moves iff pos < lengths[r]. Every step writes the (possibly frozen) h to
// hs_f[pos] / hs_b[pos] and, in the train variant, c to cs_f[pos] /
// cs_b[pos]; all f32.
//
// What bounds it on an H100: the product, 8 H^2 flops per row and step, in
// three tf32 passes at 495/3 TFLOP/s (4.8 ms at H = 288, 400 rows, T =
// 1500), over the f32 streams (2.5 ms). What governs is the serial chain of
// a step, T times: the product over the block's weight slice, the cell, and
// the exchange of the new h within the cluster.
//
// Design: bilstm_fwd_wide_mma.cu's schedule with the f32 products of
// lstm_recurrence_wide_f32.cuh (big.big + big.small + small.big on
// mma.sync m16n8k8, both operands split in registers):
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / 8, (k + 1) n / 8) of the n = H / 8 unit
//     groups (lstm_recurrence_wide_mma.cuh:unit_groups): 2 a block at 128,
//     2 or 3 at 160, 3 at 192, 3 or 4 at 224, 4 at 256, 4 or 5 at 288 (the
//     instance for MG = max_block_groups(H) groups takes each width; the
//     slowest block sets the pace through the cluster barrier);
//   * the weights are the f32 fragment copy of W_hh^T that the f32 lite
//     sweep reads (ops/lstm_cuda.py:recurrence_f32_weights of w_hh
//     transposed), read from L2: each fragment once a step for all of a
//     warp's items, with an evict_last policy;
//   * the block's UG x NT (unit group, n8 tile) items, each a unit's four
//     gates for 8 rows in one lane, are dealt over all 8 warps as in
//     bilstm_bwd_lite_f32.cu: each warp's items inside one group, group q
//     getting 8 / UG warps (the first 8 % UG one more), which split its NT
//     tiles, so the cell needs no exchange. A 3-group block deals its
//     warps 3, 3 and 2, so at 32-row tiles no warp takes more than two
//     items (as at 256), and at 16-row tiles one;
//   * the tile's f32 h lives in every block, double-buffered: step s reads
//     buffer s % 2 and pushes the block's new h into buffer (s + 1) % 2 of
//     all 8 blocks through distributed shared memory, 16-byte stores of
//     four units staged first in shared memory, one cluster barrier a step;
//   * the next step's xg is loaded into registers right after the cell, a
//     step ahead of its use, and the next step's first weight fragments
//     during the exchange; hs / cs leave from registers after the arrive;
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32;
//   * a tile stops at its longest row: past it the forward direction writes
//     its frozen state, the reverse direction zeros (its state before its
//     first real step);
//   * row tiles BR of 16 or 32 where every unit group gets two warps or
//     more (MG <= 4: H = 128-256) and of 16 at 288, each weight group cut
//     into its own tiles (ops/lstm_cuda.py:wide_plan("fwd_f32", ...) picks
//     the tile by waves, cudaOccupancyMaxActiveClusters, then the
//     smallest). Shared memory, in
//     bytes: the h tiles 2 BR (H + 16) 4 and the staging BR (8 ceil(H / 64)
//     + 16) 4, which leaves room for two blocks an SM. A 32-row tile at 288
//     gives the 5-group blocks' lone warps 4 items, and a step's time
//     follows a warp's items: one wave of it took 45.8 ms at 400 rows in 5
//     groups, T = 1500, against 36.8 for two waves of 16-row tiles.
//     Weights held in shared memory instead (one block an SM past 128) were
//     slower at 256 and 288 and level at 128 (PERF.md, chip_smoke.py phase
//     widths).
// The eval and train variants run the same code for h: they give the same
// hs bits.

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
  float* hs[2];          // per direction, (T, B, H)
  float* cs[2];          // null: the eval variant
  float* hn;             // (2, B, H)
  float* cn;
  int T, B, H, G;
};

// Dynamic shared memory of an instance (bytes), in layout order: the two
// h tiles, the staged new h of the block.
__host__ __device__ constexpr int smem_h(int H, int BR) { return 2 * BR * (H + kFPad) * 4; }
__host__ __device__ constexpr int stage_stride(int H) { return 8 * max_block_groups(H) + kFPad; }
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return smem_h(H, BR) + BR * stage_stride(H) * 4;
}

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, kThreads
// threads, two blocks an SM; MG = max_block_groups(H), H one of the widths
// MG stands for.
template <int H, int BR>
__global__ void __launch_bounds__(kThreads, 2) bilstm_fwd_wide_f32_kernel(const Args a) {
  constexpr int MG = max_block_groups(H);
  constexpr int NT = BR / 8;                // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;          // fewest warps a unit group gets
  constexpr int GI = (NT + WPG - 1) / WPG;  // most items a warp takes
  constexpr int P = kGateChunks;            // k16 chunks of fragments in flight
  constexpr int K16 = H / 16;
  constexpr int KS = H + kFPad;             // h row stride (f32)
  constexpr int SS = stage_stride(H);       // staging row stride (f32)
  constexpr int GW = (H / 8) * 64;          // uint4 of one group's fragments
  constexpr int ST_AT = smem_h(H, BR);
  // two blocks fit the SM's shared memory (228 KB, 1 KB of it reserved a block)
  static_assert(BR % 8 == 0 && WPG >= 1 && H % 32 == 0 && 2 * (smem_bytes(H, BR) + 1024) <= 233472,
                "shape");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int T = a.T, B = a.B, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TileRows tr = tile_rows(tile, BR, B / a.G);
  int glo, ghi;
  unit_groups(H, rank, glo, ghi);
  const int UG = ghi - glo, unit0 = 8 * glo;
  float* hs = a.hs[d];
  float* cs = a.cs[d];
  const bool train = cs != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);         // [2][BR][KS]: the tile's h
  float* hst = reinterpret_cast<float*>(smem + ST_AT); // [BR][SS]: the block's new h
  const uint4* wblock = a.wf + ((size_t)(d * a.G + tr.group) * (H / 8) + glo) * GW;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = tid; idx < BR * KS / 4; idx += kThreads) reinterpret_cast<float4*>(h_s)[idx] = zero4;

  // the tile's longest row bounds the positions that do any work; every
  // block of the cluster finds the same maxlen, so they take the same barriers
  int maxlen = 0;
  for (int rl = 0; rl < tr.nrows; ++rl) maxlen = max(maxlen, min(a.lengths[tr.row0 + rl], T));

  // items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group ug
  // (group q gets 8 / UG warps, the first 8 % UG groups one more:
  // lstm_recurrence_wide_mma.cuh:deal_items); lane (g, t) of item j holds
  // `unit` for tile rows 8 (nt0 + j) + 2t + i
  const ItemDeal deal = deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni;
  const int unit = unit0 + 8 * ug + g;
  int row[GI][2], len[GI][2];
  float h[GI][2], c[GI][2], xv[GI][2][4];
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 8 * (nt0 + j) + 2 * t + i;
      const bool real = j < ni && rl < tr.nrows;
      row[j][i] = real ? tr.row0 + rl : -1;
      len[j][i] = real ? a.lengths[tr.row0 + rl] : 0;
      h[j][i] = 0.0f;
      c[j][i] = 0.0f;
    }

  // the item's h and c at `pos`, from registers
  auto store_state = [&](int pos) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[j][i] < 0) continue;
        const size_t at = ((size_t)pos * B + row[j][i]) * H + unit;
        __stcs(hs + at, h[j][i]);
        if (train) __stcs(cs + at, c[j][i]);
      }
  };
  // the reverse direction meets positions [maxlen, T) first, with its state still zero
  if (d == 1)
    for (int pos = maxlen; pos < T; ++pos) store_state(pos);

  const float* xgd = a.xg + (size_t)d * T * B * H4;
  // the four gates of the item's unit and rows at `pos`, into registers
  auto load_xg = [&](int pos) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row[j][i];
        const float* src = xgd + ((size_t)pos * B + (r >= 0 ? r : 0)) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[j][i][q] = r >= 0 ? __ldcs(src + q * H) : 0.0f;
      }
  };
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;
  if (maxlen > 0) load_xg(pos0);

  // The gate product of the warp's items over K = H, three tf32 passes: A
  // the group's fragments from L2 through P slots (prefetch fills them with
  // chunks 0 .. P-1, each is refilled P chunks ahead after its use), B the
  // h tile.
  const uint64_t pol = evict_last_policy();
  const uint4* wa = wblock + (size_t)ug * GW + lane;
  uint4 ra[P][2][2];  // [slot][kh][mt]
  auto prefetch = [&]() {
    if (ni > 0)
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (i < K16) chunk_load(ra[i], wa, i, pol);
  };
  const float* h_lane = h_s + g * KS + 4 * t;
  float acc[GI][2][4];
  auto gate_mma = [&](int buf) {
#pragma unroll
    for (int j = 0; j < GI; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.0f;
    if (ni == 0) return;
    const float* hb = h_lane + buf * BR * KS;
#pragma unroll 1
    for (int c0 = 0; c0 < K16; c0 += P) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int cidx = c0 + i;
        if (cidx >= K16) continue;
        // the items' h inputs of the chunk, split where they are used
        float4 hv[GI];
#pragma unroll
        for (int j = 0; j < GI; ++j)
          if (j < ni) hv[j] = *reinterpret_cast<const float4*>(hb + 8 * (nt0 + j) * KS + 16 * cidx);
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
        if (cidx + P < K16) chunk_load(ra[i], wa, cidx + P, pol);
      }
    }
  };

  __syncthreads();  // the zero h tile is in place
  cluster.sync();   // every block of the cluster runs (its shared memory takes pushes)
  prefetch();
  const uint32_t h_u32 = smem_u32(h_s);

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    const int buf = s & 1;
    if (s > 0) cluster_wait_acquire();  // every block's step s - 1 pushes landed
    gate_mma(buf);
    const bool more = s + 1 < maxlen;

    // the cell: lane (g, t) holds the four gates of `unit` for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ig = fast_sigmoid(acc[j][0][i] + xv[j][i][0]);
        const float fg = fast_sigmoid(acc[j][0][2 + i] + xv[j][i][1]);
        const float gg = fast_tanh(acc[j][1][i] + xv[j][i][2]);
        const float og = fast_sigmoid(acc[j][1][2 + i] + xv[j][i][3]);
        const float c_new = fg * c[j][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (pos < len[j][i]) {
          c[j][i] = c_new;
          h[j][i] = h_new;
        }
        hst[(8 * (nt0 + j) + 2 * t + i) * SS + 8 * ug + g] = h[j][i];
      }
    }
    if (more) {
      load_xg(pos + dpos);
      prefetch();  // the next step's first weight fragments
    }
    __syncthreads();  // the block's new h tile is staged

    if (more) {
      // the next step's h tile of every block of the cluster: 16-byte
      // chunks of four units, 2 UG a row
      uint32_t rank_base[kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) rank_base[k] = mapa_u32(h_u32, k);
      const uint32_t next = (uint32_t)((((buf ^ 1) * BR) * KS + unit0) * 4);
      const int CH = 2 * UG;
      for (int idx = tid; idx < BR * CH; idx += kThreads) {
        const int rl = idx / CH, cc = idx - rl * CH;
        const uint4 v = *reinterpret_cast<const uint4*>(hst + rl * SS + 4 * cc);
        const uint32_t off = next + (uint32_t)((rl * KS + 4 * cc) * 4);
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k) st_dsmem_v4(rank_base[k] + off, v);
      }
      cluster_arrive_release();  // this block's pushes of step s are written
    }
    store_state(pos);
  }

  // the forward direction's state is frozen past the tile's longest row
  if (d == 0)
    for (int p = maxlen; p < T; ++p) store_state(p);
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[j][i] < 0) continue;
      const size_t at = ((size_t)d * B + row[j][i]) * H + unit;
      a.hn[at] = h[j][i];
      a.cn[at] = c[j][i];
    }
}

template <int H, int BR>
int launch(const Args& a, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide(bilstm_fwd_wide_f32_kernel<H, BR>, tiles, kThreads, smem, stream,
                     max_clusters, a);
}

// The instances by row tile: 16 and 32 where every unit group gets two
// warps or more (MG <= 4), 16 at H = 288.
template <int H>
int launch_rows(int rows, const Args& a, int tiles, int smem, cudaStream_t st, int* mc) {
  if (rows == 16) return launch<H, 16>(a, tiles, smem, st, mc);
  if constexpr (kWarps / max_block_groups(H) >= 2) {
    if (rows == 32) return launch<H, 32>(a, tiles, smem, st, mc);
  }
  return (int)cudaErrorInvalidValue;
}

// The widths the kernel is instantiated for.
constexpr int kWidths[6] = {128, 160, 192, 224, 256, 288};

}  // namespace

extern "C" {

int bilstm_fwd_wide_f32_cluster() { return kWideCluster; }
int bilstm_fwd_wide_f32_threads() { return kThreads; }
int bilstm_fwd_wide_f32_pad() { return kFPad; }
// the widths as a bit mask of H / 32 (every width is a multiple of 32), and
// the row tiles as masks of rows / 8 in 8-bit fields (MG <= 4 lowest, then
// H = 288)
int bilstm_fwd_wide_f32_widths() {
  int mask = 0;
  for (int h : kWidths) mask |= 1 << (h / 32);
  return mask;
}
int bilstm_fwd_wide_f32_rows() { return 0x14 | (0x04 << 8); }

const char* bilstm_fwd_wide_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `rows` is the row tile (16 or 32 at
// H = 128-256, 16 at 288) and `smem` its dynamic shared memory, as
// ops/lstm_cuda.py:wide_smem computes it (refused otherwise). xg
// (2, T, B, 4H) f32; lengths (B,) int32; wf the f32 fragment copy of W_hh^T
// (ops/lstm_cuda.py:recurrence_f32_weights of w_hh (2, G, 4H, H)
// transposed to (2, G, H, 4H)); hs_f, hs_b (and cs_f, cs_b, both null for
// the eval variant) (T, B, H) f32; hn, cn (2, B, H) f32. H is one of
// kWidths; each of the G weight groups (B / G rows) is cut into its own tiles of
// `rows` rows: `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int bilstm_fwd_wide_f32(int rows, const void* xg, const void* lengths,
                        const void* wf, void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn,
                        void* cn, int T_steps, int B, int H, int G, int tiles, int smem,
                        void* stream, int* max_clusters) {
  if (G <= 0 || B % G || (cs_f == nullptr) != (cs_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.wf = static_cast<const uint4*>(wf);
  a.hs[0] = static_cast<float*>(hs_f); a.hs[1] = static_cast<float*>(hs_b);
  a.cs[0] = static_cast<float*>(cs_f); a.cs[1] = static_cast<float*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 128: return launch_rows<128>(rows, a, tiles, smem, st, max_clusters);
    case 160: return launch_rows<160>(rows, a, tiles, smem, st, max_clusters);
    case 192: return launch_rows<192>(rows, a, tiles, smem, st, max_clusters);
    case 224: return launch_rows<224>(rows, a, tiles, smem, st, max_clusters);
    case 256: return launch_rows<256>(rows, a, tiles, smem, st, max_clusters);
    case 288: return launch_rows<288>(rows, a, tiles, smem, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
