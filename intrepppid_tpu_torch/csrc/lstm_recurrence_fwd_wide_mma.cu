// Masked LSTM recurrence over precomputed, time-major input gates, bf16
// compute dtype, past 288 units: the tensor-core variant, hand-written for
// Hopper (sm_90a).
//
// Replaces, like the op's other forwards (f32, and the widths up to 288),
// the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, for compute dtype bfloat16
// and H = 320 to 1024 (H % 32 == 0; ops/lstm_cuda.py:recurrence_fwd_kernel).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd): for
// each direction d (the caller has already flipped the reverse direction
// in time, so every direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + round_bf16(h) @ w[d, g]
// (xg f32, gate order i, f, g, o; g = r / (B / G), the row's weight group;
// f32 sums), then the cell update. The state (f32) moves iff
// valid[s, d, r] != 0: the mask is data and may have holes, so every step
// is computed, and none is skipped. Every step writes the (possibly frozen)
// h and c, f32, to hs[s, d, r] and cs[s, d, r], and the last state to hn /
// cn.
//
// What bounds it on an H100: the bytes (xg in, hs and cs out: 24 H bytes
// per row and step, 0.88 ms at H = 512, 400 rows, T = 300); the product
// (8 H^2 flops per row and step) is under that on the tensor cores. What
// governs is the serial chain of a step, T times: the product over the
// block's weight slice, read from L2, the cell, and the exchange of the new
// h within the cluster.
//
// Design (lstm_recurrence_wide_mma.cuh has the split and the weight copy):
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block;
//     block k owns H / 64 groups of 8 units (uneven where H % 64 == 32);
//   * the gate product on mma.sync m16n8k16, swapped (the permuted gate
//     rows are the 16-row A operand, 8 rows of the tile the n8 operand):
//     warp w takes group w (and w + 8 past H = 512) for every n8 tile, so
//     the cell needs no exchange and each weight fragment is read from L2
//     once a step for the whole tile: at 80 rows, 2 MB of bf16 weights a
//     (d, g) cross L2 once a step for all of its rows. The weights never
//     sit in shared memory (a block's bf16 slice is 256 KB at H = 512, more
//     than a block may hold); the fragments of 2 k32 steps are in flight in
//     registers ahead of their mma, the first ones loaded during the
//     previous step's exchange and barrier;
//   * xg is loaded into the accumulators before the step's cluster wait, so
//     its latency hides behind the barrier (sums: xg, then the products in
//     k order; the plain twin adds xg after the product, an f32 rounding
//     apart);
//   * the tile's rounded h is double-buffered in every block: step s reads
//     buffer s % 2 and pushes the block's new h into buffer (s + 1) % 2 of
//     all 8 blocks through distributed shared memory, 16-byte stores of a
//     row's units staged first in shared memory (32-bit cluster addresses
//     mapped each step: `mapa`); ONE cluster barrier a step
//     (a block pushes into buffer s % 2 at step s + 1 only after every block
//     has arrived at step s's barrier, i.e. finished reading it);
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32 in
//     registers, and hs / cs leave from them after the barrier's arrive;
//   * row tiles BR in {16, 32, 48, 80} up to H = 512 and {16, 32} past it
//     (multiples of the n8 tile; each weight group cut into its own tiles);
//     ops/lstm_cuda.py picks the fewest waves (cudaOccupancyMaxActiveClusters:
//     15 clusters of 8 at once on an H100, so the train step's 10 (d, g) at
//     80 rows run in one), then the smallest tile.
// Widths: H % 32 == 0 from 320 to kRecMaxH = 1024. Up to 512 the 10 (d, g)
// weight blocks of the 5-group train step (20 MB) stay in the 50 MB L2; at
// 1024 (80 MB) they do not, and the kernel runs at HBM's rate instead.

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
  float* hs;             // (T, D, B, H)
  float* cs;
  float* hn;  // (D, B, H)
  float* cn;
  int T, B, H, G;
};

// Dynamic shared memory of the <BR> instance at H (bytes): two bf16 h tiles
// and the block's new h staged.
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return 2 * BR * (H + kPad) * 2 + BR * (8 * max_block_groups(H) + kPad) * 2;
}

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, kThreads threads.
template <int BR, int MUG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_fwd_wide_mma_kernel(const Args a) {
  constexpr int NT = BR / 8;
  constexpr int P = kGateInFlight;
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
  const int KS = H + kPad, SS = 8 * max_block_groups(H) + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* h_s = reinterpret_cast<bf16*>(smem);  // [2][BR][KS]: the tile's rounded h
  bf16* hst = h_s + 2 * BR * KS;              // [BR][SS]: the block's new h
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < 2 * BR * KS / 8; idx += kThreads)
    reinterpret_cast<uint4*>(h_s)[idx] = zero4;

  // this warp's groups: local w + 8 j, global glo + w + 8 j; lane (g, t)
  // holds unit 8 (glo + w + 8 j) + g for tile rows 8 nt + 2t + i
  const int nug = warp < UGk ? min(MUG, (UGk - warp + kWarps - 1) / kWarps) : 0;
  const uint64_t pol = evict_last_policy();
  const uint4* wa[MUG];
  int unit[MUG];
#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    const int ugg = glo + warp + kWarps * j;
    wa[j] = a.wg + ((size_t)(d * a.G + tr.group) * (H / 8) + ugg) * (H / 16) * 64 + lane;
    unit[j] = 8 * ugg + g;
  }
  float acc[MUG][NT][2][4], h[MUG][NT][2], c[MUG][NT][2];
  uint8_t vv[NT][2];
#pragma unroll
  for (int j = 0; j < MUG; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) h[j][nt][i] = c[j][nt][i] = 0.0f;

  // step s's mask bytes, and its input gates into the accumulators
  auto load_step = [&](int s) {
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
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
        }
      }
  };

  __syncthreads();
  cluster.sync();  // every block runs and its h tiles are zero: pushes may land
  const uint32_t h_u32 = smem_u32(h_s);
  const uint32_t b_lane = h_u32 + (uint32_t)((lr * KS + 8 * lm) * 2);
  uint4 ra[P][MUG][4];  // the gate product's weight fragments in flight
  gate_prefetch<MUG, P>(ra, wa, nug, H / 32, pol);
  for (int s = 0; s < T; ++s) {
    const int buf = s & 1;
    load_step(s);
    if (s > 0) cluster_wait_acquire();  // every block's step s - 1 pushes landed
    if (nug > 0)
      gate_mma<MUG, NT, P>(acc, ra, wa, nug, b_lane + (uint32_t)(buf * BR * KS * 2), KS,
                           H / 32, pol);

    // the cell: lane (g, t) holds the four gates of its unit for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < MUG; ++j) {
      if (j >= nug) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float ig = fast_sigmoid(acc[j][nt][0][i]);
          const float fg = fast_sigmoid(acc[j][nt][0][2 + i]);
          const float gg = fast_tanh(acc[j][nt][1][i]);
          const float og = fast_sigmoid(acc[j][nt][1][2 + i]);
          const float c_new = fg * c[j][nt][i] + ig * gg;
          const float h_new = og * fast_tanh(c_new);
          if (vv[nt][i]) {
            c[j][nt][i] = c_new;
            h[j][nt][i] = h_new;
          }
          hst[(8 * nt + 2 * t + i) * SS + 8 * (warp + kWarps * j) + g] =
              __float2bfloat16_rn(h[j][nt][i]);
        }
    }
    if (s + 1 < T) gate_prefetch<MUG, P>(ra, wa, nug, H / 32, pol);  // the next step's
    __syncthreads();  // the block's new h tile is staged

    if (s + 1 < T) {
      // the next step's h tile of every block of the cluster
      uint32_t rank_base[kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) rank_base[k] = mapa_u32(h_u32, k);
      const uint32_t next = (uint32_t)(((buf ^ 1) * BR * KS + 8 * glo) * 2);
      for (int idx = tid; idx < BR * UGk; idx += kThreads) {
        const int rl = idx / UGk, cc = idx - rl * UGk;
        const uint4 v = *reinterpret_cast<const uint4*>(hst + rl * SS + 8 * cc);
        const uint32_t off = next + (uint32_t)((rl * KS + 8 * cc) * 2);
#pragma unroll
        for (int k = 0; k < kWideCluster; ++k) st_dsmem_v4(rank_base[k] + off, v);
      }
      cluster_arrive_release();  // this block's pushes of step s are written
    }
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
#pragma unroll
    for (int j = 0; j < MUG; ++j) {
      if (j >= nug) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = 8 * nt + 2 * t + i;
          if (rl >= tr.nrows) continue;
          const size_t at = (base + rl) * H + unit[j];
          __stcs(a.hs + at, h[j][nt][i]);
          __stcs(a.cs + at, c[j][nt][i]);
        }
    }
  }

#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    if (j >= nug) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * nt + 2 * t + i;
        if (rl >= tr.nrows) continue;
        const size_t at = ((size_t)d * B + tr.row0 + rl) * H + unit[j];
        a.hn[at] = h[j][nt][i];
        a.cn[at] = c[j][nt][i];
      }
  }
}

template <int BR, int MUG>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR)) return (int)cudaErrorInvalidValue;
  return launch_wide_dirs(lstm_recurrence_fwd_wide_mma_kernel<BR, MUG>, tiles, D, kThreads,
                          smem, stream, max_clusters, a);
}

// The row tiles each weight-group count is instantiated for, as bit BR / 8.
constexpr int kRows1 = (1 << 2) | (1 << 4) | (1 << 6) | (1 << 10);  // 16, 32, 48, 80
constexpr int kRows2 = (1 << 2) | (1 << 4);                          // 16, 32

}  // namespace

extern "C" {

int lstm_recurrence_fwd_wide_mma_cluster() { return kWideCluster; }
int lstm_recurrence_fwd_wide_mma_threads() { return kThreads; }
int lstm_recurrence_fwd_wide_mma_pad() { return kPad; }
int lstm_recurrence_fwd_wide_mma_min_h() { return kMinH; }
int lstm_recurrence_fwd_wide_mma_max_h() { return kRecMaxH; }
int lstm_recurrence_fwd_wide_mma_rows1() { return kRows1; }
int lstm_recurrence_fwd_wide_mma_rows2() { return kRows2; }

const char* lstm_recurrence_fwd_wide_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `rows` is the row tile (16, 32, 48 or 80
// up to H = 512, 16 or 32 past it) and `smem` its dynamic shared memory, as
// ops/lstm_cuda.py:recurrence_wide_mma_smem("fwd", ...) computes it (refused
// otherwise). xg (T, D, B, 4H) f32; valid (T, D, B) uint8; wg the weight
// copy of w (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_mma_weights); hs, cs
// (T, D, B, H) and hn, cn (D, B, H) f32. H % 32 == 0, 320 <= H <= 1024,
// B % G == 0; each of the G weight groups (B / G rows) is cut into its own
// tiles of `rows` rows: `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd_wide_mma(int rows, const void* xg, const void* valid, const void* wg,
                                 void* hs, void* cs, void* hn, void* cn, int D, int T_steps,
                                 int B, int H, int G, int tiles, int smem, void* stream,
                                 int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinH || H > kRecMaxH)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.valid = static_cast<const uint8_t*>(valid);
  a.wg = static_cast<const uint4*>(wg);
  a.hs = static_cast<float*>(hs);
  a.cs = static_cast<float*>(cs);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp_groups(H) == 1) {
    switch (rows) {
      case 16: return launch<16, 1>(a, D, tiles, smem, st, max_clusters);
      case 32: return launch<32, 1>(a, D, tiles, smem, st, max_clusters);
      case 48: return launch<48, 1>(a, D, tiles, smem, st, max_clusters);
      case 80: return launch<80, 1>(a, D, tiles, smem, st, max_clusters);
      default: break;
    }
  } else {
    switch (rows) {
      case 16: return launch<16, 2>(a, D, tiles, smem, st, max_clusters);
      case 32: return launch<32, 2>(a, D, tiles, smem, st, max_clusters);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
