// Masked LSTM recurrence over precomputed, time-major input gates, f32
// compute dtype, past 288 units: the tensor-core variant in three tf32
// passes, hand-written for Hopper (sm_90a).
//
// Replaces, like the op's other forwards (bf16, and the widths up to 288),
// the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, for compute dtype float32
// and H = 320 to 1024 (H % 32 == 0; ops/lstm_cuda.py:recurrence_fwd_kernel).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd with the
// compute dtype f32, where round() is the identity): for each direction d
// (the caller has already flipped the reverse direction in time, so every
// direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + h @ w[d, g]
// (xg f32, gate order i, f, g, o; g = r / (B / G), the row's weight group),
// then the cell update. The state moves iff valid[s, d, r] != 0: the mask
// is data and may have holes, so every step is computed. Every step writes
// the (possibly frozen) h and c to hs[s, d, r] and cs[s, d, r], and the last
// state to hn / cn, all f32.
//
// What bounds it on an H100: the product, 8 H^2 flops per row and step, in
// three tf32 passes at 495/3 TFLOP/s (3.05 ms at H = 512, 400 rows,
// T = 300), over the f32 streams (xg in, hs and cs out: 24 H bytes per row
// and step, 0.88 ms). What governs is the serial chain of a step, T times:
// the product over the block's weight slice, read from L2, the cell, and
// the exchange of the new h within the cluster.
//
// Design: the schedule of the bf16 forward lstm_recurrence_fwd_wide_mma.cu
// (lstm_recurrence_wide_mma.cuh has the split) with the f32 products of
// lstm_recurrence_wide_f32.cuh:
//   * a cluster of 8 blocks per (row tile, direction), 8 warps a block;
//     block k owns H / 64 groups of 8 units (uneven where H % 64 == 32);
//     warp w takes group w (and w + 8 past H = 512) for every n8 tile, so
//     the cell needs no exchange and each weight fragment is read from L2
//     once a step for the whole row tile;
//   * the gate product on mma.sync m16n8k8 tf32, three passes, A from the
//     f32 fragment copy (ops/lstm_cuda.py:recurrence_f32_weights, the copy
//     the f32 sweep past 288 reads; FusedLSTMRecurrence builds it once for
//     both), split in registers; B from the tile's f32 h, one 16-byte
//     shared load a k16 chunk and n8 tile, split in registers. Two chunks
//     of fragments are in flight ahead of their mma, the first ones loaded
//     during the previous step's exchange and barrier;
//   * xg is loaded into the accumulators before the step's cluster wait, so
//     its latency hides behind the barrier;
//   * the tile's f32 h is double-buffered in every block: step s reads
//     buffer s % 2 and pushes the block's new h into buffer (s + 1) % 2 of
//     all 8 blocks through distributed shared memory, 16-byte stores of
//     four units staged first in shared memory; ONE cluster barrier a step
//     (a block pushes into buffer s % 2 at step s + 1 only after every block
//     has arrived at step s's barrier, i.e. finished reading it);
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32 in
//     registers, and hs / cs leave from them after the barrier's arrive;
//   * row tiles BR in {32, 48} up to H = 512 and {16} past it (two groups
//     a warp), each weight group cut into its own tiles. The f32 h tiles are
//     twice the bf16 ones: 2 BR (H + 16) 4 + BR (8 ceil(H / 64) + 16) 4
//     bytes, 145,408 at H = 512 and 32 rows, 218,112 at 48; the bf16
//     kernel's one wave of 80-row tiles no longer fits. ops/lstm_cuda.py
//     (wide_plan("rec_fwd_f32", ...)) picks the fewest waves
//     (cudaOccupancyMaxActiveClusters), then the smallest tile: at the train
//     step's 400 rows in 5 groups 32 rows, two waves. A 16-row instance up to
//     512 (two blocks an SM, 30 clusters at once, also two waves) took 1.13 x
//     the 32-row time there (chip_smoke.py phase recurrence_kernel, PERF.md)
//     and is not built.
// Widths: H % 32 == 0 from 320 to kRecMaxH = 1024. Up to 512 the 10 (d, g)
// weight copies of the 5-group train step (40 MB) stay in the 50 MB L2; past
// it they do not, and the kernel reads them at HBM's rate.

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_f32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;

struct Args {
  const float* xg;       // (T, D, B, 4H)
  const uint8_t* valid;  // (T, D, B)
  const uint4* wf;       // the f32 weight copy (lstm_recurrence_wide_f32.cuh)
  float* hs;             // (T, D, B, H)
  float* cs;
  float* hn;  // (D, B, H)
  float* cn;
  int T, B, H, G;
};

// Row stride (f32) of the staged new h: 8 units for each of the block's at
// most ceil(H / 64) groups, padded.
__host__ __device__ constexpr int stage_stride(int H) { return 8 * max_block_groups(H) + kFPad; }
// Dynamic shared memory of the <BR> instance at H (bytes): two f32 h tiles
// and the block's new h staged.
__host__ __device__ constexpr int smem_bytes(int H, int BR) {
  return 2 * BR * (H + kFPad) * 4 + BR * stage_stride(H) * 4;
}

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, kThreads threads.
template <int BR, int MUG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_fwd_wide_f32_kernel(const Args a) {
  constexpr int NT = BR / 8;
  constexpr int P = kGateChunks;
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
  const int KS = H + kFPad, SS = stage_stride(H);

  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [2][BR][KS]: the tile's h
  float* hst = h_s + 2 * BR * KS;               // [BR][SS]: the block's new h
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = tid; idx < 2 * BR * KS / 4; idx += kThreads)
    reinterpret_cast<float4*>(h_s)[idx] = zero4;

  // this warp's groups: local w + 8 j, global glo + w + 8 j; lane (g, t)
  // holds unit 8 (glo + w + 8 j) + g for tile rows 8 nt + 2t + i
  const int nug = warp < UGk ? min(MUG, (UGk - warp + kWarps - 1) / kWarps) : 0;
  const uint64_t pol = evict_last_policy();
  const uint4* wa[MUG];
  int unit[MUG];
#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    const int ugg = glo + warp + kWarps * j;
    wa[j] = a.wf + ((size_t)(d * a.G + tr.group) * (H / 8) + ugg) * (H / 8) * 64 + lane;
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
  const float* h_lane = h_s + g * KS + 4 * t;
  uint4 ra[P][MUG][2][2];  // the gate product's weight fragments in flight
  gate_prefetch_f32<MUG, P>(ra, wa, nug, H / 16, pol);
  for (int s = 0; s < T; ++s) {
    const int buf = s & 1;
    load_step(s);
    if (s > 0) cluster_wait_acquire();  // every block's step s - 1 pushes landed
    if (nug > 0)
      gate_mma_f32<MUG, NT, P>(acc, ra, wa, nug, h_lane + buf * BR * KS, KS, H / 16, pol);

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
          hst[(8 * nt + 2 * t + i) * SS + 8 * (warp + kWarps * j) + g] = h[j][nt][i];
        }
    }
    if (s + 1 < T) gate_prefetch_f32<MUG, P>(ra, wa, nug, H / 16, pol);  // the next step's
    __syncthreads();  // the block's new h tile is staged

    if (s + 1 < T) {
      // the next step's h tile of every block of the cluster: 16-byte
      // chunks of four units, 2 UGk a row
      uint32_t rank_base[kWideCluster];
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) rank_base[k] = mapa_u32(h_u32, k);
      const uint32_t next = (uint32_t)(((buf ^ 1) * BR * KS + 8 * glo) * 4);
      const int CH = 2 * UGk;
      for (int idx = tid; idx < BR * CH; idx += kThreads) {
        const int rl = idx / CH, cc = idx - rl * CH;
        const uint4 v = *reinterpret_cast<const uint4*>(hst + rl * SS + 4 * cc);
        const uint32_t off = next + (uint32_t)((rl * KS + 4 * cc) * 4);
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
  return launch_wide_dirs(lstm_recurrence_fwd_wide_f32_kernel<BR, MUG>, tiles, D, kThreads,
                          smem, stream, max_clusters, a);
}

// The row tiles each weight-group count is instantiated for, as bit BR / 8.
constexpr int kRows1 = (1 << 4) | (1 << 6);  // 32, 48
constexpr int kRows2 = (1 << 2);                        // 16

}  // namespace

extern "C" {

int lstm_recurrence_fwd_wide_f32_cluster() { return kWideCluster; }
int lstm_recurrence_fwd_wide_f32_threads() { return kThreads; }
int lstm_recurrence_fwd_wide_f32_pad() { return kFPad; }
int lstm_recurrence_fwd_wide_f32_min_h() { return kMinH; }
int lstm_recurrence_fwd_wide_f32_max_h() { return kRecMaxH; }
int lstm_recurrence_fwd_wide_f32_rows1() { return kRows1; }
int lstm_recurrence_fwd_wide_f32_rows2() { return kRows2; }

const char* lstm_recurrence_fwd_wide_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `rows` is the row tile (32 or 48 up to
// H = 512, 16 past it) and `smem` its dynamic shared memory, as
// ops/lstm_cuda.py:recurrence_wide_f32_smem(H, rows, "fwd") computes it (refused
// otherwise). xg (T, D, B, 4H) f32; valid (T, D, B) uint8; wf the f32
// weight copy of w (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_f32_weights);
// hs, cs (T, D, B, H) and hn, cn (D, B, H) f32. H % 32 == 0,
// 320 <= H <= 1024, B % G == 0; each of the G weight groups (B / G rows) is
// cut into its own tiles of `rows` rows: `tiles` = G * ceil(B / G / rows).
// With max_clusters non-null, nothing is launched: it receives how many
// clusters the card holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd_wide_f32(int rows, const void* xg, const void* valid, const void* wf,
                                 void* hs, void* cs, void* hn, void* cn, int D, int T_steps,
                                 int B, int H, int G, int tiles, int smem, void* stream,
                                 int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinH || H > kRecMaxH)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.valid = static_cast<const uint8_t*>(valid);
  a.wf = static_cast<const uint4*>(wf);
  a.hs = static_cast<float*>(hs);
  a.cs = static_cast<float*>(cs);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp_groups(H) == 1) {
    switch (rows) {
      case 32: return launch<32, 1>(a, D, tiles, smem, st, max_clusters);
      case 48: return launch<48, 1>(a, D, tiles, smem, st, max_clusters);
      default: break;
    }
  } else if (rows == 16) {
    return launch<16, 2>(a, D, tiles, smem, st, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
