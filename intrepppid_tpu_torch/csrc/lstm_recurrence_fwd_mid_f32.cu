// Masked LSTM recurrence over precomputed, time-major input gates, f32
// compute dtype, at H = 96 to 288: the tensor-core variant in three tf32
// passes, hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_fwd_mid_mma.cu (bf16 at these widths) and
// lstm_recurrence_fwd.cu (the CUDA-core cluster kernel, reached by name
// only), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, for compute dtype float32 and
// H = 96, 128, ..., 288 (ops/lstm_cuda.py:recurrence_fwd_kernel): a
// one-layer model at embedding 128 on the recurrence backend, and the
// padded widths past 64 there.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd with the
// compute dtype f32, where round() is the identity): for each direction d
// (the caller has already flipped the reverse direction in time, so every
// direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + h @ w[d, g]
// (xg f32, gate order i, f, g, o; g = r / (B / G), the row's weight group),
// then the cell update. The state moves iff valid[s, d, r] != 0: the mask
// is data and may have holes, so every step is computed. Every step writes
// the (possibly frozen) h and c to hs[s, d, r] and cs[s, d, r], and the
// last state to hn / cn, all f32.
//
// What bounds it on an H100: the bytes up to H = 128 (xg in, hs and cs out:
// 24 H bytes per row and step, 1.1 ms at 128, 400 rows, D = 2, T = 1500),
// the product past it (8 H^2 flops per row and step in three tf32 passes
// at 495/3 TFLOP/s: 0.95 ms at 128, 3.8 at 256). What governs is the serial
// chain of a step, T times: the product over the block's share of the
// weights, the cell, and the exchange of the new h within the cluster. One
// tf32 pass misses the f32 agreement (1e-4 x max(1, max|ref|)) by 3-4 x, so
// the product is big.big + big.small + small.big.
//
// Design: the schedule of the bf16 forward lstm_recurrence_fwd_mid_mma.cu
// with the f32 products of lstm_recurrence_wide_f32.cuh, on the f32
// fragment copy the op's f32 sweep at these widths reads
// (ops/lstm_cuda.py:recurrence_f32_weights; FusedLSTMRecurrence builds it
// once for both):
//   * a cluster of CL blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / CL, (k + 1) n / CL) of the n = H / 8 unit
//     groups; CL is 4 (96-192) or 8 (96-288), each its own instances;
//   * the block's share of the fragments is copied once into shared memory
//     (MG x H x 128 bytes for the most groups MG a block owns: 64 KB at 128
//     with 4 groups a block, 128 KB at 256 with 4), so the product never
//     waits on L2. At 288 the share (180 KB) and the f32 h tiles leave no
//     room for one ring stage: the fragments are read from L2 (evict_last)
//     in chunks loaded ahead of their mma. So they are at 224 and 256,
//     where beside the share only 16-row tiles fit: four waves of 8-block
//     clusters at the train shape took 1.24 x the two waves of 32-row
//     L2-fed ones (ops/lstm_cuda.py:REC_FWD_MID_F32_FROM_L2);
//   * the gate product on mma.sync m16n8k8 tf32, three passes, each weight
//     fragment and each h value split in registers (split4 / split_tf32),
//     each pass into its own accumulators (chains of 2 H / 16 mma where one
//     set would chain 6 H / 16), two sets where a warp takes four items;
//     the block's UG x NT (unit group, n8 tile) items dealt over the 8 warps
//     (lstm_recurrence_wide_mma.cuh:deal_items), so lane (g, t) holds the
//     four gates of its unit for two rows and the cell needs no exchange;
//     the first chunks of fragments of the next step are loaded as soon as
//     a step's product is done, so their latency hides behind the cell and
//     the exchange;
//   * the tile's f32 h is double-buffered in every block: step s reads
//     buffer s % 2 and pushes the block's new h into buffer (s + 1) % 2 of
//     all CL blocks through distributed shared memory, 16-byte stores of
//     four units staged first in shared memory; ONE cluster barrier a step;
//   * the block's xg columns and the tile's mask bytes arrive through a
//     cp.async ring, the next steps' in flight while the chain runs: five
//     stages where they fit beside the share at the instance's widest
//     width, else as many as fit, at least three (stages());
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32 in
//     registers, and hs / cs leave from them after the barrier's arrive;
//   * row tiles BR in {16, 32}; ops/lstm_cuda.py
//     (recurrence_mid_f32_plan(..., kind="fwd")) takes the cluster size by
//     width and the fewest waves, then the smallest tile.

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_f32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;

constexpr int kMinMidH = 96;
constexpr int kMaxMidH = 288;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper
constexpr int kMaxStages = 5;       // xg tiles in flight: this step's and four ahead
constexpr int kMinStages = 3;       // fewer leave a memory latency on the step's chain
constexpr int kXPad = 4;            // f32 elements of padding on each xg ring row (4 mod 32)
constexpr int kSPad = 4;            // f32 elements of padding on each staged h row
constexpr int kMaskBytes = 48;      // a stage's mask chunks: 3 aligned 16-byte chunks hold 32 rows

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

__host__ __device__ constexpr int mid_groups(int H, int CL) { return (H / 8 + CL - 1) / CL; }

// Dynamic shared memory (bytes) with S ring stages, in layout order: the
// block's weight fragments (resident instances), two f32 h tiles, the
// block's new h staged (8 units a group), the xg ring (a row: 4 gates x 8
// units a group) and the mask ring.
__host__ __device__ constexpr int smem_w(int H, int CL, bool res) {
  return res ? mid_groups(H, CL) * H * 128 : 0;
}
__host__ __device__ constexpr int smem_h(int H, int BR) { return 2 * BR * (H + kFPad) * 4; }
__host__ __device__ constexpr int smem_st(int H, int BR, int CL) {
  return BR * (8 * mid_groups(H, CL) + kSPad) * 4;
}
__host__ __device__ constexpr int smem_stage(int H, int BR, int CL) {
  return BR * (32 * mid_groups(H, CL) + kXPad) * 4 + kMaskBytes;
}
__host__ __device__ constexpr int smem_with(int H, int BR, int CL, bool res, int S) {
  return smem_w(H, CL, res) + smem_h(H, BR) + smem_st(H, BR, CL) + S * smem_stage(H, BR, CL);
}
// The ring stages of the <CL, BR, MG, RES> instance: the most, up to
// kMaxStages, that fit at its widest width (MG groups a block); 0 where
// fewer than kMinStages fit (no instance).
__host__ __device__ constexpr int stages(int CL, int MG, int BR, bool res) {
  const int widest = 8 * CL * MG < kMaxMidH ? 8 * CL * MG : kMaxMidH;
  for (int S = kMaxStages; S >= kMinStages; --S)
    if (smem_with(widest, BR, CL, res, S) <= kSmemLimit) return S;
  return 0;
}
__host__ __device__ constexpr int smem_bytes(int H, int BR, int CL, bool res, int MG) {
  return smem_with(H, BR, CL, res, stages(CL, MG, BR, res));
}

// 16 bytes global -> shared, asynchronously, of which the first n (0-16)
// are read and the rest zero (src must be a mapped address, 16-byte aligned).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// grid (tiles * CL, D) in clusters of CL, kThreads threads; MG the most
// groups a block owns at the instance's widths; RES: the fragments resident.
template <int CL, int BR, int MG, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_fwd_mid_f32_kernel(const Args a) {
  constexpr int NT = BR / 8;                // n8 tiles of the row tile
  constexpr int WPG = kWarps / MG;          // fewest warps a unit group gets
  constexpr int GI = (NT + WPG - 1) / WPG;  // most items a warp takes
  constexpr int S = stages(CL, MG, BR, RES);
  // accumulator sets: each of the three passes sums apart (chains of 2 H /
  // 16 mma, where one accumulator would chain all 6 H / 16 of them), or the
  // two cross terms share one where a warp takes four items (registers)
  constexpr int NP = GI >= 4 ? 2 : 3;
  // k16 chunks of fragments in flight: shared memory's latency needs two;
  // from L2 four where a warp has fewer than a whole group's items
  constexpr int P = (RES || WPG == 1) ? kGateChunks : 2 * kGateChunks;
  constexpr int XS = 32 * MG + kXPad;  // xg ring row stride (f32)
  constexpr int SS = 8 * MG + kSPad;   // staged h row stride (f32): 2 SS = 8 (mod 32)
  constexpr int CPT = (BR * 8 * MG + kThreads - 1) / kThreads;  // xg chunks a thread copies
  static_assert(BR % 8 == 0 && BR <= 32 && WPG >= 1 && (CL == 4 || CL == 8), "shape");
  static_assert(S >= kMinStages, "no ring fits beside this instance's share");

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
  const int KS = H + kFPad;  // h tile row stride (f32), 16 (mod 32)
  const int KK = H / 8;      // k8 steps of the inputs: a group's fragments are KK * 64 lanes' worth
  const int K16 = H / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);                   // [UG][KK][2][32], resident
  float* h_s = reinterpret_cast<float*>(smem + smem_w(H, CL, RES));  // [2][BR][KS]
  float* hst = h_s + 2 * BR * KS;                                // [BR][SS]
  float* xs = hst + BR * SS;                                     // [S][BR][XS]
  uint8_t* vs = reinterpret_cast<uint8_t*>(xs + S * BR * XS);    // [S][kMaskBytes]

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = tid; idx < 2 * BR * KS / 4; idx += kThreads)
    reinterpret_cast<float4*>(h_s)[idx] = zero4;
  const uint64_t pol = evict_last_policy();
  const uint4* wdg = a.wf + ((size_t)(d * a.G + tr.group) * KK + glo) * KK * 64;
  if (RES) {
    for (int idx = tid; idx < UG * KK * 64; idx += kThreads) w_s[idx] = ldg_weight(wdg + idx, pol);
  }

  // the xg ring: chunk c of a step (row c / (8 UG), gate, 16 bytes of the
  // block's 8 UG units) is thread c % kThreads's; its source offset within
  // a step's (d) slice and its place in a stage are fixed
  int c_src[CPT];
  uint32_t c_dst[CPT];
  bool c_on[CPT], c_real[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int c = tid + m * kThreads;
    const int row = c / (8 * UG), rem = c - row * 8 * UG;
    const int q = rem / (2 * UG), part = rem - q * 2 * UG;
    c_on[m] = c < BR * 8 * UG;
    c_real[m] = c_on[m] && row < tr.nrows;
    c_src[m] = ((tr.row0 + (c_real[m] ? row : 0)) * H4 + q * H + unit0 + 4 * part);
    c_dst[m] = smem_u32(xs + row * XS + q * 8 * MG + 4 * part);
  }
  constexpr uint32_t kStageBytes = BR * XS * 4;
  const size_t v_size = (size_t)a.T * D * B;
  const uint32_t v_dst = smem_u32(vs) + 16 * tid;
  int fetch_step = 0, fetch_stage = 0;
  auto fetch = [&]() {
    const float* src = a.xg + ((size_t)fetch_step * D + d) * B * H4;
#pragma unroll
    for (int m = 0; m < CPT; ++m)
      if (c_on[m])
        cp_async16(c_dst[m] + fetch_stage * kStageBytes, c_real[m] ? src + c_src[m] : a.xg,
                   c_real[m]);
    if (tid < kMaskBytes / 16) {
      const size_t at = ((((size_t)fetch_step * D + d) * B + tr.row0) & ~(size_t)15) + 16 * tid;
      const int n = at >= v_size ? 0 : v_size - at < 16 ? (int)(v_size - at) : 16;
      cp_async16_n(v_dst + fetch_stage * kMaskBytes, n > 0 ? a.valid + at : a.valid, n);
    }
    ++fetch_step;
    fetch_stage = fetch_stage == S - 1 ? 0 : fetch_stage + 1;
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) fetch();
    cp_async_commit();
  }

  // gate items: warp w takes n8 tiles [nt0, nt0 + ni) of local unit group
  // ug; lane (g, t) of item j holds `unit` for tile rows 8 (nt0 + j) + 2t + i
  const ItemDeal deal = deal_items(warp, UG, NT);
  const int ug = deal.ug, nt0 = deal.nt0, ni = deal.ni;
  const int unit = unit0 + 8 * ug + g;
  // the fragments of the warp's group, this lane's
  const uint4* wa = (RES ? w_s : wdg) + (size_t)ug * KK * 64 + lane;
  // the four fragments of k16 chunk c (k8 step 2c + kh, m16 half mt)
  auto chunk = [&](uint4 (&r)[2][2], int c) {
    const uint4* p = wa + (size_t)c * 128;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        r[kh][mt] = RES ? p[kh * 64 + mt * 32] : ldg_weight(p + kh * 64 + mt * 32, pol);
  };
  // P slots of chunks in flight: gate_prefetch fills them with chunks
  // 0 .. P-1, the product refills each P chunks ahead after its use
  uint4 ra[P][2][2];
  auto gate_prefetch = [&]() {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < K16) chunk(ra[i], i);
  };
  float acc[NP][GI][2][4], h[GI][2], c[GI][2];
  bool vv[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) h[j][i] = c[j][i] = 0.0f;
  // acc[.][j][mt] += W(group ug, m16 half mt) . h^T(n8 tile nt0 + j) over
  // K = H, three tf32 passes (big.big into set 0, small.big into set 1,
  // big.small into set NP - 1); B from the f32 h tile (h_lane: row g, inputs
  // 4t .. 4t + 3 of chunk 0 of n8 tile 0)
  auto gate_mma = [&](const float* h_lane) {
#pragma unroll 1
    for (int c0 = 0; c0 < K16; c0 += P) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int cc = c0 + i;
        if (cc >= K16) continue;
        // the items' h inputs of the chunk, split where they are used
        float4 hv[GI];
#pragma unroll
        for (int j = 0; j < GI; ++j)
          if (j < ni)
            hv[j] = *reinterpret_cast<const float4*>(h_lane + 8 * (nt0 + j) * KS + 16 * cc);
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
              mma_tf32(acc[1][j][mt], as, b0, b1);
              mma_tf32(acc[NP - 1][j][mt], ab, s0, s1);
              mma_tf32(acc[0][j][mt], ab, b0, b1);
            }
          }
        if (cc + P < K16) chunk(ra[i], cc + P);
      }
    }
  };

  __syncthreads();  // the share is in shared memory
  if (ni > 0) gate_prefetch();
  cluster.sync();  // every block runs and its h tiles are zero: pushes may land
  const uint32_t h_u32 = smem_u32(h_s);
  const float* h_lane0 = h_s + g * KS + 4 * t;
  int stage = 0;
  for (int s = 0; s < T; ++s) {
    const int buf = s & 1;
    cp_async_wait<S - 2>();  // step s's stage has landed (this thread's copies)
    __syncthreads();  // ... every thread's; every warp is past step s - 1's stage
    if (s + S - 1 < T) fetch();
    cp_async_commit();
    // step s's xg into the accumulators, its mask bytes
    {
      const float* xr = xs + stage * BR * XS + 8 * ug + g;
      const uint8_t* vr = vs + stage * kMaskBytes +
                          ((((size_t)s * D + d) * B + tr.row0) & 15);
#pragma unroll
      for (int j = 0; j < GI; ++j) {
        if (j >= ni) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = 8 * (nt0 + j) + 2 * t + i;
          const float* x = xr + rl * XS;
          acc[0][j][0][i] = x[0];
          acc[0][j][0][2 + i] = x[8 * MG];
          acc[0][j][1][i] = x[16 * MG];
          acc[0][j][1][2 + i] = x[24 * MG];
#pragma unroll
          for (int p = 1; p < NP; ++p)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) acc[p][j][mt][i] = acc[p][j][mt][2 + i] = 0.0f;
          vv[j][i] = rl < tr.nrows && vr[rl] != 0;
        }
      }
    }
    stage = stage == S - 1 ? 0 : stage + 1;
    if (s > 0) cluster_wait_acquire();  // every block's step s - 1 pushes landed
    if (ni > 0) {
      gate_mma(h_lane0 + buf * BR * KS);
      if (s + 1 < T) gate_prefetch();  // the next step's first chunks
    }

    // the cell: lane (g, t) holds the four gates of its unit for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float gate[4];  // i, f, g, o: big.big + (the cross terms)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mt = q >> 1, v = 2 * (q & 1) + i;
          gate[q] = acc[0][j][mt][v] + (NP == 3 ? acc[1][j][mt][v] + acc[2 % NP][j][mt][v]
                                                : acc[1][j][mt][v]);
        }
        const float ig = fast_sigmoid(gate[0]);
        const float fg = fast_sigmoid(gate[1]);
        const float gg = fast_tanh(gate[2]);
        const float og = fast_sigmoid(gate[3]);
        const float c_new = fg * c[j][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (vv[j][i]) {
          c[j][i] = c_new;
          h[j][i] = h_new;
        }
        hst[(8 * (nt0 + j) + 2 * t + i) * SS + 8 * ug + g] = h[j][i];
      }
    }
    __syncthreads();  // the block's new h tile is staged

    if (s + 1 < T) {
      // the next step's h tile of every block of the cluster: 16 bytes (four
      // units) a store
      uint32_t rank_base[CL];
#pragma unroll
      for (int k = 0; k < CL; ++k) rank_base[k] = mapa_u32(h_u32, k);
      const uint32_t next = (uint32_t)(((buf ^ 1) * BR * KS + 8 * glo) * 4);
      for (int idx = tid; idx < BR * UG * 2; idx += kThreads) {
        const int rl = idx / (2 * UG), cc = idx - rl * 2 * UG;
        const uint4 v = *reinterpret_cast<const uint4*>(hst + rl * SS + 4 * cc);
        const uint32_t off = next + (uint32_t)((rl * KS + 4 * cc) * 4);
#pragma unroll
        for (int k = 0; k < CL; ++k) st_dsmem_v4(rank_base[k] + off, v);
      }
      cluster_arrive_release();  // this block's pushes of step s are written
    }
    const size_t base = ((size_t)s * D + d) * B + tr.row0;
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 8 * (nt0 + j) + 2 * t + i;
        if (rl >= tr.nrows) continue;
        const size_t at = (base + rl) * H + unit;
        __stcs(a.hs + at, h[j][i]);
        __stcs(a.cs + at, c[j][i]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < GI; ++j) {
    if (j >= ni) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 8 * (nt0 + j) + 2 * t + i;
      if (rl >= tr.nrows) continue;
      const size_t at = ((size_t)d * B + tr.row0 + rl) * H + unit;
      a.hn[at] = h[j][i];
      a.cn[at] = c[j][i];
    }
  }
}

template <int CL, int BR, int MG, bool RES>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR, CL, RES, MG) || mid_groups(a.H, CL) != MG)
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_recurrence_fwd_mid_f32_kernel<CL, BR, MG, RES>;
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

// The row tiles of (CL, MG, RES) whose ring fits (stages() >= kMinStages).
template <int CL, int MG, bool RES>
int launch_rows(int rows, const Args& a, int D, int tiles, int smem, cudaStream_t st, int* mc) {
  if (rows == 16) {
    if constexpr (stages(CL, MG, 16, RES) >= kMinStages)
      return launch<CL, 16, MG, RES>(a, D, tiles, smem, st, mc);
  }
  if (rows == 32) {
    if constexpr (stages(CL, MG, 32, RES) >= kMinStages)
      return launch<CL, 32, MG, RES>(a, D, tiles, smem, st, mc);
  }
  return (int)cudaErrorInvalidValue;
}

// The instances, as bit masks of H / 32 for each (cluster, resident): the
// 8-block cluster at every width, with the fragments resident up to 256
// (at 288 no ring stage fits beside them) and from L2 at every width; the
// 4-block cluster resident at 96-192 (past it a block's share leaves no
// room for the h tiles). Row tiles 16 and 32 each, where stages() fits a
// ring: not 32 rows with 6 groups a block (4-block at 192) or 4 resident
// groups in 8-block clusters (224, 256).
constexpr int kResident8 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8);
constexpr int kL2_8 = kResident8 | (1 << 9);
constexpr int kResident4 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6);
constexpr int kRows = (1 << 2) | (1 << 4);  // 16, 32, as bit rows / 8

}  // namespace

extern "C" {

int lstm_recurrence_fwd_mid_f32_threads() { return kThreads; }
int lstm_recurrence_fwd_mid_f32_pad() { return kFPad; }
int lstm_recurrence_fwd_mid_f32_x_pad() { return kXPad; }
int lstm_recurrence_fwd_mid_f32_s_pad() { return kSPad; }
int lstm_recurrence_fwd_mid_f32_max_stages() { return kMaxStages; }
int lstm_recurrence_fwd_mid_f32_min_stages() { return kMinStages; }
int lstm_recurrence_fwd_mid_f32_mask_bytes() { return kMaskBytes; }
int lstm_recurrence_fwd_mid_f32_min_h() { return kMinMidH; }
int lstm_recurrence_fwd_mid_f32_max_h() { return kMaxMidH; }
int lstm_recurrence_fwd_mid_f32_rows() { return kRows; }
int lstm_recurrence_fwd_mid_f32_resident8() { return kResident8; }
int lstm_recurrence_fwd_mid_f32_l2_8() { return kL2_8; }
int lstm_recurrence_fwd_mid_f32_resident4() { return kResident4; }

const char* lstm_recurrence_fwd_mid_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. `cluster` (4 or 8) is the blocks a
// cluster, `resident` (1 or 0) whether the fragments are copied into
// shared memory, `rows` the row tile (16 or 32), `smem` the dynamic shared
// memory, as ops/lstm_cuda.py:recurrence_mid_f32_smem(..., kind="fwd")
// computes it (refused otherwise, and so is a combination with no
// instance). xg (T, D, B, 4H) f32; valid (T, D, B) uint8, 16-byte aligned
// (the kernel copies its aligned chunks); wf the f32 weight copy of w
// (D, G, H, 4H) (ops/lstm_cuda.py:recurrence_f32_weights); hs, cs
// (T, D, B, H) and hn, cn (D, B, H) f32. H % 32 == 0, 96 <= H <= 288,
// B % G == 0, T >= 1; `tiles` = G * ceil(B / G / rows). With max_clusters
// non-null, nothing is launched: it receives how many clusters the card
// holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd_mid_f32(int cluster, int resident, int rows, const void* xg,
                                const void* valid, const void* wf, void* hs, void* cs,
                                void* hn, void* cn, int D, int T_steps, int B, int H, int G,
                                int tiles, int smem, void* stream, int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinMidH || H > kMaxMidH ||
      reinterpret_cast<uintptr_t>(valid) % 16 || (max_clusters == nullptr && T_steps < 1))
    return (int)cudaErrorInvalidValue;
  const int bit = 1 << (H / 32);
  const int mask = cluster == 4 ? (resident ? kResident4 : 0)
                                : cluster == 8 ? (resident ? kResident8 : kL2_8) : 0;
  if (!(mask & bit)) return (int)cudaErrorInvalidValue;
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
