// Masked LSTM recurrence over precomputed, time-major input gates, bf16
// compute dtype, at H = 96 to 288: the tensor-core variant, hand-written
// for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_fwd_mid_f32.cu (f32 at these widths) and
// lstm_recurrence_fwd.cu (the CUDA-core cluster kernel, reached by name
// only), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, for compute dtype bfloat16
// and H = 96, 128, ..., 288 (ops/lstm_cuda.py:recurrence_fwd_kernel).
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd): for
// each direction d (the caller has already flipped the reverse direction
// in time, so every direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + round_bf16(h) @ w[d, g]
// (xg f32, gate order i, f, g, o; g = r / (B / G), the row's weight group;
// f32 sums), then the cell update. The state (f32) moves iff
// valid[s, d, r] != 0: the mask is data and may have holes, so every step
// is computed. Every step writes the (possibly frozen) h and c, f32, to
// hs[s, d, r] and cs[s, d, r], and the last state to hn / cn.
//
// What bounds it on an H100: the bytes (xg in, hs and cs out: 24 H bytes
// per row and step, 1.1 ms at H = 128, 400 rows, D = 2, T = 1500); the
// product (8 H^2 flops per row and step) is under that on the tensor
// cores. What governs is the serial chain of a step, T times: the product
// over the block's share of the weights, the cell, and the exchange of the
// new h within the cluster.
//
// Design (the split and the weight copy of lstm_recurrence_wide_mma.cuh,
// the exchange of lstm_recurrence_fwd_wide_mma.cu, the item deal of the
// op's sweep at these widths, lstm_recurrence_bwd_mid_mma.cu, which reads
// the same copy):
//   * a cluster of CL blocks per (row tile, direction), 8 warps a block;
//     block k owns groups [k n / CL, (k + 1) n / CL) of the n = H / 8 unit
//     groups; CL is 4 (96-256) or 8 (96-288), each its own instances;
//   * the block's share of the bf16 fragment copy of w is copied once into
//     shared memory (ceil(H / 8 / CL) groups x H x 64 bytes: 32 KB at 128
//     with 4 groups a block), so the product never waits on L2;
//   * the gate product on mma.sync m16n8k16, swapped (the permuted gate
//     rows are the 16-row A operand, 8 rows of the tile the n8 operand);
//     the block's UG x NT (unit group, n8 tile) items dealt over the 8 warps
//     (deal_items), so lane (g, t) holds the four gates of its unit for two
//     rows and the cell needs no exchange;
//   * the tile's rounded h is double-buffered in every block: step s reads
//     buffer s % 2 and pushes the block's new h into buffer (s + 1) % 2 of
//     all CL blocks through distributed shared memory, 16-byte stores of a
//     row's units staged first in shared memory; ONE cluster barrier a step;
//   * the block's xg columns and the tile's mask bytes arrive through a
//     cp.async ring of kStages stages (kStagesAt8 where a block owns 8
//     groups, whose share leaves no room for a fifth), the next steps' in
//     flight while the chain runs;
//   * the cell uses ex2 / rcp (bilstm_mma.cuh); h and c stay f32 in
//     registers, and hs / cs leave from them after the barrier's arrive;
//   * row tiles BR in {16, 32}; ops/lstm_cuda.py (recurrence_mid_mma_plan)
//     takes the cluster size by width and the fewest waves, then the
//     smallest tile.

#include <cooperative_groups.h>

#include "lstm_recurrence_wide_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;
using namespace bilstm::recwide;
typedef __nv_bfloat16 bf16;

constexpr int kMinMidH = 96;
constexpr int kMaxMidH = 288;
constexpr int kStages = 5;     // xg tiles in flight: this step's and four ahead
constexpr int kStagesAt8 = 4;  // where a block owns 8 unit groups (H = 256, 4-block clusters)
constexpr int kXPad = 4;       // f32 elements of padding on each xg tile row (4 mod 16)
constexpr int kMaskBytes = 48;  // a stage's mask chunks: 3 aligned 16-byte chunks hold 32 rows

struct Args {
  const float* xg;       // (T, D, B, 4H)
  const uint8_t* valid;  // (T, D, B)
  const uint4* wg;       // the bf16 weight copy (lstm_recurrence_wide_mma.cuh)
  float* hs;             // (T, D, B, H)
  float* cs;
  float* hn;  // (D, B, H)
  float* cn;
  int T, B, H, G;
};

__host__ __device__ constexpr int mid_groups(int H, int CL) { return (H / 8 + CL - 1) / CL; }
__host__ __device__ constexpr int stages(int MG) { return MG >= 8 ? kStagesAt8 : kStages; }

// Dynamic shared memory (bytes), in layout order: the block's weight
// fragments, two bf16 h tiles, the block's new h staged, the xg ring (a
// row: 4 gates x 8 MG units) and the mask ring.
__host__ __device__ constexpr int smem_w(int H, int CL) { return mid_groups(H, CL) * H * 64; }
__host__ __device__ constexpr int smem_h(int H, int BR) { return 2 * BR * (H + kPad) * 2; }
__host__ __device__ constexpr int smem_st(int H, int BR, int CL) {
  return BR * (8 * mid_groups(H, CL) + kPad) * 2;
}
__host__ __device__ constexpr int smem_x(int H, int BR, int CL) {
  return stages(mid_groups(H, CL)) * BR * (32 * mid_groups(H, CL) + kXPad) * 4;
}
__host__ __device__ constexpr int smem_bytes(int H, int BR, int CL) {
  return smem_w(H, CL) + smem_h(H, BR) + smem_st(H, BR, CL) + smem_x(H, BR, CL) +
         stages(mid_groups(H, CL)) * kMaskBytes;
}

// 16 bytes global -> shared, asynchronously, of which the first n (0-16)
// are read and the rest zero (src must be a mapped address, 16-byte aligned).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// grid (tiles * CL, D) in clusters of CL, kThreads threads; MG the most
// groups a block owns at the instance's widths.
template <int CL, int BR, int MG>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_fwd_mid_mma_kernel(const Args a) {
  constexpr int NT = BR / 8;
  constexpr int WPG = kWarps / MG;
  constexpr int GI = (NT + WPG - 1) / WPG;
  constexpr int S = stages(MG);
  constexpr int XS = 32 * MG + kXPad;  // xg ring row stride (f32)
  constexpr int SS = 8 * MG + kPad;    // staged h row stride (bf16)
  constexpr int CPT = (BR * 8 * MG + kThreads - 1) / kThreads;  // xg chunks a thread copies
  static_assert(BR % 8 == 0 && BR <= 32 && WPG >= 1 && (CL == 4 || CL == 8), "shape");

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
  const int K16 = H / 16, KS = H + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);                   // [UG][K16][2][32]
  bf16* h_s = reinterpret_cast<bf16*>(smem + smem_w(H, CL));     // [2][BR][KS]
  bf16* hst = h_s + 2 * BR * KS;                                 // [BR][SS]
  float* xs = reinterpret_cast<float*>(smem + smem_w(H, CL) + smem_h(H, BR) +
                                       smem_st(H, BR, CL));      // [S][BR][XS]
  uint8_t* vs = reinterpret_cast<uint8_t*>(xs + S * BR * XS);    // [S][kMaskBytes]

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < 2 * BR * KS / 8; idx += kThreads)
    reinterpret_cast<uint4*>(h_s)[idx] = zero4;
  const uint4* wdg = a.wg + ((size_t)(d * a.G + tr.group) * (H / 8) + glo) * K16 * 64;
  for (int idx = tid; idx < UG * K16 * 64; idx += kThreads) w_s[idx] = __ldg(wdg + idx);

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
  const uint4* wa = w_s + (size_t)ug * K16 * 64 + lane;
  float acc[GI][2][4], h[GI][2], c[GI][2];
  bool vv[GI][2];
#pragma unroll
  for (int j = 0; j < GI; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) h[j][i] = c[j][i] = 0.0f;

  __syncthreads();
  cluster.sync();  // every block runs and its h tiles are zero: pushes may land
  const uint32_t h_u32 = smem_u32(h_s);
  const uint32_t b_lane = h_u32 + (uint32_t)(((8 * nt0 + lr) * KS + 8 * lm) * 2);
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
          acc[j][0][i] = x[0];
          acc[j][0][2 + i] = x[8 * MG];
          acc[j][1][i] = x[16 * MG];
          acc[j][1][2 + i] = x[24 * MG];
          vv[j][i] = rl < tr.nrows && vr[rl] != 0;
        }
      }
    }
    stage = stage == S - 1 ? 0 : stage + 1;
    if (s > 0) cluster_wait_acquire();  // every block's step s - 1 pushes landed
    if (ni > 0) {
      const uint32_t b_buf = b_lane + (uint32_t)(buf * BR * KS * 2);
#pragma unroll 2
      for (int k2 = 0; k2 < H / 32; ++k2) {
        uint4 f[4];  // [2 kh + mt]
#pragma unroll
        for (int q = 0; q < 4; ++q) f[q] = wa[k2 * 128 + q * 32];
#pragma unroll
        for (int j = 0; j < GI; ++j) {
          if (j >= ni) continue;
          uint32_t b[4];
          ldmatrix_x4(b, b_buf + (uint32_t)((8 * j * KS + 32 * k2) * 2));
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_a4(acc[j][mt], f[2 * kh + mt], b[2 * kh], b[2 * kh + 1]);
        }
      }
    }

    // the cell: lane (g, t) holds the four gates of its unit for rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < GI; ++j) {
      if (j >= ni) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ig = fast_sigmoid(acc[j][0][i]);
        const float fg = fast_sigmoid(acc[j][0][2 + i]);
        const float gg = fast_tanh(acc[j][1][i]);
        const float og = fast_sigmoid(acc[j][1][2 + i]);
        const float c_new = fg * c[j][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (vv[j][i]) {
          c[j][i] = c_new;
          h[j][i] = h_new;
        }
        hst[(8 * (nt0 + j) + 2 * t + i) * SS + 8 * ug + g] = __float2bfloat16_rn(h[j][i]);
      }
    }
    __syncthreads();  // the block's new h tile is staged

    if (s + 1 < T) {
      // the next step's h tile of every block of the cluster
      uint32_t rank_base[CL];
#pragma unroll
      for (int k = 0; k < CL; ++k) rank_base[k] = mapa_u32(h_u32, k);
      const uint32_t next = (uint32_t)(((buf ^ 1) * BR * KS + 8 * glo) * 2);
      for (int idx = tid; idx < BR * UG; idx += kThreads) {
        const int rl = idx / UG, cc = idx - rl * UG;
        const uint4 v = *reinterpret_cast<const uint4*>(hst + rl * SS + 8 * cc);
        const uint32_t off = next + (uint32_t)((rl * KS + 8 * cc) * 2);
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

template <int CL, int BR, int MG>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream, int* max_clusters) {
  if (smem != smem_bytes(a.H, BR, CL) || mid_groups(a.H, CL) != MG)
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_recurrence_fwd_mid_mma_kernel<CL, BR, MG>;
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

// The instances, as bit masks of H / 32 for each cluster size (those of
// lstm_recurrence_bwd_mid_mma.cu): 8-block clusters at every width, 4-block
// ones at 96-256. Row tiles 16 and 32 each.
constexpr int kWidths8 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8) | (1 << 9);
constexpr int kWidths4 = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8);
constexpr int kRows = (1 << 2) | (1 << 4);  // 16, 32, as bit rows / 8

}  // namespace

extern "C" {

int lstm_recurrence_fwd_mid_mma_threads() { return kThreads; }
int lstm_recurrence_fwd_mid_mma_pad() { return kPad; }
int lstm_recurrence_fwd_mid_mma_x_pad() { return kXPad; }
int lstm_recurrence_fwd_mid_mma_stages() { return kStages; }
int lstm_recurrence_fwd_mid_mma_stages_at8() { return kStagesAt8; }
int lstm_recurrence_fwd_mid_mma_mask_bytes() { return kMaskBytes; }
int lstm_recurrence_fwd_mid_mma_min_h() { return kMinMidH; }
int lstm_recurrence_fwd_mid_mma_max_h() { return kMaxMidH; }
int lstm_recurrence_fwd_mid_mma_rows() { return kRows; }
int lstm_recurrence_fwd_mid_mma_widths8() { return kWidths8; }
int lstm_recurrence_fwd_mid_mma_widths4() { return kWidths4; }

const char* lstm_recurrence_fwd_mid_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. `cluster` (4 or 8) is the blocks a
// cluster, `rows` the row tile (16 or 32), `smem` the dynamic shared
// memory, as ops/lstm_cuda.py:recurrence_mid_mma_smem("fwd", ...) computes
// it (refused otherwise, and so is a combination with no instance). xg
// (T, D, B, 4H) f32; valid (T, D, B) uint8, 16-byte aligned (the kernel
// copies its aligned chunks); wg the bf16 weight copy of w (D, G, H, 4H)
// (ops/lstm_cuda.py:recurrence_mma_weights); hs, cs (T, D, B, H) and hn, cn
// (D, B, H) f32. H % 32 == 0, 96 <= H <= 288, B % G == 0, T >= 1; `tiles`
// = G * ceil(B / G / rows). With max_clusters non-null, nothing is
// launched: it receives how many clusters the card holds at once. Returns
// a cudaError_t (0 on success).
int lstm_recurrence_fwd_mid_mma(int cluster, int rows, const void* xg, const void* valid,
                                const void* wg, void* hs, void* cs, void* hn, void* cn, int D,
                                int T_steps, int B, int H, int G, int tiles, int smem,
                                void* stream, int* max_clusters) {
  if (G <= 0 || B % G || D <= 0 || H % 32 || H < kMinMidH || H > kMaxMidH ||
      reinterpret_cast<uintptr_t>(valid) % 16 || (max_clusters == nullptr && T_steps < 1))
    return (int)cudaErrorInvalidValue;
  const int bit = 1 << (H / 32);
  const int mask = cluster == 4 ? kWidths4 : cluster == 8 ? kWidths8 : 0;
  if (!(mask & bit)) return (int)cudaErrorInvalidValue;
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
