// Masked LSTM recurrence over precomputed, time-major input gates,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence.
//
// Function: for each direction d (the caller has already flipped the
// reverse direction in time, so every direction walks s = 0 .. T-1) and row
// r, step s computes
//   gates = xg[s, d, r] + round(h) @ w[d, g]
// (xg f32, gate order i, f, g, o; w (D, G, H, 4H) pre-transposed in the
// compute dtype; g = r / (B / G), the row's weight group; round() to the
// compute dtype, sums in f32), then the cell update. The state moves iff
// valid[s, d, r] != 0: the mask is data and may have holes. Every step
// writes the (possibly frozen) h and c, unrounded, to hs[s, d, r] and
// cs[s, d, r] (f32), and the last state to hn / cn.
//
// What bounds it on an H100: serial in T, 4H * H multiply-adds per row and
// step on CUDA cores (f32) against the f32 streams (xg in, hs and cs out:
// 24 H bytes per row and step for 8 H * H operations): operations from
// H = 64 up (the two are about even there), bytes at H = 32.
//
// Design: the cluster split of bilstm_fwd_wide.cu, at every width. A
// cluster of 8 blocks per (row tile, direction); block k owns hidden units
// [k H/8, (k+1) H/8) and keeps its 4H/8 gate columns of w resident in
// shared memory in f32 for the whole sweep, laid out [k][unit][gate]; each
// thread (H per block) owns one unit for R rows with the gates'
// accumulators, h and c in registers. Every block holds the tile's whole
// rounded h in shared memory; per step a relaxed cluster barrier (h is
// read), the new h written into every block's copy through distributed
// shared memory, and cluster.sync(). The next step's input gates and mask
// bytes are loaded into registers while the current step computes. xg, hs
// and cs are addressed in the op's own (T, D, B, .) layout: no transposed
// copy. A tile never spans two weight groups (tile_row).
// Widths: up to H = 256 blocks instantiated for 256 threads (255
// registers a thread); H = 257 to 288 a second instance for 288-thread
// blocks (224 registers), whose f32 slice (H^2 / 2 bytes: 162 KB at 288)
// still fits shared memory beside the h tile. Past 288 it does not, so a
// third instance, for blocks of up to kRecMaxH = 1024 threads (64
// registers a thread), reads the slice from a copy in global memory that
// the wrapper lays out as the shared one is laid out ([d][g][block][k]
// [unit][gate], f32): each block's slice is contiguous and the 8 blocks of
// a cluster read disjoint slices, so one (d, g) copy (16 MB at H = 1024)
// stays in the 50 MB L2 while every cluster of that (d, g) reads it each
// step. Only the h tile stays in shared memory. Blocks of H threads reach
// CUDA's limit of 1024 there.
// Not yet done: tensor cores; a resident (one block per tile) variant for
// H <= 64, where the cluster barriers cost more than the products.

#include <cooperative_groups.h>

#include "bilstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, block H
// threads (H <= kThreads); row tile BR = kWideCluster * R. Past
// kWideMaxThreads the weight slice is read from `wl`, the global copy.
template <int R, typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_fwd_kernel(const float* __restrict__ xg, const uint8_t* __restrict__ valid,
                           const T* __restrict__ w, const float* __restrict__ wl,
                           float* __restrict__ hs,
                           float* __restrict__ cs, float* __restrict__ hn,
                           float* __restrict__ cn, int T_steps, int B, int H, int G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int D = gridDim.y;
  const int U = H / kWideCluster;  // units of this block
  const int U4 = 4 * U;
  const int H4 = 4 * H;
  const int ul = threadIdx.x % U;
  const int rg = threadIdx.x / U;  // row group, 0 .. kWideCluster-1
  const int unit = rank * U + ul;
  const int BR = kWideCluster * R;
  const int Bg = B / G;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;

  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kGlobalW = kThreads > kWideMaxThreads;
  const float* w_s;  // [H][U][4]: this block's slice of w[d, group]
  float* h_s;        // [BR][H]
  if constexpr (kGlobalW) {
    w_s = wl + (((size_t)d * G + group) * kWideCluster + rank) * H * U4;
    h_s = reinterpret_cast<float*>(smem);
  } else {
    // columns q * H + rank * U + u of w[d, group] (H, 4H), into shared memory
    float* ws = reinterpret_cast<float*>(smem);
    const T* wd = w + ((size_t)d * G + group) * H * H4;
    for (int idx = threadIdx.x; idx < H * U4; idx += blockDim.x) {
      const int k = idx / U4, lc = idx - k * U4;
      const int q = lc / U, u = lc - q * U;
      ws[((size_t)k * U + u) * 4 + q] = to_f32(wd[(size_t)k * H4 + q * H + rank * U + u]);
    }
    w_s = ws;
    h_s = ws + (size_t)H * U4;
  }
  for (int idx = threadIdx.x; idx < BR * H; idx += blockDim.x) h_s[idx] = 0.0f;

  int row[R];
  float h[R], c[R], xv[R][4];
  uint8_t vv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = tile_row(tile, rg * R + i, BR, Bg);
    h[i] = 0.0f;
    c[i] = 0.0f;
  }
  auto load_step = [&](int s) {
    const size_t base = ((size_t)s * D + d) * B;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t r = base + (row[i] >= 0 ? row[i] : 0);
      const float* src = xg + r * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = row[i] >= 0 ? __ldg(src + q * H) : 0.0f;
      vv[i] = row[i] >= 0 ? __ldg(valid + r) : (uint8_t)0;
    }
  };
  if (T_steps > 0) load_step(0);
  __syncthreads();

  const float* hv = h_s + (size_t)rg * R * H;
  for (int s = 0; s < T_steps; ++s) {
    float acc[R][4];
    bool on[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = xv[i][q];
      on[i] = vv[i] != 0;
    }
    if (s + 1 < T_steps) load_step(s + 1);
    accumulate<R, float>(acc, hv, H, w_s, U4, H, ul);

    float hq[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ig = sigmoidf_(acc[i][0]);
      const float fg = sigmoidf_(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoidf_(acc[i][3]);
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * tanhf(c_new);
      if (on[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      hq[i] = round_to<T>(h[i]);
    }
    cluster_sync_relaxed();  // every block of the cluster is done reading its h_s
#pragma unroll
    for (int k = 0; k < kWideCluster; ++k) {
      float* dst = cluster.map_shared_rank(h_s, k) + (size_t)rg * R * H + unit;
#pragma unroll
      for (int i = 0; i < R; ++i) dst[(size_t)i * H] = hq[i];
    }
    cluster.sync();  // the new h is complete in every block
    const size_t base = ((size_t)s * D + d) * B;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (row[i] >= 0) {
        const size_t at = (base + row[i]) * H + unit;
        hs[at] = h[i];
        cs[at] = c[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (row[i] >= 0) {
      hn[((size_t)d * B + row[i]) * H + unit] = h[i];
      cn[((size_t)d * B + row[i]) * H + unit] = c[i];
    }
  }
}

}  // namespace

extern "C" {

int lstm_recurrence_fwd_cluster() { return kWideCluster; }
int lstm_recurrence_fwd_max_threads() { return kWideMaxThreads; }
int lstm_recurrence_fwd_max_h() { return kRecMaxH; }
int lstm_recurrence_fwd_rows_mask() { return kWideRowsMask; }

const char* lstm_recurrence_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: float32, 1: bfloat16 (the compute dtype: w's type and h's
// rounding); rows_per_thread one of kWideRows; xg (T, D, B, 4H) f32; valid
// (T, D, B) uint8; w (D, G, H, 4H) with B % G == 0; wl, past
// kWideMaxThreads, w in f32 laid out (D, G, kWideCluster, H, H / 8, 4)
// (null otherwise); hs, cs (T, D, B, H) and hn, cn (D, B, H) f32.
// H % 32 == 0, H <= kRecMaxH; `tiles` =
// G * ceil((B / G) / (8 * rows_per_thread)). With max_clusters non-null,
// nothing is launched: *max_clusters receives how many clusters of this
// configuration the card holds at once. Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd(int dtype, int rows_per_thread, const void* xg, const void* valid,
                        const void* w, const void* wl, void* hs, void* cs, void* hn, void* cn,
                        int D, int T_steps, int B, int H, int G, int tiles, int smem,
                        void* stream, int* max_clusters) {
  if (H > kWideMaxThreads && !max_clusters && !wl) return (int)cudaErrorInvalidValue;
  return dispatch_wide<true>(dtype, rows_per_thread, H, [&](auto r, auto t, auto n) -> int {
    using T = decltype(t);
    return launch_wide_dirs(lstm_recurrence_fwd_kernel<decltype(r)::value, T, decltype(n)::value>,
                            tiles, D, H, smem, static_cast<cudaStream_t>(stream), max_clusters,
                            static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
                            static_cast<const T*>(w), static_cast<const float*>(wl),
                            static_cast<float*>(hs),
                            static_cast<float*>(cs), static_cast<float*>(hn),
                            static_cast<float*>(cn), T_steps, B, H, G);
  });
}

}  // extern "C"
