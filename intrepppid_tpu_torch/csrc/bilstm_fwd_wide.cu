// Bidirectional LSTM layer recurrence for layers whose weights do not fit
// one block's shared memory, hand-written for Hopper (sm_90a).
//
// Replaces, together with bilstm_gates.cu (the input projection), the TPU
// kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _fwd_kernel (via _fwd_pallas,
//     :376) -- at the widths the TPU's lite plan serves (H >= ~192, the
//     scaled configuration's H = 256) and wherever bilstm_fwd.cu's resident
//     weights exceed shared memory (ops/lstm_cuda.py:layer_route);
//     with_states=False (eval variant) and True (train variant, which also
//     writes the cell streams).
//
// Function: for each direction d (0 forward, 1 reverse) and row r, step s
// reads position pos = s (d = 0) or T-1-s (d = 1) and computes
//   gates = xg[d, pos, r] + h @ W_hh[d, g]^T
// (xg the f32 input gates from bilstm_gates.cu, gate order i, f, g, o;
// g = r / (B / G), the row's weight group), then the cell update. The state
// moves iff pos < lengths[r], as in bilstm_fwd.cu. Every step writes the
// (possibly frozen) h to hs_f[pos] / hs_b[pos], and in the train variant c
// to cs_f[pos] / cs_b[pos], both in the compute dtype; h and c are f32 and
// the recurrent operand is h rounded to the compute dtype.
//
// What bounds it on an H100: the recurrence is serial in T and does 4H * H
// multiply-adds per row and step on CUDA cores (f32): operations. At
// H = 256 one direction's and one group's W_hh is 1 MB in f32, so no block
// can hold it, and streaming it from L2 every step would make the ~50 KB
// of h-dependent work per step wait on 1 MB of reads.
//
// Design: a thread-block cluster of 8 blocks per (row tile, direction).
// Block k of the cluster owns hidden units [k H/8, (k+1) H/8), i.e. 4H/8
// gate rows, and keeps that slice of W_hh resident in shared memory in f32
// for the whole sweep (128 KB at H = 256), laid out [k][unit][gate] so one
// 16-byte load feeds the four gates of a unit. Each thread (H per block)
// owns one unit for R rows and keeps the four gates' accumulators, h and c
// in registers. Every block holds the tile's whole h (rounded, as f32) in
// shared memory. Per step: the gates from that h and the resident slice,
// the cell update, then a relaxed cluster barrier (all reads of h done),
// each block writes its units' new h into every block's copy through
// distributed shared memory, and cluster.sync() (the new h is complete);
// the step's hs / cs stores follow the barrier. So two cluster barriers
// per step. The next step's input gates are loaded into registers while
// the current step computes. A tile never spans two weight
// groups (tile_row); the wrapper picks R, so the tile, so that the
// clusters fill the card in as few waves as the shared memory allows.
// Not yet done: tensor cores, and one barrier per step (a second h buffer
// does not fit beside the weights at the tile sizes that fill one wave).
// Both are in bilstm_fwd_wide_mma.cu (bf16 at H = 128 and 256: one bf16
// weight copy leaves room for two h tiles), which takes those shapes over;
// this kernel keeps f32 and the other bf16 widths. Up to H = 256 it runs
// in blocks instantiated for 256 threads (255 registers a thread); H = 257
// to 288 (the bf16 layers of JAX's lite plan past 256, padded to 288)
// takes a second instance for 288-thread blocks (224 registers a thread),
// whose slice (162 KB at 288) and h tile still fit shared memory at 2, 4
// and 7 rows a thread.

#include <cooperative_groups.h>

#include "bilstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, block H
// threads (H <= kThreads); row tile BR = kWideCluster * R. cs_f / cs_b
// null: eval variant.
template <int R, typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_fwd_wide_kernel(const float* __restrict__ xg, const int* __restrict__ lengths,
                       const T* __restrict__ w_hh, T* __restrict__ hs_f, T* __restrict__ hs_b,
                       T* __restrict__ cs_f, T* __restrict__ cs_b, float* __restrict__ hn,
                       float* __restrict__ cn, int T_steps, int B, int H, int G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int U = H / kWideCluster;  // units of this block
  const int H4 = 4 * H;
  const int ul = threadIdx.x % U;
  const int rg = threadIdx.x / U;  // row group, 0 .. kWideCluster-1
  const int unit = rank * U + ul;
  const int BR = kWideCluster * R;
  const int Bg = B / G;
  const int row0 = tile_row(tile, 0, BR, Bg);
  const int group = row0 / Bg;

  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [H][U][4]
  float* h_s = w_s + (size_t)H * 4 * U;          // [BR][H]

  // this block's slice of W_hh[d, group]: gate rows q * H + rank * U + u
  const T* w = w_hh + ((size_t)d * G + group) * H4 * H;
  for (int idx = threadIdx.x; idx < 4 * U * H; idx += blockDim.x) {
    const int lr = idx / H, k = idx - lr * H;
    const int q = lr / U, u = lr - q * U;
    w_s[((size_t)k * U + u) * 4 + q] = to_f32(w[((size_t)q * H + rank * U + u) * H + k]);
  }
  for (int idx = threadIdx.x; idx < BR * H; idx += blockDim.x) h_s[idx] = 0.0f;

  int row[R], len[R];
  float h[R], c[R], xv[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = tile_row(tile, rg * R + i, BR, Bg);
    len[i] = row[i] >= 0 ? lengths[row[i]] : 0;
    h[i] = 0.0f;
    c[i] = 0.0f;
  }
  const float* xgd = xg + (size_t)d * T_steps * B * H4;
  auto load_xg = [&](int pos) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* src = xgd + ((size_t)pos * B + (row[i] >= 0 ? row[i] : 0)) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = row[i] >= 0 ? __ldg(src + q * H) : 0.0f;
    }
  };
  if (T_steps > 0) load_xg(d ? T_steps - 1 : 0);
  __syncthreads();

  T* out = d ? hs_b : hs_f;
  T* cout = d ? cs_b : cs_f;
  const float* hv = h_s + (size_t)rg * R * H;
  for (int s = 0; s < T_steps; ++s) {
    const int pos = d ? T_steps - 1 - s : s;
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = xv[i][q];
    if (s + 1 < T_steps) load_xg(d ? pos - 1 : pos + 1);
    accumulate<R, float>(acc, hv, H, w_s, 4 * U, H, ul);

    float hq[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ig = sigmoidf_(acc[i][0]);
      const float fg = sigmoidf_(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoidf_(acc[i][3]);
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * tanhf(c_new);
      if (pos < len[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      hq[i] = to_f32(from_f32<T>(h[i]));
    }
    cluster_sync_relaxed();  // every block of the cluster is done reading its h_s
#pragma unroll
    for (int k = 0; k < kWideCluster; ++k) {
      float* dst = cluster.map_shared_rank(h_s, k) + (size_t)rg * R * H + unit;
#pragma unroll
      for (int i = 0; i < R; ++i) dst[(size_t)i * H] = hq[i];
    }
    cluster.sync();  // the new h is complete in every block
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (row[i] >= 0) {
        const size_t at = ((size_t)pos * B + row[i]) * H + unit;
        out[at] = from_f32<T>(h[i]);
        if (cout) cout[at] = from_f32<T>(c[i]);
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

int bilstm_fwd_wide_cluster() { return kWideCluster; }
int bilstm_fwd_wide_max_threads() { return kWideMaxThreads; }
int bilstm_fwd_wide_rows_mask() { return kWideRowsMask; }

const char* bilstm_fwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: float32, 1: bfloat16; rows_per_thread one of kWideRows; xg
// (2, T, B, 4H) f32; lengths (B,) int32; w_hh (2, G, 4H, H) with B % G == 0;
// hs_f, hs_b (and cs_f, cs_b, null for the eval variant) (T, B, H) in the
// dtype; hn, cn (2, B, H) f32. H % 32 == 0, H <= kWideMaxThreads; `tiles`
// = G * ceil((B / G) / (8 * rows_per_thread)). With max_clusters non-null,
// nothing is launched: *max_clusters receives how many clusters of this
// configuration the card holds at once. Returns a cudaError_t (0 on success).
int bilstm_fwd_wide(int dtype, int rows_per_thread, const void* xg, const void* lengths,
                    const void* w_hh, void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn,
                    void* cn, int T_steps, int B, int H, int G, int tiles, int smem,
                    void* stream, int* max_clusters) {
  return dispatch_wide(dtype, rows_per_thread, H, [&](auto r, auto t, auto n) -> int {
    using T = decltype(t);
    return launch_wide(bilstm_fwd_wide_kernel<decltype(r)::value, T, decltype(n)::value>, tiles, H,
                       smem, static_cast<cudaStream_t>(stream), max_clusters,
                       static_cast<const float*>(xg), static_cast<const int*>(lengths),
                       static_cast<const T*>(w_hh), static_cast<T*>(hs_f),
                       static_cast<T*>(hs_b), static_cast<T*>(cs_f), static_cast<T*>(cs_b),
                       static_cast<float*>(hn), static_cast<float*>(cn), T_steps, B, H, G);
  });
}

}  // extern "C"
