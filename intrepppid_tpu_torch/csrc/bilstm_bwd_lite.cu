// Bidirectional LSTM layer backward sweep over the input-gate streams, for
// layers whose weights do not fit one block's shared memory, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel with
//     fused_input=False (via _bwd_pallas_lite, :723) -- the lite backward
//     of the large-H plan (the scaled configuration's H = 256);
// and, with bilstm_gates.cu before it and the input-side products and
// bilstm_wgrad.cu after it (ops/lstm_stack.py), _bwd_kernel with
// fused_input=True (via _bwd_pallas, :603) at the widths where
// bilstm_bwd.cu's resident weights exceed shared memory.
//
// Function: block (row tile, direction d) walks the positions in the
// reverse of that direction's forward order, carrying dh and dc (f32).
// Per step and row r:
//   * gates = xg[d, pos, r] + h_prev @ W_hh[d, g]^T, with xg the f32 input
//     gates (bilstm_gates.cu, the values the forward used) and h_prev the
//     forward stream at the previous position (hs_f[pos-1] for d = 0,
//     hs_b[pos+1] for d = 1, zero past the ends);
//   * c_new = f * c_prev + i * g with c_prev from the compute-dtype cell
//     stream, dh += the sum of the 0-2 unsummed dy streams (f32);
//   * dgates (f32) by the mask rules of lstm_pallas_layer.py:519-536, written
//     to the (2, T, B, 4H) f32 output (:573-575): a position at or past the
//     row's length gets dgates = 0 and passes dh and dc through;
//   * dh = round(dgates) @ W_hh[d, g] + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
// dW_hh, dW_ih, dx and dbias are formed from the dgates outside
// (bilstm_wgrad.cu and two products), as the JAX package forms dx, dW_ih and
// dbias outside its lite kernel.
//
// What bounds it on an H100: serial in T, 2 * 4H * H multiply-adds per row
// and step on CUDA cores (gate recompute and dh): operations. As in
// bilstm_fwd_wide.cu, W_hh (1 MB in f32 at H = 256) fits no block.
//
// Design: a thread-block cluster of 8 blocks per (row tile, direction), the
// split of bilstm_fwd_wide.cu: block k owns hidden units [k H/8,
// (k+1) H/8), keeps its 4H/8 gate rows of W_hh resident in f32, laid out
// [k][unit*4 + gate] with rows padded by kPad elements, and each thread
// owns one unit for R rows. Per step the block reads the tile's whole
// h_prev from hs (no exchange: the forward wrote it), recomputes its gate
// columns and forms its units' dgates. dh needs every gate column, so each
// block forms a partial dh over all H units from its own gate columns
// (thread = unit k of the partial, reading W_hh row k of the slice: the
// padding puts neighbouring rows in distinct banks) into shared memory,
// cluster.sync(), each block sums its own units' partials from the 8
// blocks in rank order through distributed shared memory (so the result
// does not depend on timing), and a relaxed cluster barrier follows (the
// partials are read). dc stays local. The partial buffer reuses the
// h_prev tile's shared memory. The next step's h_prev tile, input gates,
// c_prev and dy are loaded into registers while the current step computes.
// bf16 at H = 128 and 256 takes bilstm_bwd_lite_mma.cu (the same split
// with both products on the tensor cores; ops/lstm_cuda.py:lite_kernel);
// this kernel keeps f32 and the other bf16 widths. Up to H = 256 it runs
// in blocks instantiated for 256 threads (255 registers a thread); H = 257
// to 288 takes a second instance for 288-thread blocks (224 registers),
// whose padded slice (167 KB at 288), h tile and gate tile still fit
// shared memory at 2 and 4 rows a thread. Not yet done: f32 on the tensor
// cores.

#include <cooperative_groups.h>

#include "bilstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;

constexpr int kPad = 4;  // shared-memory weight row padding (elements)

struct Streams2 {
  const void* f[2];
  const void* b[2];
  int n;
};

// grid (tiles * kWideCluster, 2) in clusters of kWideCluster, block H
// threads (H <= kThreads); row tile BR = kWideCluster * R.
template <int R, typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_bwd_lite_kernel(const float* __restrict__ xg, const int* __restrict__ lengths,
                       const T* __restrict__ w_hh, const T* __restrict__ hs_f,
                       const T* __restrict__ hs_b, const T* __restrict__ cs_f,
                       const T* __restrict__ cs_b, Streams2 dy, const float* __restrict__ dhn,
                       const float* __restrict__ dcn, float* __restrict__ dgates, int T_steps,
                       int B, int H, int G) {
  constexpr int V = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int U = H / kWideCluster;
  const int U4 = 4 * U;
  const int WS = U4 + kPad;
  const int H4 = 4 * H;
  const int ul = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int unit = rank * U + ul;
  const int BR = kWideCluster * R;
  const int Bg = B / G;
  const int group = tile_row(tile, 0, BR, Bg) / Bg;

  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [H][WS], [unit*4 + gate]
  float* hp_s = w_s + (size_t)H * WS;           // [BR][H]: h_prev, then the partial dh
  float* dg_s = hp_s + (size_t)BR * H;          // [BR][4U], [unit*4 + gate]

  const T* w = w_hh + ((size_t)d * G + group) * H4 * H;
  for (int idx = threadIdx.x; idx < U4 * H; idx += blockDim.x) {
    const int lr = idx / H, k = idx - lr * H;
    const int q = lr / U, u = lr - q * U;
    w_s[(size_t)k * WS + u * 4 + q] = to_f32(w[((size_t)q * H + rank * U + u) * H + k]);
  }

  int row[R], len[R];
  float dh[R], dc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = tile_row(tile, rg * R + i, BR, Bg);
    len[i] = row[i] >= 0 ? lengths[row[i]] : 0;
    const size_t at = ((size_t)d * B + (row[i] >= 0 ? row[i] : 0)) * H + unit;
    dh[i] = (row[i] >= 0 && dhn) ? dhn[at] : 0.0f;
    dc[i] = (row[i] >= 0 && dcn) ? dcn[at] : 0.0f;
  }
  const T* hs = d ? hs_b : hs_f;
  const T* cs = d ? cs_b : cs_f;
  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const float* xgd = xg + (size_t)d * T_steps * B * H4;
  float* dgd = dgates + (size_t)d * T_steps * B * H4;

  // The next step's operands, loaded into registers while this step
  // computes: the tile's h_prev (16-byte chunks, kChunks per thread: H
  // threads move BR * H elements) and this thread's input gates, c_prev and
  // dy sum.
  constexpr int kChunks = kWideCluster * R / V;
  uint4 hr[kChunks];
  float xv[R][4], cpv[R], dyv[R];
  auto load_step = [&](int pos) {
    const int ppos = pos + hshift;
    const bool has_prev = ppos >= 0 && ppos < T_steps;
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int elem = (threadIdx.x + m * blockDim.x) * V;
      const int rl = elem / H;
      const int r = tile_row(tile, rl, BR, Bg);
      hr[m] = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && has_prev)
        hr[m] = __ldg(reinterpret_cast<const uint4*>(hs + ((size_t)ppos * B + r) * H + elem -
                                                     rl * H));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      cpv[i] = 0.0f;
      dyv[i] = 0.0f;
      const int r = row[i] >= 0 ? row[i] : 0;
      const size_t at = ((size_t)pos * B + r) * H + unit;
      const float* src = xgd + ((size_t)pos * B + r) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = row[i] >= 0 ? __ldg(src + q * H) : 0.0f;
      if (row[i] >= 0) {
        if (has_prev) cpv[i] = to_f32(cs[((size_t)ppos * B + r) * H + unit]);
        for (int k = 0; k < dy.n; ++k)
          dyv[i] += to_f32(static_cast<const T*>(d ? dy.b[k] : dy.f[k])[at]);
      }
    }
  };
  if (T_steps > 0) load_step(d ? 0 : T_steps - 1);

  for (int s = 0; s < T_steps; ++s) {
    const int pos = d ? s : T_steps - 1 - s;
    // the tile's h_prev, widened to f32 (hp_s is free: the last step's
    // partials were read before its final cluster barrier)
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      store_chunk(hp_s + (threadIdx.x + m * blockDim.x) * V, hr[m], T());
    float acc[R][4], cprev[R], dyt[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = xv[i][q];
      cprev[i] = cpv[i];
      dyt[i] = dyv[i];
    }
    __syncthreads();  // hp_s complete
    if (s + 1 < T_steps) load_step(d ? pos + 1 : pos - 1);

    accumulate<R, float>(acc, hp_s + (size_t)rg * R * H, H, w_s, WS, H, ul);
    float keep[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ig = sigmoidf_(acc[i][0]);
      const float fg = sigmoidf_(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoidf_(acc[i][3]);
      const float c_new = fg * cprev[i] + ig * gg;
      const float dht = dh[i] + dyt[i];
      const float tc = tanhf(c_new);
      const float dct = dc[i] + dht * og * (1.0f - tc * tc);
      const bool m = pos < len[i];
      float g4[4];
      g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
      g4[1] = m ? dct * cprev[i] * fg * (1.0f - fg) : 0.0f;
      g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
      g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
      dc[i] = m ? dct * fg : dc[i];
      keep[i] = m ? 0.0f : dht;
      if (row[i] >= 0) {
        float* dst = dgd + ((size_t)pos * B + row[i]) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q * H] = g4[q];
      }
      *reinterpret_cast<float4*>(dg_s + (size_t)(rg * R + i) * U4 + 4 * ul) =
          make_float4(to_f32(from_f32<T>(g4[0])), to_f32(from_f32<T>(g4[1])),
                      to_f32(from_f32<T>(g4[2])), to_f32(from_f32<T>(g4[3])));
    }
    __syncthreads();  // dg_s complete; hp_s free for the partial dh

    // partial dh over all H units from this block's gate columns:
    // thread k, rows in kWideCluster chunks of R
    {
      const int k = threadIdx.x;
      const float* wk = w_s + (size_t)k * WS;
#pragma unroll 1
      for (int ch = 0; ch < kWideCluster; ++ch) {
        float p[R];
#pragma unroll
        for (int i = 0; i < R; ++i) p[i] = 0.0f;
        const float* g = dg_s + (size_t)ch * R * U4;
#pragma unroll 2
        for (int c = 0; c < U4; c += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wk + c);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 gv = *reinterpret_cast<const float4*>(g + (size_t)i * U4 + c);
            p[i] = fmaf(gv.w, wv.w, fmaf(gv.z, wv.z, fmaf(gv.y, wv.y, fmaf(gv.x, wv.x, p[i]))));
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) hp_s[(size_t)(ch * R + i) * H + k] = p[i];
      }
    }
    cluster.sync();  // every block's partial is complete
    {
      float sum[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sum[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < kWideCluster; ++k) {
        const float* src = cluster.map_shared_rank(hp_s, k) + (size_t)rg * R * H + unit;
#pragma unroll
        for (int i = 0; i < R; ++i) sum[i] += src[(size_t)i * H];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) dh[i] = sum[i] + keep[i];
    }
    cluster_sync_relaxed();  // every block is done reading the partials
  }
}

}  // namespace

extern "C" {

int bilstm_bwd_lite_cluster() { return kWideCluster; }
int bilstm_bwd_lite_max_threads() { return kWideMaxThreads; }
int bilstm_bwd_lite_rows_mask() { return kWideRowsMask; }
int bilstm_bwd_lite_pad() { return kPad; }

const char* bilstm_bwd_lite_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: float32, 1: bfloat16; rows_per_thread one of kWideRows; xg
// (2, T, B, 4H) f32; w_hh (2, G, 4H, H); hs_f, hs_b, cs_f, cs_b and the dy
// streams (T, B, H) in the dtype (dy*1 may be null, ny = 0-2 streams per
// direction); dhn / dcn (2, B, H) f32 or null (zero); dgates (2, T, B, 4H)
// f32. H % 32 == 0, H <= kWideMaxThreads; `tiles` as for bilstm_fwd_wide.
// With max_clusters non-null, nothing is launched (see bilstm_fwd_wide).
// Returns a cudaError_t (0 on success).
int bilstm_bwd_lite(int dtype, int rows_per_thread, const void* xg, const void* lengths,
                    const void* w_hh, const void* hs_f, const void* hs_b, const void* cs_f,
                    const void* cs_b, const void* dyf0, const void* dyf1, const void* dyb0,
                    const void* dyb1, int ny, const void* dhn, const void* dcn, void* dgates,
                    int T_steps, int B, int H, int G, int tiles, int smem, void* stream,
                    int* max_clusters) {
  const Streams2 dy{{dyf0, dyf1}, {dyb0, dyb1}, ny};
  return dispatch_wide(dtype, rows_per_thread, H, [&](auto r, auto t, auto n) -> int {
    using T = decltype(t);
    return launch_wide(bilstm_bwd_lite_kernel<decltype(r)::value, T, decltype(n)::value>, tiles, H,
                       smem, static_cast<cudaStream_t>(stream), max_clusters,
                       static_cast<const float*>(xg), static_cast<const int*>(lengths),
                       static_cast<const T*>(w_hh), static_cast<const T*>(hs_f),
                       static_cast<const T*>(hs_b), static_cast<const T*>(cs_f),
                       static_cast<const T*>(cs_b), dy, static_cast<const float*>(dhn),
                       static_cast<const float*>(dcn), static_cast<float*>(dgates), T_steps, B,
                       H, G);
  });
}

}  // extern "C"
