// Backward sweep of the masked LSTM recurrence over precomputed, time-major
// input gates, hand-written for Hopper (sm_90a).
//
// Replaces, with lstm_recurrence_wgrad.cu after it (the dW sums), the TPU
// kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence.
//
// Function: block (row tile, direction d) walks s = T-1 .. 0 carrying dh and
// dc (f32, from dhn / dcn). Per step and row r:
//   * gates = xg[s, d, r] + round(h_prev) @ w[d, g], h_prev = hs[s-1, d, r]
//     and c_prev = cs[s-1, d, r] (both f32, zero at s = 0; c_prev is used
//     unrounded); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates (f32) by the rules of lstm_pallas.py:210-228: a step with
//     valid[s, d, r] == 0 gets dgates = 0 and passes dh and dc through;
//     dxg[s, d, r] = dgates, unrounded;
//   * dh = round(dgates) @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
// round() is to the compute dtype (w's). dW is formed from hs and dxg by
// lstm_recurrence_wgrad.cu: the TPU kernel sums it in VMEM scratch across
// its sequential time grid, which parallel row tiles cannot share.
//
// What bounds it on an H100: serial in T, 2 * 4H * H multiply-adds per row
// and step on CUDA cores (gate recompute and dh) against 44 H bytes of f32
// streams (xg, hs, cs, dhs in, dxg out): operations from H = 64 up, bytes
// at H = 32.
//
// Design: the cluster split of bilstm_fwd_wide.cu, at every width: a
// cluster of 8 blocks per (row tile, direction), block k owning hidden
// units [k H/8, (k+1) H/8) with its 4H/8 gate columns of w resident in f32,
// laid out [k][unit*4 + gate] with rows padded by kPad elements; each
// thread owns one unit for R rows. Per step the block stages the tile's
// whole h_prev (rounded) from hs, recomputes its gate columns, forms its
// units' dgates, then a partial dh over all H units from its own gate
// columns; cluster.sync(); each block sums its units' partials from the 8
// blocks in rank order through distributed shared memory (so the result
// does not depend on timing); a relaxed cluster barrier follows. The next
// step's h_prev tile, input gates, c_prev, dhs and mask bytes are loaded
// into registers while the current step computes. All streams are addressed
// in the op's own (T, D, B, .) layout: no transposed copy.
// Widths it keeps: H = 96 to 288 in either compute dtype (a one-layer
// model at embedding 128 on the recurrence backend); H = 32 and 64 go to
// the single-block tensor-core sweeps, lstm_recurrence_bwd_mma.cu (bf16)
// and lstm_recurrence_bwd_f32.cu (f32)
// (ops/lstm_cuda.py:recurrence_sweep_kernel). Up to H = 256 blocks
// instantiated for 256 threads (255 registers a thread); H = 257 to 288 a
// second instance for 288-thread blocks (224 registers), whose padded f32
// slice (167 KB at 288), h tile and gate tile still fit shared memory. Past
// 288 they do not (about 240 KB at 320): the op takes the tensor-core
// sweeps there (lstm_recurrence_bwd_wide_mma.cu, lstm_recurrence_bwd_wide_f32.cu).

#include <cooperative_groups.h>

#include "bilstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bilstm;

constexpr int kPad = 4;  // shared-memory weight row padding (elements)

// grid (tiles * kWideCluster, D) in clusters of kWideCluster, block H
// threads (H <= kThreads); row tile BR = kWideCluster * R. dhs, dhn, dcn may
// be null (zero).
template <int R, typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_bwd_kernel(const float* __restrict__ xg, const uint8_t* __restrict__ valid,
                           const T* __restrict__ w, const float* __restrict__ hs,
                           const float* __restrict__ cs, const float* __restrict__ dhs,
                           const float* __restrict__ dhn, const float* __restrict__ dcn,
                           float* __restrict__ dxg, int T_steps, int B, int H, int G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kWideCluster;
  const int d = blockIdx.y;
  const int D = gridDim.y;
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
  float* w_s = reinterpret_cast<float*>(smem);  // [H][WS], [unit*4 + gate]: w[d, group]'s slice
  const T* wd = w + ((size_t)d * G + group) * H * H4;
  for (int idx = threadIdx.x; idx < H * U4; idx += blockDim.x) {
    const int k = idx / U4, lc = idx - k * U4;
    const int q = lc / U, u = lc - q * U;
    w_s[(size_t)k * WS + u * 4 + q] = to_f32(wd[(size_t)k * H4 + q * H + rank * U + u]);
  }
  float* hp_s = w_s + (size_t)H * WS;  // [BR][H]: h_prev, then the partial dh
  float* dg_s = hp_s + (size_t)BR * H;  // [BR][4U], [unit*4 + gate]

  int row[R];
  float dh[R], dc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = tile_row(tile, rg * R + i, BR, Bg);
    const size_t at = ((size_t)d * B + (row[i] >= 0 ? row[i] : 0)) * H + unit;
    dh[i] = (row[i] >= 0 && dhn) ? dhn[at] : 0.0f;
    dc[i] = (row[i] >= 0 && dcn) ? dcn[at] : 0.0f;
  }

  // The next step's operands, loaded into registers while this step
  // computes: the tile's h_prev (16-byte chunks, kChunks per thread: H
  // threads move BR * H f32 values) and this thread's input gates, c_prev,
  // dhs and mask byte.
  constexpr int kChunks = kWideCluster * R / 4;
  float4 hr[kChunks];
  float xv[R][4], cpv[R], dyv[R];
  uint8_t vv[R];
  auto load_step = [&](int s) {
    const size_t base = ((size_t)s * D + d) * B;
    const size_t pbase = ((size_t)(s - 1) * D + d) * B;  // used only when s > 0
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int elem = (threadIdx.x + m * blockDim.x) * 4;
      const int rl = elem / H;
      const int r = tile_row(tile, rl, BR, Bg);
      hr[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r >= 0 && s > 0)
        hr[m] = __ldg(reinterpret_cast<const float4*>(hs + (pbase + r) * H + elem - rl * H));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      cpv[i] = 0.0f;
      dyv[i] = 0.0f;
      vv[i] = 0;
      const int r = row[i] >= 0 ? row[i] : 0;
      const float* src = xg + (base + r) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = row[i] >= 0 ? __ldg(src + q * H) : 0.0f;
      if (row[i] >= 0) {
        vv[i] = __ldg(valid + base + r);
        if (s > 0) cpv[i] = __ldg(cs + (pbase + r) * H + unit);
        if (dhs) dyv[i] = __ldg(dhs + (base + r) * H + unit);
      }
    }
  };
  if (T_steps > 0) load_step(T_steps - 1);

  for (int s = T_steps - 1; s >= 0; --s) {
    // the tile's h_prev, rounded to the compute dtype (hp_s is free: the
    // last step's partials were read before its final cluster barrier)
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      *reinterpret_cast<float4*>(hp_s + (threadIdx.x + m * blockDim.x) * 4) =
          make_float4(round_to<T>(hr[m].x), round_to<T>(hr[m].y), round_to<T>(hr[m].z),
                      round_to<T>(hr[m].w));
    float acc[R][4], cprev[R], dyt[R];
    bool on[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = xv[i][q];
      cprev[i] = cpv[i];
      dyt[i] = dyv[i];
      on[i] = vv[i] != 0;
    }
    __syncthreads();  // hp_s complete
    if (s > 0) load_step(s - 1);

    accumulate<R, float>(acc, hp_s + (size_t)rg * R * H, H, w_s, WS, H, ul);
    float keep[R];
    const size_t base = ((size_t)s * D + d) * B;
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
      const bool m = on[i];
      float g4[4];
      g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
      g4[1] = m ? dct * cprev[i] * fg * (1.0f - fg) : 0.0f;
      g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
      g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
      dc[i] = m ? dct * fg : dc[i];
      keep[i] = m ? 0.0f : dht;
      if (row[i] >= 0) {
        float* dst = dxg + (base + row[i]) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q * H] = g4[q];
      }
      *reinterpret_cast<float4*>(dg_s + (size_t)(rg * R + i) * U4 + 4 * ul) =
          make_float4(round_to<T>(g4[0]), round_to<T>(g4[1]), round_to<T>(g4[2]),
                      round_to<T>(g4[3]));
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

int lstm_recurrence_bwd_cluster() { return kWideCluster; }
int lstm_recurrence_bwd_max_threads() { return kWideMaxThreads; }
int lstm_recurrence_bwd_max_h() { return kWideMaxThreads; }
int lstm_recurrence_bwd_rows_mask() { return kWideRowsMask; }
int lstm_recurrence_bwd_pad() { return kPad; }

const char* lstm_recurrence_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: float32, 1: bfloat16 (the compute dtype: w's type and the
// rounding of h_prev and dgates); rows_per_thread one of kWideRows; xg
// (T, D, B, 4H) f32; valid (T, D, B) uint8; w (D, G, H, 4H); hs, cs, dhs
// (T, D, B, H) f32 (dhs may be null: zero); dhn / dcn (D, B, H) f32 or null
// (zero); dxg (T, D, B, 4H) f32. H % 32 == 0, H <= kWideMaxThreads; `tiles`
// as for lstm_recurrence_fwd. With max_clusters non-null, nothing is
// launched (see lstm_recurrence_fwd). Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd(int dtype, int rows_per_thread, const void* xg, const void* valid,
                        const void* w, const void* hs, const void* cs,
                        const void* dhs, const void* dhn, const void* dcn, void* dxg, int D,
                        int T_steps, int B, int H, int G, int tiles, int smem, void* stream,
                        int* max_clusters) {
  return dispatch_wide(dtype, rows_per_thread, H, [&](auto r, auto t, auto n) -> int {
    using T = decltype(t);
    return launch_wide_dirs(lstm_recurrence_bwd_kernel<decltype(r)::value, T, decltype(n)::value>,
                            tiles, D, H, smem, static_cast<cudaStream_t>(stream), max_clusters,
                            static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
                            static_cast<const T*>(w), static_cast<const float*>(hs),
                            static_cast<const float*>(cs), static_cast<const float*>(dhs),
                            static_cast<const float*>(dhn), static_cast<const float*>(dcn),
                            static_cast<float*>(dxg), T_steps, B, H, G);
  });
}

}  // extern "C"
