// Masked LSTM recurrence over precomputed, time-major input gates, f32
// compute dtype, H = 32 and 64: the tensor-core variant in three tf32
// passes, hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_fwd_mma.cu (bf16 at these widths) and
// lstm_recurrence_fwd.cu (the CUDA-core cluster kernel, reached by name
// only), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, for compute dtype float32 at
// the widths of the manuscript model's recurrence backend.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd with the
// compute dtype f32, where round() is the identity): for each direction d
// (the caller has already flipped the reverse direction in time, so every
// direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + h @ w[d, g]
// (xg f32, gate order i, f, g, o; w (D, G, H, 4H) f32; g = r / (B / G), the
// row's weight group), then the cell update. The state moves iff
// valid[s, d, r] != 0: the mask is data and may have holes. Every step
// writes the (possibly frozen) h and c to hs[s, d, r] and cs[s, d, r], and
// the last state to hn / cn, all f32.
//
// What bounds it on an H100: the roofline bound is bytes, the f32 streams
// (xg in, hs and cs out: 24 H bytes per row and step, 0.55 ms at the
// recurrence backend's step, 400 rows x 2 directions x T = 1500, H = 64);
// the 8 H^2 operations per row and step in three tf32 passes take about
// half that at 495/3 TFLOP/s. What governs is the serial chain of a step,
// T times. One tf32 pass keeps ~3 decimal digits, which misses the f32
// agreement (1e-4 x max(1, max|ref|)) by 3-4 x, so the product is
// big.big + big.small + small.big (split_tf32, bilstm_mma.cuh): ~20 bits.
//
// Design: the schedule of the bf16 forward lstm_recurrence_fwd_mma.cu in
// three tf32 passes:
//   * ONE block per (8-row tile, direction), no cluster, one warp per 8
//     hidden units; each weight group is cut into its own 8-row tiles
//     (tile_row): 50 tiles x 2 directions at 400 rows in 5 groups, one wave
//     on 132 SMs;
//   * w[d, g] (4H x H f32) stays resident for the whole sweep as the warps'
//     tf32 A fragments in registers, read once from global memory in the
//     gate-row-permuted order (bilstm_mma.cuh) and PRE-SPLIT into big and
//     small parts: 2 H registers a thread (128 at H = 64), so a step reads
//     no weight from shared memory and splits none (a pre-split copy in
//     shared memory, as the f32 sweep lstm_recurrence_bwd_f32.cu holds it,
//     is 128 KB read every step: 1.84 ms a call at H = 64 against the
//     cluster forward's 4.76 on an NVIDIA H100 80GB HBM3 at 700 W,
//     chip_smoke.py, PERF.md);
//   * the swapped product gates^T (4H x 8) = W . h^T on mma.sync m16n8k8
//     tf32, so lane (g, t) of warp w holds the four gates of unit 8w + g
//     for rows 2t and 2t + 1 and the cell needs no exchange; the K order
//     within a k8 step is taken in pairs (lane t holds inputs 2t, 2t + 1 as
//     logical k t and t + 4), so B is one float2 of the h tile a k8 step,
//     conflict-free; only the 8-row f32 h tile is split in the loop, and
//     the three passes accumulate apart (six chains);
//   * the new h (f32) goes into a double-buffered shared tile, the next
//     step's B operand: ONE __syncthreads a step;
//   * the step's xg tile (8 rows x 4H f32) and its 8 mask bytes (the two
//     aligned 16-byte chunks that hold them) arrive through a five-stage
//     cp.async ring, four steps ahead; a memory read not in flight that far
//     ahead puts its latency on every step's chain (PERF.md: 1.69 -> 0.81 ms
//     in bf16); xg goes straight into the accumulators;
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh);
//   * shared memory 46,368 bytes at H = 64 (ring 41,760, h tiles 4,608);
//     the registers hold one block an SM.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kStages = 5;  // xg tiles in flight: this step's and four ahead
constexpr int kMaxH = 64;
constexpr int kWPad = 8;    // f32 elements: h tile rows, 8 (mod 32)
constexpr int kFPad = 4;    // f32 elements: xg tile rows, 4 (mod 32)

struct Args {
  const float* xg;
  const uint8_t* valid;
  const float* w;
  float* hs;
  float* cs;
  float* hn;
  float* cn;
  int T, B, G;
};

// Dynamic shared memory at H (bytes), in layout order: two h tiles, the xg
// ring and the mask ring.
__host__ __device__ constexpr int smem_bytes(int H) {
  return 4 * (2 * kMmaTile * (H + kWPad) + kStages * kMmaTile * (4 * H + kFPad)) + kStages * 32;
}

// 16 bytes global -> shared, asynchronously, of which the first n (0-16)
// are read and the rest zero (src must be a mapped address, 16-byte aligned).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// grid (tiles, D), block 4H threads: one warp per 8 hidden units.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) lstm_recurrence_fwd_f32_kernel(const Args a) {
  constexpr int H4 = 4 * H, kThreads = 4 * H;
  constexpr int PS = H + kWPad;   // h tile row stride (f32), 8 (mod 32)
  constexpr int KK = H / 8;       // k8 steps of the inputs
  constexpr int XS = H4 + kFPad;  // xg tile row stride (f32), 4 (mod 32)
  // the xg tile is 8 x 4H floats: 2 x 4H chunks of 16 bytes, two a thread
  constexpr int kChunks = 2, kRowChunks = H4 / 4;
  static_assert(H % 32 == 0 && H <= kMaxH, "unsupported width");
  const int tile = blockIdx.x, d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;
  const ptrdiff_t step_rows = (ptrdiff_t)D * B;  // rows between consecutive steps

  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [2][8][PS]
  float* xg_s = h_s + 2 * kMmaTile * PS;         // [kStages][8][XS]
  // the tile's mask bytes of each stage: the aligned 32 bytes around them
  uint8_t* v_s = reinterpret_cast<uint8_t*>(xg_s + kStages * kMmaTile * XS);

  // the xg chunks: each thread walks the source address of its two chunks
  // one step per fetch
  const float* c_src[kChunks];
  uint32_t c_dst[kChunks];
  bool c_real[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int idx = tid + m * kThreads;
    const int n = idx / kRowChunks, col = (idx - n * kRowChunks) * 4;
    c_real[m] = n < nrows;
    c_src[m] = a.xg + ((size_t)d * B + row0 + (c_real[m] ? n : 0)) * H4 + col;
    c_dst[m] = smem_u32(xg_s + n * XS + col);
  }
  constexpr uint32_t kStageBytes = kMmaTile * XS * 4;
  // the mask chunks: threads 0 and 1 copy the aligned 16-byte chunks at
  // (v_at & ~15) and 16 past it, v_at the tile's first mask byte of the
  // step; bytes past the mask's end are zero
  const size_t v_size = (size_t)T * D * B;
  size_t v_at = (size_t)d * B + row0;
  const uint32_t v_dst = smem_u32(v_s) + 16 * tid;
  int fetch_stage = 0;
  auto fetch = [&]() {
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      cp_async16(c_dst[m] + fetch_stage * kStageBytes, c_real[m] ? c_src[m] : a.xg, c_real[m]);
      c_src[m] += step_rows * H4;
    }
    if (tid < 2) {
      const size_t at = (v_at & ~(size_t)15) + 16 * tid;
      const int n = at >= v_size ? 0 : v_size - at < 16 ? (int)(v_size - at) : 16;
      cp_async16_n(v_dst + fetch_stage * 32, n > 0 ? a.valid + at : a.valid, n);
    }
    v_at += step_rows;
    fetch_stage = fetch_stage == kStages - 1 ? 0 : fetch_stage + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) fetch();
    cp_async_commit();
  }

  // the weights' A fragments, split, while the ring's first tiles are in
  // flight: m16 tile mt of warp w is permuted rows 32w + 16mt .. +15, i.e.
  // gates 2mt (rows g) and 2mt + 1 (rows g + 8) of unit 8w + g; k8 step kk
  // holds inputs 8kk + 2t (logical k t) and 8kk + 2t + 1 (k t + 4). w[d,
  // group] is (H, 4H): input k of gate column j at k * 4H + j
  uint32_t ab[KK][2][4], as[KK][2][4];
  {
    const float* wd = a.w + ((size_t)d * a.G + group) * H * H4;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = 2 * mt * H + (v & 1) * H + unit;  // gate 2mt (+1) of the unit
          const int k = 8 * kk + 2 * t + (v >> 1);
          split_tf32(__ldg(wd + (size_t)k * H4 + row), ab[kk][mt][v], as[kk][mt][v]);
        }
      }
    }
  }
  // h before the first step is zero
  for (int idx = tid; idx < kMmaTile * PS; idx += kThreads) h_s[idx] = 0.0f;

  // this lane's rows 2t, 2t + 1: state and output addresses
  int rown[2];
  float h[2] = {0.0f, 0.0f}, c[2] = {0.0f, 0.0f};
  size_t out_at[2];  // this row's and unit's element of hs / cs at step s
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * t + i;
    rown[i] = n < nrows ? row0 + n : -1;
    out_at[i] = ((size_t)d * B + (rown[i] >= 0 ? rown[i] : 0)) * H + unit;
  }
  size_t v_read = (size_t)d * B + row0;  // the tile's first mask byte at step s

  // B: the h tile row g, inputs 8kk + 2t and 8kk + 2t + 1
  const int x_at = 2 * t * XS + unit, p_at = g * PS + 2 * t;

  cp_async_wait<kStages - 2>();
  __syncthreads();  // the zero h tile and the first xg tile are in

  int stage = 0;
  for (int s = 0; s < T; ++s) {
    if (s + kStages - 1 < T) fetch();
    cp_async_commit();
    const int buf = s & 1;
    const float* xs = xg_s + stage * kMmaTile * XS + x_at;
    const uint8_t* vs = v_s + stage * 32 + (v_read & 15) + 2 * t;
    const bool on[2] = {rown[0] >= 0 && vs[0] != 0, rown[1] >= 0 && vs[1] != 0};
    v_read += step_rows;
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // gates^T: acc[pass][mt]: mt 0 rows = gates i | f, mt 1 = g | o, of
    // units 8w..8w+7; pass 0 sums big.big (from xg), passes 1 and 2 the
    // cross terms
    float acc[3][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[0][mt][i] = xs[i * XS + (2 * mt) * H];
        acc[0][mt][2 + i] = xs[i * XS + (2 * mt + 1) * H];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[1][mt][v] = acc[2][mt][v] = 0.0f;
    }
    const float* hp = h_s + buf * kMmaTile * PS + p_at;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float2 bv = *reinterpret_cast<const float2*>(hp + 8 * kk);
      uint32_t bb[2], bs[2];
      split_tf32(bv.x, bb[0], bs[0]);
      split_tf32(bv.y, bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[0][mt], ab[kk][mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[1][mt], as[kk][mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[2][mt], ab[kk][mt], bs[0], bs[1]);
    }

    float* h_next = h_s + (buf ^ 1) * kMmaTile * PS + 2 * t * PS + unit;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + (acc[1][0][i] + acc[2][0][i]));
      const float fg = fast_sigmoid(acc[0][0][2 + i] + (acc[1][0][2 + i] + acc[2][0][2 + i]));
      const float gg = fast_tanh(acc[0][1][i] + (acc[1][1][i] + acc[2][1][i]));
      const float og = fast_sigmoid(acc[0][1][2 + i] + (acc[1][1][2 + i] + acc[2][1][2 + i]));
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * fast_tanh(c_new);
      if (on[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      h_next[i * PS] = h[i];
      if (rown[i] >= 0) {
        __stcs(a.hs + out_at[i], h[i]);
        __stcs(a.cs + out_at[i], c[i]);
      }
      out_at[i] += step_rows * H;
    }
    cp_async_wait<kStages - 2>();  // the next step's xg tile has landed
    __syncthreads();  // the next step's h is stored; every warp is past this step's tiles
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rown[i] < 0) continue;
    const size_t at = ((size_t)d * B + rown[i]) * H + unit;
    a.hn[at] = h[i];
    a.cn[at] = c[i];
  }
}

template <int H>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream) {
  if (smem != smem_bytes(H)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_fwd_f32_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_fwd_f32_kernel<H><<<dim3(tiles, D), 4 * H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_recurrence_fwd_f32_tile() { return kMmaTile; }
int lstm_recurrence_fwd_f32_stages() { return kStages; }
int lstm_recurrence_fwd_f32_max_h() { return kMaxH; }
int lstm_recurrence_fwd_f32_w_pad() { return kWPad; }
int lstm_recurrence_fwd_f32_f_pad() { return kFPad; }

const char* lstm_recurrence_fwd_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. xg (T, D, B, 4H) f32; valid (T, D, B)
// uint8, 16-byte aligned (the kernel copies its aligned chunks); w
// (D, G, H, 4H) f32; hs, cs (T, D, B, H) and hn, cn (D, B, H) f32. H is 32
// or 64 (kMaxH); each of the G weight groups (B / G rows) is cut into its
// own 8-row tiles: `tiles` = G * ceil(B / G / 8); `smem` the dynamic
// shared memory, as ops/lstm_cuda.py:recurrence_fwd_f32_smem computes it
// (refused otherwise). T >= 1 and B >= 1 (the wrapper launches nothing
// otherwise). Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd_f32(const void* xg, const void* valid, const void* w, void* hs, void* cs,
                            void* hn, void* cn, int D, int T_steps, int B, int H, int G,
                            int tiles, int smem, void* stream) {
  if (G <= 0 || B <= 0 || B % G || T_steps <= 0 || D <= 0 || tiles <= 0 ||
      reinterpret_cast<uintptr_t>(valid) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
               static_cast<const float*>(w), static_cast<float*>(hs),
               static_cast<float*>(cs), static_cast<float*>(hn),
               static_cast<float*>(cn), T_steps, B, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch<64>(a, D, tiles, smem, st);
  if (H == 32) return launch<32>(a, D, tiles, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
