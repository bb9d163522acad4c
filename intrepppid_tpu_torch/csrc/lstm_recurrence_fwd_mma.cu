// Masked LSTM recurrence over precomputed, time-major input gates, bf16
// compute dtype, H = 32 and 64: the tensor-core variant, hand-written for
// Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_fwd_f32.cu (f32 at these widths) and
// lstm_recurrence_fwd.cu (the cluster kernel, reached by name only), the
// TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _fwd_kernel (via _fwd_pallas, :145)
// behind the public op fused_lstm_recurrence, at the widths of the
// manuscript model's recurrence backend.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_fwd): for each
// direction d (the caller has already flipped the reverse direction in time,
// so every direction walks s = 0 .. T-1) and row r, step s computes
//   gates = xg[s, d, r] + bf16(h) @ w[d, g]
// (xg f32, gate order i, f, g, o; w (D, G, H, 4H) bf16; g = r / (B / G),
// the row's weight group; sums in f32), then the cell update. The state
// moves iff valid[s, d, r] != 0: the mask is data and may have holes.
// Every step writes the (possibly frozen) h and c, unrounded, to
// hs[s, d, r] and cs[s, d, r] (f32), and the last state to hn / cn.
//
// What bounds it on an H100: the roofline bound is bytes, the f32 streams
// (xg in, hs and cs out: 24 H bytes per row and step, 0.55 ms at the
// recurrence backend's step, 400 rows x 2 directions x T = 1500, H = 64);
// the 8 H^2 operations per row and step are a few microseconds on the
// tensor cores. What governs is the serial chain of a step, T times: one
// ldmatrix of h per 32 of K, a short mma chain, the cell's transcendentals,
// one shared-memory store of the new h and one block barrier; and what the
// step reads from device memory, which must be in flight far enough ahead
// that its latency stays off that chain: a mask byte loaded into a
// register one step ahead put a memory latency on every step and about
// doubled the step's time, and each stage the ring holds beyond three
// shortened it further.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes; this is
// the gate product of the tensor-core sweep lstm_recurrence_bwd_mma.cu
// without its second product, and the schedule of bilstm_fwd_mma.cu):
//   * ONE block per (8-row tile, direction), no cluster; each weight group
//     is cut into its own 8-row tiles (tile_row): 50 tiles x 2 directions at
//     400 rows in 5 groups, one wave on 132 SMs;
//   * the swapped product gates^T (4H x 8) = w[d, g]^T . bf16(h)^T on
//     mma.sync m16n8k16 with the gate rows permuted, so lane (g, t) of warp
//     w holds the four gates of unit 8w + g for rows 2t and 2t + 1: the
//     cell maths runs on the accumulators, with no exchange;
//   * w[d, g] stays resident on chip for the whole sweep as the warps' A
//     fragments in registers (4H x H bf16: 32 registers a thread at
//     H = 64), read once from global memory in the permuted order; a step
//     loads only the 8-row bf16 h tile, one ldmatrix per 32 of K;
//   * the new h, rounded to bf16, goes into a double-buffered shared tile,
//     the next step's B operand: ONE __syncthreads a step;
//   * the step's xg tile (8 rows x 4H f32) and its 8 mask bytes (the two
//     aligned 16-byte chunks that hold them) arrive through a five-stage
//     cp.async ring, four steps ahead (44 KB of static shared memory at
//     H = 64); xg goes straight into the accumulators;
//   * hs and cs leave from the accumulator lanes: for each of its rows a
//     warp stores 8 consecutive units, whole 32-byte sectors.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kStages = 5;  // xg tiles in flight: this step's and four ahead
constexpr int kMaxH = 64;
constexpr int kWPad = 8;    // bf16 elements of padding on each h tile row
constexpr int kFPad = 4;    // f32 elements of padding on each xg tile row

struct Args {
  const float* xg;
  const uint8_t* valid;
  const bf16* w;
  float* hs;
  float* cs;
  float* hn;
  float* cn;
  int T, B, G;
};

// 16 bytes global -> shared, asynchronously, of which the first n (0-16)
// are read and the rest zero (src must be a mapped address, 16-byte aligned).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ uint32_t pair_bf16(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// grid (tiles, D), block 4H threads: one warp per 8 hidden units.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) lstm_recurrence_fwd_mma_kernel(const Args a) {
  constexpr int H4 = 4 * H, NK = H / 16, kThreads = 4 * H;
  constexpr int XS = H4 + kFPad;  // xg tile row stride (f32)
  constexpr int HS = H + kWPad;   // h tile row stride (bf16)
  // the xg tile is 8 x 4H floats: 2 x 4H chunks of 16 bytes, two a thread
  constexpr int kChunks = 2, kRowChunks = H4 / 4;
  static_assert(H % 32 == 0 && H <= kMaxH, "unsupported width");
  const int tile = blockIdx.x, d = blockIdx.y, D = gridDim.y;
  const int T = a.T, B = a.B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix index
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;
  const ptrdiff_t step_rows = (ptrdiff_t)D * B;  // rows between consecutive steps

  __shared__ __align__(16) float xg_s[kStages][kMmaTile][XS];
  __shared__ __align__(16) bf16 h_s[2][kMmaTile][HS];
  // the tile's mask bytes of each stage: the aligned 32 bytes around them
  __shared__ __align__(16) uint8_t v_s[kStages][32];

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
    c_dst[m] = smem_u32(&xg_s[0][n][col]);
  }
  constexpr uint32_t kStageBytes = kMmaTile * XS * 4;
  // the mask chunks: threads 0 and 1 copy the aligned 16-byte chunks at
  // (v_at & ~15) and 16 past it, v_at the tile's first mask byte of the
  // step; bytes past the mask's end are zero
  const size_t v_size = (size_t)T * D * B;
  size_t v_at = (size_t)d * B + row0;
  const uint32_t v_dst = smem_u32(&v_s[0][0]) + 16 * tid;
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

  // the weights' A fragments: m16 tile mt of warp w is permuted rows
  // 32w + 16mt .. +15, i.e. gates 2mt (rows g) and 2mt + 1 (rows g + 8) of
  // unit 8w + g; k-step ks covers inputs [16ks, 16ks + 16). w[d, group] is
  // (H, 4H): input k of gate column j at k * 4H + j
  uint32_t wa[NK][2][4];
  {
    const bf16* wd = a.w + ((size_t)d * a.G + group) * H * H4;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = 16 * ks + 2 * t;
        const bf16* lo = wd + (size_t)k * H4 + 2 * mt * H + unit;  // gate 2mt
        const bf16* hi = lo + H;                                    // gate 2mt + 1
        wa[ks][mt][0] = pair_bf16(lo, lo + H4);
        wa[ks][mt][1] = pair_bf16(hi, hi + H4);
        wa[ks][mt][2] = pair_bf16(lo + 8 * H4, lo + 9 * H4);
        wa[ks][mt][3] = pair_bf16(hi + 8 * H4, hi + 9 * H4);
      }
    }
  }

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

  // h before the first step is zero
  for (int idx = tid; idx < kMmaTile * HS; idx += kThreads)
    (&h_s[0][0][0])[idx] = __float2bfloat16_rn(0.0f);
  cp_async_wait<kStages - 2>();
  __syncthreads();

  const uint32_t b_lane = (uint32_t)((lr * HS + 8 * lm) * 2);
  const int x_at = 2 * t * XS + unit;
  int stage = 0;
  for (int s = 0; s < T; ++s) {
    if (s + kStages - 1 < T) fetch();
    cp_async_commit();
    const int buf = s & 1;
    const float* xs = &xg_s[stage][0][0] + x_at;
    const uint8_t* vs = &v_s[stage][0] + (v_read & 15) + 2 * t;
    const bool on[2] = {rown[0] >= 0 && vs[0] != 0, rown[1] >= 0 && vs[1] != 0};
    v_read += step_rows;
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // gates^T: acc[mt][chain]: mt 0 rows = gates i | f, mt 1 = g | o, of
    // units 8w..8w+7; two chains over alternate k-steps, xg in chain 0
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[mt][0][i] = xs[i * XS + (2 * mt) * H];
        acc[mt][0][2 + i] = xs[i * XS + (2 * mt + 1) * H];
        acc[mt][1][i] = 0.0f;
        acc[mt][1][2 + i] = 0.0f;
      }
    }
    const uint32_t b_step = smem_u32(&h_s[buf][0][0]) + b_lane;
#pragma unroll
    for (int kp = 0; kp < NK / 2; ++kp) {
      uint32_t b[4];
      ldmatrix_x4(b, b_step + (uint32_t)(kp * 64));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][0], wa[2 * kp][mt], b[0], b[1]);
        mma_bf16(acc[mt][1], wa[2 * kp + 1][mt], b[2], b[3]);
      }
    }

    bf16* h_next = &h_s[buf ^ 1][0][0] + 2 * t * HS + unit;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + acc[0][1][i]);
      const float fg = fast_sigmoid(acc[0][0][2 + i] + acc[0][1][2 + i]);
      const float gg = fast_tanh(acc[1][0][i] + acc[1][1][i]);
      const float og = fast_sigmoid(acc[1][0][2 + i] + acc[1][1][2 + i]);
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * fast_tanh(c_new);
      if (on[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      h_next[i * HS] = __float2bfloat16_rn(h[i]);
      if (rown[i] >= 0) {
        a.hs[out_at[i]] = h[i];
        a.cs[out_at[i]] = c[i];
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
int launch(const Args& a, int D, int tiles, cudaStream_t stream) {
  lstm_recurrence_fwd_mma_kernel<H><<<dim3(tiles, D), 4 * H, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_recurrence_fwd_mma_tile() { return kMmaTile; }
int lstm_recurrence_fwd_mma_stages() { return kStages; }
int lstm_recurrence_fwd_mma_max_h() { return kMaxH; }
int lstm_recurrence_fwd_mma_w_pad() { return kWPad; }
int lstm_recurrence_fwd_mma_f_pad() { return kFPad; }

const char* lstm_recurrence_fwd_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16 (w's type and the rounding of h). xg
// (T, D, B, 4H) f32; valid (T, D, B) uint8; w (D, G, H, 4H) bf16; hs, cs
// (T, D, B, H) and hn, cn (D, B, H) f32; valid 16-byte aligned (the kernel
// copies its aligned chunks). H is 32 or 64 (kMaxH); each of the
// G weight groups (B / G rows) is cut into its own 8-row tiles: `tiles` =
// G * ceil(B / G / 8). T >= 1 and B >= 1 (the wrapper launches nothing
// otherwise). Returns a cudaError_t (0 on success).
int lstm_recurrence_fwd_mma(const void* xg, const void* valid, const void* w, void* hs, void* cs,
                            void* hn, void* cn, int D, int T_steps, int B, int H, int G,
                            int tiles, void* stream) {
  if (G <= 0 || B <= 0 || B % G || T_steps <= 0 || D <= 0 || tiles <= 0 ||
      reinterpret_cast<uintptr_t>(valid) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
               static_cast<const bf16*>(w), static_cast<float*>(hs),
               static_cast<float*>(cs), static_cast<float*>(hn),
               static_cast<float*>(cn), T_steps, B, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch<64>(a, D, tiles, st);
  if (H == 32) return launch<32>(a, D, tiles, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
