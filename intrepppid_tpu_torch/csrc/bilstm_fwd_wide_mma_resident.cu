// Bidirectional LSTM layer recurrence over the input gates, bf16 compute
// dtype, at H = 96, where one direction's and one group's W_hh fits one
// block: the tensor-core forward with the weights resident, hand-written for
// Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_wide_mma.cu (bf16 at 128, 256 and 288) and
// bilstm_fwd_wide.cu (the CUDA-core cluster kernel, which keeps f32 at 96
// and both dtypes at 160, 192 and 224), together with the input projection
// (bilstm_gates_mma.cu), the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _fwd_kernel (via _fwd_pallas,
//     :376) -- with_states=False (eval variant) and True (train variant,
//     which also writes the cell streams)
// at H = 96: the stacked layer of the bf16 models at embedding 80 and 72
// (E = 2 x 80 and 2 x 72, run padded at H = 96 on the wide route, one
// weight group).
//
// Function (the contract of ops/lstm.py:bidir_recurrence, as
// bilstm_fwd_wide.cu): for each direction d (0 forward, 1 reverse) and row
// r, step s reads position pos = s (d = 0) or T-1-s (d = 1) and computes
//   gates = xg[d, pos, r] + bf16(h) @ W_hh[d, g]^T
// (xg the f32 input gates from bilstm_gates_mma.cu, the bias in them, gate
// order i, f, g, o; g = r / (B / G), the row's weight group; bf16 operands,
// f32 sums), then the cell update. The state moves iff pos < lengths[r].
// Every position gets the row's (possibly frozen) h in hs_f / hs_b and, in
// the train variant, c in cs_f / cs_b, both bf16; h and c are f32, and the
// final state goes to hn / cn in f32.
//
// What bounds it on an H100: bytes, 0.688 ms (train) and 0.619 (eval) at
// 400 rows, T = 1500 (the f32 xg stream in, the bf16 h and c streams out);
// the product, 4H x H multiply-adds per row and step, is a few microseconds
// on the tensor cores. What governs is the serial chain of a step, T times:
// the gate product's ldmatrix and mma rounds, the cell's transcendentals,
// one shared-memory store of the new h and one block barrier; and the step's
// 12 KB of xg a block, which must be in flight far enough ahead that its
// latency stays off that chain. bilstm_fwd_wide.cu adds two cluster
// barriers and a broadcast of h through distributed shared memory to that
// chain and runs the product on the CUDA cores; at 96 one direction's bf16
// W_hh (384 x 96) fits one block, so neither is needed.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes): the gate
// product of bilstm_bwd_lite_mma_resident.cu without its dh half, on the
// schedule of lstm_recurrence_fwd_mma.cu:
//   * one block per (8-row tile, direction), no cluster; each weight group
//     is cut into its own 8-row tiles (tile_row); one warp per 8 hidden
//     units (12 warps, 384 threads); the stacked layer's 400 rows in one
//     group give 100 blocks, one wave on 132 SMs;
//   * the swapped product gates^T (4H x 8) = W_hh[d, g] . bf16(h)^T on
//     mma.sync m16n8k16 with the gate rows permuted, so lane (g, t) of warp
//     w holds the four gates of unit 8w + g for rows 2t and 2t + 1: the cell
//     runs on the accumulators, with no exchange. The warp's 32 permuted
//     gate rows stay in registers as A fragments for the whole sweep (2 m16
//     tiles x 6 k16 steps x 4 = 48 registers), read once from global memory;
//     W_hh needs no shared-memory copy (there is no dh product);
//   * xg[d, pos] goes straight into the accumulators (the first of two
//     chains over alternate k16 steps);
//   * the new h, rounded to bf16, goes into a double-buffered shared tile,
//     the next step's B operand (one ldmatrix.x4 per 32 of K): ONE
//     __syncthreads a step;
//   * the step's f32 xg tile (8 rows x 4H, 12 KB) arrives through a
//     five-stage cp.async ring, four steps ahead; the rows' lengths sit in
//     registers for the whole sweep;
//   * a tile stops at its longest row: past it the forward direction's
//     state is frozen (its final h and c are written there), and the reverse
//     direction has not started (zeros).
// Shared memory: the two h tiles (8 rows of H + 8 bf16) and the ring's
// stages (8 rows of 4H + 4 f32), 65,408 B at 96 (smem_bytes), dynamic.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kMaxH = 96;               // the one width it is built for
constexpr int kMaxThreads = 4 * kMaxH;  // one warp per 8 units
constexpr int kWPad = 8;                // bf16 elements of padding on each h tile row
constexpr int kFPad = 4;                // f32 elements of padding on each xg tile row
constexpr int kStages = 5;              // xg tiles in flight: this step's and four ahead

struct Args {
  const float* xg;     // (2, T, B, 4H)
  const int* lengths;  // (B,)
  const bf16* w_hh;    // (2, G, 4H, H)
  bf16* hs[2];         // per direction, (T, B, H)
  bf16* cs[2];         // null: the eval variant
  float* hn;           // (2, B, H)
  float* cn;
  int T, B, G;
};

// Dynamic shared memory at H (bytes): the two bf16 h tiles (8 rows of H +
// kWPad), then the ring's f32 xg tiles (8 rows of 4H + kFPad). Both parts
// are multiples of 16 bytes.
__host__ __device__ constexpr int smem_bytes(int H) {
  return 2 * kMmaTile * (H + kWPad) * 2 + kStages * kMmaTile * (4 * H + kFPad) * 4;
}

// grid (tiles, 2), block 4H threads: one warp per 8 hidden units.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) bilstm_fwd_wide_mma_resident_kernel(const Args a) {
  constexpr int H4 = 4 * H, NK = H / 16, kThreads = 4 * H;
  constexpr int XS = H4 + kFPad;  // xg tile row stride (f32)
  constexpr int HS = H + kWPad;   // h tile row stride (bf16)
  // the xg tile is 8 x 4H floats: 8 x 4H / 4 chunks of 16 bytes, two a thread
  constexpr int kChunks = 2, kRowChunks = H4 / 4;
  static_assert(H % 32 == 0 && H <= kMaxH && kMmaTile * kRowChunks == kChunks * kThreads,
                "unsupported width");
  const int tile = blockIdx.x, d = blockIdx.y;
  const int T = a.T, B = a.B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix index
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* h_s = reinterpret_cast<bf16*>(smem);                                  // [2][8][HS]
  float* xg_s = reinterpret_cast<float*>(smem + 2 * kMmaTile * HS * 2);       // [kStages][8][XS]

  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;

  // the xg chunks: each thread walks the source address of its two chunks
  // one position per fetch
  const float* xgd = a.xg + (size_t)d * T * B * H4;
  const float* c_src[kChunks];
  uint32_t c_dst[kChunks];
  bool c_real[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int idx = tid + m * kThreads;
    const int n = idx / kRowChunks, col = (idx - n * kRowChunks) * 4;
    c_real[m] = n < nrows;
    c_src[m] = xgd + ((size_t)max(pos0, 0) * B + row0 + (c_real[m] ? n : 0)) * H4 + col;
    c_dst[m] = smem_u32(xg_s + n * XS + col);
  }
  const ptrdiff_t c_walk = (ptrdiff_t)dpos * B * H4;
  constexpr uint32_t kStageBytes = kMmaTile * XS * 4;
  int fetch_stage = 0;
  auto fetch = [&]() {
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      cp_async16(c_dst[m] + fetch_stage * kStageBytes, c_real[m] ? c_src[m] : a.xg, c_real[m]);
      c_src[m] += c_walk;
    }
    fetch_stage = fetch_stage == kStages - 1 ? 0 : fetch_stage + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < maxlen) fetch();
    cp_async_commit();
  }

  // the weights' A fragments: m16 tile mt of warp w is permuted rows
  // 32w + 16mt .. +15, i.e. gates 2mt (rows g) and 2mt + 1 (rows g + 8) of
  // unit 8w + g; k-step ks covers inputs [16ks, 16ks + 16)
  uint32_t wa[NK][2][4];
  {
    const bf16* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    auto pair = [&](int q, int k) -> uint32_t {
      return *reinterpret_cast<const uint32_t*>(wh + (size_t)(q * H + unit) * H + k);
    };
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = 16 * ks + 2 * t;
        wa[ks][mt][0] = pair(2 * mt, k);
        wa[ks][mt][1] = pair(2 * mt + 1, k);
        wa[ks][mt][2] = pair(2 * mt, k + 8);
        wa[ks][mt][3] = pair(2 * mt + 1, k + 8);
      }
    }
  }

  // this lane's rows 2t, 2t + 1: state and length
  int rown[2], len[2];
  float h[2] = {0.0f, 0.0f}, c[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * t + i;
    rown[i] = n < nrows ? row0 + n : -1;
    len[i] = rown[i] >= 0 ? a.lengths[rown[i]] : 0;
  }
  bf16* hs = a.hs[d];
  bf16* cs = a.cs[d];
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // h before the first step is zero
  for (int idx = tid; idx < kMmaTile * HS; idx += kThreads) h_s[idx] = zero;
  cp_async_wait<kStages - 2>();
  __syncthreads();

  const uint32_t b_lane = (uint32_t)((lr * HS + 8 * lm) * 2);
  const int x_at = 2 * t * XS + unit;
  int stage = 0, pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + kStages - 1 < maxlen) fetch();
    cp_async_commit();
    const int buf = s & 1;
    const float* xs = xg_s + stage * (kMmaTile * XS) + x_at;
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
    const uint32_t b_step = smem_u32(h_s + buf * (kMmaTile * HS)) + b_lane;
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

    bf16* h_next = h_s + (buf ^ 1) * (kMmaTile * HS) + 2 * t * HS + unit;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + acc[0][1][i]);
      const float fg = fast_sigmoid(acc[0][0][2 + i] + acc[0][1][2 + i]);
      const float gg = fast_tanh(acc[1][0][i] + acc[1][1][i]);
      const float og = fast_sigmoid(acc[1][0][2 + i] + acc[1][1][2 + i]);
      const float c_new = fg * c[i] + ig * gg;
      const float h_new = og * fast_tanh(c_new);
      if (pos < len[i]) {
        c[i] = c_new;
        h[i] = h_new;
      }
      const bf16 hq = __float2bfloat16_rn(h[i]);
      h_next[i * HS] = hq;
      if (rown[i] >= 0) {
        const size_t at = ((size_t)pos * B + rown[i]) * H + unit;
        hs[at] = hq;
        if (cs) cs[at] = __float2bfloat16_rn(c[i]);
      }
    }
    cp_async_wait<kStages - 2>();  // the next step's xg tile has landed
    __syncthreads();  // the next step's h is stored; every warp is past this step's tiles
  }

  // positions [maxlen, T): the forward direction's frozen state, the reverse
  // direction's zeros (it starts at each row's last position)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rown[i] < 0) continue;
    const bf16 hq = d ? zero : __float2bfloat16_rn(h[i]);
    const bf16 cq = d ? zero : __float2bfloat16_rn(c[i]);
    for (int p = maxlen; p < T; ++p) {
      const size_t at = ((size_t)p * B + rown[i]) * H + unit;
      hs[at] = hq;
      if (cs) cs[at] = cq;
    }
    const size_t at = ((size_t)d * B + rown[i]) * H + unit;
    a.hn[at] = h[i];
    a.cn[at] = c[i];
  }
}

}  // namespace

extern "C" {

int bilstm_fwd_wide_mma_resident_tile() { return kMmaTile; }
int bilstm_fwd_wide_mma_resident_max_h() { return kMaxH; }
int bilstm_fwd_wide_mma_resident_max_threads() { return kMaxThreads; }
int bilstm_fwd_wide_mma_resident_w_pad() { return kWPad; }
int bilstm_fwd_wide_mma_resident_f_pad() { return kFPad; }
int bilstm_fwd_wide_mma_resident_stages() { return kStages; }

const char* bilstm_fwd_wide_mma_resident_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. xg (2, T, B, 4H) f32; lengths (B,) int32;
// w_hh (2, G, 4H, H) bf16 with B % G == 0; hs_f, hs_b (and cs_f, cs_b, both
// null for the eval variant) (T, B, H) bf16; hn, cn (2, B, H) f32. H =
// kMaxH; each of the G weight groups (B / G rows) is cut into its own 8-row
// tiles: `tiles` = G * ceil(B / G / 8); threads = 4H; smem the dynamic
// shared memory, smem_bytes(H) (ops/lstm_cuda.py:fwd_wide_mma_resident_plan).
// T >= 0, B >= 1 (the wrapper launches nothing for an empty batch). Returns a
// cudaError_t (0 on success).
int bilstm_fwd_wide_mma_resident(const void* xg, const void* lengths, const void* w_hh,
                                 void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn,
                                 void* cn, int T_steps, int B, int H, int G, int tiles,
                                 int threads, int smem, void* stream) {
  if (H != kMaxH || G <= 0 || B <= 0 || B % G || T_steps < 0 || tiles <= 0 ||
      threads != 4 * H || smem != smem_bytes(H) || (cs_f == nullptr) != (cs_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = static_cast<const bf16*>(w_hh);
  a.hs[0] = static_cast<bf16*>(hs_f); a.hs[1] = static_cast<bf16*>(hs_b);
  a.cs[0] = static_cast<bf16*>(cs_f); a.cs[1] = static_cast<bf16*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.G = G;
  auto kernel = bilstm_fwd_wide_mma_resident_kernel<kMaxH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, 2), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
