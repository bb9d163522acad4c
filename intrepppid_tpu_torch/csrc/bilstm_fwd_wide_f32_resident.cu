// Bidirectional LSTM layer recurrence over the input gates, f32 compute
// dtype, at H = 96, where one direction's and one group's W_hh fits one
// block: the tensor-core forward in three tf32 passes with the weights
// resident, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_wide_f32.cu (f32 at 128-288) and
// bilstm_fwd_wide.cu (the CUDA-core cluster kernel, reached here by name
// only), together with the input projection (bilstm_gates_f32.cu), the TPU
// kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _fwd_kernel (via _fwd_pallas,
//     :376) -- with_states=False (eval variant) and True (train variant,
//     which also writes the cell streams)
// at H = 96: the stacked layer of the f32 model at embedding 80
// (E = 2 x 80, run padded at H = 96 on the wide route, one weight group).
//
// Function (the contract of ops/lstm.py:bidir_recurrence, as
// bilstm_fwd_wide.cu, with the compute dtype f32): for each direction d
// (0 forward, 1 reverse) and row r, step s reads position pos = s (d = 0)
// or T-1-s (d = 1) and computes
//   gates = xg[d, pos, r] + h @ W_hh[d, g]^T
// (xg the f32 input gates from bilstm_gates_f32.cu, the bias in them, gate
// order i, f, g, o; g = r / (B / G), the row's weight group; f32 operands
// and sums), then the cell update. The state moves iff pos < lengths[r].
// Every position gets the row's (possibly frozen) h in hs_f / hs_b and, in
// the train variant, c in cs_f / cs_b, all f32; the final state goes to
// hn / cn.
//
// What bounds it on an H100: bytes, 0.83 ms (train) and 0.69 (eval) at 400
// rows, T = 1500 (the f32 xg stream in, the f32 h and c streams out); the
// product, 4H x H multiply-adds per row and step, takes 0.54 ms in three
// tf32 passes at 495/3 TFLOP/s. What governs is the serial chain of a step,
// T times: the gate product's mma rounds, the cell's transcendentals, one
// shared-memory store of the new h and one block barrier; and the step's
// 12 KB of xg a block, which must be in flight far enough ahead that its
// latency stays off that chain. bilstm_fwd_wide.cu adds two cluster
// barriers and a broadcast of h through distributed shared memory to that
// chain and runs the product on the CUDA cores; at 96 one direction's f32
// W_hh (384 x 96, 147,456 B) fits one block, so neither is needed. One
// tf32 pass keeps ~3 decimal digits, which misses the f32 agreement
// (1e-4 x max(1, max|ref|)) by 3-4 x, so the product is big.big +
// big.small + small.big (split_tf32, bilstm_mma.cuh).
//
// Design: the schedule of bilstm_fwd_wide_mma_resident.cu (bf16 at 96) in
// three tf32 passes:
//   * one block per (8-row tile, direction), no cluster; each weight group
//     is cut into its own 8-row tiles (tile_row); one warp per 8 hidden
//     units (12 warps, 384 threads); the stacked layer's 400 rows in one
//     group give 100 blocks, one wave on 132 SMs;
//   * the swapped product gates^T (4H x 8) = W_hh[d, g] . h^T on mma.sync
//     m16n8k8 tf32 with the gate rows permuted, so lane (g, t) of warp w
//     holds the four gates of unit 8w + g for rows 2t and 2t + 1: the cell
//     runs on the accumulators, with no exchange. The warp's 32 permuted
//     gate rows stay in registers as one f32 copy of its A fragments for the
//     whole sweep (2 m16 tiles x 12 k8 steps x 4 = 96 registers), read once
//     from global memory and split into big and small where they are used
//     (a mask and a subtraction a value);
//   * the K order within each k16 chunk is permuted so that lane (g, t)
//     holds inputs 4t .. 4t + 3 of the chunk (k8 step 2c: 4t, 4t + 1; step
//     2c + 1: 4t + 2, 4t + 3): the B operand is one 16-byte shared load a
//     chunk from the f32 h tile;
//   * xg[d, pos] goes straight into the accumulators (the first of two
//     chains over alternate k16 chunks);
//   * the new h (f32) goes into a double-buffered shared tile, the next
//     step's B operand: ONE __syncthreads a step;
//   * the step's f32 xg tile (8 rows x 4H, 12 KB) arrives through a
//     five-stage cp.async ring, four steps ahead; the rows' lengths sit in
//     registers for the whole sweep;
//   * a tile stops at its longest row: past it the forward direction's
//     state is frozen (its final h and c are written there), and the reverse
//     direction has not started (zeros).
// Shared memory: the two f32 h tiles (8 rows of H + 16, rows 16 mod 32 floats
// apart, so a 16-byte B load of 8 lanes spans the 32 banks once) and the
// ring's stages (8 rows of 4H + 4 f32), 69,248 B at 96 (smem_bytes), dynamic.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kMaxH = 96;               // the one width it is built for
constexpr int kMaxThreads = 4 * kMaxH;  // one warp per 8 units
constexpr int kHPad = 16;               // f32 elements of padding on each h tile row
constexpr int kFPad = 4;                // f32 elements of padding on each xg tile row
constexpr int kStages = 5;              // xg tiles in flight: this step's and four ahead

struct Args {
  const float* xg;     // (2, T, B, 4H)
  const int* lengths;  // (B,)
  const float* w_hh;   // (2, G, 4H, H)
  float* hs[2];        // per direction, (T, B, H)
  float* cs[2];        // null: the eval variant
  float* hn;           // (2, B, H)
  float* cn;
  int T, B, G;
};

// Dynamic shared memory at H (bytes): the two f32 h tiles (8 rows of H +
// kHPad), then the ring's f32 xg tiles (8 rows of 4H + kFPad). Both parts
// are multiples of 16 bytes.
__host__ __device__ constexpr int smem_bytes(int H) {
  return 2 * kMmaTile * (H + kHPad) * 4 + kStages * kMmaTile * (4 * H + kFPad) * 4;
}

// c += a . b in three tf32 passes (small.big, big.small, big.big), the f32
// fragment a split here.
__device__ __forceinline__ void mma3_split(float (&c)[4], const float (&a)[4], uint32_t b0,
                                           uint32_t b1, uint32_t s0, uint32_t s1) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ab[q], as[q]);
  mma_tf32(c, as, b0, b1);
  mma_tf32(c, ab, s0, s1);
  mma_tf32(c, ab, b0, b1);
}

// grid (tiles, 2), block 4H threads: one warp per 8 hidden units.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) bilstm_fwd_wide_f32_resident_kernel(const Args a) {
  constexpr int H4 = 4 * H, NC = H / 16, kThreads = 4 * H;
  constexpr int XS = H4 + kFPad;  // xg tile row stride (f32)
  constexpr int HS = H + kHPad;   // h tile row stride (f32)
  // the xg tile is 8 x 4H floats: 8 x 4H / 4 chunks of 16 bytes, two a thread
  constexpr int kChunks = 2, kRowChunks = H4 / 4;
  static_assert(H % 32 == 0 && H <= kMaxH && kMmaTile * kRowChunks == kChunks * kThreads,
                "unsupported width");
  const int tile = blockIdx.x, d = blockIdx.y;
  const int T = a.T, B = a.B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;

  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);                           // [2][8][HS]
  float* xg_s = reinterpret_cast<float*>(smem + 2 * kMmaTile * HS * 4);  // [kStages][8][XS]

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

  // the weights' A fragments, f32: m16 tile mt of warp w is permuted rows
  // 32w + 16mt .. +15, i.e. gates 2mt (rows g) and 2mt + 1 (rows g + 8) of
  // unit 8w + g; k8 step kh of chunk c covers inputs 16c + 4t + 2kh (K slot
  // t) and the one after it (slot t + 4)
  float wa[NC][2][2][4];  // [chunk][kh][mt][register]
  {
    const float* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int k = 16 * c + 4 * t + 2 * kh;
          const float2 lo = *reinterpret_cast<const float2*>(wh + (size_t)(2 * mt * H + unit) * H + k);
          const float2 hi =
              *reinterpret_cast<const float2*>(wh + (size_t)((2 * mt + 1) * H + unit) * H + k);
          wa[c][kh][mt][0] = lo.x;
          wa[c][kh][mt][1] = hi.x;
          wa[c][kh][mt][2] = lo.y;
          wa[c][kh][mt][3] = hi.y;
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
  float* hs = a.hs[d];
  float* cs = a.cs[d];

  // h before the first step is zero
  for (int idx = tid; idx < kMmaTile * HS; idx += kThreads) h_s[idx] = 0.0f;
  cp_async_wait<kStages - 2>();
  __syncthreads();

  const float* h_lane = h_s + g * HS + 4 * t;
  const int x_at = 2 * t * XS + unit;
  int stage = 0, pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + kStages - 1 < maxlen) fetch();
    cp_async_commit();
    const int buf = s & 1;
    const float* xs = xg_s + stage * (kMmaTile * XS) + x_at;
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // gates^T: acc[mt][chain]: mt 0 rows = gates i | f, mt 1 = g | o, of
    // units 8w..8w+7; two chains over alternate k16 chunks, xg in chain 0
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
    const float* hb = h_lane + buf * (kMmaTile * HS);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const float4 v = *reinterpret_cast<const float4*>(hb + 16 * cc);
      uint32_t bb[4], bs[4];
      split_tf32(v.x, bb[0], bs[0]);
      split_tf32(v.y, bb[1], bs[1]);
      split_tf32(v.z, bb[2], bs[2]);
      split_tf32(v.w, bb[3], bs[3]);
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3_split(acc[mt][cc & 1], wa[cc][kh][mt], bb[2 * kh], bb[2 * kh + 1], bs[2 * kh],
                     bs[2 * kh + 1]);
    }

    float* h_next = h_s + (buf ^ 1) * (kMmaTile * HS) + 2 * t * HS + unit;
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
      h_next[i * HS] = h[i];
      if (rown[i] >= 0) {
        const size_t at = ((size_t)pos * B + rown[i]) * H + unit;
        hs[at] = h[i];
        if (cs) cs[at] = c[i];
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
    const float hq = d ? 0.0f : h[i];
    const float cq = d ? 0.0f : c[i];
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

int bilstm_fwd_wide_f32_resident_tile() { return kMmaTile; }
int bilstm_fwd_wide_f32_resident_max_h() { return kMaxH; }
int bilstm_fwd_wide_f32_resident_max_threads() { return kMaxThreads; }
int bilstm_fwd_wide_f32_resident_h_pad() { return kHPad; }
int bilstm_fwd_wide_f32_resident_f_pad() { return kFPad; }
int bilstm_fwd_wide_f32_resident_stages() { return kStages; }

const char* bilstm_fwd_wide_f32_resident_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. xg (2, T, B, 4H) f32; lengths (B,) int32;
// w_hh (2, G, 4H, H) f32 with B % G == 0; hs_f, hs_b (and cs_f, cs_b, both
// null for the eval variant) (T, B, H) f32; hn, cn (2, B, H) f32. H =
// kMaxH; each of the G weight groups (B / G rows) is cut into its own 8-row
// tiles: `tiles` = G * ceil(B / G / 8); threads = 4H; smem the dynamic
// shared memory, smem_bytes(H) (ops/lstm_cuda.py:fwd_wide_f32_resident_plan).
// T >= 0, B >= 1 (the wrapper launches nothing for an empty batch). Returns a
// cudaError_t (0 on success).
int bilstm_fwd_wide_f32_resident(const void* xg, const void* lengths, const void* w_hh,
                                 void* hs_f, void* hs_b, void* cs_f, void* cs_b, void* hn,
                                 void* cn, int T_steps, int B, int H, int G, int tiles,
                                 int threads, int smem, void* stream) {
  if (H != kMaxH || G <= 0 || B <= 0 || B % G || T_steps < 0 || tiles <= 0 ||
      threads != 4 * H || smem != smem_bytes(H) || (cs_f == nullptr) != (cs_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = static_cast<const float*>(w_hh);
  a.hs[0] = static_cast<float*>(hs_f); a.hs[1] = static_cast<float*>(hs_b);
  a.cs[0] = static_cast<float*>(cs_f); a.cs[1] = static_cast<float*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.G = G;
  auto kernel = bilstm_fwd_wide_f32_resident_kernel<kMaxH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, 2), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
