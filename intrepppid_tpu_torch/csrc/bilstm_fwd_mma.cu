// Bidirectional LSTM layer forward, bf16 compute dtype, the resident
// shapes: the tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_f32.cu (f32), the TPU kernels
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _fwd_kernel_packed (via
//     _fwd_pallas_packed) -- the layer forward at 2H == 128: with_states
//     False (eval variant) and True (train variant, which also emits the
//     cell stream for the backward);
//   intrepppid_tpu/ops/lstm_pallas_layer.py   _fwd_kernel (via _fwd_pallas,
//     :376) -- the same function at the other resident widths, layer 0 of
//     the two-layer models at embedding 72 and 80 among them.
// It is instantiated at every bf16 resident shape a layer runs at (the
// CUDA-core forward that took the others is deleted).
// f32 at these widths goes to bilstm_fwd_f32.cu, in three tf32 passes: one
// pass, with tf32's 10-bit mantissa, breaks the serve path's 1e-4
// agreement with the plain forward.
//
// Function (the contract of ops/lstm.py:bidir_layer): for
// each direction d and row r, step s reads position pos = s (d = 0) or
// T-1-s (d = 1) and computes gates = [x_parts](pos) @ W_ih[d]^T + bias[d] +
// bf16(h) @ W_hh[d, g]^T (gate order i, f, g, o; g the row's weight group),
// then the cell update. The state moves iff pos < lengths[r], otherwise it
// stays frozen. Every position gets the row's (possibly frozen) h in hs_f /
// hs_b and, in the train variant, c in cs_f / cs_b, both bf16; the final
// state goes to hn / cn in f32. bf16 operands, f32 sums and state.
//
// What bounds it on an H100: the roofline bound is bytes (the bf16 streams,
// a fraction of a millisecond per layer at the train shape); the products
// are a small share of that on the tensor cores. What governs is the serial
// chain of a step, T times: the h-part of the gate product, the cell's
// transcendentals, one shared-memory store of h and one block barrier.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes; this is
// the gate product of the tensor-core sweep bilstm_bwd_mma.cu without the
// backward half):
//   * one block per (8-row tile, direction), one warp per 8 hidden units;
//     each weight group is cut into its own 8-row tiles (nothing padded):
//     50 tiles x 2 directions at 400 train rows, one wave on 132 SMs;
//   * the swapped product gates^T (4H x 8) = [W_ih | W_hh] . [x ; h]^T on
//     mma.sync m16n8k16 with the gate rows permuted, so lane (g, t) of warp
//     w holds the four gates of unit 8w + g for batch rows 2t and 2t + 1:
//     the cell maths runs on the accumulators, with no exchange;
//   * the weights' A fragments stay in registers for the whole sweep (the
//     kernel is templated on H and E, so they are a fixed set: 96 registers
//     at E + H = 192), read once from global memory in the permuted order:
//     a step loads only the 8-row [x ; h] tile, one ldmatrix per 32 of K;
//   * the [x ; h] tile of a step lives in a three-stage ring: x arrives by
//     cp.async two steps ahead, h is stored by the previous step's cell
//     update into the same stage (bf16, the next step's B operand): ONE
//     __syncthreads a step;
//   * a tile stops at its longest row: past it the forward direction's
//     state is frozen (its final h and c are written there), and the
//     reverse direction has not started (zeros).
// Each instance's __launch_bounds__ is its own block, 4H threads, one block
// an SM: the <80, 80> instance's 320 threads may take 204 registers a
// thread, the others 255; at H = 8 a block is one warp. The weights' A
// fragments are 2 m16 tiles x 4 registers a k16 step (80 at K = 160; the
// -Xptxas -v summary of the build reports registers and spills). Where
// E + H is not a whole number of 32 the product steps the rest natively:
//   * K % 32 == 16 (E = H = 72: nine k16 steps): four ldmatrix.x4 rounds
//     and one ldmatrix.x2 step, where bilstm_bwd_mma.cu runs K to the next
//     32 over zero columns: here the weights sit in registers, so a zero
//     k16 step would cost 8 registers and one mma a step for nothing;
//   * K % 16 == 8 (H % 16 == 8, and H = 48 at E = 80 or 112: K = 24, 72,
//     120, 168): the k16 steps, then one mma.sync m16n8k8 step on two A
//     registers an m16 tile and one ldmatrix.x1 of the B tile (4 registers
//     for the tail, not the 8 of a zero-padded k16 step: 84 at K = 168);
//   * the [x ; h] rows are padded so their stride is an odd number of 16
//     bytes, which keeps ldmatrix free of bank conflicts: K + 8 where
//     K % 16 == 0, K + 16 where K % 16 == 8 (K + 8 there would be an even
//     number: 176 elements at K = 168).
// The grid: 400 rows in 5 groups of 80 are 50 tiles, 100 blocks with both
// directions, one wave on 132 SMs; the three-stage ring is 8 x (K + pad) x
// 2 x 3 bytes (8,064 at K = 160, 8,832 at K = 168).

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;
constexpr int kMaxChunks = 2;   // 16-byte x chunks each thread copies per step
constexpr int kMaxThreads = 320;  // the <80, 80> instance: one warp per 8 units
constexpr int kPad = 8;         // bf16 elements of padding on a shared row at K % 16 == 0
constexpr int kTailPad = 16;    // and at K % 16 == 8
// the [x ; h] row stride: an odd number of 16-byte units (conflict-free ldmatrix)
__host__ __device__ constexpr int row_stride(int K) { return K + (K % 16 ? kTailPad : kPad); }

// One 8x8 b16 matrix (lanes 0-7 give the row addresses).
__device__ __forceinline__ void ldmatrix_x1(uint32_t& r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
               : "=r"(r)
               : "r"(addr)
               : "memory");
}

// c (16x8 f32) += a (16x8 bf16: a0 rows g, a1 rows g + 8, columns 2t, 2t + 1)
// . b (8x8 bf16: rows 2t, 2t + 1 of column g): the k8 tail of the product.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Two 8x8 b16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

struct Args {
  const bf16* x[2];
  int E0, E1;
  const int* lengths;
  const bf16* w_ih;   // (2, 4H, E)
  const bf16* w_hh;   // (2, G, 4H, H)
  const float* bias;  // (2, 4H)
  bf16* hs[2];        // (T, B, H) per direction
  bf16* cs[2];        // null: the eval variant
  float* hn;          // (2, B, H)
  float* cn;
  int T, B, G;
};

// grid (tiles, 2), block 32 * H / 8 threads.
template <int H, int E>
__global__ void __launch_bounds__(4 * H, 1) bilstm_fwd_mma_kernel(const Args a) {
  // NK whole k16 steps, then a k8 tail where K % 16 == 8
  constexpr int H4 = 4 * H, K = E + H, KS = row_stride(K), NK = K / 16;
  constexpr bool kTail = K % 16 != 0;
  static_assert(H % 8 == 0 && 4 * H <= kMaxThreads && E % 8 == 0 &&
                    kMmaTile * E / 8 <= kMaxChunks * 4 * H,
                "unsupported shape");
  static_assert((KS / 8) % 2 == 1, "row stride an odd number of 16-byte units");
  const int tile = blockIdx.x, d = blockIdx.y, T = a.T, B = a.B;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix index
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;

  // the [x ; h] tile of each step: x in columns [0, E), h in [E, K)
  __shared__ __align__(16) bf16 tile_s[kStages][kMmaTile][KS];

  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;

  // x tile chunks: 8 rows x E / 8 chunks of 16 bytes; each thread walks the
  // source address of its chunks one position per fetch
  constexpr int kRowChunks = E / 8;
  const bf16* c_src[kMaxChunks];
  uint32_t c_dst[kMaxChunks];
  int c_walk[kMaxChunks];  // 0: chunk unused
  bool c_real[kMaxChunks];
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int idx = tid + m * nthreads;
    c_src[m] = a.x[0];
    c_dst[m] = 0;
    c_walk[m] = 0;
    c_real[m] = false;
    if (idx >= kMmaTile * kRowChunks) continue;
    const int n = idx / kRowChunks, e = (idx - n * kRowChunks) * 8;
    c_real[m] = n < nrows;
    const size_t row = row0 + (c_real[m] ? n : 0);
    const bool part0 = e < a.E0;
    const int width = part0 ? a.E0 : a.E1, col = part0 ? e : e - a.E0;
    const bf16* base = a.x[part0 ? 0 : 1];
    c_dst[m] = smem_u32(&tile_s[0][n][e]);
    c_walk[m] = dpos * B * width;
    c_src[m] = base + row * width + col + (ptrdiff_t)max(pos0, 0) * B * width;
  }
  constexpr uint32_t kStageBytes = kMmaTile * KS * 2;
  int fetch_stage = 0;
  auto fetch = [&]() {
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (c_walk[m] == 0) continue;
      cp_async16(c_dst[m] + fetch_stage * kStageBytes, c_real[m] ? c_src[m] : a.x[0], c_real[m]);
      c_src[m] += c_walk[m];
    }
    fetch_stage = fetch_stage == kStages - 1 ? 0 : fetch_stage + 1;
  };
  if (maxlen > 0) fetch();
  cp_async_commit();
  if (maxlen > 1) fetch();
  cp_async_commit();

  // the weights' A fragments: m16 tile mt of warp w is permuted rows
  // 32w + 16mt .. +15, i.e. gates 2mt (rows g) and 2mt + 1 (rows g + 8) of
  // unit 8w + g; k-step ks covers K columns [16ks, 16ks + 16), the tail wt
  // columns [16NK, K)
  uint32_t wa[NK][2][4], wt[2][2];
  {
    const bf16* wi = a.w_ih + (size_t)d * H4 * E;
    const bf16* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    auto pair = [&](int q, int k) -> uint32_t {
      const int j = q * H + unit;  // torch gate row
      const bf16* p = k < E ? wi + (size_t)j * E + k : wh + (size_t)j * H + (k - E);
      return *reinterpret_cast<const uint32_t*>(p);
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
    if constexpr (kTail) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        wt[mt][0] = pair(2 * mt, 16 * NK + 2 * t);
        wt[mt][1] = pair(2 * mt + 1, 16 * NK + 2 * t);
      }
    }
  }
  float bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bi[q] = a.bias[d * H4 + q * H + unit];

  // this lane's rows 2t, 2t + 1: state, length, stream addresses
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
  for (int idx = tid; idx < kMmaTile * H; idx += nthreads)
    tile_s[0][idx / H][E + idx % H] = zero;
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t b_lane = (uint32_t)((lr * KS + 8 * lm) * 2);
  int stage = 0, pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + 2 < maxlen) fetch();
    cp_async_commit();
    const int next = stage == kStages - 1 ? 0 : stage + 1;

    // gates^T: acc[mt][chain], two chains over alternate k-steps
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[mt][0][i] = bi[2 * mt];
        acc[mt][0][2 + i] = bi[2 * mt + 1];
        acc[mt][1][i] = 0.0f;
        acc[mt][1][2 + i] = 0.0f;
      }
    }
    const uint32_t b_step = smem_u32(&tile_s[stage][0][0]) + b_lane;
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
    if constexpr (NK % 2) {
      uint32_t b[2];
      ldmatrix_x2(b, b_step + (uint32_t)((NK - 1) * 32));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][0], wa[NK - 1][mt], b[0], b[1]);
    }
    if constexpr (kTail) {
      uint32_t b;
      ldmatrix_x1(b, b_step + (uint32_t)(NK * 32));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16_k8(acc[mt][1], wt[mt], b);
    }

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
      tile_s[next][2 * t + i][E + unit] = hq;
      if (rown[i] >= 0) {
        const size_t at = ((size_t)pos * B + rown[i]) * H + unit;
        hs[at] = hq;
        if (cs) cs[at] = __float2bfloat16_rn(c[i]);
      }
    }
    cp_async_wait<1>();  // the next step's x has landed
    __syncthreads();     // the next step's h is stored; every warp is past this step's tile
    stage = next;
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

template <int H, int E>
int launch(const Args& a, int tiles, int threads, cudaStream_t stream) {
  if (threads != 32 * H / 8) return (int)cudaErrorInvalidValue;
  bilstm_fwd_mma_kernel<H, E><<<dim3(tiles, 2), threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_fwd_mma_tile() { return kMmaTile; }
int bilstm_fwd_mma_stages() { return kStages; }
int bilstm_fwd_mma_max_chunks() { return kMaxChunks; }
int bilstm_fwd_mma_max_threads() { return kMaxThreads; }
int bilstm_fwd_mma_pad() { return kPad; }
int bilstm_fwd_mma_tail_pad() { return kTailPad; }

const char* bilstm_fwd_mma_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The compute dtype is bfloat16. Operands (ops/lstm_cuda.py:_tile_fwd_launch):
// x0 (T, B, E0), x1 (T, B, E1), w_ih (2, 4H, E0 + E1) and
// w_hh (2, G, 4H, H) in the compute dtype; lengths (B,) int32; bias (2, 4H)
// f32; out: hs_f, hs_b and cs_f, cs_b (T, B, H) in the compute dtype, hn,
// cn (2, B, H) f32. x1 may be null (E1 = 0); cs_f /
// cs_b null selects the eval variant. Each of the G weight groups (B / G
// rows) is cut into its own 8-row tiles: `tiles` = G * ceil(B / G / 8);
// threads = 4H (at most kMaxThreads). (H, E0 + E1) is one of the
// instantiated shapes below, input parts multiples of 8. Returns a cudaError_t (0 on success).
int bilstm_fwd_mma(const void* x0, const void* x1, int E0, int E1, const void* lengths,
                   const void* w_ih, const void* w_hh, const void* bias, void* hs_f, void* hs_b,
                   void* cs_f, void* cs_b, void* hn, void* cn, int T_steps, int B, int H, int G,
                   int tiles, int threads, void* stream) {
  if (E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 || (E1 > 0) != (x1 != nullptr) || G <= 0 ||
      B % G || (cs_f == nullptr) != (cs_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.E0 = E0; a.E1 = E1;
  a.lengths = static_cast<const int*>(lengths);
  a.w_ih = static_cast<const bf16*>(w_ih);
  a.w_hh = static_cast<const bf16*>(w_hh);
  a.bias = static_cast<const float*>(bias);
  a.hs[0] = static_cast<bf16*>(hs_f); a.hs[1] = static_cast<bf16*>(hs_b);
  a.cs[0] = static_cast<bf16*>(cs_f); a.cs[1] = static_cast<bf16*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int E = E0 + E1;
  // the model's layers at the resident widths: E = H below, E = 2H stacked;
  // layer 0 of the two-layer models at embedding 80 and 72; the shapes at
  // H % 16 == 8 and H = 48 at E = 80 / 112 (a k8 tail) that the layers of
  // 1-56 units run at (ops/lstm_cuda.py:FWD_MMA_SHAPES)
  if (H == 80 && E == 80) return launch<80, 80>(a, tiles, threads, st);
  if (H == 72 && E == 72) return launch<72, 72>(a, tiles, threads, st);
  if (H == 64 && E == 64) return launch<64, 64>(a, tiles, threads, st);
  if (H == 64 && E == 128) return launch<64, 128>(a, tiles, threads, st);
  if (H == 48 && E == 48) return launch<48, 48>(a, tiles, threads, st);
  if (H == 32 && E == 32) return launch<32, 32>(a, tiles, threads, st);
  if (H == 32 && E == 64) return launch<32, 64>(a, tiles, threads, st);
  if (H == 16 && E == 16) return launch<16, 16>(a, tiles, threads, st);
  if (H == 16 && E == 32) return launch<16, 32>(a, tiles, threads, st);
  if (H == 8 && E == 8) return launch<8, 8>(a, tiles, threads, st);
  if (H == 8 && E == 16) return launch<8, 16>(a, tiles, threads, st);
  if (H == 16 && E == 8) return launch<16, 8>(a, tiles, threads, st);
  if (H == 24 && E == 24) return launch<24, 24>(a, tiles, threads, st);
  if (H == 24 && E == 48) return launch<24, 48>(a, tiles, threads, st);
  if (H == 40 && E == 40) return launch<40, 40>(a, tiles, threads, st);
  if (H == 40 && E == 80) return launch<40, 80>(a, tiles, threads, st);
  if (H == 48 && E == 80) return launch<48, 80>(a, tiles, threads, st);
  if (H == 48 && E == 112) return launch<48, 112>(a, tiles, threads, st);
  if (H == 56 && E == 56) return launch<56, 56>(a, tiles, threads, st);
  if (H == 56 && E == 112) return launch<56, 112>(a, tiles, threads, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
