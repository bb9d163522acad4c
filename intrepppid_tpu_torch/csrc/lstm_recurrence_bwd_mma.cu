// Backward sweep of the masked LSTM recurrence over precomputed, time-major
// input gates, bf16 compute dtype, H <= 64: the tensor-core variant,
// hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_bwd_f32.cu (f32) and the sweeps of the
// wider widths, the recurrent part of the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence; the dW sums stay in
// lstm_recurrence_wgrad.cu.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_sweep): block
// (row tile, direction d) walks s = T-1 .. 0 carrying dh and dc (f32, from
// dhn / dcn). Per step and row r:
//   * gates = xg[s, d, r] + bf16(h_prev) @ w[d, g], h_prev = hs[s-1, d, r]
//     and c_prev = cs[s-1, d, r] (f32 streams, zero at s = 0; c_prev is used
//     unrounded); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates (f32): a step with valid[s, d, r] == 0 gets dgates = 0 and
//     passes dh and dc through; dxg[s, d, r] = dgates, unrounded;
//   * dh = bf16(dgates) @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
//
// What bounds it on an H100: the roofline bound is the 44 H bytes of f32
// streams per row and step (xg, hs, cs, dhs in, dxg out); the tensor-core
// work is a fraction of a microsecond per launch. What governs is the serial
// chain of a step, T times: fragment loads, two short mma chains, the
// cell's transcendentals, one shared-memory round trip, one block barrier.
//
// Design: ONE block per (8-row tile, direction), no cluster. w[d, g] is
// resident in shared memory in bf16 (4H x H, 32 KB at H = 64), transposed
// and gate-row-permuted while staged (bilstm_mma.cuh), and serves both
// products: gates^T = W . h_prev^T through ldmatrix, dh_prev^T = W^T .
// dgates^T through ldmatrix.trans of the same copy. Warp w owns hidden units
// 8w .. 8w+7: its two m16 tiles of the gate product leave the four gates of
// a unit for two batch rows in one lane, the cell maths runs on those
// accumulators, the rounded dgates go to shared memory once (the narrow
// operand of the dh product, double-buffered so the step has ONE
// __syncthreads), and dh_prev comes back into the lane that carries dh for
// that unit and those rows. The step's stream tiles (xg, hs, cs, dhs; 16
// bytes a copy) arrive through a three-stage cp.async ring, two steps ahead;
// h_prev is rounded to bf16 as the B fragment is built from the f32 tile.
// dxg is stored from the f32 dgates, 32-byte sectors whole.
// Row tiles of 8 give 2 x 50 blocks at 400 rows: one wave on 132 SMs.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;
constexpr int kMaxChunks = 4;  // 16-byte tile chunks each thread copies per step
constexpr int kMaxH = 64;
constexpr int kWPad = 8;       // bf16 elements: W and dgates rows, h_prev f32 rows
constexpr int kFPad = 4;       // f32 elements: xg, c_prev, dhs tile rows

// One round (32 of K) of a product's fragments: the B operand of two
// k-steps and the A operands.
struct GateFrag {
  uint32_t b[4];
  uint32_t a[2][2][4];  // [k-step][m-tile]
};
struct TransFrag {
  uint32_t b[4];
  uint32_t a[4];  // stored rows 8i .. 8i+7 of the round, transposed
};

struct Args {
  const float* xg;
  const uint8_t* valid;
  const bf16* w;
  const float* hs;
  const float* cs;
  const float* dhs;  // may be null (zero)
  const float* dhn;  // may be null (zero)
  const float* dcn;  // may be null (zero)
  float* dxg;
  int T, B, G;
};

// grid (tiles, D), block 32 * H / 8 threads. H is a template parameter so
// the product loops unroll and the shared-memory offsets are immediates: a
// step is bound by how many machine operations it dispatches, not by the
// tensor cores.
template <int H>
__global__ void __launch_bounds__(32 * H / 8, 1) lstm_recurrence_bwd_mma_kernel(const Args a) {
  constexpr int H4 = 4 * H;
  constexpr int WS = H + kWPad;    // W_s row stride (bf16)
  constexpr int GS = H4 + kWPad;   // dgates tile row stride (bf16)
  constexpr int XS = H4 + kFPad;   // xg tile row stride (f32)
  constexpr int PS = H + kWPad;    // h_prev tile row stride (f32)
  constexpr int CS = H + kFPad;    // c_prev / dhs tile row stride (f32)
  constexpr int kThreads = 32 * H / 8;
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

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* W_s = reinterpret_cast<bf16*>(smem);  // [4H permuted][WS]: W_s[p][k] = w[k][j(p)]
  constexpr uint32_t dg_at = (uint32_t)H4 * WS * 2;  // a multiple of 16
  bf16* dg_s = reinterpret_cast<bf16*>(smem + dg_at);  // [2][8][GS], permuted gate order
  constexpr uint32_t stages_at = dg_at + 2 * kMmaTile * GS * 2;
  constexpr uint32_t xg_off = 0;
  constexpr uint32_t hp_off = xg_off + kMmaTile * XS * 4;
  constexpr uint32_t cp_off = hp_off + kMmaTile * PS * 4;
  constexpr uint32_t dy_off = cp_off + kMmaTile * CS * 4;
  constexpr uint32_t stage_bytes = dy_off + kMmaTile * CS * 4;
  unsigned char* stages = smem + stages_at;
  const uint32_t stages_u32 = smem_u32(stages);

  // the step's tiles as 16-byte chunks (4 floats): xg | hs | cs | dhs. Each
  // thread keeps, per chunk, the source address of the next step to fetch
  // and walks it back one time step per fetch.
  const int per_row = (H4 + (a.dhs ? 3 : 2) * H) / 4;
  const float* c_src[kMaxChunks];
  uint32_t c_dst[kMaxChunks];
  int c_back[kMaxChunks];   // floats to walk back per step; 0: chunk unused
  int c_first[kMaxChunks];  // the last step that fetches real data: 0, 1 (reads s - 1), or T (none)
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int idx = tid + m * kThreads;
    c_src[m] = a.xg;
    c_dst[m] = 0;
    c_back[m] = 0;
    c_first[m] = T;
    if (idx >= kMmaTile * per_row) continue;
    const int n = idx / per_row, e = (idx - n * per_row) * 4;
    const bool real = n < nrows;
    const size_t row = (size_t)d * B + row0 + (real ? n : 0);
    const float* base;
    int width, col, lag;
    if (e < H4) {
      base = a.xg; width = H4; col = e; lag = 0;
      c_dst[m] = xg_off + (n * XS + col) * 4;
    } else if (e < H4 + H) {
      base = a.hs; width = H; col = e - H4; lag = 1;
      c_dst[m] = hp_off + (n * PS + col) * 4;
    } else if (e < H4 + 2 * H) {
      base = a.cs; width = H; col = e - H4 - H; lag = 1;
      c_dst[m] = cp_off + (n * CS + col) * 4;
    } else {
      base = a.dhs; width = H; col = e - H4 - 2 * H; lag = 0;
      c_dst[m] = dy_off + (n * CS + col) * 4;
    }
    c_back[m] = D * B * width;
    // the first fetch is for step T - 1, which reads time T - 1 - lag
    c_src[m] = base + row * width + col + (ptrdiff_t)(T - 1 - lag) * c_back[m];
    if (real) c_first[m] = lag;
  }
  int fetch_stage = (T - 1) % kStages;  // stage of step s is s % kStages
  auto fetch = [&](int s) {
    const uint32_t base = stages_u32 + (uint32_t)fetch_stage * stage_bytes;
    fetch_stage = fetch_stage == 0 ? kStages - 1 : fetch_stage - 1;
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (c_back[m] == 0) continue;
      const bool ok = s >= c_first[m];
      cp_async16(base + c_dst[m], ok ? c_src[m] : a.xg, ok);
      c_src[m] -= c_back[m];
    }
  };
  if (T > 0) fetch(T - 1);
  cp_async_commit();
  if (T > 1) fetch(T - 2);
  cp_async_commit();

  // stage w[d, group] (H, 4H) transposed, rows permuted
  {
    const bf16* wd = a.w + ((size_t)d * a.G + group) * H * H4;
    for (int idx = tid; idx < H * H4; idx += kThreads) {
      const int k = idx / H4, j = idx - k * H4;
      W_s[permuted_of_gate_row(j, H) * WS + k] = wd[idx];
    }
  }

  // this lane: unit `unit`, batch rows 2t and 2t + 1 of the tile
  int rown[2];
  float dh[2], dc[2];
  uint8_t vnext[2];
  const uint8_t* vsrc[2];  // this row's mask byte of the step after next
  float* dsrc[2];          // this row's and unit's dxg of the current step
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * t + i;
    rown[i] = n < nrows ? row0 + n : -1;
    const size_t row = (size_t)d * B + (rown[i] >= 0 ? rown[i] : 0);
    dh[i] = (rown[i] >= 0 && a.dhn) ? a.dhn[row * H + unit] : 0.0f;
    dc[i] = (rown[i] >= 0 && a.dcn) ? a.dcn[row * H + unit] : 0.0f;
    vsrc[i] = a.valid + row + (ptrdiff_t)(T - 1) * D * B;
    dsrc[i] = a.dxg + (row + (ptrdiff_t)(T - 1) * D * B) * H4 + unit;
    vnext[i] = (rown[i] >= 0 && T > 0) ? __ldg(vsrc[i]) : 0;
    vsrc[i] -= D * B;
  }

  const uint32_t W_u32 = smem_u32(W_s);
  // gate product A: rows 32*warp + 16*mt + lr + 8*(lm & 1), columns k0 + 8*(lm >> 1)
  const uint32_t a_gate =
      W_u32 + (uint32_t)(((32 * warp + lr + 8 * (lm & 1)) * WS + 8 * (lm >> 1)) * 2);
  // dh product A (transposed read): stored rows p0 + 8*lm + lr (32 of the k
  // index a load), columns 8*warp .. 8*warp + 7 (this warp's units)
  const uint32_t a_dh = W_u32 + (uint32_t)(((8 * lm + lr) * WS + 8 * warp) * 2);
  // dh product B: dgates tile row lr, columns p0 + 8*lm
  const uint32_t b_dh = smem_u32(dg_s) + (uint32_t)((lr * GS + 8 * lm) * 2);
  // this lane's reads of the step's tiles and its writes of the dgates tile
  const int x_at = 2 * t * XS + unit, c_at = 2 * t * CS + unit, p_at = g * PS + 2 * t;
  const int dg_at_lane = 2 * t * GS + 32 * warp + g;
  const bool has_dhs = a.dhs != nullptr;

  cp_async_wait<1>();
  __syncthreads();

  int stage = (T - 1) % kStages;
  for (int s = T - 1; s >= 0; --s) {
    if (s >= 2) fetch(s - 2);
    cp_async_commit();
    const unsigned char* st = stages + (uint32_t)stage * stage_bytes;
    stage = stage == 0 ? kStages - 1 : stage - 1;
    const float* xg_s = reinterpret_cast<const float*>(st + xg_off) + x_at;
    const float* hp_s = reinterpret_cast<const float*>(st + hp_off) + p_at;
    const float* cp_s = reinterpret_cast<const float*>(st + cp_off) + c_at;
    const float* dy_s = reinterpret_cast<const float*>(st + dy_off) + c_at;
    const bool on[2] = {vnext[0] != 0, vnext[1] != 0};
    if (s > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rown[i] >= 0) vnext[i] = __ldg(vsrc[i]);
        vsrc[i] -= D * B;
      }
    }

    // gates^T: acc[mt][half]: mt 0 rows = gates i | f, mt 1 = g | o, of units 8w..8w+7
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[mt][0][i] = xg_s[i * XS + (2 * mt) * H];
        acc[mt][0][2 + i] = xg_s[i * XS + (2 * mt + 1) * H];
        acc[mt][1][i] = 0.0f;
        acc[mt][1][2 + i] = 0.0f;
      }
    }
    pipelined_rounds<GateFrag>(
        H / 32,
        [&](GateFrag& f, int r) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kk = 32 * r + 16 * half;
            const float2 lo = *reinterpret_cast<const float2*>(hp_s + kk);
            const float2 hi = *reinterpret_cast<const float2*>(hp_s + kk + 8);
            f.b[2 * half] = pack_bf16x2(lo.x, lo.y);
            f.b[2 * half + 1] = pack_bf16x2(hi.x, hi.y);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldmatrix_x4(f.a[half][mt], a_gate + (uint32_t)((16 * mt * WS + kk) * 2));
          }
        },
        [&](const GateFrag& f, int) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_bf16(acc[mt][half], f.a[half][mt], f.b[2 * half], f.b[2 * half + 1]);
          }
        });

    float keep[2];
    bf16* dg_w = dg_s + (s & 1) * kMmaTile * GS + dg_at_lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + acc[0][1][i]);
      const float fg = fast_sigmoid(acc[0][0][2 + i] + acc[0][1][2 + i]);
      const float gg = fast_tanh(acc[1][0][i] + acc[1][1][i]);
      const float og = fast_sigmoid(acc[1][0][2 + i] + acc[1][1][2 + i]);
      const float cprev = cp_s[i * CS];
      const float dyv = has_dhs ? dy_s[i * CS] : 0.0f;
      const float c_new = fg * cprev + ig * gg;
      const float dht = dh[i] + dyv;
      const float tc = fast_tanh(c_new);
      const float dct = dc[i] + dht * og * (1.0f - tc * tc);
      const bool m = on[i];
      float g4[4];
      g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
      g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
      g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
      g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
      dc[i] = m ? dct * fg : dc[i];
      keep[i] = m ? 0.0f : dht;
#pragma unroll
      for (int q = 0; q < 4; ++q) dg_w[i * GS + 8 * q] = __float2bfloat16_rn(g4[q]);
      if (rown[i] >= 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dsrc[i][q * H] = g4[q];
      }
      dsrc[i] -= (ptrdiff_t)D * B * H4;
    }
    cp_async_wait<1>();  // the next step's tiles have landed
    __syncthreads();     // dgates tile complete; every warp is past this step's tile reads

    // dh_prev^T = W^T . dgates^T: rows 0-7 of the m16 tile are this warp's units
    float c2[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int v = 0; v < 4; ++v) c2[h2][v] = 0.0f;
    }
    const uint32_t b_step = b_dh + (uint32_t)((s & 1) * kMmaTile * GS * 2);
    pipelined_rounds<TransFrag>(
        H4 / 32,
        [&](TransFrag& f, int r) {
          ldmatrix_x4(f.b, b_step + (uint32_t)(r * 64));
          ldmatrix_x4_trans(f.a, a_dh + (uint32_t)(32 * r * WS * 2));
        },
        [&](const TransFrag& f, int) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            // the A fragment is (rows 0-7, rows 8-15) x (k 0-7, k 8-15): rows
            // 8-15 of the tile repeat rows 0-7 and their results are not read
            const uint32_t aa[4] = {f.a[2 * h2], f.a[2 * h2], f.a[2 * h2 + 1], f.a[2 * h2 + 1]};
            mma_bf16(c2[h2], aa, f.b[2 * h2], f.b[2 * h2 + 1]);
          }
        });
#pragma unroll
    for (int i = 0; i < 2; ++i) dh[i] = c2[0][i] + c2[1][i] + keep[i];
  }
}

template <int H>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_bwd_mma_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_bwd_mma_kernel<H><<<dim3(tiles, D), 32 * H / 8, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_recurrence_bwd_mma_tile() { return kMmaTile; }
int lstm_recurrence_bwd_mma_stages() { return kStages; }
int lstm_recurrence_bwd_mma_max_chunks() { return kMaxChunks; }
int lstm_recurrence_bwd_mma_max_h() { return kMaxH; }
int lstm_recurrence_bwd_mma_w_pad() { return kWPad; }
int lstm_recurrence_bwd_mma_f_pad() { return kFPad; }

const char* lstm_recurrence_bwd_mma_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16 (w's type and the rounding of h_prev and
// dgates). xg (T, D, B, 4H) f32; valid (T, D, B) uint8; w (D, G, H, 4H) bf16;
// hs, cs, dhs (T, D, B, H) f32 (dhs may be null: zero); dhn / dcn (D, B, H)
// f32 or null (zero); dxg (T, D, B, 4H) f32. H is 32 or 64 (kMaxH); each
// of the G weight groups (B / G rows) is cut into its own 8-row tiles:
// `tiles` = G * ceil(B / G / 8). Returns a cudaError_t (0 on success).
int lstm_recurrence_bwd_mma(const void* xg, const void* valid, const void* w, const void* hs,
                            const void* cs, const void* dhs, const void* dhn, const void* dcn,
                            void* dxg, int D, int T_steps, int B, int H, int G, int tiles,
                            int smem, void* stream) {
  const Args a{static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
               static_cast<const bf16*>(w), static_cast<const float*>(hs),
               static_cast<const float*>(cs), static_cast<const float*>(dhs),
               static_cast<const float*>(dhn), static_cast<const float*>(dcn),
               static_cast<float*>(dxg), T_steps, B, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch<64>(a, D, tiles, smem, st);
  if (H == 32) return launch<32>(a, D, tiles, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
