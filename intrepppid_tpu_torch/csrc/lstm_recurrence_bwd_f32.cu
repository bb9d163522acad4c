// Backward sweep of the masked LSTM recurrence over precomputed, time-major
// input gates, f32 compute dtype, H = 32 or 64: the tensor-core variant in
// three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like lstm_recurrence_bwd_mma.cu (bf16) and the sweeps of the
// wider widths, the recurrent part of the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas.py  _bwd_kernel (via _bwd_pallas, :274)
// behind the public op fused_lstm_recurrence; the dW sums stay in
// lstm_recurrence_wgrad.cu.
//
// Function (the contract of ops/lstm_recurrence.py:recurrence_sweep with the
// compute dtype f32, where round() is the identity): block (row tile,
// direction d) walks s = T-1 .. 0 carrying dh and dc (f32, from dhn / dcn).
// Per step and row r:
//   * gates = xg[s, d, r] + h_prev @ w[d, g], h_prev = hs[s-1, d, r] and
//     c_prev = cs[s-1, d, r] (zero at s = 0); c_new = f * c_prev + i * g;
//   * dh += dhs[s, d, r];
//   * dgates: a step with valid[s, d, r] == 0 gets dgates = 0 and passes dh
//     and dc through; dxg[s, d, r] = dgates;
//   * dh = dgates @ w[d, g]^T + (masked ? dh : 0),
//     dc = masked ? dc : dc_t * f.
//
// What bounds it on an H100: the roofline bound is the 44 H bytes of f32
// streams per row and step (xg, hs, cs, dhs in, dxg out), about 2 ms for
// both layers of the recurrence-backend step; the products (2 x 4H x H
// multiply-adds per row and step) take three tf32 passes each, a fraction
// of that at 495/3 TFLOP/s. What governs is the serial chain of a step, T
// times. One tf32 pass keeps ~3 decimal digits, which would break the f32
// agreement (1e-4 x max(1, max|ref|)), so every product is big.big +
// big.small + small.big (split_tf32, bilstm_mma.cuh): about 20 bits.
//
// Design: the single-block design of lstm_recurrence_bwd_mma.cu, no cluster:
//   * one block per (8-row tile, direction), one warp per 8 hidden units;
//     2 x 50 blocks at 400 rows (one wave on 132 SMs);
//   * w[d, g] (4H x H f32, 64 KB at H = 64) is small enough to sit in
//     shared memory PRE-SPLIT: a big and a small copy (128 KB), transposed
//     and gate-row-permuted while staged (bilstm_mma.cuh), rows padded to
//     8 (mod 32) floats. Both products read them and split no weight:
//     gates^T = W . h_prev^T as float2 pairs (the K order within a k8 step
//     is read as pairs, the h_prev tile the same way), and dh_prev^T =
//     W^T . dgates^T as single floats, all conflict-free;
//   * in the transposed product the m16 tile's rows 8-15, which would only
//     repeat rows 0-7 (a warp owns 8 units), carry the small copy: one mma
//     gives big.b and small.b, so two mma a k8 step give all four terms;
//   * the cell update splits its dgates once into a big and a small f32
//     tile (two buffers each, so the step has ONE __syncthreads), which the
//     transposed product reads through ldmatrix (a b16 pair is one f32);
//     dxg is stored from the unsplit f32 dgates;
//   * the step's stream tiles (xg, hs, cs, dhs; 16 bytes a copy) arrive
//     through a three-stage cp.async ring, two steps ahead; only the 8-row
//     h_prev operand is split in the loop;
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh).

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kStages = 3;
constexpr int kMaxChunks = 4;  // 16-byte tile chunks each thread copies per step
constexpr int kMaxH = 64;
constexpr int kWPad = 8;       // f32 elements: W rows and h_prev tile rows, 8 (mod 32)
constexpr int kFPad = 4;       // f32 elements: xg, c_prev, dhs and dgates tile rows

struct Args {
  const float* xg;
  const uint8_t* valid;
  const float* w;
  const float* hs;
  const float* cs;
  const float* dhs;  // may be null (zero)
  const float* dhn;  // may be null (zero)
  const float* dcn;  // may be null (zero)
  float* dxg;
  int T, B, G;
};

// grid (tiles, D), block 32 * H / 8 threads. H is a template parameter so
// the product loops unroll and the shared-memory offsets are immediates.
template <int H>
__global__ void __launch_bounds__(32 * H / 8, 1) lstm_recurrence_bwd_f32_kernel(const Args a) {
  constexpr int H4 = 4 * H;
  constexpr int WS = H + kWPad;    // W row stride (f32), 8 (mod 32)
  constexpr int GS = H4 + kFPad;   // dgates tile row stride (f32), 4 (mod 32)
  constexpr int XS = H4 + kFPad;   // xg tile row stride
  constexpr int PS = H + kWPad;    // h_prev tile row stride, 8 (mod 32)
  constexpr int CS = H + kFPad;    // c_prev / dhs tile row stride
  constexpr int kThreads = 32 * H / 8;
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

  extern __shared__ __align__(16) unsigned char smem[];
  float* Wb_s = reinterpret_cast<float*>(smem);  // [4H permuted][WS]: big of w[k][j(p)]
  float* Ws_s = Wb_s + H4 * WS;                  // the small part
  float* dg_s = Ws_s + H4 * WS;                  // [2 buffers][big, small][8][GS], permuted
  constexpr int dg_buf = 2 * kMmaTile * GS;
  unsigned char* stages = reinterpret_cast<unsigned char*>(dg_s + 2 * dg_buf);
  constexpr uint32_t xg_off = 0;
  constexpr uint32_t hp_off = xg_off + kMmaTile * XS * 4;
  constexpr uint32_t cp_off = hp_off + kMmaTile * PS * 4;
  constexpr uint32_t dy_off = cp_off + kMmaTile * CS * 4;
  constexpr uint32_t stage_bytes = dy_off + kMmaTile * CS * 4;
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

  // stage w[d, group] (H, 4H) transposed, rows permuted, split into big and small
  {
    const float* wd = a.w + ((size_t)d * a.G + group) * H * H4;
    for (int idx = tid; idx < H * H4; idx += kThreads) {
      const int k = idx / H4, j = idx - k * H4;
      const int at = permuted_of_gate_row(j, H) * WS + k;
      uint32_t big, small;
      split_tf32(wd[idx], big, small);
      Wb_s[at] = __uint_as_float(big);
      Ws_s[at] = __uint_as_float(small);
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

  // gate product A: permuted rows 32 w + 16 mt + g (+ 8), k pairs 2t, 2t + 1
  // of each k8 step (logical k t and t + 4); B the h_prev tile row g, the
  // same pairs
  const float* ag_b = Wb_s + (32 * warp + g) * WS + 2 * t;
  const float* ag_s = Ws_s + (32 * warp + g) * WS + 2 * t;
  // dh product A: stored rows (permuted gate rows) t and t + 4 of each k8
  // step, column `unit`: rows 0-7 of the tile from the big copy, 8-15 from
  // the small one; B the dgates tiles by ldmatrix, matrix lm = gate columns
  // 4 lm .. 4 lm + 3 of a 16-column pair of k8 steps
  const float* at_b = Wb_s + t * WS + unit;
  const float* at_s = Ws_s + t * WS + unit;
  const uint32_t b_tr = smem_u32(dg_s) + (uint32_t)((lr * GS + 4 * lm) * 4);
  // this lane's reads of the step's tiles and its writes of the dgates tiles
  const int x_at = 2 * t * XS + unit, c_at = 2 * t * CS + unit, p_at = g * PS + 2 * t;
  const int dg_lane = 2 * t * GS + 32 * warp + g;
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

    // gates^T: acc[pass][mt]: mt 0 rows = gates i | f, mt 1 = g | o, of units
    // 8w..8w+7; pass 0 sums big.big (from xg), passes 1 and 2 the cross terms
    float acc[3][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[0][mt][i] = xg_s[i * XS + (2 * mt) * H];
        acc[0][mt][2 + i] = xg_s[i * XS + (2 * mt + 1) * H];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[1][mt][v] = acc[2][mt][v] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < H / 8; ++kk) {
      const float2 bv = *reinterpret_cast<const float2*>(hp_s + 8 * kk);
      uint32_t bb[2], bs[2], ab[2][4], as[2][4];
      split_tf32(bv.x, bb[0], bs[0]);
      split_tf32(bv.y, bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 16 * mt * WS + 8 * kk;
        const float2 lb = *reinterpret_cast<const float2*>(ag_b + r);
        const float2 hb = *reinterpret_cast<const float2*>(ag_b + r + 8 * WS);
        const float2 ls = *reinterpret_cast<const float2*>(ag_s + r);
        const float2 hs2 = *reinterpret_cast<const float2*>(ag_s + r + 8 * WS);
        ab[mt][0] = __float_as_uint(lb.x); ab[mt][1] = __float_as_uint(hb.x);
        ab[mt][2] = __float_as_uint(lb.y); ab[mt][3] = __float_as_uint(hb.y);
        as[mt][0] = __float_as_uint(ls.x); as[mt][1] = __float_as_uint(hs2.x);
        as[mt][2] = __float_as_uint(ls.y); as[mt][3] = __float_as_uint(hs2.y);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[0][mt], ab[mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[1][mt], as[mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[2][mt], ab[mt], bs[0], bs[1]);
    }

    float keep[2];
    float* dg_w = dg_s + (s & 1) * dg_buf + dg_lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + (acc[1][0][i] + acc[2][0][i]));
      const float fg = fast_sigmoid(acc[0][0][2 + i] + (acc[1][0][2 + i] + acc[2][0][2 + i]));
      const float gg = fast_tanh(acc[0][1][i] + (acc[1][1][i] + acc[2][1][i]));
      const float og = fast_sigmoid(acc[0][1][2 + i] + (acc[1][1][2 + i] + acc[2][1][2 + i]));
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
      for (int q = 0; q < 4; ++q) {
        uint32_t big, small;
        split_tf32(g4[q], big, small);
        dg_w[i * GS + 8 * q] = __uint_as_float(big);
        dg_w[kMmaTile * GS + i * GS + 8 * q] = __uint_as_float(small);
      }
      if (rown[i] >= 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dsrc[i][q * H] = g4[q];
      }
      dsrc[i] -= (ptrdiff_t)D * B * H4;
    }
    cp_async_wait<1>();  // the next step's tiles have landed
    __syncthreads();     // dgates tiles complete; every warp is past this step's tile reads

    // dh_prev^T = W^T . dgates^T: rows 0-7 of the m16 tile are this warp's
    // units with the big weights, rows 8-15 the same units with the small
    // ones. c2[B part: big, small][k8 step mod 4]: eight independent chains.
    float c2[2][4][4];
#pragma unroll
    for (int p2 = 0; p2 < 2; ++p2)
#pragma unroll
      for (int h2 = 0; h2 < 4; ++h2)
#pragma unroll
        for (int v = 0; v < 4; ++v) c2[p2][h2][v] = 0.0f;
    const uint32_t b_step = b_tr + (uint32_t)((s & 1) * dg_buf * 4);
#pragma unroll
    for (int k2 = 0; k2 < H4 / 16; ++k2) {
      uint32_t bb[4], bs[4];
      ldmatrix_x4(bb, b_step + (uint32_t)(k2 * 64));
      ldmatrix_x4(bs, b_step + (uint32_t)((kMmaTile * GS + k2 * 16) * 4));
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = (16 * k2 + 8 * h2) * WS;
        const uint32_t aa[4] = {__float_as_uint(at_b[r]), __float_as_uint(at_s[r]),
                                __float_as_uint(at_b[r + 4 * WS]),
                                __float_as_uint(at_s[r + 4 * WS])};
        const int chain = (2 * k2 + h2) & 3;
        mma_tf32(c2[0][chain], aa, bb[2 * h2], bb[2 * h2 + 1]);
        mma_tf32(c2[1][chain], aa, bs[2 * h2], bs[2 * h2 + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = keep[i];
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2)
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2) v += c2[p2][h2][i] + c2[p2][h2][2 + i];
      dh[i] = v;
    }
  }
}

template <int H>
int launch(const Args& a, int D, int tiles, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_bwd_f32_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_bwd_f32_kernel<H><<<dim3(tiles, D), 32 * H / 8, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_recurrence_bwd_f32_tile() { return kMmaTile; }
int lstm_recurrence_bwd_f32_stages() { return kStages; }
int lstm_recurrence_bwd_f32_max_chunks() { return kMaxChunks; }
int lstm_recurrence_bwd_f32_max_h() { return kMaxH; }
int lstm_recurrence_bwd_f32_w_pad() { return kWPad; }
int lstm_recurrence_bwd_f32_f_pad() { return kFPad; }

const char* lstm_recurrence_bwd_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. xg (T, D, B, 4H) f32; valid (T, D, B) uint8;
// w (D, G, H, 4H) f32; hs, cs, dhs (T, D, B, H) f32 (dhs may be null: zero);
// dhn / dcn (D, B, H) f32 or null (zero); dxg (T, D, B, 4H) f32. H is 32 or
// 64 (kMaxH); each of the G weight groups (B / G rows) is cut into its own
// 8-row tiles: `tiles` = G * ceil(B / G / 8). Returns a cudaError_t (0 on
// success).
int lstm_recurrence_bwd_f32(const void* xg, const void* valid, const void* w, const void* hs,
                            const void* cs, const void* dhs, const void* dhn, const void* dcn,
                            void* dxg, int D, int T_steps, int B, int H, int G, int tiles,
                            int smem, void* stream) {
  if (G <= 0 || B % G) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xg), static_cast<const uint8_t*>(valid),
               static_cast<const float*>(w), static_cast<const float*>(hs),
               static_cast<const float*>(cs), static_cast<const float*>(dhs),
               static_cast<const float*>(dhn), static_cast<const float*>(dcn),
               static_cast<float*>(dxg), T_steps, B, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch<64>(a, D, tiles, smem, st);
  if (H == 32) return launch<32>(a, D, tiles, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
