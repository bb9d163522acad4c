// Bidirectional LSTM layer backward sweep (BPTT), bf16 compute dtype, H <= 80:
// the tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd_f32.cu (f32), the recurrent part of the TPU
// kernels
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _bwd_kernel_packed (via
//     _bwd_pallas_packed) -- the train step's layer backward at 2H == 128,
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel (via _bwd_pallas)
//     at the other widths that fit.
// Their weight-gradient products are bilstm_wgrad_mma.cu's.
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep, as bilstm_bwd.cu):
// block (row tile, direction d) walks the positions in the reverse of that
// direction's forward order carrying dh and dc (f32). Per step and row:
// gates recomputed from x(pos) and h_prev, c_prev from the bf16 cell stream,
// dh += the 0-2 dy streams, the masked dgates (f32; a position at or past
// the row's length gets dgates = 0 and passes dh and dc through), dgc =
// bf16(dgates) to the (2, T, B, 4H) stream, dx = dgc @ W_ih[d] per input
// part in bf16, dh = dgc @ W_hh[d, g] (+ the passed-through dh), and dbias
// partials from the unrounded dgates, one (2, 4H) slab per tile.
//
// What bounds it on an H100: the roofline bound is bytes (the bf16 streams,
// under a millisecond per layer); the products are a fraction of that on the
// tensor cores. What governs is the serial chain of a step, T times:
// fragment loads, an mma chain over K = E + H, the cell's transcendentals,
// one shared-memory round trip of the dgates, one block barrier, an mma
// chain over K = 4H.
//
// Design (bilstm_mma.cuh has the fragment and permutation notes):
//   * the products are swapped, weights as the 16-row operand, the 8-row
//     tile as the 8-column one (mma.sync m16n8k16);
//   * [W_ih[d] | W_hh[d, g]] is resident in shared memory in bf16, ONE copy
//     (4H x (E + H), 96 KB at E = 128), gate rows permuted, rows padded by 8
//     elements so ldmatrix is conflict-free. The gate product reads it
//     through ldmatrix, the transposed products (dx, dh) through
//     ldmatrix.trans;
//   * warp w owns hidden units 8w .. 8w+7: the four gates of a unit for two
//     batch rows land in one lane, the cell maths needs no exchange, and the
//     bf16 dgates go to shared memory once (double-buffered: ONE
//     __syncthreads a step);
//   * the m16 tile of warp w's dh product has only 8 useful rows (its
//     units); rows 8-15 carry 8 columns of dx for free. The dx columns left
//     over (E > H) go to extra warps that only wait at the barrier, multiply
//     and store: dx is off the serial chain;
//   * the step's tiles (x, h_prev, c_prev, dy; 16 bytes a copy) arrive
//     through a three-stage cp.async ring, two steps ahead; dgc leaves as
//     16-byte chunks copied from the shared tile;
//   * a tile skips the positions at or past its longest row: there dgates
//     and dx are zero (written up front) and dh only gathers dy, which the
//     forward direction's sweep adds up before its first real step (the
//     reverse direction meets those positions last, where dh is dead);
//   * row tiles of 8: 2 x 50 blocks at 400 rows, one wave on 132 SMs; each
//     weight group is cut into its own tiles, nothing is padded.
// At E = H = 80 (layer 0 of the two-layer model at embedding 80) the same
// design takes 10 warps, one per 8 units, whose m16 rows 8-15 carry all 80
// dx columns (no extra warps); the resident weights are 4H x (E + H + 8) x 2
// = 107,520 B and the block 138,752 B of shared memory: one block an SM, the
// 100 blocks of the train step in one wave. ops/lstm_cuda.py:bwd_mma_plan
// takes H = 80 at E = 80 only (the <80, 80> instance), the shapes
// bilstm_bwd.cu took there, so no layer changes its route or padded shape.
// At H % 16 == 8 (H = 8, 24, 40, 56, 72: layer 0 at embedding 72 is the
// main path, E = H = 72, its <72, 72> instance) the gate rows still fill
// whole m16 tiles (a warp's 8 units are 32 permuted rows) and the dh
// product's K = 4H whole rounds of 32; only the gate product's K = E + H
// stops 16 (or 8 or 24) short of a round. The kernel pads it inside: K runs
// to Kp, the next multiple of 32, over zero columns of the resident weights
// and of each stage's [x ; h] tile, written once (zero weights add exact
// zeros). The streams, dgc, dx and dbias keep their true widths, and the
// layer its padded shape: bwd_mma_plan takes these widths only at the
// shapes bilstm_bwd.cu took there. At E = H = 72: 9 warps, K = 144 run as
// 160, 125,824 B of shared memory.
// At H = 16-64 the same padding takes every E (ops/lstm_cuda.py:
// BWD_MMA_ANY_K_WIDTHS), where K % 32 is 16 and K = E + H was refused
// before: the stacked layer of the bf16 model at embedding 16 (E = 32,
// H = 16, K = 48 run as 64; its <16, 32> instance: 2 main warps and one dx
// warp, 18,432 B of shared memory; layer 0, E = H = 16, has a <16, 16>
// instance) and layer 0 at H = 16, E = 8 (K = 24, the run-time <0, 0>
// build), both bilstm_bwd.cu's before.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;
constexpr int kMaxChunks = 3;   // 16-byte tile chunks each thread copies per step
constexpr int kMaxThreads = 384;
constexpr int kMaxH = 80;
constexpr int kPad = 8;         // bf16 elements of padding on every shared row

// One round (32 of K) of a product's fragments: the B operand of two
// k-steps and the A operands of each k-step's m16 tiles.
struct GateFrag {
  uint32_t b[4];
  uint32_t a[2][2][4];  // [k-step][m-tile]
};
struct TransFrag {
  uint32_t b[4];
  uint32_t a[2][4];  // [k-step]
};

struct Args {
  const bf16* x[2];
  int E0, E1;
  const int* lengths;
  const bf16* w_ih;
  const bf16* w_hh;
  const float* bias;
  const bf16* hs[2];     // per direction
  const bf16* cs[2];
  const bf16* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // may be null (zero)
  const float* dcn;
  bf16* dx[2][2];  // [direction][part]
  bf16* dgc;
  float* dbias_part;
  int T, B, H, G;
};

// grid (tiles, 2), block 32 * (H / 8 + extra dx warps) threads. HT and ET
// (the layer's H and total input width E) are template parameters for the
// model's shapes, so the product loops unroll and the shared-memory offsets
// are immediates: a step is bound by how many machine operations it
// dispatches, not by the tensor cores. HT = ET = 0 is the same code with
// both read at run time.
template <int HT, int ET>
__global__ void __launch_bounds__(kMaxThreads, 1) bilstm_bwd_mma_kernel(const Args a) {
  const int tile = blockIdx.x, d = blockIdx.y;
  const int H = HT ? HT : a.H, H4 = 4 * H, T = a.T, B = a.B;
  const int E0 = a.E0, E1 = a.E1, E = ET ? ET : E0 + E1, K = E + H, ny = a.ny;
  const int Kp = (K + 31) & ~31;  // the gate product's K: zero columns past K
  const int KS = Kp + kPad;  // weight and x|h tile row stride
  const int HS = H + kPad;   // c_prev / dy tile row stride
  const int GS = H4 + kPad;  // dgates tile row stride
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix index
  const int NW = H / 8;                     // main warps, 8 units each
  const int NE = E / 8;                     // dx column groups of 8
  const bool main_warp = warp < NW;
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;  // main warps only

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* W_s = reinterpret_cast<bf16*>(smem);  // [4H permuted][KS]: W_ih | W_hh | 0
  const uint32_t dg_at = (uint32_t)H4 * KS * 2;  // a multiple of 16
  bf16* dg_s = reinterpret_cast<bf16*>(smem + dg_at);  // [2][8][GS], permuted gate order
  const uint32_t stages_at = dg_at + 2 * kMmaTile * GS * 2;
  const uint32_t cp_off = kMmaTile * KS * 2;            // after the x|h tile
  const uint32_t dy_off = cp_off + kMmaTile * HS * 2;   // after the c_prev tile
  const uint32_t stage_bytes = dy_off + ny * kMmaTile * HS * 2;
  unsigned char* stages = smem + stages_at;
  const uint32_t stages_u32 = smem_u32(stages);

  // the tile's longest row bounds the positions that do any work: step s of
  // this tile works on position s (d = 1) or maxlen - 1 - s (d = 0)
  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;

  // the step's tiles as 16-byte chunks (8 elements): x0 | x1 | h_prev | c_prev
  // | dy.. Each thread keeps, per chunk, the source address of the next step
  // to fetch and walks it one position per fetch.
  const int per_row = (E + (2 + ny) * H) / 8;
  const bf16* c_src[kMaxChunks];
  uint32_t c_dst[kMaxChunks];
  int c_walk[kMaxChunks];   // elements to walk per step; 0: chunk unused
  int c_shift[kMaxChunks];  // position offset; kNoRow when the tile row is past the group
  constexpr int kNoRow = 1 << 20;
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int idx = tid + m * nthreads;
    c_src[m] = a.x[0];
    c_dst[m] = 0;
    c_walk[m] = 0;
    c_shift[m] = 0;
    if (idx >= kMmaTile * per_row) continue;
    const int n = idx / per_row, e = (idx - n * per_row) * 8;
    const bool real = n < nrows;
    const size_t row = row0 + (real ? n : 0);
    const bf16* base;
    int width, col;
    if (e < E0) {
      base = a.x[0]; width = E0; col = e;
      c_dst[m] = (n * KS + e) * 2;
    } else if (e < E) {
      base = a.x[1]; width = E1; col = e - E0;
      c_dst[m] = (n * KS + e) * 2;
    } else if (e < K) {
      base = a.hs[d]; width = H; col = e - E;
      c_dst[m] = (n * KS + e) * 2;
      c_shift[m] = hshift;
    } else if (e < K + H) {
      base = a.cs[d]; width = H; col = e - K;
      c_dst[m] = cp_off + (n * HS + col) * 2;
      c_shift[m] = hshift;
    } else {
      const int k = (e - K - H) / H;
      base = a.dy[d][k]; width = H; col = (e - K - H) - k * H;
      c_dst[m] = dy_off + ((k * kMmaTile + n) * HS + col) * 2;
    }
    c_walk[m] = dpos * B * width;
    c_src[m] = base + row * width + col + (ptrdiff_t)(pos0 + c_shift[m]) * B * width;
    if (!real) c_shift[m] = kNoRow;
  }
  int fetch_stage = 0, fetch_pos = pos0;
  auto fetch = [&]() {
    const uint32_t base = stages_u32 + (uint32_t)fetch_stage * stage_bytes;
    fetch_stage = fetch_stage == kStages - 1 ? 0 : fetch_stage + 1;
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (c_walk[m] == 0) continue;
      const int at = fetch_pos + c_shift[m];
      const bool ok = at >= 0 && at < T;  // kNoRow puts `at` past T
      cp_async16(base + c_dst[m], ok ? c_src[m] : a.x[0], ok);
      c_src[m] += c_walk[m];
    }
    fetch_pos += dpos;
  };
  if (maxlen > 0) fetch();
  cp_async_commit();
  if (maxlen > 1) fetch();
  cp_async_commit();

  // stage [W_ih[d] | W_hh[d, group] | 0] with permuted rows, 16 bytes a copy
  const uint4 zero16 = make_uint4(0u, 0u, 0u, 0u);
  {
    const int wpr = Kp / 8;
    const bf16* wi = a.w_ih + (size_t)d * H4 * E;
    const bf16* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    for (int idx = tid; idx < H4 * wpr; idx += nthreads) {
      const int p = idx / wpr, c = (idx - p * wpr) * 8;
      const int j = gate_row_of_permuted(p, H);
      const bf16* src = c < E ? wi + (size_t)j * E + c : wh + (size_t)j * H + (c - E);
      *reinterpret_cast<uint4*>(W_s + (size_t)p * KS + c) =
          c < K ? *reinterpret_cast<const uint4*>(src) : zero16;
    }
  }
  // the [x ; h] tile's columns [K, Kp) of every stage: zero, never copied to
  if (Kp > K) {
    const int pc = max(1, (Kp - K) / 8);  // (max: no division by zero where Kp == K)
    for (int idx = tid; idx < kStages * kMmaTile * pc; idx += nthreads) {
      const int sn = idx / pc, c = K + (idx - sn * pc) * 8;
      *reinterpret_cast<uint4*>(stages + (size_t)(sn / kMmaTile) * stage_bytes +
                                ((sn % kMmaTile) * KS + c) * 2) = zero16;
    }
  }

  // positions [maxlen, T): zero dgc and dx rows, 16 bytes a store
  {
    const int per_pos = nrows * (H4 + E) / 8, ng = nrows * H4 / 8, n0 = nrows * E0 / 8;
    for (int idx = tid; idx < (T - maxlen) * per_pos; idx += nthreads) {
      const int pi = idx / per_pos, r = idx - pi * per_pos;
      const size_t at = (size_t)(maxlen + pi) * B + row0;
      bf16* dst;
      if (r < ng) dst = a.dgc + ((size_t)d * T * B + at) * H4 + (size_t)r * 8;
      else if (r < ng + n0) dst = a.dx[d][0] + at * E0 + (size_t)(r - ng) * 8;
      else dst = a.dx[d][1] + at * E1 + (size_t)(r - ng - n0) * 8;
      *reinterpret_cast<uint4*>(dst) = zero16;
    }
  }

  // main warps: this lane owns unit `unit` for batch rows 2t and 2t + 1
  int rown[2], len[2];
  float dh[2], dc[2], bi[4], dbias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bi[q] = main_warp ? a.bias[d * H4 + q * H + unit] : 0.0f;
    dbias[q] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * t + i;
    rown[i] = (main_warp && n < nrows) ? row0 + n : -1;
    len[i] = rown[i] >= 0 ? a.lengths[rown[i]] : 0;
    const size_t at = ((size_t)d * B + (rown[i] >= 0 ? rown[i] : 0)) * H + unit;
    dh[i] = (rown[i] >= 0 && a.dhn) ? a.dhn[at] : 0.0f;
    dc[i] = (rown[i] >= 0 && a.dcn) ? a.dcn[at] : 0.0f;
    // the forward direction's sweep starts at T-1: past the tile's longest
    // row a step only adds dy to dh, in the same order as the full sweep
    if (d == 0 && rown[i] >= 0 && ny > 0) {
      for (int pos = T - 1; pos >= maxlen; --pos) {
        float dyv = 0.0f;
        for (int k = 0; k < ny; ++k)
          dyv += __bfloat162float(a.dy[0][k][((size_t)pos * B + rown[i]) * H + unit]);
        dh[i] += dyv;
      }
    }
  }

  // columns of W_s the two row halves of this warp's transposed-product tile
  // read: main warp w: rows 0-7 = dh of its units (W_hh columns), rows 8-15 =
  // dx column group w; extra warp x: dx column groups NW + 2x and NW + 2x + 1.
  // A group past NE repeats the other half and is not stored.
  int col_lo, col_hi;
  if (main_warp) {
    col_lo = E + 8 * warp;
    col_hi = warp < NE ? 8 * warp : col_lo;
  } else {
    const int ga = NW + 2 * (warp - NW);
    col_lo = 8 * ga;
    col_hi = ga + 1 < NE ? 8 * (ga + 1) : col_lo;
  }
  // this lane's dx outputs: input column col_lo + g (extra warps) and
  // col_hi + g, rows 2t and 2t + 1, at the current position; null: none
  bf16* dx_out[2][2];
  int dx_walk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool has = half ? col_hi != col_lo : !main_warp;
    const int e = (half ? col_hi : col_lo) + g;
    const bool part0 = e < E0;
    const int Ep = part0 ? E0 : E1, col = part0 ? e : e - E0;
    dx_walk[half] = dpos * B * Ep;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = 2 * t + i;
      dx_out[half][i] = (has && n < nrows)
          ? a.dx[d][part0 ? 0 : 1] + ((size_t)pos0 * B + row0 + n) * Ep + col : nullptr;
    }
  }

  const uint32_t W_u32 = smem_u32(W_s);
  // gate product A: rows 32*warp + 16*mt + lr + 8*(lm & 1), columns k0 + 8*(lm >> 1)
  const uint32_t a_gate =
      W_u32 + (uint32_t)(((32 * warp + lr + 8 * (lm & 1)) * KS + 8 * (lm >> 1)) * 2);
  // gate product B: x|h tile row lr, columns k0 + 8*lm (two k-steps a load)
  const uint32_t b_gate = (uint32_t)((lr * KS + 8 * lm) * 2);
  // transposed product A: stored rows p0 + 8*(lm >> 1) + lr, columns by row half
  const uint32_t a_tr =
      W_u32 + (uint32_t)(((8 * (lm >> 1) + lr) * KS + ((lm & 1) ? col_hi : col_lo)) * 2);
  // transposed product B: dgates tile row lr, columns p0 + 8*lm
  const uint32_t b_tr = smem_u32(dg_s) + (uint32_t)((lr * GS + 8 * lm) * 2);
  // this lane's reads of the c_prev / dy tiles and its writes of the dgates tile
  const int c_at = 2 * t * HS + unit, dg_at_lane = 2 * t * GS + 32 * warp + g;

  // the dgc tile leaves as 16-byte chunks: chunk c of row n holds permuted
  // rows 8c .. 8c+7, i.e. gate rows j .. j+7 with j = gate_row_of_permuted(8c)
  // (the block has at least 4H threads and the tile 4H chunks: one each)
  int g_src = -1;         // element offset in the dgates tile, -1: none
  bf16* g_dst = nullptr;  // its place in dgc at the current position
  {
    const int n = tid / (H4 / 8), c = tid - n * (H4 / 8);
    if (n < nrows) {
      g_src = n * GS + 8 * c;
      g_dst = a.dgc + (((size_t)d * T + pos0) * B + row0 + n) * H4 + gate_row_of_permuted(8 * c, H);
    }
  }
  const ptrdiff_t g_walk = (ptrdiff_t)dpos * B * H4;

  cp_async_wait<1>();
  __syncthreads();

  int stage = 0, pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + 2 < maxlen) fetch();
    cp_async_commit();
    const uint32_t st_off = (uint32_t)stage * stage_bytes;
    stage = stage == kStages - 1 ? 0 : stage + 1;
    bf16* dg_w = dg_s + (s & 1) * kMmaTile * GS;
    float keep[2] = {0.0f, 0.0f};

    if (main_warp) {
      // gates^T: acc[mt][chain]: mt 0 rows = gates i | f, mt 1 = g | o, of units 8w..8w+7
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
      const uint32_t b_step = stages_u32 + st_off + b_gate;
      pipelined_rounds<GateFrag>(
          Kp / 32,
          [&](GateFrag& f, int r) {
            ldmatrix_x4(f.b, b_step + (uint32_t)(r * 64));
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(f.a[half][mt],
                            a_gate + (uint32_t)((16 * mt * KS + 32 * r + 16 * half) * 2));
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

      const bf16* cp_s = reinterpret_cast<const bf16*>(stages + st_off + cp_off) + c_at;
      const bf16* dy_s = reinterpret_cast<const bf16*>(stages + st_off + dy_off) + c_at;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ig = fast_sigmoid(acc[0][0][i] + acc[0][1][i]);
        const float fg = fast_sigmoid(acc[0][0][2 + i] + acc[0][1][2 + i]);
        const float gg = fast_tanh(acc[1][0][i] + acc[1][1][i]);
        const float og = fast_sigmoid(acc[1][0][2 + i] + acc[1][1][2 + i]);
        const float cprev = __bfloat162float(cp_s[i * HS]);
        float dyv = 0.0f;
        for (int k = 0; k < ny; ++k) dyv += __bfloat162float(dy_s[(k * kMmaTile + i) * HS]);
        const float c_new = fg * cprev + ig * gg;
        const float dht = dh[i] + dyv;
        const float tc = fast_tanh(c_new);
        const float dct = dc[i] + dht * og * (1.0f - tc * tc);
        const bool m = pos < len[i];
        float g4[4];
        g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
        g4[1] = m ? dct * cprev * fg * (1.0f - fg) : 0.0f;
        g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
        g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
        dc[i] = m ? dct * fg : dc[i];
        keep[i] = m ? 0.0f : dht;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dbias[q] += g4[q];
          dg_w[dg_at_lane + i * GS + 8 * q] = __float2bfloat16_rn(g4[q]);
        }
      }
    }
    cp_async_wait<1>();  // the next step's tiles have landed
    __syncthreads();     // dgates tile complete; every warp is past this step's tile reads

    // [dh_prev ; dx]^T = [W_hh ; W_ih]^T . dgates^T over the permuted gate rows
    float c2[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int v = 0; v < 4; ++v) c2[h2][v] = 0.0f;
    }
    const uint32_t b_step = b_tr + (uint32_t)((s & 1) * kMmaTile * GS * 2);
    pipelined_rounds<TransFrag>(
        H4 / 32,
        [&](TransFrag& f, int r) {
          ldmatrix_x4(f.b, b_step + (uint32_t)(r * 64));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            ldmatrix_x4_trans(f.a[h2], a_tr + (uint32_t)((32 * r + 16 * h2) * KS * 2));
        },
        [&](const TransFrag& f, int) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) mma_bf16(c2[h2], f.a[h2], f.b[2 * h2], f.b[2 * h2 + 1]);
        });
    if (main_warp) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dh[i] = c2[0][i] + c2[1][i] + keep[i];
    }
    // dx: rows g (lo half) and g + 8 (hi half) of the tile are input columns
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (dx_out[half][i]) {
          *dx_out[half][i] = __float2bfloat16_rn(c2[0][2 * half + i] + c2[1][2 * half + i]);
          dx_out[half][i] += dx_walk[half];
        }
      }
    }
    // dgc: the bf16 dgates tile, back in torch gate order
    if (g_src >= 0) {
      *reinterpret_cast<uint4*>(g_dst) =
          *reinterpret_cast<const uint4*>(dg_s + (s & 1) * kMmaTile * GS + g_src);
      g_dst += g_walk;
    }
  }

  // dbias: sum the four lanes that share a unit, one slab per (tile, direction)
  if (main_warp) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = dbias[q];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) a.dbias_part[((size_t)tile * 2 + d) * H4 + q * H + unit] = v;
    }
  }
}

template <int HT, int ET>
int launch(const Args& a, int tiles, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bilstm_bwd_mma_kernel<HT, ET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_bwd_mma_kernel<HT, ET><<<dim3(tiles, 2), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_bwd_mma_tile() { return kMmaTile; }
int bilstm_bwd_mma_stages() { return kStages; }
int bilstm_bwd_mma_max_chunks() { return kMaxChunks; }
int bilstm_bwd_mma_max_threads() { return kMaxThreads; }
int bilstm_bwd_mma_max_h() { return kMaxH; }
int bilstm_bwd_mma_pad() { return kPad; }

const char* bilstm_bwd_mma_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The compute dtype is bfloat16. Operands as bilstm_bwd (bilstm_bwd.cu)
// without the dtype code: x1, dy*1, dx*1 may be null (one input part, fewer
// dy streams); ny is the number of dy streams per direction (0-2); dhn / dcn
// may be null (zero). Each of the G weight groups (B / G rows) is cut into
// its own 8-row tiles: `tiles` = G * ceil(B / G / 8), and dbias_part is
// (tiles, 2, 4H) f32. H % 8 == 0, H <= kMaxH, E parts multiples of 8 (the
// gate product runs E + H to the next multiple of 32 over zero columns).
// generic != 0 runs the run-time <0, 0> build whatever the shape (to time
// an instance against it). Returns a cudaError_t (0 on success).
int bilstm_bwd_mma(const void* x0, const void* x1, int E0, int E1, const void* lengths,
                   const void* w_ih, const void* w_hh, const void* bias, const void* hs_f,
                   const void* hs_b, const void* cs_f, const void* cs_b, const void* dyf0,
                   const void* dyf1, const void* dyb0, const void* dyb1, int ny, const void* dhn,
                   const void* dcn, void* dxf0, void* dxf1, void* dxb0, void* dxb1, void* dgc,
                   void* dbias_part, int T_steps, int B, int H, int G, int tiles, int threads,
                   int smem, int generic, void* stream) {
  if (H % 8 || H <= 0 || H > kMaxH || E0 % 8 || E1 % 8 || ny < 0 || ny > 2 ||
      threads > kMaxThreads || threads < 32 * (H / 8))
    return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  Args a;
  a.x[0] = in(x0); a.x[1] = in(x1);
  a.E0 = E0; a.E1 = E1;
  a.lengths = static_cast<const int*>(lengths);
  a.w_ih = in(w_ih); a.w_hh = in(w_hh);
  a.bias = static_cast<const float*>(bias);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = static_cast<const float*>(dhn);
  a.dcn = static_cast<const float*>(dcn);
  a.dx[0][0] = out(dxf0); a.dx[0][1] = out(dxf1);
  a.dx[1][0] = out(dxb0); a.dx[1][1] = out(dxb1);
  a.dgc = out(dgc);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int E = E0 + E1;
  if (generic) return launch<0, 0>(a, tiles, threads, smem, st);
  // the model's layers (E = H below, E = 2H stacked) at its two widths,
  // layer 0 of the two-layer models at embedding 80 and 72, and both layers
  // of the bf16 model at embedding 16 (K = 32, and 48 run as 64)
  if (H == 80 && E == 80) return launch<80, 80>(a, tiles, threads, smem, st);
  if (H == 72 && E == 72) return launch<72, 72>(a, tiles, threads, smem, st);
  if (H == 64 && E == 64) return launch<64, 64>(a, tiles, threads, smem, st);
  if (H == 64 && E == 128) return launch<64, 128>(a, tiles, threads, smem, st);
  if (H == 32 && E == 32) return launch<32, 32>(a, tiles, threads, smem, st);
  if (H == 32 && E == 64) return launch<32, 64>(a, tiles, threads, smem, st);
  if (H == 16 && E == 32) return launch<16, 32>(a, tiles, threads, smem, st);
  if (H == 16 && E == 16) return launch<16, 16>(a, tiles, threads, smem, st);
  return launch<0, 0>(a, tiles, threads, smem, st);
}

}  // extern "C"
