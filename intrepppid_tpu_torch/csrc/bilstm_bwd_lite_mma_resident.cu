// Bidirectional LSTM layer backward sweep over the input-gate streams, bf16
// compute dtype, at H = 96, where one direction's and one group's W_hh fits
// one block: the tensor-core sweep with the weights resident, hand-written
// for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd_lite_mma.cu (bf16 at 128, 256 and 288) and
// bilstm_bwd_lite.cu (the CUDA-core sweep, which keeps 160, 192 and 224),
// the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel with
//     fused_input=False (via _bwd_pallas_lite, :723)
// at H = 96: the stacked layer of the bf16 models at embedding 80 and 72
// (E = 2 x 80 and 2 x 72, run padded at H = 96 on the wide route, one
// weight group).
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep_lite with the
// compute dtype bf16): block (row tile, direction d) walks the positions in
// the reverse of that direction's forward order carrying dh and dc (f32).
// Per step and row: gates = xg[d, pos] (f32, the bias in it) + h_prev @
// W_hh[d, g]^T (bf16 operands, f32 sums; h_prev the forward stream at the
// previous position: hs_f[pos - 1] for d = 0, hs_b[pos + 1] for d = 1, zero
// past the ends), c_new = f * c_prev + i * g with c_prev from the bf16 cell
// stream there, dh += the 0-2 bf16 dy streams (summed in f32), the masked
// dgates (f32; pos >= length gets 0 and passes dh and dc through, the rules
// of lstm_pallas_layer.py:519-536) to the (2, T, B, 4H) f32 output, and dh =
// bf16(dgates) @ W_hh[d, g] (+ dh passed through where masked), dc = masked
// ? dc : dc_t * f.
//
// What bounds it on an H100: bytes, 1.31 ms at 400 rows, T = 1500 (mostly
// the f32 xg stream in and the f32 dgates stream out); the two products,
// 2 x 4H x H multiply-adds per row and step, are a tenth of that on the
// tensor cores. What governs is the serial chain of a step, T times: the
// gate product, a barrier, the cell, a barrier, the dh product, the pair
// exchange. bilstm_bwd_lite.cu adds two cluster barriers and an exchange
// through distributed shared memory to that chain and runs its products on
// the CUDA cores; at 96 the bf16 weights fit one block, so neither is
// needed.
//
// Design: the schedule of the one-block f32 sweep
// (bilstm_bwd_lite_f32_resident.cu) in one bf16 pass (bilstm_mma.cuh has the
// fragment and permutation notes):
//   * one block per (8-row tile, direction), tiles cut inside each weight
//     group; one warp per 8 hidden units (12 warps, 384 threads, at most
//     170 registers a thread); the stacked layer's 400 rows in one group
//     give 100 blocks, one wave;
//   * the gate product gates^T = W_hh . h_prev^T on mma.sync m16n8k16 with
//     xg[d, pos] straight into the accumulators: no x stream, no W_ih, no
//     dx product. Its A fragments (the warp's 32 permuted gate rows: 2 m16
//     tiles x 6 k16 steps x 4 = 48 registers) stay in registers for the
//     whole sweep, read once from global memory in the permuted order, as
//     in bilstm_fwd_mma.cu; its B operand, the h_prev tile, one ldmatrix.x4
//     per 32 of K;
//   * W_hh[d, g] is also resident in shared memory in bf16, ONE copy (4H
//     rows permuted as the gate product's, row stride H + 8: 79,872 B), for
//     the dh product dh^T = W_hh^T . bf16(dgates)^T (K = 4H = 384). Its A
//     fragments are the transposed reads bf16 allows: ldmatrix.x4.trans of
//     8 x 8 blocks (the f32 sweep reads single floats there). The product
//     has only H / 16 = 6 m16 tiles of units for 12 warps, so warp pair p
//     takes the tile of units 16p .. 16p + 15 and splits its K: warp 2p the
//     first 192 permuted gate rows, warp 2p + 1 the rest (6 rounds of 32
//     each). Each sends the half of its partial that the other warp's units
//     need through shared memory, the pair meets at a named barrier, and
//     each sums (first half) + (second half) in that order, so the result
//     does not depend on timing;
//   * the step's tiles (h_prev and c_prev, the f32 xg, the 0-2 dy streams;
//     16 bytes a copy, zeros past the ends and past the group's rows) come
//     through a three-stage cp.async ring two steps ahead, as in
//     bilstm_bwd_mma.cu. A first build loaded xg, c_prev and dy into
//     registers one step ahead, hidden only by the dh product: 5.74 ms at
//     the main path's shape, 3.8 us a step of exposed latency (PERF.md);
//   * the cell writes the step's dgates twice: in f32 to the tile that
//     leaves for the output as 16-byte chunks in torch gate order, and
//     rounded to bf16 to the dh product's B tile (both in the permuted
//     order; row strides 4H + 4 floats and 4H + 8 bf16, so the lanes'
//     stores and the ldmatrix reads fall in distinct banks; the ring's xg
//     tile takes 4H + 4 too);
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh);
//   * a tile skips the positions at or past its longest row: there dgates
//     is zero (written up front) and dh only gathers dy, which the forward
//     direction's sweep adds up before its first real step (the reverse
//     direction meets those positions last, where dh is dead).
// Shared memory: the weights, the f32 and the bf16 dgates tiles, three ring
// stages and the pair exchange, 158,848 B (smem_bytes); one block an SM.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;
typedef __nv_bfloat16 bf16;

constexpr int kMaxH = 96;               // the one width it is built for
constexpr int kMaxThreads = 4 * kMaxH;  // one warp per 8 units
constexpr int kPad = 8;                 // bf16 elements of padding on every bf16 row
constexpr int kStages = 3;              // the ring of step tiles
constexpr int kMaxChunks = 3;           // 16-byte tile chunks each thread copies per step

struct Args {
  const float* xg;       // (2, T, B, 4H)
  const int* lengths;    // (B,)
  const bf16* w_hh;      // (2, G, 4H, H)
  const bf16* hs[2];     // per direction, (T, B, H)
  const bf16* cs[2];
  const bf16* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // (2, B, H) or null (zero)
  const float* dcn;
  float* dgates;  // (2, T, B, 4H)
  int T, B, G;
};

// One ring stage at H (bytes): the bf16 h_prev tile (8 rows of H + kPad),
// the f32 xg tile (8 rows of 4H + 4), the bf16 c_prev tile and two bf16 dy
// tiles (8 rows of H + kPad each).
__host__ __device__ constexpr int stage_bytes(int H) {
  return kMmaTile * (H + kPad) * 2 * 4 + kMmaTile * (4 * H + 4) * 4;
}

// Dynamic shared memory at H (bytes): the bf16 weights (4H rows of H +
// kPad), the f32 dgates tile (8 rows of 4H + 4), the bf16 dgates tile (8
// rows of 4H + kPad), the ring's stages and the pair exchange (two floats a
// lane). Every part is a multiple of 16 bytes.
__host__ __device__ constexpr int smem_bytes(int H) {
  return 4 * H * (H + kPad) * 2 + kMmaTile * (4 * H + 4) * 4 + kMmaTile * (4 * H + kPad) * 2 +
         kStages * stage_bytes(H) + H / 8 * 64 * 4;
}

// The 64 threads of warp pair `id - 1` meet; shared-memory writes before it
// are visible to both warps after it.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// One round (32 of K) of the dh product: the B operand of two k-steps and
// the A operand of each.
struct TransFrag {
  uint32_t b[4];
  uint32_t a[2][4];  // [k-step]
};

// grid (tiles, 2), block 4H threads.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) bilstm_bwd_lite_mma_resident_kernel(const Args a) {
  constexpr int H4 = 4 * H, NW = H / 8, NK = H / 16;
  constexpr int KS = H + kPad;   // weight, h_prev, c_prev and dy tile row stride (bf16)
  constexpr int FS = H4 + 4;     // f32 xg and dgates tile row stride
  constexpr int GS = H4 + kPad;  // bf16 dgates tile row stride
  constexpr int kThreads = 32 * NW;
  constexpr int kOut = 2;        // 16-byte f32 dgates chunks a thread stores a step
  constexpr int K2 = H4 / 64;    // 32-wide rounds of each half of the dh product
  // a stage: [h_prev][xg][c_prev][dy 0][dy 1], byte offsets
  constexpr uint32_t kXg = kMmaTile * KS * 2, kCp = kXg + kMmaTile * FS * 4;
  constexpr uint32_t kDy = kCp + kMmaTile * KS * 2, kStageBytes = stage_bytes(H);
  // 16-byte chunks of a tile row: h_prev, xg, c_prev, each dy stream
  constexpr int kRowH = H / 8, kRowX = H4 / 4;
  static_assert(H % 16 == 0 && NK % 2 == 0 && H4 % 64 == 0 &&
                    kMmaTile * H4 / 4 <= kOut * kThreads &&
                    kMmaTile * (4 * kRowH + kRowX) <= kMaxChunks * kThreads &&
                    kDy + 2 * kMmaTile * KS * 2 == kStageBytes,
                "shape");
  const int tile = blockIdx.x, d = blockIdx.y;
  const int T = a.T, B = a.B, ny = a.ny;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix index
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, kMmaTile, Bg);
  const int group = row0 / Bg;
  const int nrows = min(kMmaTile, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* W_s = reinterpret_cast<bf16*>(smem);                       // [4H permuted][KS]
  float* dgf_s = reinterpret_cast<float*>(W_s + H4 * KS);          // [8][FS], permuted gate order
  bf16* dgb_s = reinterpret_cast<bf16*>(dgf_s + kMmaTile * FS);    // [8][GS], the same, bf16
  unsigned char* stages = reinterpret_cast<unsigned char*>(dgb_s + kMmaTile * GS);
  float* part_s = reinterpret_cast<float*>(stages + kStages * kStageBytes);  // [NW][2][32]
  const uint32_t stages_u32 = smem_u32(stages);

  // the tile's longest row bounds the positions that do any work: step s
  // works on position s (d = 1) or maxlen - 1 - s (d = 0)
  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  float* dgd = a.dgates + (size_t)d * T * B * H4;
  // positions [maxlen, T): the tile's dgates rows are zero, 16 bytes a store
  {
    const int per_pos = nrows * H4 / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = tid; idx < (T - maxlen) * per_pos; idx += kThreads) {
      const int pi = idx / per_pos, r = idx - pi * per_pos;
      *reinterpret_cast<float4*>(dgd + ((size_t)(maxlen + pi) * B + row0) * H4 +
                                 (size_t)r * 4) = zero;
    }
  }
  if (maxlen == 0) return;  // no step (the whole block leaves: no barrier is skipped)

  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;

  // the step's tiles as 16-byte chunks: h_prev | xg | c_prev | dy.. Each
  // thread keeps, per chunk, the source address of the next step to fetch
  // and walks it one position per fetch.
  const int per_row = 2 * kRowH + kRowX + ny * kRowH;
  const char* c_src[kMaxChunks];
  uint32_t c_dst[kMaxChunks];
  int c_walk[kMaxChunks];   // bytes to walk per step; 0: chunk unused
  int c_shift[kMaxChunks];  // position offset; kNoRow when the tile row is past the group
  constexpr int kNoRow = 1 << 20;
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int idx = tid + m * kThreads;
    c_src[m] = reinterpret_cast<const char*>(a.xg);
    c_dst[m] = 0;
    c_walk[m] = 0;
    c_shift[m] = 0;
    if (idx >= kMmaTile * per_row) continue;
    const int n = idx / per_row, e = idx - n * per_row;
    const bool real = n < nrows;
    const size_t row = row0 + (real ? n : 0);
    const char* base;
    int row_bytes, col;
    if (e < kRowH) {
      base = reinterpret_cast<const char*>(a.hs[d]); row_bytes = H * 2; col = e;
      c_dst[m] = (n * KS + 8 * col) * 2;
      c_shift[m] = hshift;
    } else if (e < kRowH + kRowX) {
      base = reinterpret_cast<const char*>(a.xg + (size_t)d * T * B * H4);
      row_bytes = H4 * 4; col = e - kRowH;
      c_dst[m] = kXg + (n * FS + 4 * col) * 4;
    } else if (e < 2 * kRowH + kRowX) {
      base = reinterpret_cast<const char*>(a.cs[d]); row_bytes = H * 2; col = e - kRowH - kRowX;
      c_dst[m] = kCp + (n * KS + 8 * col) * 2;
      c_shift[m] = hshift;
    } else {
      const int k = (e - 2 * kRowH - kRowX) / kRowH;
      base = reinterpret_cast<const char*>(a.dy[d][k]); row_bytes = H * 2;
      col = e - 2 * kRowH - kRowX - k * kRowH;
      c_dst[m] = kDy + ((k * kMmaTile + n) * KS + 8 * col) * 2;
    }
    c_walk[m] = dpos * B * row_bytes;
    c_src[m] = base + row * row_bytes + (size_t)col * 16 +
               (ptrdiff_t)(pos0 + c_shift[m]) * B * row_bytes;
    if (!real) c_shift[m] = kNoRow;
  }
  int fetch_stage = 0, fetch_pos = pos0;
  auto fetch = [&]() {
    const uint32_t base = stages_u32 + (uint32_t)fetch_stage * kStageBytes;
    fetch_stage = fetch_stage == kStages - 1 ? 0 : fetch_stage + 1;
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (c_walk[m] == 0) continue;
      const int at = fetch_pos + c_shift[m];
      const bool ok = at >= 0 && at < T;  // kNoRow puts `at` past T
      cp_async16(base + c_dst[m], ok ? c_src[m] : reinterpret_cast<const char*>(a.xg), ok);
      c_src[m] += c_walk[m];
    }
    fetch_pos += dpos;
  };
  fetch();
  cp_async_commit();
  if (maxlen > 1) fetch();
  cp_async_commit();

  const bf16* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
  // stage W_hh[d, group] with permuted rows, 16 bytes a copy (the dh
  // product's operand)
  {
    constexpr int kq = H / 8;
    for (int idx = tid; idx < H4 * kq; idx += kThreads) {
      const int p = idx / kq, c = (idx - p * kq) * 8;
      const int j = gate_row_of_permuted(p, H);
      *reinterpret_cast<uint4*>(W_s + p * KS + c) =
          *reinterpret_cast<const uint4*>(wh + (size_t)j * H + c);
    }
  }
  // the gate product's A fragments: m16 tile mt of warp w is permuted rows
  // 32w + 16mt .. +15, i.e. gates 2mt (rows g) and 2mt + 1 (rows g + 8) of
  // unit 8w + g; k-step ks covers W_hh columns [16ks, 16ks + 16)
  uint32_t wa[NK][2][4];
  {
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

  // this lane owns unit `unit` for tile rows 2t and 2t + 1
  int rown[2], len[2];
  float dh[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * t + i;
    rown[i] = n < nrows ? row0 + n : -1;
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

  // gate product B: h_prev tile row lr, columns k0 + 8 lm (two k-steps a load)
  const uint32_t b_gate = stages_u32 + (uint32_t)((lr * KS + 8 * lm) * 2);
  // dh product of warp pair pj, half hk of its K: A = W_hh^T rows 16 pj ..
  // 16 pj + 15 (units), read transposed: stored rows k0 + 8 (lm >> 1) + lr,
  // columns 16 pj + 8 (lm & 1); B the bf16 dgates tile row lr, columns
  // k0 + 8 lm
  const int pj = warp >> 1, hk = warp & 1;
  const uint32_t a_tr = smem_u32(W_s) + (uint32_t)(((hk * 2 * H + 8 * (lm >> 1) + lr) * KS +
                                                    16 * pj + 8 * (lm & 1)) * 2);
  const uint32_t b_tr = smem_u32(dgb_s) + (uint32_t)((lr * GS + hk * 2 * H + 8 * lm) * 2);
  // this lane's reads of a stage's xg (f32) and c_prev / dy (bf16) tiles,
  // and its writes of the two dgates tiles
  const int x_lane = 2 * t * FS + unit, c_lane = 2 * t * KS + unit;
  const int dgf_lane = 2 * t * FS + 32 * warp + g, dgb_lane = 2 * t * GS + 32 * warp + g;
  // this warp's half of the pair exchange, and its partner's
  float* part_mine = part_s + warp * 64;
  const float* part_theirs = part_s + (warp ^ 1) * 64;

  // the f32 dgates tile leaves as 16-byte chunks: chunk c of row n holds
  // permuted rows 4c .. 4c+3, i.e. gate rows j .. j+3 with j =
  // gate_row_of_permuted(4c)
  int o_src[kOut];     // float offset in the f32 dgates tile, -1: none
  float* o_dst[kOut];  // its place in dgates at the current position
#pragma unroll
  for (int m = 0; m < kOut; ++m) {
    const int idx = tid + m * kThreads, n = idx / (H4 / 4), c = idx - n * (H4 / 4);
    o_src[m] = -1;
    o_dst[m] = nullptr;
    if (n < nrows) {
      o_src[m] = n * FS + 4 * c;
      o_dst[m] = dgd + ((size_t)pos0 * B + row0 + n) * H4 + gate_row_of_permuted(4 * c, H);
    }
  }
  const ptrdiff_t o_walk = (ptrdiff_t)dpos * B * H4;

  cp_async_wait<1>();
  __syncthreads();  // the weights and the first step's tiles are staged

  int stage = 0, pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + 2 < maxlen) fetch();
    cp_async_commit();
    unsigned char* st = stages + (uint32_t)stage * kStageBytes;
    const float* xg_s = reinterpret_cast<const float*>(st + kXg) + x_lane;
    // gates^T: acc[mt][chain]: mt 0 rows = gates i | f, mt 1 = g | o, of
    // units 8w..8w+7; chain 0 starts from xg, chain 1 takes the odd k-steps
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[mt][0][i] = xg_s[i * FS + 2 * mt * H];
        acc[mt][0][2 + i] = xg_s[i * FS + (2 * mt + 1) * H];
        acc[mt][1][i] = 0.0f;
        acc[mt][1][2 + i] = 0.0f;
      }
    }
    const uint32_t b_step = b_gate + (uint32_t)stage * kStageBytes;
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
    __syncthreads();  // every warp is past the last step's dgates tiles

    const bf16* cp_s = reinterpret_cast<const bf16*>(st + kCp) + c_lane;
    const bf16* dy_s = reinterpret_cast<const bf16*>(st + kDy) + c_lane;
    float keep[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i] + acc[0][1][i]);
      const float fg = fast_sigmoid(acc[0][0][2 + i] + acc[0][1][2 + i]);
      const float gg = fast_tanh(acc[1][0][i] + acc[1][1][i]);
      const float og = fast_sigmoid(acc[1][0][2 + i] + acc[1][1][2 + i]);
      const float cprev = __bfloat162float(cp_s[i * KS]);
      float dyv = 0.0f;
      for (int k = 0; k < ny; ++k) dyv += __bfloat162float(dy_s[(k * kMmaTile + i) * KS]);
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
        dgf_s[dgf_lane + i * FS + 8 * q] = g4[q];
        dgb_s[dgb_lane + i * GS + 8 * q] = __float2bfloat16_rn(g4[q]);
      }
    }
    cp_async_wait<1>();  // the next step's tiles have landed
    __syncthreads();     // the dgates tiles are complete; every warp is past this step's tiles
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // dh^T = W_hh^T . bf16(dgates)^T over this warp's half of the permuted
    // gate rows: c2[k-step parity], two independent chains
    float c2[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int v = 0; v < 4; ++v) c2[h2][v] = 0.0f;
    pipelined_rounds<TransFrag>(
        K2,
        [&](TransFrag& f, int r) {
          ldmatrix_x4(f.b, b_tr + (uint32_t)(r * 64));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            ldmatrix_x4_trans(f.a[h2], a_tr + (uint32_t)((32 * r + 16 * h2) * KS * 2));
        },
        [&](const TransFrag& f, int) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) mma_bf16(c2[h2], f.a[h2], f.b[2 * h2], f.b[2 * h2 + 1]);
        });
    float out[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) out[v] = c2[0][v] + c2[1][v];
    // rows g of the tile (out 0, 1) are warp 2 pj's units, rows g + 8 (out
    // 2, 3) warp 2 pj + 1's: each warp sends the other's rows, then sums
    // first half + second half of K
    part_mine[lane] = out[hk ? 0 : 2];
    part_mine[32 + lane] = out[hk ? 1 : 3];
    pair_sync(1 + pj);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float own = out[hk ? 2 + i : i], other = part_theirs[32 * i + lane];
      dh[i] = (hk ? other + own : own + other) + keep[i];
    }
    // dgates: the f32 tile, back in torch gate order
#pragma unroll
    for (int m = 0; m < kOut; ++m) {
      if (o_src[m] >= 0) {
        *reinterpret_cast<float4*>(o_dst[m]) = *reinterpret_cast<const float4*>(dgf_s + o_src[m]);
        o_dst[m] += o_walk;
      }
    }
  }
}

}  // namespace

extern "C" {

int bilstm_bwd_lite_mma_resident_tile() { return kMmaTile; }
int bilstm_bwd_lite_mma_resident_max_h() { return kMaxH; }
int bilstm_bwd_lite_mma_resident_max_threads() { return kMaxThreads; }
int bilstm_bwd_lite_mma_resident_pad() { return kPad; }
int bilstm_bwd_lite_mma_resident_stages() { return kStages; }

const char* bilstm_bwd_lite_mma_resident_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is bfloat16. xg (2, T, B, 4H) f32; w_hh (2, G, 4H, H);
// hs_f, hs_b, cs_f, cs_b and the dy streams (T, B, H) bf16 (dy*1 may be
// null, ny = 0-2 streams per direction); dhn / dcn (2, B, H) f32 or null
// (zero); dgates (2, T, B, 4H) f32. H = kMaxH; each of the G weight groups
// (B / G rows) is cut into its own 8-row tiles: `tiles` = G * ceil(B / G /
// 8); threads = 4H; smem the dynamic shared memory, smem_bytes(H)
// (ops/lstm_cuda.py:lite_mma_resident_plan). Returns a cudaError_t (0 on
// success).
int bilstm_bwd_lite_mma_resident(const void* xg, const void* lengths, const void* w_hh,
                                 const void* hs_f, const void* hs_b, const void* cs_f,
                                 const void* cs_b, const void* dyf0, const void* dyf1,
                                 const void* dyb0, const void* dyb1, int ny, const void* dhn,
                                 const void* dcn, void* dgates, int T_steps, int B, int H, int G,
                                 int tiles, int threads, int smem, void* stream) {
  if (H != kMaxH || G <= 0 || B % G || ny < 0 || ny > 2 || threads != 4 * H ||
      smem != smem_bytes(H))
    return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  Args a;
  a.xg = static_cast<const float*>(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = in(w_hh);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = static_cast<const float*>(dhn);
  a.dcn = static_cast<const float*>(dcn);
  a.dgates = static_cast<float*>(dgates);
  a.T = T_steps; a.B = B; a.G = G;
  auto kernel = bilstm_bwd_lite_mma_resident_kernel<kMaxH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, 2), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
