// Bidirectional LSTM layer backward sweep over the input-gate streams, f32
// compute dtype, at H = 96, where one direction's and one group's f32 W_hh
// fits one block: the tensor-core sweep in three tf32 passes with the
// weights resident in shared memory, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd_lite_f32.cu (f32 at 128, 256 and 288) and
// bilstm_bwd_lite.cu (the CUDA-core sweep, which keeps 160, 192 and 224),
// the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel with
//     fused_input=False (via _bwd_pallas_lite, :723)
// at H = 96: the stacked layer of the f32 model at embedding 80 (E = 2 x 80,
// run padded at H = 96 on the wide route, one weight group).
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep_lite with the
// compute dtype f32, where round() is the identity): block (row tile,
// direction d) walks the positions in the reverse of that direction's
// forward order carrying dh and dc. Per step and row: gates = xg[d, pos] +
// h_prev @ W_hh[d, g]^T (h_prev the forward stream at the previous
// position: hs_f[pos - 1] for d = 0, hs_b[pos + 1] for d = 1, zero past the
// ends), c_new = f * c_prev + i * g with c_prev from the cell stream there,
// dh += the 0-2 dy streams (summed in f32), the masked dgates (pos >= length
// gets 0 and passes dh and dc through) to the (2, T, B, 4H) output, and dh =
// dgates @ W_hh[d, g] (+ dh passed through where masked), dc = masked ? dc :
// dc_t * f.
//
// What bounds it on an H100: the two products, 2 x 4H x H multiply-adds per
// row and step (1.07 ms at 400 rows, T = 1500, H = 96 in three tf32 passes
// at 495/3 TFLOP/s), and the f32 streams (xg in, dgates out, the forward's
// streams and dy). What governs is the serial chain of a step, T times: the
// gate product, a barrier, the cell, a barrier, the dh product, the pair
// exchange. The cluster sweep (bilstm_bwd_lite_f32.cu) adds two cluster
// barriers and an exchange through distributed shared memory to that chain;
// at 96 the f32 weights fit one block, so none is needed.
//
// Design: the schedule of the one-stage f32 sweep (bilstm_bwd_f32.cuh) on
// the lite operands:
//   * one block per (8-row tile, direction), tiles cut inside each weight
//     group; one warp per 8 hidden units (12 warps, 384 threads, 170
//     registers a thread); the stacked layer's 400 rows in one group give
//     100 blocks, one wave;
//   * W_hh[d, g] is resident in shared memory in f32, ONE copy (4H rows,
//     permuted so lane (g, t) of warp w holds the four gates of unit 8w + g
//     for rows 2t and 2t + 1; stride 104 floats, 8 mod 32: 159,744 B), and
//     both products read it, split into tf32 big and small parts in
//     registers as the fragments are built; big.big + big.small + small.big
//     accumulated apart;
//   * the gate product gates^T = W_hh . h_prev^T on mma.sync m16n8k8 with
//     xg[d, pos] straight into the accumulators (xg holds the bias): no x
//     stream, no W_ih, no dx product. Its h_prev tile arrives by cp.async
//     two steps ahead in two stages (it does not depend on dh);
//   * the dh product dh^T = W_hh^T . dgates^T (K = 4H = 384) has only H / 16
//     = 6 m16 tiles of units for 12 warps, so warp pair p takes the tile of
//     units 16p .. 16p + 15 and splits its K: warp 2p the first 192 permuted
//     gate rows, warp 2p + 1 the rest. Each sends the half of its partial
//     that the other warp's units need through shared memory, the pair meets
//     at a named barrier, and each sums (first half) + (second half) in that
//     order, so the result does not depend on timing. The transposed reads
//     of the weights are single floats of 4 rows x 8 columns (stride 8 mod
//     32: conflict-free), the dgates tile (f32, stride 4 mod 32) is read by
//     ldmatrix, as in the one-stage sweep;
//   * xg, c_prev and dy come from HBM into registers a step ahead;
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh);
//   * a tile skips the positions at or past its longest row: there dgates
//     is zero (written up front) and dh only gathers dy, which the forward
//     direction's sweep adds up before its first real step (the reverse
//     direction meets those positions last, where dh is dead).

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kMaxH = 96;               // the one width it is built for
constexpr int kMaxThreads = 4 * kMaxH;  // one warp per 8 units
constexpr int kStrideAlign = 32, kStridePad = 8;

struct Args {
  const float* xg;        // (2, T, B, 4H)
  const int* lengths;     // (B,)
  const float* w_hh;      // (2, G, 4H, H)
  const float* hs[2];     // per direction, (T, B, H)
  const float* cs[2];
  const float* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // (2, B, H) or null (zero)
  const float* dcn;
  float* dgates;  // (2, T, B, 4H)
  int T, B, G;
};

// The row stride (floats) of the weight and h_prev tiles: 8 (mod 32), so
// the float2 reads of a half-warp (4 rows x 4 pairs) and the float reads of
// a warp (4 rows x 8 columns) fall in distinct banks.
__host__ __device__ constexpr int k_stride(int K) {
  return (K + kStrideAlign - 1) / kStrideAlign * kStrideAlign + kStridePad;
}

// Dynamic shared memory at H (bytes): the weights, the dgates tile, two
// h_prev stages and the pair exchange (two floats a lane).
__host__ __device__ constexpr int smem_bytes(int H) {
  return (4 * H * k_stride(H) + kMmaTile * (4 * H + 4) + 2 * kMmaTile * k_stride(H) +
          H / 8 * 64) * 4;
}

// The 64 threads of warp pair `id - 1` meet; shared-memory writes before it
// are visible to both warps after it.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// grid (tiles, 2), block 4H threads.
template <int H>
__global__ void __launch_bounds__(4 * H, 1) bilstm_bwd_lite_f32_resident_kernel(const Args a) {
  constexpr int H4 = 4 * H, NW = H / 8, KS = k_stride(H), GS = H4 + 4;
  constexpr int kThreads = 32 * NW;
  constexpr int kStage = kMmaTile * KS;
  constexpr int kChunks = kMmaTile * H / 4;  // 16-byte chunks of an h_prev tile
  constexpr int kOut = 2;                    // 16-byte dgates chunks a thread stores a step
  constexpr int K2 = H4 / 32;                // k16 steps of each half of the dh product
  static_assert(H % 16 == 0 && kChunks <= kThreads && kMmaTile * H4 / 4 <= kOut * kThreads,
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
  float* W_s = reinterpret_cast<float*>(smem);  // [4H permuted][KS]
  float* dg_s = W_s + H4 * KS;                  // [8][GS], permuted gate order
  float* st_s = dg_s + kMmaTile * GS;           // [2][8][KS]: h_prev
  float* part_s = st_s + 2 * kStage;            // [NW][2][32]: the pair exchange

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
  const float* xgd = a.xg + (size_t)d * T * B * H4;

  // the h_prev tile of a step: this thread's 16-byte chunk (threads past
  // kChunks have none), by cp.async into the next of two stages, zero past
  // the ends and for rows past the group
  const int cn = tid / (H / 4), ce = (tid - cn * (H / 4)) * 4;
  const bool c_real = tid < kChunks && cn < nrows;
  const float* c_src = a.hs[d] + (size_t)(c_real ? row0 + cn : 0) * H + ce;
  const uint32_t c_dst = smem_u32(st_s) + (uint32_t)((cn * KS + ce) * 4);
  int fetch_stage = 0, fetch_pos = pos0;
  auto fetch = [&]() {
    if (tid < kChunks) {
      const int pp = fetch_pos + hshift;
      const bool ok = c_real && pp >= 0 && pp < T;
      cp_async16(c_dst + (uint32_t)(fetch_stage * kStage * 4),
                 ok ? c_src + (size_t)pp * B * H : a.hs[d], ok);
    }
    fetch_stage ^= 1;
    fetch_pos += dpos;
  };
  fetch();
  cp_async_commit();
  if (maxlen > 1) fetch();
  cp_async_commit();

  // stage W_hh[d, group] with permuted rows, 16 bytes a copy
  {
    const float* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    constexpr int kq = H / 4;
    for (int idx = tid; idx < H4 * kq; idx += kThreads) {
      const int p = idx / kq, c = (idx - p * kq) * 4;
      const int j = gate_row_of_permuted(p, H);
      *reinterpret_cast<float4*>(W_s + p * KS + c) =
          *reinterpret_cast<const float4*>(wh + (size_t)j * H + c);
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
        for (int k = 0; k < ny; ++k) dyv += a.dy[0][k][((size_t)pos * B + rown[i]) * H + unit];
        dh[i] += dyv;
      }
    }
  }
  // this lane's input gates, c_prev and summed dy at a position, for the
  // step that uses them (loaded a step ahead)
  auto lane_inputs = [&](int pos, float (&xv)[2][4], float (&cprev)[2], float (&dyv)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cprev[i] = 0.0f;
      dyv[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = 0.0f;
      if (rown[i] < 0) continue;
      const float* src = xgd + ((size_t)pos * B + rown[i]) * H4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = __ldg(src + q * H);
      const int pp = pos + hshift;
      if (pp >= 0 && pp < T) cprev[i] = a.cs[d][((size_t)pp * B + rown[i]) * H + unit];
      for (int k = 0; k < ny; ++k) dyv[i] += a.dy[d][k][((size_t)pos * B + rown[i]) * H + unit];
    }
  };
  float xv[2][4], cprev[2], dyv[2];
  lane_inputs(pos0, xv, cprev, dyv);

  // gate product: A rows 32 w + 16 mt + g (+ 8), k pairs 2t, 2t + 1 of each
  // k8 step (logical k t and t + 4); B the h_prev tile row g, the same pairs
  const float* a_gate = W_s + (32 * warp + g) * KS + 2 * t;
  const int b_gate = g * KS + 2 * t;
  // dh product of warp pair pj, half hk of its K: A rows g (units 16 pj + g)
  // and g + 8 (16 pj + 8 + g), k the permuted gate rows t and t + 4 of each
  // k8 step; B the dgates tile by ldmatrix, matrix lm = gate columns
  // 4 lm .. 4 lm + 3 of a 16-column pair of k8 steps
  const int pj = warp >> 1, hk = warp & 1;
  const float* a_lo = W_s + t * KS + 16 * pj + g;
  const float* a_hi = a_lo + 8;
  const uint32_t b_tr = smem_u32(dg_s) + (uint32_t)((lr * GS + 4 * lm) * 4);
  // this lane's writes of the dgates tile
  const int dg_lane = 2 * t * GS + 32 * warp + g;
  // this warp's half of the pair exchange, and its partner's
  float* part_mine = part_s + warp * 64;
  const float* part_theirs = part_s + (warp ^ 1) * 64;

  // the dgates tile leaves as 16-byte chunks: chunk c of row n holds permuted
  // rows 4c .. 4c+3, i.e. gate rows j .. j+3 with j = gate_row_of_permuted(4c)
  int o_src[kOut];     // float offset in the dgates tile, -1: none
  float* o_dst[kOut];  // its place in dgates at the current position
#pragma unroll
  for (int m = 0; m < kOut; ++m) {
    const int idx = tid + m * kThreads, n = idx / (H4 / 4), c = idx - n * (H4 / 4);
    o_src[m] = -1;
    o_dst[m] = nullptr;
    if (n < nrows) {
      o_src[m] = n * GS + 4 * c;
      o_dst[m] = dgd + ((size_t)pos0 * B + row0 + n) * H4 + gate_row_of_permuted(4 * c, H);
    }
  }
  const ptrdiff_t o_walk = (ptrdiff_t)dpos * B * H4;

  cp_async_wait<1>();
  __syncthreads();  // the weights and the first step's h_prev tile are staged

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    // gates^T: acc[pass][mt]: mt 0 rows = gates i | f, mt 1 = g | o, of units
    // 8w..8w+7; pass 0 sums big.big from xg, passes 1 and 2 the cross terms
    float acc[3][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[0][mt][i] = xv[i][2 * mt];
        acc[0][mt][2 + i] = xv[i][2 * mt + 1];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[1][mt][v] = acc[2][mt][v] = 0.0f;
    }
    const float* tile_s = st_s + (s & 1) * kStage + b_gate;
#pragma unroll 4
    for (int kk = 0; kk < H / 8; ++kk) {
      const float2 bv = *reinterpret_cast<const float2*>(tile_s + 8 * kk);
      uint32_t bb[2], bs[2], ab[2][4], as[2][4];
      split_tf32(bv.x, bb[0], bs[0]);
      split_tf32(bv.y, bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = a_gate + 16 * mt * KS + 8 * kk;
        const float2 lo = *reinterpret_cast<const float2*>(ap);
        const float2 hi = *reinterpret_cast<const float2*>(ap + 8 * KS);
        split_tf32(lo.x, ab[mt][0], as[mt][0]);
        split_tf32(hi.x, ab[mt][1], as[mt][1]);
        split_tf32(lo.y, ab[mt][2], as[mt][2]);
        split_tf32(hi.y, ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[0][mt], ab[mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[1][mt], as[mt], bb[0], bb[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[2][mt], ab[mt], bs[0], bs[1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[0][mt][v] += acc[1][mt][v] + acc[2][mt][v];
    __syncthreads();  // every warp is past this step's h_prev stage and the last dgates tile

    float keep[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ig = fast_sigmoid(acc[0][0][i]);
      const float fg = fast_sigmoid(acc[0][0][2 + i]);
      const float gg = fast_tanh(acc[0][1][i]);
      const float og = fast_sigmoid(acc[0][1][2 + i]);
      const float c_new = fg * cprev[i] + ig * gg;
      const float dht = dh[i] + dyv[i];
      const float tc = fast_tanh(c_new);
      const float dct = dc[i] + dht * og * (1.0f - tc * tc);
      const bool m = pos < len[i];
      float g4[4];
      g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
      g4[1] = m ? dct * cprev[i] * fg * (1.0f - fg) : 0.0f;
      g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
      g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
      dc[i] = m ? dct * fg : dc[i];
      keep[i] = m ? 0.0f : dht;
#pragma unroll
      for (int q = 0; q < 4; ++q) dg_s[dg_lane + i * GS + 8 * q] = g4[q];
    }
    cp_async_wait<0>();  // the next step's h_prev tile has landed
    __syncthreads();     // the dgates tile is complete
    if (s + 2 < maxlen) fetch();
    cp_async_commit();
    if (s + 1 < maxlen) lane_inputs(pos + dpos, xv, cprev, dyv);

    // dh^T = W_hh^T . dgates^T over this warp's half of the permuted gate
    // rows; c2[pass][k8 step parity]: six independent products a k16 step
    float c2[3][2][4];
#pragma unroll
    for (int p2 = 0; p2 < 3; ++p2)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int v = 0; v < 4; ++v) c2[p2][h2][v] = 0.0f;
#pragma unroll 2
    for (int k2 = hk * K2; k2 < (hk + 1) * K2; ++k2) {
      uint32_t bfr[4], ab[2][4], as[2][4], bb[2][2], bs[2][2];
      ldmatrix_x4(bfr, b_tr + (uint32_t)(k2 * 64));
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = (16 * k2 + 8 * h2) * KS;
        split_tf32(a_lo[r], ab[h2][0], as[h2][0]);
        split_tf32(a_hi[r], ab[h2][1], as[h2][1]);
        split_tf32(a_lo[r + 4 * KS], ab[h2][2], as[h2][2]);
        split_tf32(a_hi[r + 4 * KS], ab[h2][3], as[h2][3]);
        split_tf32(__uint_as_float(bfr[2 * h2]), bb[h2][0], bs[h2][0]);
        split_tf32(__uint_as_float(bfr[2 * h2 + 1]), bb[h2][1], bs[h2][1]);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) mma_tf32(c2[0][h2], ab[h2], bb[h2][0], bb[h2][1]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) mma_tf32(c2[1][h2], as[h2], bb[h2][0], bb[h2][1]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) mma_tf32(c2[2][h2], ab[h2], bs[h2][0], bs[h2][1]);
    }
    float out[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      out[v] = (c2[0][0][v] + c2[0][1][v]) + ((c2[1][0][v] + c2[1][1][v]) +
                                              (c2[2][0][v] + c2[2][1][v]));
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
    // dgates: the tile, back in torch gate order
#pragma unroll
    for (int m = 0; m < kOut; ++m) {
      if (o_src[m] >= 0) {
        *reinterpret_cast<float4*>(o_dst[m]) = *reinterpret_cast<const float4*>(dg_s + o_src[m]);
        o_dst[m] += o_walk;
      }
    }
  }
}

}  // namespace

extern "C" {

int bilstm_bwd_lite_f32_resident_tile() { return kMmaTile; }
int bilstm_bwd_lite_f32_resident_max_h() { return kMaxH; }
int bilstm_bwd_lite_f32_resident_max_threads() { return kMaxThreads; }
int bilstm_bwd_lite_f32_resident_stride_align() { return kStrideAlign; }
int bilstm_bwd_lite_f32_resident_stride_pad() { return kStridePad; }

const char* bilstm_bwd_lite_f32_resident_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. xg (2, T, B, 4H); w_hh (2, G, 4H, H); hs_f,
// hs_b, cs_f, cs_b and the dy streams (T, B, H) (dy*1 may be null, ny = 0-2
// streams per direction); dhn / dcn (2, B, H) or null (zero); dgates (2, T,
// B, 4H). H = kMaxH; each of the G weight groups (B / G rows) is cut into
// its own 8-row tiles: `tiles` = G * ceil(B / G / 8); threads = 4H; smem
// the dynamic shared memory, smem_bytes(H) (ops/lstm_cuda.py:
// lite_f32_resident_plan). Returns a cudaError_t (0 on success).
int bilstm_bwd_lite_f32_resident(const void* xg, const void* lengths, const void* w_hh,
                                 const void* hs_f, const void* hs_b, const void* cs_f,
                                 const void* cs_b, const void* dyf0, const void* dyf1,
                                 const void* dyb0, const void* dyb1, int ny, const void* dhn,
                                 const void* dcn, void* dgates, int T_steps, int B, int H, int G,
                                 int tiles, int threads, int smem, void* stream) {
  if (H != kMaxH || G <= 0 || B % G || ny < 0 || ny > 2 || threads != 4 * H ||
      smem != smem_bytes(H))
    return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  Args a;
  a.xg = in(xg);
  a.lengths = static_cast<const int*>(lengths);
  a.w_hh = in(w_hh);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = in(dhn);
  a.dcn = in(dcn);
  a.dgates = static_cast<float*>(dgates);
  a.T = T_steps; a.B = B; a.G = G;
  auto kernel = bilstm_bwd_lite_f32_resident_kernel<kMaxH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, 2), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
