// The f32 tensor-core BPTT sweep of a bidirectional LSTM layer, three tf32
// passes a product: the kernel template of bilstm_bwd_f32.cu (two cp.async
// stages, H <= 64) and bilstm_bwd_f32_onestage.cu (one stage, the next
// tile in registers, E = H = 80). Each source's header says what bounds it
// and how it is laid out; this file holds the code they share, and each
// source instantiates it for its own shapes and exports its C entry.

#pragma once

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {  // each including source builds a library of its own

using namespace bilstm;

constexpr int kMaxChunks = 2;   // 16-byte [x ; h] tile chunks each thread moves per step
constexpr int kMaxOut = 2;      // 16-byte dgc chunks each thread stores per step
constexpr int kStrideAlign = 32, kStridePad = 8;

struct Args {
  const float* x[2];
  int E0, E1;
  const int* lengths;
  const float* w_ih;
  const float* w_hh;
  const float* bias;
  const float* hs[2];     // per direction
  const float* cs[2];
  const float* dy[2][2];  // [direction][stream]
  int ny;
  const float* dhn;  // may be null (zero)
  const float* dcn;
  float* dx[2][2];  // [direction][part]
  float* dgc;
  float* dbias_part;
  int T, B, H, G;
};

// The row stride (floats) of the weight and [x ; h] tiles: 8 (mod 32), so
// the float2 reads of a half-warp (4 rows x 4 pairs) and the float reads of
// a warp (4 rows x 8 columns) fall in distinct banks.
__host__ __device__ constexpr int k_stride(int K) {
  return (K + kStrideAlign - 1) / kStrideAlign * kStrideAlign + kStridePad;
}

// grid (tiles, 2), block 32 * (H / 8 + extra dx warps) <= kThreads threads.
// HT and ET (the layer's H and total input width E) are template parameters
// for the model's shapes, so the product loops unroll; HT = ET = 0 is the
// same code with both read at run time. kOneStage: the [x ; h] tile has one
// shared stage and the step after next waits in registers (the weights
// leave no room for two stages), else two cp.async stages.
template <int HT, int ET, int kThreads, bool kOneStage>
__global__ void __launch_bounds__(kThreads, 1) bilstm_bwd_f32_kernel(const Args a) {
  const int tile = blockIdx.x, d = blockIdx.y;
  const int H = HT ? HT : a.H, H4 = 4 * H, T = a.T, B = a.B;
  const int E0 = a.E0, E1 = a.E1, E = ET ? ET : E0 + E1, K = E + H, ny = a.ny;
  const int KS = k_stride(K);  // weight and x|h tile row stride
  const int GS = H4 + 4;       // dgates tile row stride: 4 (mod 32), for ldmatrix
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
  float* W_s = reinterpret_cast<float*>(smem);  // [4H permuted][KS]: W_ih | W_hh
  float* dg_s = W_s + (size_t)H4 * KS;          // [8][GS], permuted gate order
  float* st_s = dg_s + kMmaTile * GS;           // [1 or 2][8][KS]: x | h_prev
  const int stage_floats = kMmaTile * KS;

  // the tile's longest row bounds the positions that do any work: step s of
  // this tile works on position s (d = 1) or maxlen - 1 - s (d = 0)
  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos
  const int pos0 = d ? 0 : maxlen - 1, dpos = d ? 1 : -1;

  // the step's [x0 | x1 | h_prev] tile as 16-byte chunks (4 floats); each
  // thread keeps, per chunk, the source address of the next step to fetch
  // (one stage: and the chunk it loaded for the step after the current one)
  const int per_row = K / 4;
  const float* c_src[kMaxChunks];
  int c_dst[kMaxChunks];  // float offset in the stage
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
    const int n = idx / per_row, e = (idx - n * per_row) * 4;
    const bool real = n < nrows;
    const size_t row = row0 + (real ? n : 0);
    const float* base;
    int width, col;
    if (e < E0) {
      base = a.x[0]; width = E0; col = e;
    } else if (e < E) {
      base = a.x[1]; width = E1; col = e - E0;
    } else {
      base = a.hs[d]; width = H; col = e - E;
      c_shift[m] = hshift;
    }
    c_dst[m] = n * KS + e;
    c_walk[m] = dpos * B * width;
    c_src[m] = base + row * width + col + (ptrdiff_t)(pos0 + c_shift[m]) * B * width;
    if (!real) c_shift[m] = kNoRow;
  }
  // fetch: the chunks of the next position (zero past the ends and for
  // rows past the group), into registers (one stage; `store` puts them in
  // the stage) or by cp.async into the next of the two stages
  float4 c_next[kMaxChunks];
  int fetch_stage = 0, fetch_pos = pos0;
  auto fetch = [&]() {
    const uint32_t base = smem_u32(st_s + fetch_stage * stage_floats);
    if (!kOneStage) fetch_stage ^= 1;
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (kOneStage) c_next[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c_walk[m] == 0) continue;
      const int at = fetch_pos + c_shift[m];
      const bool ok = at >= 0 && at < T;  // kNoRow puts `at` past T
      if (kOneStage) {
        if (ok) c_next[m] = __ldg(reinterpret_cast<const float4*>(c_src[m]));
      } else {
        cp_async16(base + c_dst[m] * 4, ok ? c_src[m] : a.x[0], ok);
      }
      c_src[m] += c_walk[m];
    }
    fetch_pos += dpos;
  };
  auto store = [&]() {
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m)
      if (c_walk[m] != 0) *reinterpret_cast<float4*>(st_s + c_dst[m]) = c_next[m];
  };
  if (maxlen > 0) fetch();
  if (kOneStage && maxlen > 0) store();
  cp_async_commit();
  if (maxlen > 1) fetch();
  cp_async_commit();

  // stage [W_ih[d] | W_hh[d, group]] with permuted rows, 16 bytes a copy
  {
    const float* wi = a.w_ih + (size_t)d * H4 * E;
    const float* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    for (int idx = tid; idx < H4 * per_row; idx += nthreads) {
      const int p = idx / per_row, c = (idx - p * per_row) * 4;
      const int j = gate_row_of_permuted(p, H);
      const float* src = c < E ? wi + (size_t)j * E + c : wh + (size_t)j * H + (c - E);
      *reinterpret_cast<float4*>(W_s + (size_t)p * KS + c) =
          *reinterpret_cast<const float4*>(src);
    }
  }

  // positions [maxlen, T): zero dgc and dx rows, 16 bytes a store
  {
    const int per_pos = nrows * (H4 + E) / 4, ng = nrows * H4 / 4, n0 = nrows * E0 / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = tid; idx < (T - maxlen) * per_pos; idx += nthreads) {
      const int pi = idx / per_pos, r = idx - pi * per_pos;
      const size_t at = (size_t)(maxlen + pi) * B + row0;
      float* dst;
      if (r < ng) dst = a.dgc + ((size_t)d * T * B + at) * H4 + (size_t)r * 4;
      else if (r < ng + n0) dst = a.dx[d][0] + at * E0 + (size_t)(r - ng) * 4;
      else dst = a.dx[d][1] + at * E1 + (size_t)(r - ng - n0) * 4;
      *reinterpret_cast<float4*>(dst) = zero;
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
        for (int k = 0; k < ny; ++k) dyv += a.dy[0][k][((size_t)pos * B + rown[i]) * H + unit];
        dh[i] += dyv;
      }
    }
  }
  // this lane's c_prev and summed dy at a position, for the step that uses
  // them (loaded a step ahead)
  auto lane_inputs = [&](int pos, float (&cprev)[2], float (&dyv)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cprev[i] = 0.0f;
      dyv[i] = 0.0f;
      if (rown[i] < 0) continue;
      const int pp = pos + hshift;
      if (pp >= 0 && pp < T) cprev[i] = a.cs[d][((size_t)pp * B + rown[i]) * H + unit];
      for (int k = 0; k < ny; ++k) dyv[i] += a.dy[d][k][((size_t)pos * B + rown[i]) * H + unit];
    }
  };
  float cprev[2], dyv[2];
  if (maxlen > 0) lane_inputs(pos0, cprev, dyv);

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
  float* dx_out[2][2];
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

  // gate product: A rows 32 w + 16 mt + g (+ 8), k pairs 2t, 2t + 1 of each
  // k8 step (logical k t and t + 4); B the tile row g, the same pairs
  const float* a_gate = W_s + (size_t)(32 * warp + g) * KS + 2 * t;
  const int b_gate = g * KS + 2 * t;
  // transposed product: A rows (permuted gate rows) t and t + 4 of each k8
  // step, columns col_lo + g and col_hi + g; B the dgates tile by ldmatrix,
  // matrix lm = gate columns 4 lm .. 4 lm + 3 of a 16-column pair of k8 steps
  const float* a_lo = W_s + (size_t)t * KS + col_lo + g;
  const float* a_hi = W_s + (size_t)t * KS + col_hi + g;
  const uint32_t b_tr = smem_u32(dg_s) + (uint32_t)((lr * GS + 4 * lm) * 4);
  // this lane's writes of the dgates tile
  const int dg_lane = 2 * t * GS + 32 * warp + g;

  // the dgc tile leaves as 16-byte chunks: chunk c of row n holds permuted
  // rows 4c .. 4c+3, i.e. gate rows j .. j+3 with j = gate_row_of_permuted(4c)
  int o_src[kMaxOut];          // float offset in the dgates tile, -1: none
  float* o_dst[kMaxOut];       // its place in dgc at the current position
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) {
    const int idx = tid + m * nthreads, n = idx / (H4 / 4), c = idx - n * (H4 / 4);
    o_src[m] = -1;
    o_dst[m] = nullptr;
    if (n < nrows) {
      o_src[m] = n * GS + 4 * c;
      o_dst[m] = a.dgc + (((size_t)d * T + pos0) * B + row0 + n) * H4 +
                 gate_row_of_permuted(4 * c, H);
    }
  }
  const ptrdiff_t o_walk = (ptrdiff_t)dpos * B * H4;

  cp_async_wait<1>();
  __syncthreads();  // the weights and the first step's tile are staged

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    float keep[2] = {0.0f, 0.0f};
    // gates^T: acc[pass][mt]: mt 0 rows = gates i | f, mt 1 = g | o, of units
    // 8w..8w+7; pass 0 sums big.big (from the bias), passes 1 and 2 the cross
    // terms, so a k8 step issues six independent products
    float acc[3][2][4];
    if (main_warp) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[0][mt][i] = bi[2 * mt];
          acc[0][mt][2 + i] = bi[2 * mt + 1];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[1][mt][v] = acc[2][mt][v] = 0.0f;
      }
      const float* tile_s = st_s + (kOneStage ? 0 : (s & 1) * stage_floats) + b_gate;
#pragma unroll 4
      for (int kk = 0; kk < K / 8; ++kk) {
        const float2 bv = *reinterpret_cast<const float2*>(tile_s + 8 * kk);
        uint32_t bb[2], bs[2], ab[2][4], as[2][4];
        split_tf32(bv.x, bb[0], bs[0]);
        split_tf32(bv.y, bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ap = a_gate + (size_t)16 * mt * KS + 8 * kk;
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
    }
    __syncthreads();  // every warp is past the stage and the previous step's dgates tile

    if (main_warp) {
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
        for (int q = 0; q < 4; ++q) {
          dbias[q] += g4[q];
          dg_s[dg_lane + i * GS + 8 * q] = g4[q];
        }
      }
    }
    if (kOneStage) {
      // the next step's tile into the stage, and the one after it into registers
      if (s + 1 < maxlen) store();
      if (s + 2 < maxlen) fetch();
      __syncthreads();  // the dgates tile and the next step's stage are complete
    } else {
      cp_async_wait<0>();  // the next step's tile has landed
      __syncthreads();     // dgates tile complete; every warp is past this step's tile reads
      if (s + 2 < maxlen) fetch();
      cp_async_commit();
    }
    if (main_warp && s + 1 < maxlen) lane_inputs(pos + dpos, cprev, dyv);

    // [dh_prev ; dx]^T = [W_hh ; W_ih]^T . dgates^T over the permuted gate rows;
    // c2[pass][k8 step parity]: six independent products a pair of k8 steps
    float c2[3][2][4];
#pragma unroll
    for (int p2 = 0; p2 < 3; ++p2)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int v = 0; v < 4; ++v) c2[p2][h2][v] = 0.0f;
#pragma unroll 2
    for (int k2 = 0; k2 < H4 / 16; ++k2) {
      uint32_t bfr[4], ab[2][4], as[2][4], bb[2][2], bs[2][2];
      ldmatrix_x4(bfr, b_tr + (uint32_t)(k2 * 64));
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const size_t r = (size_t)(16 * k2 + 8 * h2) * KS;
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
    if (main_warp) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dh[i] = out[i] + keep[i];
    }
    // dx: rows g (lo half) and g + 8 (hi half) of the tile are input columns
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (dx_out[half][i]) {
          *dx_out[half][i] = out[2 * half + i];
          dx_out[half][i] += dx_walk[half];
        }
      }
    }
    // dgc: the dgates tile, back in torch gate order
#pragma unroll
    for (int m = 0; m < kMaxOut; ++m) {
      if (o_src[m] >= 0) {
        *reinterpret_cast<float4*>(o_dst[m]) = *reinterpret_cast<const float4*>(dg_s + o_src[m]);
        o_dst[m] += o_walk;
      }
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

template <int HT, int ET, int kThreads, bool kOneStage>
int launch(const Args& a, int tiles, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bilstm_bwd_f32_kernel<HT, ET, kThreads, kOneStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_bwd_f32_kernel<HT, ET, kThreads, kOneStage><<<dim3(tiles, 2), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The operands of a C entry (bilstm_bwd_f32.cu's contract) as Args, or
// false for a shape a kernel of kThreads threads and H <= kMaxH does not
// take: H % 16 == 0, E parts multiples of 8, 0-2 dy streams, the [x ; h]
// and dgc chunks within the per-thread constants.
template <int kThreads, int kMaxH>
bool make_args(Args& a, const void* x0, const void* x1, int E0, int E1, const void* lengths,
               const void* w_ih, const void* w_hh, const void* bias, const void* hs_f,
               const void* hs_b, const void* cs_f, const void* cs_b, const void* dyf0,
               const void* dyf1, const void* dyb0, const void* dyb1, int ny, const void* dhn,
               const void* dcn, void* dxf0, void* dxf1, void* dxb0, void* dxb1, void* dgc,
               void* dbias_part, int T_steps, int B, int H, int G, int threads) {
  const int E = E0 + E1;
  if (H % 16 || H <= 0 || H > kMaxH || E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 || ny < 0 ||
      ny > 2 || threads > kThreads || threads < 32 * (H / 8) ||
      2 * (E + H) > kMaxChunks * threads || 8 * H > kMaxOut * threads)
    return false;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  a.x[0] = in(x0); a.x[1] = in(x1);
  a.E0 = E0; a.E1 = E1;
  a.lengths = static_cast<const int*>(lengths);
  a.w_ih = in(w_ih); a.w_hh = in(w_hh);
  a.bias = in(bias);
  a.hs[0] = in(hs_f); a.hs[1] = in(hs_b);
  a.cs[0] = in(cs_f); a.cs[1] = in(cs_b);
  a.dy[0][0] = in(dyf0); a.dy[0][1] = in(dyf1);
  a.dy[1][0] = in(dyb0); a.dy[1][1] = in(dyb1);
  a.ny = ny;
  a.dhn = in(dhn);
  a.dcn = in(dcn);
  a.dx[0][0] = out(dxf0); a.dx[0][1] = out(dxf1);
  a.dx[1][0] = out(dxb0); a.dx[1][1] = out(dxb1);
  a.dgc = out(dgc);
  a.dbias_part = out(dbias_part);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  return true;
}

}  // namespace
