// Bidirectional LSTM layer backward sweep (BPTT), hand-written for Hopper
// (sm_90a).
//
// Replaces the recurrent part of the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _bwd_kernel_packed (via
//     _bwd_pallas_packed) -- the train step's layer backward at 2H == 128.
// Its weight-gradient products (dW_ih, dW_hh) are the second launch,
// bilstm_wgrad_mma.cu (bf16) or bilstm_wgrad_f32.cu (f32): the TPU kernel
// sums them in VMEM scratch across its sequential time grid, but here the
// sweep's block already holds the resident weights and the f32 sums fit
// neither beside them nor in registers, so the sweep writes dgc once.
//
// Function: block (row tile, direction d) walks the positions in the
// reverse of that direction's forward order (d = 0: T-1 .. 0, d = 1:
// 0 .. T-1), carrying dh and dc (f32, in registers). Per step and row r:
//   * recompute the gates from x(pos) and h_prev (the forward stream at the
//     previous position: hs_f[pos-1] for d = 0, hs_b[pos+1] for d = 1, zero
//     past the ends), exactly as the forward did;
//   * c_new = f * c_prev + i * g with c_prev from the compute-dtype cell
//     stream cs (as the TPU kernel stores it);
//   * dh += the sum of the 0-2 unsummed dy streams at pos (f32);
//   * dgates (f32) by the mask rules of lstm_pallas_packed.py:672-737: a
//     position at or past the row's length gets dgates = 0, and there dh and
//     dc pass through unchanged;
//   * dgc = dgates rounded to the compute dtype, written to the (2, T, B, 4H)
//     stream that the weight-gradient kernels read;
//   * dx = dgc @ W_ih[d] per input part, per direction, unsummed (compute-
//     dtype operands, f32 accumulate), written in the compute dtype;
//   * dh = dgc @ W_hh[d, g] + (masked ? dh : 0); dc = masked ? dc : dc_t * f.
// dbias partials (f32, from the unrounded dgates) are summed per block and
// written as (blocks, 2, 4H); the wrapper sums them.
//
// What bounds it on an H100: like the forward, the sweep is serial in T and
// every step does 4H * (2E + 2H) multiply-adds per row on CUDA cores (gate
// recompute, dx, dh): operations bound it. Per step, dx and dh need every
// gate of every unit of a row, so the step's dgates are exchanged through
// shared memory: two __syncthreads per step.
//
// What the design does about it: one block per (row tile, direction) with
// the direction's W_ih and its group's W_hh resident in shared memory for
// the whole sweep, in f32 (209 KB at E = 128), ONE copy each, laid out
// [k][unit*4 + gate] with rows padded by kPad elements. The same copy serves the gate recompute (thread
// = unit reads a 16-byte row slice: consecutive threads, consecutive
// addresses), dh (thread = unit k reads its own row across all gates) and
// dx (thread = input column e reads its own row): the padding puts the rows
// that neighbouring threads read in distinct banks. The row tile is 8 rows
// (kRows = 2 per thread), half the forward's, so 400 rows give 100 blocks
// for the 132 SMs. The next step's x and h_prev tiles are fetched into
// registers while the current step computes.
// Not yet done: tensor cores, and splitting a tile's units over a cluster.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

constexpr int kRows = 2;       // rows owned by each thread
constexpr int kMaxChunks = 4;  // 16-byte tile chunks each thread moves per step
constexpr int kMaxThreads = 256;
constexpr int kMaxRX = 8;      // dx rows per thread
constexpr int kPad = 4;        // shared-memory weight row padding (elements)

// The step's input tiles: x parts 0 and 1 into x_s [BR][E] and h_prev into
// hp_s [BR][H], cut into 16-byte chunks (nq0 | nq1 | nqh).
struct Tiles {
  const void* x0;
  const void* x1;
  const void* hs;  // this direction's hidden stream
  int E0, E1, H, nq0, nq1, nq;
};

template <typename T>
__device__ __forceinline__ void load_tiles(uint4 (&r)[kMaxChunks], const Tiles& t, int pos,
                                           int hpos, int row0, int B, int T_steps) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    r[m] = make_uint4(0u, 0u, 0u, 0u);
    if (q >= t.nq) continue;
    const T* base;
    int W, elem, p;
    if (q < t.nq0) {
      base = static_cast<const T*>(t.x0); W = t.E0; elem = q * V; p = pos;
    } else if (q < t.nq0 + t.nq1) {
      base = static_cast<const T*>(t.x1); W = t.E1; elem = (q - t.nq0) * V; p = pos;
    } else {
      base = static_cast<const T*>(t.hs); W = t.H; elem = (q - t.nq0 - t.nq1) * V; p = hpos;
    }
    if (p >= 0 && p < T_steps && row0 + elem / W < B)
      r[m] = __ldg(reinterpret_cast<const uint4*>(base + ((size_t)p * B + row0) * W + elem));
  }
}

template <typename T>
__device__ __forceinline__ void store_tiles(float* x_s, float* hp_s, const uint4 (&r)[kMaxChunks],
                                            const Tiles& t) {
  constexpr int V = 16 / sizeof(T);
  const int E = t.E0 + t.E1;
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    if (q >= t.nq) continue;
    if (q < t.nq0 + t.nq1) {
      const bool p0 = q < t.nq0;
      const int W = p0 ? t.E0 : t.E1;
      const int elem = (p0 ? q : q - t.nq0) * V;
      const int rl = elem / W;
      store_chunk(x_s + rl * E + elem - rl * W + (p0 ? 0 : t.E0), r[m], T());
    } else {
      store_chunk(hp_s + (q - t.nq0 - t.nq1) * V, r[m], T());
    }
  }
}

// acc[i] = sum_c dg[i][c] * w[c] over c in [0, 4H) for rows i < n: dg f32
// rows in shared memory `ld` floats apart, w one padded weight row, whose
// loads are shared by the n rows.
template <int R, typename T>
__device__ __forceinline__ void dot_rows(float (&acc)[R], const float* dg, int ld, const T* w,
                                         int H4, int n) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < H4; c += 4) {
    const float4 wv = load_w4(w + c);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < n) {
        const float4 g = *reinterpret_cast<const float4*>(dg + (size_t)i * ld + c);
        acc[i] = fmaf(g.w, wv.w, fmaf(g.z, wv.z, fmaf(g.y, wv.y, fmaf(g.x, wv.x, acc[i]))));
      }
    }
  }
}

struct Streams2 {
  const void* f[2];
  const void* b[2];
  int n;
};
struct Out2 {
  void* f[2];
  void* b[2];
};

// grid (ceil(B / BR), 2), block H * RG threads with BR = RG * kRows.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_bwd_kernel(Tiles tf, Tiles tb, const int* __restrict__ lengths,
                  const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                  const float* __restrict__ bias, const T* __restrict__ cs_f,
                  const T* __restrict__ cs_b, Streams2 dy, const float* __restrict__ dhn,
                  const float* __restrict__ dcn, Out2 dx, T* __restrict__ dgc,
                  float* __restrict__ dbias_part, int T_steps, int B, int H, int G) {
  const int d = blockIdx.y;
  const Tiles tl = d ? tb : tf;
  const int E0 = tl.E0, E1 = tl.E1, E = E0 + E1;
  const int H4 = 4 * H;
  const int WS = H4 + kPad;
  const int unit = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  const int RG = blockDim.x / H;
  const int BR = RG * kRows;
  const int row0 = blockIdx.x * BR;
  const int rl0 = rg * kRows;
  const int group = row0 / (B / G);
  // dx mapping: thread -> input column e, rows [rx0, rx0 + RX)
  const int ex = threadIdx.x % E;
  const int RX = BR * E / blockDim.x;
  const int rx0 = (threadIdx.x / E) * RX;

  // the weights are kept in f32 whatever T is (bf16 widens exactly), so
  // the inner products spend no instructions on conversion
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_ih_s = reinterpret_cast<float*>(smem);  // [E][WS]
  size_t off = align16((size_t)E * WS * sizeof(float));
  float* w_hh_s = reinterpret_cast<float*>(smem + off);  // [H][WS]
  off += align16((size_t)H * WS * sizeof(float));
  float* x_s = reinterpret_cast<float*>(smem + off);  // [BR][E]
  off += (size_t)BR * E * sizeof(float);
  float* hp_s = reinterpret_cast<float*>(smem + off);  // [BR][H]
  off += (size_t)BR * H * sizeof(float);
  float* dg_s = reinterpret_cast<float*>(smem + off);  // [BR][4H], [unit*4 + gate]

  load_weight<float, T>(w_ih_s, w_ih + (size_t)d * H4 * E, H, E, WS);
  load_weight<float, T>(w_hh_s, w_hh + ((size_t)d * G + group) * H4 * H, H, H, WS);

  float bi[4], dbias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bi[q] = bias[d * H4 + q * H + unit];
    dbias[q] = 0.0f;
  }
  int len[kRows];
  float dh[kRows], dc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + rl0 + i;
    len[i] = r < B ? lengths[r] : 0;
    dh[i] = (r < B && dhn) ? dhn[((size_t)d * B + r) * H + unit] : 0.0f;
    dc[i] = (r < B && dcn) ? dcn[((size_t)d * B + r) * H + unit] : 0.0f;
  }
  const T* cs = d ? cs_b : cs_f;
  const int hshift = d ? 1 : -1;  // h_prev / c_prev position relative to pos

  uint4 tr[kMaxChunks];
  if (T_steps > 0) {
    const int pos = d ? 0 : T_steps - 1;
    load_tiles<T>(tr, tl, pos, pos + hshift, row0, B, T_steps);
    store_tiles<T>(x_s, hp_s, tr, tl);
  }
  __syncthreads();

  for (int s = 0; s < T_steps; ++s) {
    const int pos = d ? s : T_steps - 1 - s;
    const int ppos = pos + hshift;
    if (s + 1 < T_steps) {
      const int npos = d ? pos + 1 : pos - 1;
      load_tiles<T>(tr, tl, npos, npos + hshift, row0, B, T_steps);
    }
    // this thread's c_prev and dy at pos (consumed after the recompute)
    float cprev[kRows], dyv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = row0 + rl0 + i;
      cprev[i] = 0.0f;
      dyv[i] = 0.0f;
      if (r < B) {
        const size_t at = ((size_t)pos * B + r) * H + unit;
        if (ppos >= 0 && ppos < T_steps)
          cprev[i] = to_f32(cs[((size_t)ppos * B + r) * H + unit]);
        for (int k = 0; k < dy.n; ++k)
          dyv[i] += to_f32(static_cast<const T*>(d ? dy.b[k] : dy.f[k])[at]);
      }
    }

    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = bi[q];
    }
    accumulate<kRows, float>(acc, x_s + (size_t)rl0 * E, E, w_ih_s, WS, E, unit);
    accumulate<kRows, float>(acc, hp_s + (size_t)rl0 * H, H, w_hh_s, WS, H, unit);

    float keep[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float ig = sigmoidf_(acc[i][0]);
      const float fg = sigmoidf_(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoidf_(acc[i][3]);
      const float c_new = fg * cprev[i] + ig * gg;
      const float dht = dh[i] + dyv[i];
      const float tc = tanhf(c_new);
      const float dct = dc[i] + dht * og * (1.0f - tc * tc);
      const bool m = pos < len[i];
      float g4[4];
      g4[0] = m ? dct * gg * ig * (1.0f - ig) : 0.0f;
      g4[1] = m ? dct * cprev[i] * fg * (1.0f - fg) : 0.0f;
      g4[2] = m ? dct * ig * (1.0f - gg * gg) : 0.0f;
      g4[3] = m ? dht * tc * og * (1.0f - og) : 0.0f;
      dc[i] = m ? dct * fg : dc[i];
      keep[i] = m ? 0.0f : dht;
      const int r = row0 + rl0 + i;
      float gq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dbias[q] += g4[q];
        const T v = from_f32<T>(g4[q]);
        gq[q] = to_f32(v);
        if (r < B) dgc[(((size_t)d * T_steps + pos) * B + r) * H4 + q * H + unit] = v;
      }
      *reinterpret_cast<float4*>(dg_s + (size_t)(rl0 + i) * H4 + 4 * unit) =
          make_float4(gq[0], gq[1], gq[2], gq[3]);
    }
    __syncthreads();  // dg_s complete; x_s / hp_s no longer read this step

    // dx = dgc @ W_ih[d], one input column per thread, RX rows
    {
      const float* wrow = w_ih_s + (size_t)ex * WS;
      const bool p0 = ex < E0;
      T* out = static_cast<T*>(d ? dx.b[p0 ? 0 : 1] : dx.f[p0 ? 0 : 1]);
      const int Ep = p0 ? E0 : E1;
      const int col = p0 ? ex : ex - E0;
      float ax[kMaxRX];
      dot_rows<kMaxRX, float>(ax, dg_s + (size_t)rx0 * H4, H4, wrow, H4, RX);
#pragma unroll
      for (int i = 0; i < kMaxRX; ++i) {
        const int r = row0 + rx0 + i;
        if (i < RX && r < B) out[((size_t)pos * B + r) * Ep + col] = from_f32<T>(ax[i]);
      }
    }
    // dh_prev = dgc @ W_hh[d, g] (+ the passed-through dh where masked)
    {
      float ah[kRows];
      dot_rows<kRows, float>(ah, dg_s + (size_t)rl0 * H4, H4, w_hh_s + (size_t)unit * WS, H4,
                             kRows);
#pragma unroll
      for (int i = 0; i < kRows; ++i) dh[i] = ah[i] + keep[i];
    }
    if (s + 1 < T_steps) store_tiles<T>(x_s, hp_s, tr, tl);
    __syncthreads();  // next tiles in place; dg_s free
  }

  // dbias: sum this block's row groups, one partial per (block, direction)
#pragma unroll
  for (int q = 0; q < 4; ++q) dg_s[(size_t)rg * H4 + q * H + unit] = dbias[q];
  __syncthreads();
  for (int c = threadIdx.x; c < H4; c += blockDim.x) {
    float sum = 0.0f;
    for (int g = 0; g < RG; ++g) sum += dg_s[(size_t)g * H4 + c];
    dbias_part[((size_t)blockIdx.x * 2 + d) * H4 + c] = sum;
  }
}

template <typename T>
int launch(const void* x0, const void* x1, int E0, int E1, const int* lengths, const void* w_ih,
           const void* w_hh, const float* bias, const void* hs_f, const void* hs_b,
           const void* cs_f, const void* cs_b, Streams2 dy, const float* dhn, const float* dcn,
           Out2 dx, void* dgc, float* dbias_part, int T_steps, int B, int H, int G, int threads,
           int smem, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int BR = (threads / H) * kRows;
  const int nq0 = BR * E0 / V, nq1 = BR * E1 / V, nq = nq0 + nq1 + BR * H / V;
  const Tiles tf{x0, x1, hs_f, E0, E1, H, nq0, nq1, nq};
  const Tiles tb{x0, x1, hs_b, E0, E1, H, nq0, nq1, nq};
  cudaError_t err = cudaFuncSetAttribute(bilstm_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BR - 1) / BR, 2);
  bilstm_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      tf, tb, lengths, static_cast<const T*>(w_ih), static_cast<const T*>(w_hh), bias,
      static_cast<const T*>(cs_f), static_cast<const T*>(cs_b), dy, dhn, dcn, dx,
      static_cast<T*>(dgc), dbias_part, T_steps, B, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_bwd_rows_per_thread() { return kRows; }
int bilstm_bwd_max_chunks() { return kMaxChunks; }
int bilstm_bwd_max_threads() { return kMaxThreads; }
int bilstm_bwd_max_dx_rows() { return kMaxRX; }
int bilstm_bwd_pad() { return kPad; }

const char* bilstm_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype 0: float32, 1: bfloat16. x1, dy*1, dx*1 may be null (one input
// part, fewer dy streams); ny is the number of dy streams per direction
// (0-2); dhn / dcn may be null (zero). dbias_part is (ceil(B / BR), 2, 4H)
// f32. Returns a cudaError_t (0 on success).
int bilstm_bwd(int dtype, const void* x0, const void* x1, int E0, int E1, const void* lengths,
               const void* w_ih, const void* w_hh, const void* bias, const void* hs_f,
               const void* hs_b, const void* cs_f, const void* cs_b, const void* dyf0,
               const void* dyf1, const void* dyb0, const void* dyb1, int ny, const void* dhn,
               const void* dcn, void* dxf0, void* dxf1, void* dxb0, void* dxb1, void* dgc,
               void* dbias_part, int T_steps, int B, int H, int G, int threads, int smem,
               void* stream) {
  const Streams2 dy{{dyf0, dyf1}, {dyb0, dyb1}, ny};
  const Out2 dx{{dxf0, dxf1}, {dxb0, dxb1}};
  const int* len = static_cast<const int*>(lengths);
  const float* b = static_cast<const float*>(bias);
  const float* dh = static_cast<const float*>(dhn);
  const float* dc = static_cast<const float*>(dcn);
  float* db = static_cast<float*>(dbias_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f, hs_b, cs_f, cs_b, dy, dh, dc,
                         dx, dgc, db, T_steps, B, H, G, threads, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x0, x1, E0, E1, len, w_ih, w_hh, b, hs_f, hs_b, cs_f, cs_b, dy,
                                 dh, dc, dx, dgc, db, T_steps, B, H, G, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
