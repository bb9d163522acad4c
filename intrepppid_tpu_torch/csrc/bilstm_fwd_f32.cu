// Bidirectional LSTM layer forward, f32 compute dtype, H <= 80: the
// tensor-core variant in three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_fwd_mma.cu (bf16), the TPU kernels
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _fwd_kernel_packed (via
//     _fwd_pallas_packed) -- the layer forward at 2H == 128: with_states
//     False (eval variant: the serve path, infer from_csv) and True (train
//     variant, which also emits the cell stream for the backward);
//   intrepppid_tpu/ops/lstm_pallas_layer.py   _fwd_kernel (via _fwd_pallas)
//     -- the same function at the other resident widths, layer 0 of the
//     model at embedding 80 (E = H = 80) among them.
//
// Function (the contract of ops/lstm.py:bidir_layer): for
// each direction d and row r, step s reads position pos = s (d = 0) or
// T-1-s (d = 1) and computes gates = [x_parts](pos) @ W_ih[d]^T + bias[d] +
// h @ W_hh[d, g]^T (gate order i, f, g, o; g the row's weight group), then
// the cell update. The state moves iff pos < lengths[r], otherwise it stays
// frozen. Every position gets the row's (possibly frozen) h in hs_f / hs_b
// and, in the train variant, c in cs_f / cs_b; the final state goes to
// hn / cn. Every operand, stream and state is f32.
//
// What bounds it on an H100: per step and row 4H x (E + H) multiply-adds,
// 393 GFLOP at serve's shape (800 rows, T = 1500, both layers). On the CUDA
// cores (67 TFLOP/s) that is ~5.9 ms of operations, and the CUDA-core
// kernel this one replaced took ~21 ms on an H100, paced by shared-memory
// weight reads and FMA issue. One tf32
// pass on the tensor cores keeps ~3 decimal digits, which would break the
// serve path's 1e-4 agreement with the plain forward; three passes
// (big.big + big.small + small.big, split_tf32 in bilstm_mma.cuh) keep
// about 20 bits, at 495/3 TFLOP/s: ~2.4 ms at serve's shape. The serial
// chain of a step, T times, is the floor under that.
//
// Design: the swapped product of bilstm_fwd_mma.cu with the three tf32
// passes of bilstm_bwd_f32.cu:
//   * one block per (row tile, direction), one warp per 8 hidden units; the
//     product gates^T (4H x rows) = [W_ih | W_hh] . [x ; h]^T on mma.sync
//     m16n8k8 with the gate rows permuted, so lane (g, t) of warp w holds
//     the four gates of unit 8w + g for its rows: the cell maths runs on
//     the accumulators;
//   * [W_ih[d] | W_hh[d, g]] is resident in shared memory in f32, ONE copy
//     (200 KB at E = 128; a pre-split copy does not fit), rows padded to 8
//     (mod 32) floats, read as float2 pairs (the K order within a k8 step
//     is read as pairs, the [x ; h] tile the same way: conflict-free) and
//     split as the fragments are built, with a mask;
//   * the row tile is 8 or 16 rows (NT n8 tiles), picked per launch: 16
//     where 8-row tiles would take more than one wave of the SMs (serve's
//     800 rows: 100 blocks instead of 200), so each split weight fragment
//     feeds two n8 products; 8 where they fill the card in one wave (the
//     train step's 400 rows in 5 groups: 100 blocks);
//   * the three passes accumulate apart (6 NT independent products a k8
//     step);
//   * the [x ; h] tile of a step lives in two stages: x arrives by cp.async
//     a step ahead, h (f32, the next step's B operand) is stored by the
//     cell update into the same stage: ONE __syncthreads a step;
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh);
//   * a tile stops at its longest row: past it the forward direction's
//     state is frozen (its final h and c are written there), and the
//     reverse direction has not started (zeros);
//   * at H = 80 (layer 0 of the model at embedding 80) the block has 10
//     warps, 320 threads, in an instance of its own whose launch bound
//     leaves the H <= 64 instances their 255 registers a thread (320
//     threads get 204): its weights (320 rows of stride 168, 215,040 B at
//     E = 80) and two 8-row stages take 225,792 B, so its tiles are 8 rows
//     (16 would need 236,544 B of the 232,448 a block may use); at the
//     train step's 400 rows in 5 groups that is 100 blocks in one wave.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kMaxChunks = 2;   // 16-byte x chunks each thread copies per step
// threads a block (4H): at most kSmallThreads in the instances up to H = 64,
// kMaxThreads in the H = 80 ones, each instance's launch bound its own
constexpr int kSmallThreads = 256;
constexpr int kMaxThreads = 320;
constexpr int kMaxH = 80;
constexpr int kStrideAlign = 32, kStridePad = 8;

struct Args {
  const float* x[2];
  int E0, E1;
  const int* lengths;
  const float* w_ih;   // (2, 4H, E)
  const float* w_hh;   // (2, G, 4H, H)
  const float* bias;   // (2, 4H)
  float* hs[2];        // (T, B, H) per direction
  float* cs[2];        // null: the eval variant
  float* hn;           // (2, B, H)
  float* cn;
  int T, B, H, G;
};

// The row stride (floats) of the weight and [x ; h] tiles: 8 (mod 32), so
// the float2 reads of a half-warp (4 rows x 4 pairs) fall in distinct banks.
__host__ __device__ constexpr int k_stride(int K) {
  return (K + kStrideAlign - 1) / kStrideAlign * kStrideAlign + kStridePad;
}

// grid (tiles, 2), block 32 * H / 8 threads, row tiles of 8 NT rows. HT and
// ET (the layer's H and total input width E) are template parameters for
// the model's shapes, so the product loop unrolls whole and its loads run
// ahead of the products; ET = 0 is the same code with E read at run time,
// HT = ET = 0 with both (H <= 64).
template <int HT, int ET, int NT>
__global__ void __launch_bounds__(HT > 64 ? kMaxThreads : kSmallThreads, 1)
    bilstm_fwd_f32_kernel(const Args a) {
  constexpr int R = kMmaTile * NT;  // rows of a tile
  const int tile = blockIdx.x, d = blockIdx.y;
  const int H = HT ? HT : a.H, H4 = 4 * H, T = a.T, B = a.B;
  const int E0 = a.E0, E = ET ? ET : E0 + a.E1, K = E + H;
  const int KS = k_stride(K);  // weight and x|h tile row stride
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Bg = B / a.G;
  const int row0 = tile_row(tile, 0, R, Bg);
  const int group = row0 / Bg;
  const int nrows = min(R, (group + 1) * Bg - row0);
  const int unit = 8 * warp + g;

  extern __shared__ __align__(16) unsigned char smem[];
  float* W_s = reinterpret_cast<float*>(smem);  // [4H permuted][KS]: W_ih | W_hh
  float* st_s = W_s + (size_t)H4 * KS;          // [2][R][KS]: x | h
  const uint32_t st_u32 = smem_u32(st_s);
  const int stage_floats = R * KS;

  int maxlen = 0;
  for (int n = 0; n < nrows; ++n) maxlen = max(maxlen, min(a.lengths[row0 + n], T));
  const int pos0 = d ? maxlen - 1 : 0, dpos = d ? -1 : 1;

  // x tile chunks: R rows x E / 4 chunks of 16 bytes; each thread walks the
  // source address of its chunks one position per fetch
  const int per_row = E / 4;
  const float* c_src[kMaxChunks];
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
    if (idx >= R * per_row) continue;
    const int n = idx / per_row, e = (idx - n * per_row) * 4;
    c_real[m] = n < nrows;
    const size_t row = row0 + (c_real[m] ? n : 0);
    const bool part0 = e < E0;
    const int width = part0 ? E0 : a.E1, col = part0 ? e : e - E0;
    const float* base = a.x[part0 ? 0 : 1];
    c_dst[m] = (uint32_t)((n * KS + e) * 4);
    c_walk[m] = dpos * B * width;
    c_src[m] = base + row * width + col + (ptrdiff_t)max(pos0, 0) * B * width;
  }
  int fetch_stage = 0;
  auto fetch = [&]() {
    const uint32_t base = st_u32 + (uint32_t)(fetch_stage * stage_floats * 4);
    fetch_stage ^= 1;
#pragma unroll
    for (int m = 0; m < kMaxChunks; ++m) {
      if (c_walk[m] == 0) continue;
      cp_async16(base + c_dst[m], c_real[m] ? c_src[m] : a.x[0], c_real[m]);
      c_src[m] += c_walk[m];
    }
  };
  if (maxlen > 0) fetch();
  cp_async_commit();

  // stage [W_ih[d] | W_hh[d, group]] with permuted rows, 16 bytes a copy
  {
    const float* wi = a.w_ih + (size_t)d * H4 * E;
    const float* wh = a.w_hh + ((size_t)d * a.G + group) * H4 * H;
    const int kq = K / 4;
    for (int idx = tid; idx < H4 * kq; idx += nthreads) {
      const int p = idx / kq, c = (idx - p * kq) * 4;
      const int j = gate_row_of_permuted(p, H);
      const float* src = c < E ? wi + (size_t)j * E + c : wh + (size_t)j * H + (c - E);
      *reinterpret_cast<float4*>(W_s + (size_t)p * KS + c) =
          *reinterpret_cast<const float4*>(src);
    }
  }
  // h before the first step is zero
  for (int idx = tid; idx < R * H; idx += nthreads) st_s[(idx / H) * KS + E + idx % H] = 0.0f;

  float bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bi[q] = a.bias[d * H4 + q * H + unit];
  // this lane's rows 8 nt + 2t + i: state, length
  int rown[NT][2], len[NT][2];
  float h[NT][2], c[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = kMmaTile * nt + 2 * t + i;
      rown[nt][i] = n < nrows ? row0 + n : -1;
      len[nt][i] = rown[nt][i] >= 0 ? a.lengths[rown[nt][i]] : 0;
      h[nt][i] = 0.0f;
      c[nt][i] = 0.0f;
    }
  }
  float* hs = a.hs[d];
  float* cs = a.cs[d];

  cp_async_wait<0>();
  __syncthreads();

  // A rows 32 w + 16 mt + g (+ 8), k pairs 2t, 2t + 1 of each k8 step
  // (logical k t and t + 4); B the tile rows 8 nt + g, the same pairs
  const float* a_gate = W_s + (size_t)(32 * warp + g) * KS + 2 * t;
  const int b_gate = g * KS + 2 * t;
  // this lane's writes of h into the next stage
  const int h_at = 2 * t * KS + E + unit;

  int pos = pos0;
  for (int s = 0; s < maxlen; ++s, pos += dpos) {
    if (s + 1 < maxlen) fetch();
    cp_async_commit();

    // gates^T: acc[pass][mt][nt]: mt 0 rows = gates i | f, mt 1 = g | o, of
    // units 8w..8w+7; pass 0 sums big.big (from the bias), passes 1 and 2
    // the cross terms
    float acc[3][2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[0][mt][nt][i] = bi[2 * mt];
          acc[0][mt][nt][2 + i] = bi[2 * mt + 1];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[1][mt][nt][v] = acc[2][mt][nt][v] = 0.0f;
      }
    }
    const float* tile_s = st_s + (s & 1) * stage_floats + b_gate;
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t bb[NT][2], bs[NT][2], ab[2][4], as[2][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv =
            *reinterpret_cast<const float2*>(tile_s + kMmaTile * nt * KS + 8 * kk);
        split_tf32(bv.x, bb[nt][0], bs[nt][0]);
        split_tf32(bv.y, bb[nt][1], bs[nt][1]);
      }
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
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[0][mt][nt], ab[mt], bb[nt][0], bb[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[1][mt][nt], as[mt], bb[nt][0], bb[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[2][mt][nt], ab[mt], bs[nt][0], bs[nt][1]);
    }

    float* h_next = st_s + ((s + 1) & 1) * stage_floats + h_at;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mt = q >> 1, v = 2 * (q & 1) + i;
          gate[q] = acc[0][mt][nt][v] + (acc[1][mt][nt][v] + acc[2][mt][nt][v]);
        }
        const float ig = fast_sigmoid(gate[0]);
        const float fg = fast_sigmoid(gate[1]);
        const float gg = fast_tanh(gate[2]);
        const float og = fast_sigmoid(gate[3]);
        const float c_new = fg * c[nt][i] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        if (pos < len[nt][i]) {
          c[nt][i] = c_new;
          h[nt][i] = h_new;
        }
        h_next[(kMmaTile * nt + i) * KS] = h[nt][i];
        if (rown[nt][i] >= 0) {
          const size_t at = ((size_t)pos * B + rown[nt][i]) * H + unit;
          hs[at] = h[nt][i];
          if (cs) cs[at] = c[nt][i];
        }
      }
    }
    cp_async_wait<0>();  // the next step's x has landed
    __syncthreads();     // the next step's h is stored; every warp is past this step's tile
  }

  // positions [maxlen, T): the forward direction's frozen state, the reverse
  // direction's zeros (it starts at each row's last position)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rown[nt][i] < 0) continue;
      const float hq = d ? 0.0f : h[nt][i];
      const float cq = d ? 0.0f : c[nt][i];
      for (int p = maxlen; p < T; ++p) {
        const size_t at = ((size_t)p * B + rown[nt][i]) * H + unit;
        hs[at] = hq;
        if (cs) cs[at] = cq;
      }
      const size_t at = ((size_t)d * B + rown[nt][i]) * H + unit;
      a.hn[at] = h[nt][i];
      a.cn[at] = c[nt][i];
    }
  }
}

template <int HT, int ET, int NT>
int launch(const Args& a, int tiles, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bilstm_fwd_f32_kernel<HT, ET, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_fwd_f32_kernel<HT, ET, NT><<<dim3(tiles, 2), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_shape(const Args& a, int E, int tiles, int threads, int smem, cudaStream_t st) {
  // H = 80: 320-thread blocks, 8-row tiles only (16 do not fit shared
  // memory); E = 80 is layer 0 of the model at embedding 80
  if (a.H == 80) {
    if constexpr (NT == 1) {
      if (E == 80) return launch<80, 80, NT>(a, tiles, threads, smem, st);
      return launch<80, 0, NT>(a, tiles, threads, smem, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  // the model's layers (E = H below, E = 2H stacked) at its two widths
  if (a.H == 64 && E == 64) return launch<64, 64, NT>(a, tiles, threads, smem, st);
  if (a.H == 64 && E == 128) return launch<64, 128, NT>(a, tiles, threads, smem, st);
  if (a.H == 32 && E == 32) return launch<32, 32, NT>(a, tiles, threads, smem, st);
  if (a.H == 32 && E == 64) return launch<32, 64, NT>(a, tiles, threads, smem, st);
  return launch<0, 0, NT>(a, tiles, threads, smem, st);
}

}  // namespace

extern "C" {

int bilstm_fwd_f32_tile() { return kMmaTile; }
int bilstm_fwd_f32_max_chunks() { return kMaxChunks; }
int bilstm_fwd_f32_max_threads() { return kMaxThreads; }
int bilstm_fwd_f32_max_h() { return kMaxH; }
int bilstm_fwd_f32_stride_align() { return kStrideAlign; }
int bilstm_fwd_f32_stride_pad() { return kStridePad; }

const char* bilstm_fwd_f32_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The compute dtype is float32. Operands (ops/lstm_cuda.py:_tile_fwd_launch):
// x0 (T, B, E0), x1 (T, B, E1), w_ih (2, 4H, E0 + E1) and
// w_hh (2, G, 4H, H) in the compute dtype; lengths (B,) int32; bias (2, 4H)
// f32; out: hs_f, hs_b and cs_f, cs_b (T, B, H) in the compute dtype, hn,
// cn (2, B, H) f32. x1 may be null (E1 = 0); cs_f /
// cs_b null selects the eval variant. `rows` (8 or 16) is the row tile;
// each of the G weight groups (B / G rows) is cut into its own tiles:
// `tiles` = G * ceil(B / G / rows); threads = 4H; smem the dynamic shared
// memory (4H + 2 rows) * k_stride(E + H) * 4 bytes. H % 16 == 0, H <= kMaxH
// (8-row tiles at H = 80), input parts multiples of 8. Returns a cudaError_t
// (0 on success).
int bilstm_fwd_f32(const void* x0, const void* x1, int E0, int E1, const void* lengths,
                   const void* w_ih, const void* w_hh, const void* bias, void* hs_f, void* hs_b,
                   void* cs_f, void* cs_b, void* hn, void* cn, int T_steps, int B, int H, int G,
                   int rows, int tiles, int threads, int smem, void* stream) {
  const int E = E0 + E1;
  if (H % 16 || H <= 0 || H > kMaxH || E0 <= 0 || E0 % 8 || E1 < 0 || E1 % 8 ||
      (E1 > 0) != (x1 != nullptr) || G <= 0 || B % G || (cs_f == nullptr) != (cs_b == nullptr) ||
      (rows != kMmaTile && rows != 2 * kMmaTile) || threads != 4 * H ||
      rows * E / 4 > kMaxChunks * threads)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.E0 = E0; a.E1 = E1;
  a.lengths = static_cast<const int*>(lengths);
  a.w_ih = static_cast<const float*>(w_ih);
  a.w_hh = static_cast<const float*>(w_hh);
  a.bias = static_cast<const float*>(bias);
  a.hs[0] = static_cast<float*>(hs_f); a.hs[1] = static_cast<float*>(hs_b);
  a.cs[0] = static_cast<float*>(cs_f); a.cs[1] = static_cast<float*>(cs_b);
  a.hn = static_cast<float*>(hn);
  a.cn = static_cast<float*>(cn);
  a.T = T_steps; a.B = B; a.H = H; a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == kMmaTile) return launch_shape<1>(a, E, tiles, threads, smem, st);
  return launch_shape<2>(a, E, tiles, threads, smem, st);
}

}  // extern "C"
