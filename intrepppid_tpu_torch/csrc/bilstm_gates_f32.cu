// Input projection of a bidirectional LSTM layer, f32 compute dtype: the
// tensor-core variant in three tf32 passes, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_gates_mma.cu (bf16), the input-gate product that
// the TPU kernels form in their own body:
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _xg2 (:255-283), called by
//     _fwd_kernel (row 3, via _fwd_pallas) and _bwd_kernel with
//     fused_input=True (row 4, via _bwd_pallas);
// and the lite backward's recompute of the same gates (_input_gates,
// :808-823). The wide route takes its input gates from this kernel in the
// forward and again in the backward: the same kernel on the same operands,
// deterministic (no split-K, no atomics), so both see the same f32 bits.
//
// Function (the contract of ops/lstm.py:input_gates with the compute dtype
// f32): for each direction d,
//   xg[d, t, b, :] = concat_p(x_p[t, b, :]) @ W_ih[d]^T + bias[d]
// with f32 operands and accumulation, the f32 bias added last and an f32
// (2, T, B, 4H) output: a GEMM per direction, M = T * B rows, N = 4H gate
// columns, K = E input columns over 1 or 2 parts, both operands K-contiguous.
//
// What bounds it on an H100: operations. One f32 product is three tf32
// products (big.big + big.small + small.big, split_tf32 in bilstm_mma.cuh:
// one tf32 pass keeps ~3 decimal digits, which misses the f32 agreement),
// so the rate is 495 / 3 TFLOP/s: at the scaled train shape (M = 600,000,
// N = 1024, K = 256 and 512) 1.89 TFLOP, 11.4 ms, against 4.9 GB of f32
// output a layer, 1.5 ms at 3.35 TB/s.
//
// Design: bilstm_gates_mma.cu's schedule with f32 stages. 128 x 128 output
// tiles, 8 warps of 64 x 32 (4 m16 x 4 n8 each), mma.sync m16n8k8 tf32. K
// advances 16 columns at a time (64 bytes of a row, the bf16 kernel's
// bytes) through a 4-stage cp.async ring of 16-byte copies (a chunk past E
// is zero; each chunk is read from whichever input part holds it). Rows are
// padded by 4 floats (80-byte stride): the same byte layout as the bf16
// stages, so non-transposed ldmatrix delivers tf32 fragments directly (an
// 8 x 8 b16 matrix is 8 rows of four f32, lane 4g + t receives element
// (g, t)) and stays conflict-free. Each fragment is split into big and
// small once after its load; every k8 step runs 48 mma a warp. The ring is
// 80 KB, so two blocks fit an SM and one block's stores overlap the other's
// products. The tile leaves through shared memory (the ring's space, rows
// padded to 136 floats) as 16-byte coalesced rows, the bias added on the
// way out. Blocks walk the N tiles and both directions of one row tile in
// turn, so the row tile's operand is read from L2 after the first. Not yet
// done: wgmma and TMA.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace {

using namespace bilstm;

constexpr int kBM = 128;    // output rows per block
constexpr int kBN = 128;    // output (gate) columns per block
constexpr int kBK = 16;     // input columns per stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kPad = 4;     // f32 elements of padding on every staged row
constexpr int kOutPad = 8;  // f32 elements of padding on every output row
constexpr int kRowS = kBK + kPad;                      // staged row stride (floats)
constexpr int kStageBytes = (kBM + kBN) * kRowS * 4;   // A and B tiles
constexpr int kSmem = kStages * kStageBytes;           // 81,920 bytes
constexpr int kOutS = kBN + kOutPad;                   // output row stride
static_assert(kBM * kOutS * 4 <= kSmem, "the output tile reuses the ring");

struct Args {
  const float* x[2];
  int E0, E1;
  const float* w;     // (2, N, E)
  const float* bias;  // (2, N)
  float* xg;          // (2, M, N)
  int M, N;
};

// A fragment's four f32 values split into their big and small tf32 parts.
__device__ __forceinline__ void split_frag(const uint32_t (&r)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(r[q]), big[q], small[q]);
}

// grid (ceil(M / kBM) * 2 * N / kBN), block kThreads; consecutive blocks
// share a row tile.
__global__ void __launch_bounds__(kThreads, 2) bilstm_gates_f32_kernel(const Args a) {
  const int E0 = a.E0, E = a.E0 + a.E1, M = a.M, N = a.N;
  const int ntiles = N / kBN;
  const int n_tile = blockIdx.x % ntiles;
  const int rest = blockIdx.x / ntiles;
  const int d = rest & 1;
  const int m0 = (rest >> 1) * kBM, n0 = n_tile * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int wm0 = (warp >> 2) * 64, wn0 = (warp & 3) * 32;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  const float* w = a.w + (size_t)d * N * E;

  // each thread copies 4 chunks a stage: two of the A tile (x rows), two of
  // the B tile (W_ih rows); chunk c: tile row c / 4, columns 4 * (c % 4)
  auto load = [&](int stage, int k0) {
    const uint32_t base = smem0 + (uint32_t)stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + (i & 1) * kThreads;
      const int row = c >> 2, k = k0 + 4 * (c & 3);
      const bool in_k = k < E;
      const float* src;
      bool ok;
      uint32_t dst;
      if (i < 2) {
        const int m = m0 + row;
        const int p = k < E0 ? 0 : 1;
        const int Ep = p ? a.E1 : E0;
        ok = in_k && m < M;
        src = ok ? a.x[p] + (size_t)m * Ep + (k - (p ? E0 : 0)) : a.x[0];
        dst = base + (uint32_t)((row * kRowS + 4 * (c & 3)) * 4);
      } else {
        ok = in_k;
        src = ok ? w + (size_t)(n0 + row) * E + k : w;
        dst = base + (uint32_t)(((kBM + row) * kRowS + 4 * (c & 3)) * 4);
      }
      cp_async16(dst, src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  const int nk = (E + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }
  // A: rows wm0 + 16i + lr + 8 (lm & 1), columns kk + 4 (lm >> 1): matrices
  // (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7), i.e. a0 .. a3;
  // B: rows wn0 + 16jp + lr + 8 (lm >> 1), columns kk + 4 (lm & 1): b0, b1
  // of n8 tile 2jp, then of 2jp + 1
  const uint32_t a_off = (uint32_t)(((wm0 + lr + 8 * (lm & 1)) * kRowS + 4 * (lm >> 1)) * 4);
  const uint32_t b_off =
      (uint32_t)(((kBM + wn0 + lr + 8 * (lm >> 1)) * kRowS + 4 * (lm & 1)) * 4);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    cp_async_commit();
    const uint32_t st = smem0 + (uint32_t)(kt % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4], big[4], small[4];
        ldmatrix_x4(r, st + b_off + (uint32_t)((16 * jp * kRowS + kk) * 4));
        split_frag(r, big, small);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bb[2 * jp + h][0] = big[2 * h];
          bb[2 * jp + h][1] = big[2 * h + 1];
          bs[2 * jp + h][0] = small[2 * h];
          bs[2 * jp + h][1] = small[2 * h + 1];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t r[4], ab[4], as[4];
        ldmatrix_x4(r, st + a_off + (uint32_t)((16 * i * kRowS + kk) * 4));
        split_frag(r, ab, as);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], as, bb[j][0], bb[j][1]);
          mma_tf32(acc[i][j], ab, bs[j][0], bs[j][1]);
          mma_tf32(acc[i][j], ab, bb[j][0], bb[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the output tile now

  float* out_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm0 + 16 * i + g, c = wn0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out_s + r * kOutS + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out_s + (r + 8) * kOutS + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  __syncthreads();
  // a warp stores one 512-byte row segment at a time; the bias goes on last
  const int cc = 4 * lane;
  const float4 b = *reinterpret_cast<const float4*>(a.bias + (size_t)d * N + n0 + cc);
  float* out = a.xg + ((size_t)d * M + m0) * N + n0 + cc;
#pragma unroll 4
  for (int r = warp; r < kBM; r += kThreads / 32) {
    if (m0 + r >= M) break;
    const float4 v = *reinterpret_cast<const float4*>(out_s + r * kOutS + cc);
    __stcs(reinterpret_cast<float4*>(out + (size_t)r * N),
           make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
  }
}

}  // namespace

extern "C" {

int bilstm_gates_f32_tile_m() { return kBM; }
int bilstm_gates_f32_tile_n() { return kBN; }
int bilstm_gates_f32_tile_k() { return kBK; }
int bilstm_gates_f32_stages() { return kStages; }
int bilstm_gates_f32_smem() { return kSmem; }

const char* bilstm_gates_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compute dtype is float32. x0 (T, B, E0); x1 (T, B, E1) or null with
// E1 = 0; w_ih (2, 4H, E0 + E1); bias (2, 4H); xg (2, T, B, 4H), all f32.
// Needs 4H % kBN == 0 and E0, E1 multiples of 4. Returns a cudaError_t (0 on
// success).
int bilstm_gates_f32(const void* x0, const void* x1, int E0, int E1, const void* w_ih,
                     const void* bias, void* xg, int T_steps, int B, int H, void* stream) {
  if (H <= 0 || (4 * H) % kBN || E0 <= 0 || E0 % 4 || E1 < 0 || E1 % 4 || (E1 > 0 && !x1) ||
      T_steps < 0 || B < 0 || (long long)T_steps * B > 0x7fffffffLL - kBM)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.E0 = E0;
  a.E1 = E1;
  a.w = static_cast<const float*>(w_ih);
  a.bias = static_cast<const float*>(bias);
  a.xg = static_cast<float*>(xg);
  a.M = T_steps * B;
  a.N = 4 * H;
  if (a.M == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(bilstm_gates_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.M + kBM - 1) / kBM) * 2 * (a.N / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bilstm_gates_f32_kernel<<<(unsigned)blocks, kThreads, kSmem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
