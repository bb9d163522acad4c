// Bidirectional LSTM layer backward sweep (BPTT), f32 compute dtype, H <= 64:
// the tensor-core variant, hand-written for Hopper (sm_90a).
//
// Replaces, like bilstm_bwd.cu (which keeps the f32 shapes this kernel does
// not take) and bilstm_bwd_mma.cu (bf16), the recurrent part of the TPU
// kernels
//   intrepppid_tpu/ops/lstm_pallas_packed.py  _bwd_kernel_packed (via
//     _bwd_pallas_packed) -- the train step's layer backward at 2H == 128,
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel (via _bwd_pallas)
//     at the other widths that fit.
// Their weight-gradient products are bilstm_wgrad_f32.cu's.
//
// Function (the contract of ops/lstm.py:bidir_layer_sweep, as bilstm_bwd.cu):
// block (row tile, direction d) walks the positions in the reverse of that
// direction's forward order carrying dh and dc (f32). Per step and row:
// gates recomputed from x(pos) and h_prev, c_prev from the cell stream,
// dh += the 0-2 dy streams, the masked dgates (a position at or past the
// row's length gets dgates = 0 and passes dh and dc through), dgc = dgates
// to the (2, T, B, 4H) stream, dx = dgc @ W_ih[d] per input part, dh =
// dgc @ W_hh[d, g] (+ the passed-through dh), and dbias partials, one
// (2, 4H) slab per tile. Every stream is f32.
//
// What bounds it on an H100: the sweep is serial in T, and each step does
// 4H x (2E + 2H) multiply-adds per row (gate recompute, dx, dh). On CUDA
// cores (bilstm_bwd.cu) those are 67 TFLOP/s work, and there each weight
// read from shared memory fed 2 rows, so shared-memory bandwidth paced it
// at ~14.6 us a step. One tf32 pass on the tensor cores keeps ~3 decimal
// digits, which would break the f32 agreement (1e-4 x max(1, max|ref|)).
//
// Design: the tensor-core sweep of bilstm_bwd_mma.cu in three passes of
// tf32 ("3xTF32"): each f32 operand is split as it is loaded into a tf32
// `big` and the f32 remainder `small`, and a product is big.big + big.small
// + small.big on mma.sync m16n8k8 (split_tf32, bilstm_mma.cuh): about 20
// bits of each product, at three tensor-core passes where f32 has none.
//   * the products are swapped as in bilstm_bwd_mma.cu: weights the 16-row
//     A operand, the 8-row tile the 8-column B operand; gate rows permuted
//     so a lane holds the four gates of one unit for two rows;
//   * [W_ih[d] | W_hh[d, g]] is resident in shared memory in f32, ONE copy
//     (4H x (E + H), 200 KB at E = 128; a second, pre-split copy does not
//     fit), rows padded to 8 (mod 32) floats. The gate product reads it as
//     float2 pairs (its K order within a k8 step is permuted so a lane's two
//     k values are adjacent, and the [x ; h] tile is read the same way), the
//     transposed products (dh, dx) as single floats, all conflict-free;
//   * the three passes accumulate apart (six independent products a k8
//     step), and the split is a mask and a subtraction, on the integer and
//     FMA pipes, not cvt.rna.tf32.f32 on the slower conversion unit;
//   * the cell's sigmoid and tanh from ex2 / rcp (bilstm_mma.cuh), as in the
//     bf16 kernels, not expf / tanhf;
//   * the dgates tile is f32 in shared memory, read by ldmatrix (a b16 pair
//     is one f32); with one buffer (two do not fit beside the weights), a
//     step has two barriers: before the dgates are written and after;
//   * the [x ; h_prev] tile arrives by cp.async into two stages, a step
//     ahead; c_prev and dy come straight from HBM into registers a step
//     ahead (they are read by the lane that uses them);
//   * dx stays in the serial loop, as in bilstm_bwd_mma.cu: rows 8-15 of a
//     main warp's transposed tile and extra warps carry its columns;
//   * a tile skips the positions at or past its longest row (zeros written
//     up front; the forward direction adds their dy to dh first); row tiles
//     of 8 cut inside each weight group: 2 x 50 blocks at 400 rows.
// What paces it: ~6 us a step at 400 rows (chip_smoke.py, phase
// train_kernel): issue, with every weight split twice a step (gate and
// transposed product), two integer-or-float operations per element, and
// the tf32 products of one block per SM.
// Not yet done: wgmma (tf32 takes K-major operands: A from registers, B
// from shared memory fits both products), and dx out of the loop.
// The kernel is bilstm_bwd_f32.cuh's, shared with bilstm_bwd_f32_onestage.cu
// (its one-stage instance); this source instantiates it with two stages.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"
#include "bilstm_bwd_f32.cuh"

namespace {

constexpr int kMaxThreads = 384;
constexpr int kMaxH = 64;

}  // namespace

extern "C" {

int bilstm_bwd_f32_tile() { return kMmaTile; }
int bilstm_bwd_f32_max_chunks() { return kMaxChunks; }
int bilstm_bwd_f32_max_threads() { return kMaxThreads; }
int bilstm_bwd_f32_max_h() { return kMaxH; }
int bilstm_bwd_f32_stride_align() { return kStrideAlign; }
int bilstm_bwd_f32_stride_pad() { return kStridePad; }

const char* bilstm_bwd_f32_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The compute dtype is float32. Operands as bilstm_bwd (bilstm_bwd.cu)
// without the dtype code: x1, dy*1, dx*1 may be null (one input part, fewer
// dy streams); ny is the number of dy streams per direction (0-2); dhn / dcn
// may be null (zero). Each of the G weight groups (B / G rows) is cut into
// its own 8-row tiles: `tiles` = G * ceil(B / G / 8), and dbias_part is
// (tiles, 2, 4H) f32. H % 16 == 0, H <= kMaxH, E parts multiples of 8.
// Returns a cudaError_t (0 on success).
int bilstm_bwd_f32(const void* x0, const void* x1, int E0, int E1, const void* lengths,
                   const void* w_ih, const void* w_hh, const void* bias, const void* hs_f,
                   const void* hs_b, const void* cs_f, const void* cs_b, const void* dyf0,
                   const void* dyf1, const void* dyb0, const void* dyb1, int ny, const void* dhn,
                   const void* dcn, void* dxf0, void* dxf1, void* dxb0, void* dxb1, void* dgc,
                   void* dbias_part, int T_steps, int B, int H, int G, int tiles, int threads,
                   int smem, void* stream) {
  Args a;
  if (!make_args<kMaxThreads, kMaxH>(a, x0, x1, E0, E1, lengths, w_ih, w_hh, bias, hs_f, hs_b,
                                     cs_f, cs_b, dyf0, dyf1, dyb0, dyb1, ny, dhn, dcn, dxf0,
                                     dxf1, dxb0, dxb1, dgc, dbias_part, T_steps, B, H, G,
                                     threads))
    return (int)cudaErrorInvalidValue;
  const int E = E0 + E1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the model's layers (E = H below, E = 2H stacked) at its two widths
  if (H == 64 && E == 64) return launch<64, 64, kMaxThreads, false>(a, tiles, threads, smem, st);
  if (H == 64 && E == 128) return launch<64, 128, kMaxThreads, false>(a, tiles, threads, smem, st);
  if (H == 32 && E == 32) return launch<32, 32, kMaxThreads, false>(a, tiles, threads, smem, st);
  if (H == 32 && E == 64) return launch<32, 64, kMaxThreads, false>(a, tiles, threads, smem, st);
  return launch<0, 0, kMaxThreads, false>(a, tiles, threads, smem, st);
}

}  // extern "C"
