// Bidirectional LSTM layer backward sweep (BPTT), f32 compute dtype, at the
// widths past bilstm_bwd_f32.cu's shared memory (E = H = 80): the tensor-core
// sweep in three tf32 passes with ONE [x ; h] stage, hand-written for Hopper
// (sm_90a).
//
// Replaces, like bilstm_bwd.cu (which keeps the bf16 shapes the tensor-core
// sweeps do not take), the recurrent part of the TPU kernel
//   intrepppid_tpu/ops/lstm_pallas_layer.py  _bwd_kernel (via _bwd_pallas)
// at the resident widths past H = 64: layer 0 of a model at embedding 80.
// Its weight-gradient products are bilstm_wgrad_f32.cu's.
//
// Function: that of bilstm_bwd_f32.cu (ops/lstm.py:bidir_layer_sweep):
// block (row tile, direction d) walks the positions in the reverse of that
// direction's forward order carrying dh and dc (f32); per step and row the
// gates recomputed from x(pos) and h_prev, c_prev from the cell stream, dh
// += the 0-2 dy streams, the masked dgates, dgc = dgates to the (2, T, B,
// 4H) stream, dx = dgc @ W_ih[d] per input part, dh = dgc @ W_hh[d, g] (+
// the passed-through dh), and dbias partials, one (2, 4H) slab per tile.
// Every stream is f32.
//
// What bounds it on an H100: the sweep is serial in T; a step does
// 4H x (2E + 2H) multiply-adds per row, 3.668 ms of f32 CUDA-core work at
// 400 rows and T = 1500, 1.49 ms at the 3xTF32 rate (495 / 3 TFLOP/s). On
// the CUDA cores (bilstm_bwd.cu) shared-memory bandwidth paced it at ~33 us
// a step.
//
// Design: bilstm_bwd_f32.cu's design (swapped products on mma.sync m16n8k8,
// each f32 operand split into a tf32 `big` and the f32 remainder `small`,
// big.big + big.small + small.big accumulated apart; permuted gate rows;
// the dgates tile in f32 read by ldmatrix; the cell from ex2 / rcp; dx in
// the serial loop; 8-row tiles cut inside each weight group), with the one
// change its shared memory forces at E = H = 80: the f32 weights (4H rows
// of stride 168: 215,040 B), the dgates tile (10,368 B) and two cp.async
// stages (10,752 B) are 3,712 B past the 232,448 a block may use, so
//   * the [x0 | x1 | h_prev] tile has ONE stage (5,376 B; 230,784 B in all),
//     and the next step's tile comes through registers: each thread loads
//     its 16-byte chunks of step s + 2 from HBM while step s's transposed
//     product and step s + 1's gate product run, and stores them into the
//     stage between the two barriers of step s + 1, after that step's gate
//     product has read it. The load's latency is a step long, as with
//     cp.async two stages ahead;
//   * 320 threads at E = H = 80 (10 warps, each with 8 units and 8 dx
//     columns), so the register budget is 204 a thread, not 168.
// c_prev and dy come straight from HBM into registers a step ahead, as in
// bilstm_bwd_f32.cu.
// Not yet done: a 2-block cluster splitting the gate rows (which would also
// take the stacked layer at E = 2H = 160; the port pads that one to the wide
// route at H = 96), wgmma, dx out of the loop.
// The kernel is bilstm_bwd_f32.cuh's (kOneStage), shared with
// bilstm_bwd_f32.cu.

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"
#include "bilstm_bwd_f32.cuh"

namespace {

constexpr int kMaxThreads = 320;
constexpr int kMaxH = 80;

}  // namespace

extern "C" {

int bilstm_bwd_f32_onestage_tile() { return kMmaTile; }
int bilstm_bwd_f32_onestage_max_chunks() { return kMaxChunks; }
int bilstm_bwd_f32_onestage_max_threads() { return kMaxThreads; }
int bilstm_bwd_f32_onestage_max_h() { return kMaxH; }
int bilstm_bwd_f32_onestage_stride_align() { return kStrideAlign; }
int bilstm_bwd_f32_onestage_stride_pad() { return kStridePad; }

const char* bilstm_bwd_f32_onestage_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The compute dtype is float32. Operands as bilstm_bwd_f32 (bilstm_bwd_f32.cu):
// x1, dy*1, dx*1 may be null (one input part, fewer dy streams); ny is the
// number of dy streams per direction (0-2); dhn / dcn may be null (zero).
// Each of the G weight groups (B / G rows) is cut into its own 8-row tiles:
// `tiles` = G * ceil(B / G / 8), and dbias_part is (tiles, 2, 4H) f32.
// H % 16 == 0, H <= kMaxH, E parts multiples of 8. Returns a cudaError_t (0
// on success).
int bilstm_bwd_f32_onestage(const void* x0, const void* x1, int E0, int E1, const void* lengths,
                            const void* w_ih, const void* w_hh, const void* bias,
                            const void* hs_f, const void* hs_b, const void* cs_f,
                            const void* cs_b, const void* dyf0, const void* dyf1,
                            const void* dyb0, const void* dyb1, int ny, const void* dhn,
                            const void* dcn, void* dxf0, void* dxf1, void* dxb0, void* dxb1,
                            void* dgc, void* dbias_part, int T_steps, int B, int H, int G,
                            int tiles, int threads, int smem, void* stream) {
  Args a;
  if (!make_args<kMaxThreads, kMaxH>(a, x0, x1, E0, E1, lengths, w_ih, w_hh, bias, hs_f, hs_b,
                                     cs_f, cs_b, dyf0, dyf1, dyb0, dyb1, ny, dhn, dcn, dxf0,
                                     dxf1, dxb0, dxb1, dgc, dbias_part, T_steps, B, H, G,
                                     threads))
    return (int)cudaErrorInvalidValue;
  const int E = E0 + E1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // layer 0 of the model at embedding 80
  if (H == 80 && E == 80) return launch<80, 80, kMaxThreads, true>(a, tiles, threads, smem, st);
  return launch<0, 0, kMaxThreads, true>(a, tiles, threads, smem, st);
}

}  // extern "C"
