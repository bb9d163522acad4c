// Tensor-core building blocks shared by the tensor-core kernels
// (bilstm_bwd_mma.cu, lstm_recurrence_bwd_mma.cu, bilstm_fwd_mma.cu,
// bilstm_wgrad_mma.cu, lstm_recurrence_wgrad_mma.cu, bilstm_bwd_f32.cu,
// bilstm_fwd_f32.cu, lstm_recurrence_bwd_f32.cu, bilstm_gates_mma.cu,
// bilstm_bwd_lite_mma.cu, bilstm_fwd_wide_mma.cu, bilstm_wgrad_f32.cu,
// bilstm_gates_f32.cu, and through the recurrence headers the wide ones):
// warp-level mma.sync m16n8k16 (bf16 operands, f32 accumulators) and
// m16n8k8 (tf32 operands, for the three-pass f32 products), ldmatrix
// fragment loads from shared memory, cp.async tile copies, the gate-row
// permutation, and the cell's transcendentals.
//
// Why mma.sync and not wgmma: a sweep step is a chain of small products
// (N = 8 rows, K <= 256) bound by latency, not by tensor-core rate; mma.sync
// needs no descriptors, no swizzled layouts and no warpgroup-wide waits, and
// its accumulator layout is what lets one thread own the four gates of a
// unit (below).
//
// The products are "swapped": the weights are the 16-row A operand and the
// row tile (8 batch rows) is the 8-column B operand, e.g.
//   gates^T (4H x 8) = [W_ih | W_hh] (4H x (E+H)) . [x ; h_prev]^T.
// In the m16n8 accumulator, lane 4*g + t holds rows g and g + 8 of the tile
// for columns 2t and 2t + 1. The gate rows are therefore permuted while the
// weights are staged: permuted row p = 32*(u/8) + 8*q + u%8 holds gate q
// (i, f, g, o) of hidden unit u. Two consecutive m16 tiles (32 permuted
// rows) then cover 8 units, and lane (g, t) of the warp that owns them holds
// all four gates of unit 8*(p/32) + g for batch rows 2t and 2t + 1: the cell
// maths needs no exchange. The same lane receives dh_prev of that unit and
// those rows from the transposed product, whose A rows 0-7 are the warp's 8
// units (rows 8-15 carry 8 columns of dx where there is a dx, see the
// kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bilstm {

constexpr int kMmaTile = 8;  // batch rows per block: the n of m16n8k16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix
// i; lane 4*g + t receives elements (g, 2t) and (g, 2t + 1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// The same, each matrix transposed: lane 4*g + t receives the stored
// elements (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) . b (16x8 bf16, "col").
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 f32) += a (16x8 tf32, row-major fragment) . b (8x8 tf32, "col").
// Fragments: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, column g), b1 (t + 4, g); the accumulator as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 value as the sum of two tf32 operands: `big`, x cut to tf32's 10
// mantissa bits, and `small` = x - big, exact in f32, of which the tensor
// core reads the top 10 mantissa bits. big.big + big.small + small.big
// then carries about 20 bits: the f32 product to ~2e-6 relative, where one
// tf32 pass keeps ~1e-3. The cut is a mask (one integer operation), not
// cvt.rna.tf32.f32, which runs on the slower conversion unit and paced the
// f32 sweep when every weight was split with it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Rounds i = 0 .. n-1 of load(frag, i) then use(frag, i), software-pipelined
// over two fragment buffers: round i + 1's ldmatrix loads are started before
// round i's mma, so a round costs its mma time and not a shared-memory
// latency as well. (The asm statements are volatile and keep program order;
// the order is made here.) With n a compile-time constant at the call, the
// loop unrolls into straight-line code.
template <typename Frag, typename Load, typename Use>
__device__ __forceinline__ void pipelined_rounds(int n, Load&& load, Use&& use) {
  Frag f0, f1;
  if (n > 0) load(f0, 0);
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    if (i + 1 < n) load(f1, i + 1);
    use(f0, i);
    if (i + 1 < n) {
      if (i + 2 < n) load(f0, i + 2);
      use(f1, i + 1);
    }
  }
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Two f32 values rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Torch gate row (gate * H + unit) of permuted row p, and back.
__host__ __device__ inline int gate_row_of_permuted(int p, int H) {
  return ((p & 31) >> 3) * H + ((p >> 5) << 3) + (p & 7);
}
__host__ __device__ inline int permuted_of_gate_row(int j, int H) {
  const int q = j / H, u = j - q * H;
  return ((u >> 3) << 5) + (q << 3) + (u & 7);
}

// The cell's transcendentals from the hardware's ex2 and reciprocal
// approximations (a few ulp: absolute error ~3e-7, far below the bf16
// rounding of the operands they are computed from, and in the f32 sweep
// more than two orders of magnitude below its 1e-4 agreement): four or five
// operations each on the serial chain, where expf and tanhf proper take
// several times as many. ex2 overflows to inf and the reciprocal of inf is
// 0, so both saturate correctly.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_sigmoid(float x) {
  return rcp_approx(1.0f + ex2_approx(-1.4426950408889634f * x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return fmaf(-2.0f, rcp_approx(1.0f + ex2_approx(2.8853900817779268f * x)), 1.0f);
}

}  // namespace bilstm
