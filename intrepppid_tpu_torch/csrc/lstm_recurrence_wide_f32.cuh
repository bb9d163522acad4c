// Shared by the f32 tensor-core kernels that read the weights as one f32
// copy in mma fragment order from L2 (ops/lstm_cuda.py:recurrence_f32_weights):
// the recurrence op's sweep and forward past 288 units
// (lstm_recurrence_bwd_wide_f32.cu, lstm_recurrence_fwd_wide_f32.cu) and the
// layer's f32 lite sweep and wide forward (bilstm_bwd_lite_f32.cu,
// bilstm_fwd_wide_f32.cu). Each product runs in three tf32 passes,
// big.big + big.small + small.big, with both operands split in registers
// (split_tf32, bilstm_mma.cuh): one tf32 pass keeps ~3 decimal
// digits, which misses the f32 agreement (1e-4 x max(1, max|ref|)) by 3-4 x.
//
// The copy: for each (d, g), unit group of 8, k8 step kk of the H inputs
// and m16 half mt of the group's 32 permuted gate rows (bilstm_mma.cuh), the
// tf32 A fragment of every lane, 16 bytes: [D][G][H / 8][H / 8][2][32][4].
// The K order within each k16 chunk c is permuted so that lane (g, t) holds
// inputs 16 c + 4 t .. 16 c + 4 t + 3 (k8 step 2c: 4t, 4t + 1; step 2c + 1:
// 4t + 2, 4t + 3): the gate product's B (an f32 h tile) is one 16-byte
// shared load a chunk and n8 tile, and each 8x8 block of a fragment holds a
// row's two inputs 2t', 2t' + 1 in one lane, which is the layout movmatrix
// transposes, so the same copy serves the dh product (units as rows, gate
// columns as K). 4 MB a (d, g) at H = 512: 40 MB for the train step's 10,
// under the card's 50 MB L2, where a copy pre-split into big and small
// would be 80 MB, past it.
#pragma once

#include "lstm_recurrence_wide_mma.cuh"

namespace bilstm {
namespace recwide {

constexpr int kFPad = 16;       // f32 elements of padding on h and dgates tile rows (16 mod 32)
constexpr int kGateChunks = 2;  // k16 chunks of gate-product fragments in flight in registers

// An f32 fragment (four values as bits) split into its big and small tf32 parts.
__device__ __forceinline__ void split4(const uint4& r, uint32_t (&big)[4], uint32_t (&small)[4]) {
  split_tf32(__uint_as_float(r.x), big[0], small[0]);
  split_tf32(__uint_as_float(r.y), big[1], small[1]);
  split_tf32(__uint_as_float(r.z), big[2], small[2]);
  split_tf32(__uint_as_float(r.w), big[3], small[3]);
}

// c += a . b in three tf32 passes: small.big, big.small, big.big.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t b0, uint32_t b1,
                                     uint32_t s0, uint32_t s1) {
  mma_tf32(c, as, b0, b1);
  mma_tf32(c, ab, s0, s1);
  mma_tf32(c, ab, b0, b1);
}

// The four fragments of k16 chunk c of one unit group (wa: the lane's
// fragment of the group at kk = 0): r[kh][mt] is k8 step 2c + kh, m16 half
// mt (a k8 step is 64 lanes' worth further, an m16 half 32).
__device__ __forceinline__ void chunk_load(uint4 (&r)[2][2], const uint4* wa, int c, uint64_t pol) {
  const uint4* p = wa + (size_t)c * 128;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) r[kh][mt] = ldg_weight(p + kh * 64 + mt * 32, pol);
}

// The B operands of k16 chunk c of one n8 tile, split: the lane's four f32
// inputs 16 c + 4 t .. of row g (h_lane: row g, chunk 0).
__device__ __forceinline__ void chunk_b(uint32_t (&bb)[4], uint32_t (&bs)[4], const float* h_lane,
                                       int c) {
  const float4 v = *reinterpret_cast<const float4*>(h_lane + 16 * c);
  split_tf32(v.x, bb[0], bs[0]);
  split_tf32(v.y, bb[1], bs[1]);
  split_tf32(v.z, bb[2], bs[2]);
  split_tf32(v.w, bb[3], bs[3]);
}

// acc[nt][mt] += W(one unit group, m16 half mt) . h^T(n8 tile nt) for one
// k16 chunk: the chunk's fragments r (chunk_load) split, B from bb / bs
// (chunk_b of each n8 tile).
template <int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[NT][2][4], const uint4 (&r)[2][2],
                                          const uint32_t (&bb)[NT][4],
                                          const uint32_t (&bs)[NT][4]) {
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t ab[4], as[4];
      split4(r[kh][mt], ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3(acc[nt][mt], ab, as, bb[nt][2 * kh], bb[nt][2 * kh + 1], bs[nt][2 * kh],
             bs[nt][2 * kh + 1]);
    }
}

// acc[j][nt][mt] += W(group j of the warp, m16 half mt) . h^T(n8 tile nt)
// over K = H (K16 k16 chunks), three tf32 passes: A from the weight copy
// through the P slots of ra (filled with chunks 0 .. P-1 by the caller;
// each refilled P chunks ahead after its use), B from an f32 h tile
// (h_lane: the lane's row g, inputs 4t .. 4t + 3 of chunk 0; rows KS apart).
// The warp owns `nug` (warp-uniform) of its MUG groups, every n8 tile.
template <int MUG, int NT, int P>
__device__ __forceinline__ void gate_mma_f32(float (&acc)[MUG][NT][2][4],
                                             uint4 (&ra)[P][MUG][2][2], const uint4* (&wa)[MUG],
                                             int nug, const float* h_lane, int KS, int K16,
                                             uint64_t pol) {
#pragma unroll 1
  for (int c0 = 0; c0 < K16; c0 += P) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = c0 + i;
      if (c >= K16) continue;
      uint32_t bb[NT][4], bs[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) chunk_b(bb[nt], bs[nt], h_lane + 8 * nt * KS, c);
#pragma unroll
      for (int j = 0; j < MUG; ++j) {
        if (j >= nug) continue;
        chunk_mma<NT>(acc[j], ra[i][j], bb, bs);
        if (c + P < K16) chunk_load(ra[i][j], wa[j], c + P, pol);
      }
    }
  }
}
// Fill the P slots with chunks 0 .. P-1 of the warp's groups.
template <int MUG, int P>
__device__ __forceinline__ void gate_prefetch_f32(uint4 (&ra)[P][MUG][2][2],
                                                  const uint4* (&wa)[MUG], int nug, int K16,
                                                  uint64_t pol) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < MUG; ++j)
      if (i < K16 && j < nug) chunk_load(ra[i][j], wa[j], i, pol);
}

// The dh product's A fragment from one m16 half of a gate-product fragment
// pair (k0, k1: k8 steps 2m and 2m + 1 of a group, the inputs of m16 tile m
// of the units) transposed 8x8 block by 8x8 block in registers (an f32
// block as its two b16 halves through movmatrix), split: the block of gate
// rows 16 mt + 8 hi ... Row g of the result is unit 16 m + 4 (g >> 1) +
// (g & 1), row g + 8 the unit two further; K slot t (t + 4) is gate column
// 16 mt + 8 hi + 2t (+ 1) of the group.
__device__ __forceinline__ void dh_fragment(const uint4& k0, const uint4& k1, int hi,
                                            uint32_t (&ab)[4], uint32_t (&as)[4]) {
  uint32_t at[4];
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    // this lane holds row g, columns 2t and 2t + 1 of the block
    const uint4& r = kh ? k1 : k0;
    const uint32_t x0 = hi ? r.y : r.x;
    const uint32_t x1 = hi ? r.w : r.z;
    const uint32_t tl = movmatrix_trans(__byte_perm(x0, x1, 0x5410));
    const uint32_t th = movmatrix_trans(__byte_perm(x0, x1, 0x7632));
    at[kh] = __byte_perm(tl, th, 0x5410);
    at[kh + 2] = __byte_perm(tl, th, 0x7632);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(at[q]), ab[q], as[q]);
}

// Row stride (f32) of a partial dh buffer: at least BR and 8 mod 16.
__host__ __device__ constexpr int part_stride_f32(int BR) {
  return BR + ((8 - BR) % 16 + 16) % 16;
}

}  // namespace recwide
}  // namespace bilstm
