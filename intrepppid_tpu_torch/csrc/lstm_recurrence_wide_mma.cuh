// Shared by the recurrence op's bf16 tensor-core kernels past 288 units,
// lstm_recurrence_fwd_wide_mma.cu and lstm_recurrence_bwd_wide_mma.cu: the
// unit split over a cluster, the weight copy both read, and the gate
// product both run.
//
// The split: a cluster of kWideCluster blocks per (row tile, direction).
// The H units form H / 8 groups of 8 (bilstm_mma.cuh's permutation: the 32
// gate rows of a group, permuted, are two m16 tiles in which lane (g, t)
// holds all four gates of unit 8 * group + g); block `rank` owns groups
// [rank * n / 8, (rank + 1) * n / 8) of the n = H / 8, so every H % 32 == 0
// splits, 5 or 6 groups a block at H = 352. Warp w of a block owns its local
// groups w, w + 8 (at most kMaxGroups = 2 a warp: H <= 1024) and every n8
// tile of the row tile.
//
// The weight copy (ops/lstm_cuda.py:recurrence_mma_weights lays it out from
// w (D, G, H, 4H) bf16): for each (d, g), unit group, k16 step kk of the H
// inputs and m16 half mt of the group's 32 permuted gate rows, the mma A
// fragment of every lane, 16 bytes: [D][G][H / 8][H / 16][2][32 lanes][8].
// A warp reads a fragment as one coalesced 512-byte line, from L2, straight
// into registers; nothing of the weights is staged in shared memory. The
// gate product reads the fragments of its groups for every kk; the sweep's
// dh product reads the fragments (its block's groups, kk of its own m16
// tiles of units) and transposes them in registers (movmatrix), so one copy
// (2 MB a (d, g) at H = 512) serves both products. The loads carry an L2
// evict_last policy, so the streams (xg, hs, cs, dxg) pass L2 without
// pushing the weights out.
#pragma once

#include "bilstm_common.cuh"
#include "bilstm_mma.cuh"

namespace bilstm {
namespace recwide {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;          // bf16 elements of padding on h, staging and dgates rows
constexpr int kMinH = 320;       // the first H % 32 == 0 past kWideMaxThreads
constexpr int kMaxGroups = 2;    // unit groups a warp may own (H <= kRecMaxH)
// k32 steps of gate-product weight fragments in flight in registers: a
// third spills the sweep at 32-row tiles and does not speed the forward
constexpr int kGateInFlight = 2;

// The most unit groups one block owns (ceil(H / 64)); host and device agree.
__host__ __device__ constexpr int max_block_groups(int H) { return (H + 63) / 64; }
// Unit groups a warp owns: 1 up to H = 512, else 2.
__host__ __device__ constexpr int warp_groups(int H) { return H <= 512 ? 1 : 2; }

__device__ __forceinline__ void unit_groups(int H, int rank, int& lo, int& hi) {
  const int n = H / 8;
  lo = rank * n / kWideCluster;
  hi = (rank + 1) * n / kWideCluster;
}

// The item deal of the kernels whose blocks own fewer unit groups than they
// have warps (bilstm_bwd_lite_f32.cu, bilstm_bwd_lite_mma.cu's uneven
// kernel, bilstm_fwd_wide_f32.cu): a block's UG x NT (unit group, n8 tile)
// items over its kWarps warps, each warp's items inside one group, so the
// cell needs no exchange. Group q gets kWarps / UG warps, the first
// kWarps % UG groups one more, which split its NT tiles: warp `warp` takes
// tiles [nt0, nt0 + ni) of local group ug. dh_rank is the warp's place in
// the sweeps' dh product, the warps ranked by their gate items, the fewest
// first, then by index (every warp computes every warp's count of the same
// deal).
struct ItemDeal {
  int ug, nt0, ni, dh_rank;
};
__host__ __device__ inline ItemDeal deal_items(int warp, int UG, int NT) {
  ItemDeal r{0, 0, 0, 0};
  int first = 0, wpg = 1;
  for (int q = 0; q < UG; ++q) {
    const int m = kWarps / UG + (q < kWarps % UG);
    if (warp < first + m) {
      r.ug = q;
      wpg = m;
      break;
    }
    first += m;
  }
  r.nt0 = (warp - first) * NT / wpg;
  r.ni = (warp - first + 1) * NT / wpg - r.nt0;
  int w = 0;
  for (int q = 0; q < UG; ++q) {
    const int m = kWarps / UG + (q < kWarps % UG);
    for (int k = 0; k < m; ++k, ++w) {
      const int n = (k + 1) * NT / m - k * NT / m;
      r.dh_rank += n < r.ni || (n == r.ni && w < warp);
    }
  }
  return r;
}

// The row tile: its first row, its real rows (the rest, past its weight
// group's end, are padding that never reaches an output) and its group.
struct TileRows {
  int row0, nrows, group;
};
__device__ __forceinline__ TileRows tile_rows(int tile, int BR, int Bg) {
  const int tpg = (Bg + BR - 1) / BR;
  TileRows r;
  r.group = tile / tpg;
  const int in_group = (tile % tpg) * BR;
  r.row0 = r.group * Bg + in_group;
  r.nrows = min(BR, Bg - in_group);
  return r;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
// 16 bytes of the weight copy, read-only path, kept in L2 by `pol`.
__device__ __forceinline__ uint4 ldg_weight(const uint4* ptr, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(ptr), "l"(pol));
  return v;
}

// An 8x8 b16 fragment (lane 4g + t: row g, columns 2t, 2t + 1) transposed
// across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// c (16x8 f32) += a (the four A registers in a uint4) . b.
__device__ __forceinline__ void mma_a4(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  const uint32_t r[4] = {a.x, a.y, a.z, a.w};
  mma_bf16(c, r, b0, b1);
}

// Distributed shared memory by 32-bit addresses: `mapa` gives the address
// of the same byte in block `rank`'s shared memory (a block's window is
// contiguous, so offsets carry over). Mapped once a step from a base
// (asm volatile keeps it in the loop), where generic pointers from
// map_shared_rank, loop-invariant, would be hoisted and held across the
// whole sweep at 64 bits each.
__device__ __forceinline__ uint32_t mapa_u32(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_dsmem_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_dsmem_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The gate product's weight fragments in flight: ra[slot][group j of the
// warp][2 kh + mt] of P k32 steps. gate_prefetch fills the slots with k32
// steps 0 .. P-1 (wa[j]: the lane's fragment of the group at kk = 0; a k16
// step is 64 lanes' worth further, an m16 half 32); the caller issues it
// before the work that precedes the product (the weights are the same
// every step), so their latency hides behind that work.
template <int MUG>
__device__ __forceinline__ void gate_load(uint4 (&r)[MUG][4], const uint4* (&wa)[MUG], int nug,
                                          int k2, uint64_t pol) {
#pragma unroll
  for (int j = 0; j < MUG; ++j) {
    if (j >= nug) continue;
    const uint4* p = wa[j] + (size_t)k2 * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q) r[j][q] = ldg_weight(p + q * 32, pol);
  }
}
template <int MUG, int P>
__device__ __forceinline__ void gate_prefetch(uint4 (&ra)[P][MUG][4], const uint4* (&wa)[MUG],
                                              int nug, int K2, uint64_t pol) {
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < K2) gate_load<MUG>(ra[i], wa, nug, i, pol);
}

// acc[j][nt][mt] += W(group j of the warp, m16 half mt) . h^T(n8 tile nt)
// over K = H (K2 = H / 32 k32 steps): A from the weight copy through the
// slots (gate_prefetch filled them; each is refilled P steps ahead after its
// mma), B from the bf16 h tile in shared memory (b_addr: the lane's ldmatrix
// row 8 nt + (lane & 7), column 8 (lane >> 3) of n8 tile 0; rows KS elements
// apart). `nug` (warp-uniform) groups of the warp are present.
template <int MUG, int NT, int P>
__device__ __forceinline__ void gate_mma(float (&acc)[MUG][NT][2][4], uint4 (&ra)[P][MUG][4],
                                         const uint4* (&wa)[MUG], int nug, uint32_t b_addr,
                                         int KS, int K2, uint64_t pol) {
#pragma unroll 1
  for (int k0 = 0; k0 < K2; k0 += P) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k2 = k0 + i;
      if (k2 >= K2) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr + (uint32_t)((8 * nt * KS + 32 * k2) * 2));
#pragma unroll
        for (int j = 0; j < MUG; ++j) {
          if (j >= nug) continue;
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_a4(acc[j][nt][mt], ra[i][j][2 * kh + mt], b[2 * kh], b[2 * kh + 1]);
        }
      }
      if (k2 + P < K2) gate_load<MUG>(ra[i], wa, nug, k2 + P, pol);
    }
  }
}

}  // namespace recwide
}  // namespace bilstm
