// Building blocks of the mma.sync gated flash attention forward
// (`gated_flash_fwd` in gated_flash_fwd.cu, S_q <= 64): tile staging and the warp-level
// bf16 products, on the cp.async and mma.sync m16n8k16 primitives of
// mma_common.cuh.
//
// Tiles are 64 rows of one (batch, head) slab of a (B, S, H, 64) tensor, kept
// in shared memory with rows padded to kSRow elements (144 bytes), which makes
// the fragment reads below free of bank conflicts. A warp owns 16 rows of the
// 64-row tile it multiplies; its results live in the accumulator layout of
// mma.m16n8k16: for n-tile nt (8 columns), elements e = 0, 1 sit at row gr and
// e = 2, 3 at row gr + 8, columns nt·8 + 2·tg + (e & 1), with gr = lane / 4 and
// tg = lane % 4.
#pragma once

#include "mma_common.cuh"

namespace gfa {

using namespace hopper;

constexpr int kD = 64;          // head dim
constexpr int kBlock = 64;      // rows per tile, queries and kv alike
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSRow = kD + 8;   // padded shared row
constexpr int kTileElems = kBlock * kSRow;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Stage rows [row0, row0 + 64) of one (batch, head) slab into shared memory;
// rows at or past n_rows are zero-filled and their source is never read.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_rows, long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlock * kD / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int ch = (c & 7) * 8;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* g = in ? src + (long)(row0 + r) * row_stride + ch : src;
    cp_async_16(dst + r * kSRow + ch, g, in);
  }
}

// A fragments of rows [row0, row0 + 16) × all 64 columns of a shared tile, for
// the four 16-wide k-blocks of a product that contracts over the head dim.
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const __nv_bfloat16* tile,
                                             int row0, int gr, int tg) {
  const __nv_bfloat16* p = tile + (row0 + gr) * kSRow + 2 * tg;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = ld_u32(p + kk * 16);
    f[kk][1] = ld_u32(p + 8 * kSRow + kk * 16);
    f[kk][2] = ld_u32(p + kk * 16 + 8);
    f[kk][3] = ld_u32(p + 8 * kSRow + kk * 16 + 8);
  }
}

// c = A · Bᵀ for the warp's 16 rows × 64 columns: A from `a` (16 × 64 over the
// head dim), B the shared tile read row by row (each of its 64 rows is one
// output column). The pattern of S = Q·Kᵀ.
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4],
                                        const __nv_bfloat16* b_tile, int gr, int tg) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
    const __nv_bfloat16* b0 = b_tile + (nt * 8 + gr) * kSRow + 2 * tg;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t bf[2] = {ld_u32(b0 + kk * 16), ld_u32(b0 + kk * 16 + 8)};
      mma_16816(c[nt], a[kk], bf);
    }
  }
}

// c += A · B for the warp's 16 rows × 64 head-dim columns: A is a 16 × 64 block
// in the accumulator layout (e.g. probabilities over 64 kv columns), rounded
// to bf16 here; B the shared tile whose 64 rows are the contraction index.
// The pattern of O += P·V. An accumulator's n-tiles (2kk, 2kk+1) are exactly
// the A fragment of k-block kk, so A never touches shared memory.
__device__ __forceinline__ void mma_ab(float c[8][4], const float a[8][4],
                                       const __nv_bfloat16* b_tile, int gr, int tg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_f32(a[2 * kk][0], a[2 * kk][1]),
                            pack_f32(a[2 * kk][2], a[2 * kk][3]),
                            pack_f32(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                            pack_f32(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const __nv_bfloat16* b0 = b_tile + (kk * 16 + 2 * tg) * kSRow + gr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* bp = b0 + nt * 8;
      const uint32_t bf[2] = {pack_bf16(bp[0], bp[kSRow]), pack_bf16(bp[8 * kSRow], bp[9 * kSRow])};
      mma_16816(c[nt], pa, bf);
    }
  }
}

// Store the warp's accumulator block times `mul` as bf16 rows of a (B, S, H, 64)
// slab; rows at or past n_rows are skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float c[8][4], float mul,
                                           int row, int n_rows, long row_stride, int tg) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (row < n_rows) {
      *reinterpret_cast<uint32_t*>(dst + (long)row * row_stride + col) =
          pack_f32(c[nt][0] * mul, c[nt][1] * mul);
    }
    if (row + 8 < n_rows) {
      *reinterpret_cast<uint32_t*>(dst + (long)(row + 8) * row_stride + col) =
          pack_f32(c[nt][2] * mul, c[nt][3] * mul);
    }
  }
}

}  // namespace gfa
