// Head-gated flash attention backward for Hopper (sm_90a): a one-pass kernel
// where the kv side fits one tile, two kernels (dq, then dk/dv) where it
// spans several, and the fixed-order reduction of a split one pass.
//
// Forward (gated_flash_fwd.cu), with g = gate[b, h] and q' = g·q, k' = g·k,
// v' = g·v:  O = softmax(q'·k'ᵀ·d^-½)·v' = g · softmax(q·kᵀ·d^-½·g²)·v.
// With P the probabilities, recomputed from the forward's natural-log lse,
// and δ = rowsum(dO ∘ O):
//
//   dP = dO·v'ᵀ = g·dO·vᵀ,  dS = P ∘ (dP − δ),
//   dq' = dS·k'·d^-½,  dk' = dSᵀ·q'·d^-½,  dv' = Pᵀ·dO,
//   dq = g·dq',  dk = g·dk',  dv = g·dv',
//   dgate = Σ dq'∘q + Σ dk'∘k + Σ dv'∘v   (per (b, h), over rows and head dim).
//
// Replaces the JAX package's Pallas backward bodies in
// diffusion_pruning_tpu/ops/flash_attention.py: `_flash_bwd_dq_kernel` (:586),
// its head-pair-packed twin `_flash_bwd_dq_kernel2` (:686),
// `_flash_bwd_dkv_kernel` (:638) and `_flash_bwd_dkv_kernel2` (:741), launched
// by `_flash_backward` (:899), `_flash_backward_packed2` (:798) and `_fa_bwd`
// (:1055). The packing only fit the TPU's 128-lane tiles. The TPU kernels
// accumulate dgate across their sequential grid in a revisited block; blocks
// of a CUDA grid run in no order, so each consumer warp writes its own
// partial of dgate and the wrapper sums the partials in a fixed order.
//
// What bounds the function on an H100 (5 products of 2·S_q·S_kv·64
// operations; q, k, v, o, dO and lse read once, dq, dk, dv written once):
// at S_q = S_kv = 1024 the operations (0.217 ms over the 5 sites of a
// student pass at B = 64); at every other site of the 256px U-Net the bytes:
// cross-attention (S_kv = 77), 256², and the 64- and 16-token blocks. 22 of
// the 32 sites have S_kv <= 80, where the whole kv side of a (b, h) is one
// tile and the bytes of the query side (q, dO, o, dq: 512 bytes a row)
// dominate, so reading each of them once is what counts.
//
// The plan (route, tiles, grid, partials) is chosen in Python by
// `backward_plan` in ops/flash_attention.py; the wrappers allocate every
// output and scratch buffer.
//
// gated_flash_bwd_fused — one pass, S_kv <= 80:
//  * persistent blocks walk work items (b·h, slice of the q range); a block
//    is a producer warpgroup (setmaxnreg 24) whose one thread issues every
//    TMA load, and two consumer warpgroups (240) of 64 query rows each. K and
//    V (one 80-row box each, zero-filled past S_kv inside the batch element)
//    are double-buffered across items; Q, dO and O of each 128-row query
//    tile come through a two-stage ring;
//  * per tile: δ from O and dO in shared memory; S = Q Kᵀ and dP = dO Vᵀ
//    (SS-wgmma m64n80); P and dS in registers; dS·K (RS-wgmma, K read
//    MN-major) gives dq, stored straight to HBM with its dgate term; P and dS
//    are rounded to bf16 and stored transposed (stmatrix .trans) into
//    swizzled shared tiles, and after one barrier between the consumers
//    warpgroup 0 accumulates dvᵀ += dOᵀ·P and warpgroup 1 dkᵀ += Qᵀ·dS over
//    the tile's query rows (SS-wgmma m64n80, A MN-major straight from the dO
//    or Q tile, only the 16-row steps that hold a row: at S_q <= 64 the
//    second warpgroup computes no S, dP or dq): 5 products, every operand
//    read once;
//  * at an item's end dk and dv are written, or, where the plan splits the
//    q range (so that the last of the 132 SMs' rounds is at least half
//    full), f32 partials that gated_flash_bwd_reduce adds in slice order;
//  * at S_q <= 64 (the 64- and 16-token blocks) an item is one 64-row query
//    tile, and a second kernel instance lets each consumer warpgroup take
//    whole items of its own, all five products included, so that the two
//    never wait for each other and two items are in flight per SM.
//
// gated_flash_bwd_dq, then gated_flash_bwd_dkv — S_kv > 80 (7 products):
//  * dq: persistent blocks walk the work tiles (b·h, 128-row query tile):
//    producer warpgroup, two consumer warpgroups; Q, dO and O by TMA,
//    double-buffered across work tiles, K and V through a three-stage ring
//    of 128-row tiles. δ is computed in the prologue and written, with
//    lse·log2 e, to a row-stats buffer padded to 64 rows (pad: lse = +inf,
//    δ = 0). Per kv tile S = Q Kᵀ and dP = dO Vᵀ are SS-wgmma m64n128,
//    dq += dS·K RS-wgmma; tile j's S and dP are issued beside tile j − 1's
//    dS·K, and dS is packed into A registers only with no product in flight
//    (else ptxas serialises every wgmma: note C7513);
//  * dk/dv: persistent blocks walk the work tiles (b·h, 128-row kv tile),
//    two consumer warpgroups of 64 kv rows; K and V double-buffered across
//    work tiles, Q, dO (64-row tiles) and the row stats (one bulk copy
//    each) through a four-stage ring. It works in the transposed layout:
//    Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are SS-wgmma m64n64, Pᵀ and dSᵀ come out in
//    registers with kv rows, exactly the A operand of dv += Pᵀ·dO and
//    dk += dSᵀ·Q (RS-wgmma, dO and Q read MN-major), issued beside the next
//    tile's Sᵀ and dPᵀ. (128-row query tiles ran 3-7 % faster on an H100,
//    PERF.md §6, but need 128 registers for Sᵀ and dPᵀ alone and spilled.)
//
// Everywhere: P and dS are rounded to bf16 just before their products (the
// JAX `_prob_in`); kv columns past S_kv and query rows past S_q get P = 0
// before anything reads P (their rows are zero-filled by TMA, lse = +inf
// for rows past S_q), rows past the end are never stored, so a 77-row kv
// side in an 80-row box adds nothing to any output or dgate partial; a
// closed gate (g = 0) runs the full computation: dq = dk = dv = 0 exactly,
// and Σ dv'∘v with uniform P is the dgate that trains the router through
// the straight-through estimator.
//
// Given up: FlashAttention-3's single pass at multi-tile kv, which adds each
// kv tile's dq into HBM with f32 atomics or TMA reduce-add: the order of the
// additions changes from run to run, and the port's backward repeats bit for
// bit (checked by chip_smoke.py). Also: ping-pong of the two consumer
// warpgroups, and TMA stores of the outputs.

#include <math.h>

#include "sm90_common.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;                  // head dim
constexpr int kRow = kD * 2;            // bytes of one bf16 row
constexpr int kBox = 64 * kRow;         // one 64-row box
constexpr int kQTile = 2 * kBox;        // 128 query rows
constexpr int kThreads = 3 * 128;       // a producer warpgroup, two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte address of element (row, col) of a 128-byte-swizzled tile of 64-wide rows
__device__ __forceinline__ uint32_t sw_addr(uint32_t tile, int row, int col) {
  return tile + row * kRow + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float2 lds_bf16x2(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float lds_bf16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds_128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// δ = rowsum(dO ∘ O) of tile rows `row0` and row0 + 8 (the accumulator rows
// of this thread), from the swizzled O and dO tiles: the four threads of a
// quad take 16 of the 64 columns each
__device__ __forceinline__ void row_delta(uint32_t o_tile, uint32_t do_tile, int row0, int tg,
                                          float (&delta)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t off = row * kRow + ((((2 * tg + c) ^ row) & 7) << 4);
      const uint4 a = lds_128(o_tile + off);
      const uint4 b = lds_128(do_tile + off);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(a2[j]);
        const float2 y = __bfloat1622float2(b2[j]);
        acc += x.x * y.x + x.y * y.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[hh] = acc;
  }
}

// Σ over this thread's m64n64 accumulators of acc ∘ T, T the swizzled tile
// at the same (row, column) positions (tile rows row0 and row0 + 8)
__device__ __forceinline__ float dot_tile(const float (&acc)[32], uint32_t tile, int row0,
                                          int tg) {
  float s = 0.0f;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 t = lds_bf16x2(sw_addr(tile, row0 + 8 * hh, 8 * nb + 2 * tg));
      s += acc[4 * nb + 2 * hh] * t.x + acc[4 * nb + 2 * hh + 1] * t.y;
    }
  }
  return s;
}

// the accumulators × mul as bf16 to rows row and row + 8 of a (B, S, H, 64)
// slab (`dst` at its row 0, rows `stride` elements apart); rows >= n_rows skipped
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[32], float mul,
                                           int row, int n_rows, long stride, int tg) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= n_rows) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dst + (long)r * stride + nb * 8 + 2 * tg) =
          pack_f32(acc[4 * nb + 2 * hh] * mul, acc[4 * nb + 2 * hh + 1] * mul);
    }
  }
}

// A fragments of an m64 × (8·N4) block in the accumulator layout: the
// accumulator's column blocks 2kk and 2kk + 1 are the A fragment of step kk
template <int KK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4], const float (&x)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack_f32(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_f32(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_f32(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_f32(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// This warpgroup's m64 × N block (accumulator layout, 64 query rows) rounded
// to bf16 and stored transposed into a swizzled tile of N rows (kv) × 64
// (the warpgroup's query rows): a K-major B operand over the query rows
template <int N>
__device__ __forceinline__ void store_transposed(uint32_t tile, const float (&x)[N / 2], int warp,
                                                 int lane) {
  const int mi = lane >> 3, c = lane & 7;
  const int chunk = 2 * warp + (mi & 1);  // 8 query rows: 16·warp + 8·(mi & 1) …
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    const int row = 8 * (j + (mi >> 1)) + c;
    sm90::stmatrix_x4_trans(tile + row * kRow + (((chunk ^ row) & 7) << 4),
                            pack_f32(x[4 * j + 0], x[4 * j + 1]), pack_f32(x[4 * j + 2], x[4 * j + 3]),
                            pack_f32(x[4 * j + 4], x[4 * j + 5]), pack_f32(x[4 * j + 6], x[4 * j + 7]));
  }
}

// Sum of one float per thread over the warp, in a fixed order; valid in lane 0
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- one pass (S_kv <= 80)

constexpr int kKV1 = 80;                    // the one kv tile: S_kv <= 80
constexpr int kKV1Bytes = kKV1 * kRow;      // one K or V box, one Pᵀ or dSᵀ half
constexpr int kStage1 = 3 * kQTile;         // Q, dO, O of one query tile
// K ×2 | V ×2 | ring of 2 stages | Pᵀ and dSᵀ, two halves each, ×2 | barriers
constexpr int kSmem1 = 1024 + 4 * kKV1Bytes + 2 * kStage1 + 8 * kKV1Bytes + 64;

// Persistent: each block walks the work items (b·h, slice `ch` of the
// `chunks` slices of the query tiles) blockIdx.x, blockIdx.x + gridDim.x, …
__global__ void __launch_bounds__(kThreads, 1)
    gated_flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const __grid_constant__ CUtensorMap domap,
                                 const float* __restrict__ lse, const float* __restrict__ gate,
                                 __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, float* __restrict__ ws,
                                 float* __restrict__ dgate_part, int B, int H, int Sq, int Skv,
                                 int chunks, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  auto k_s = [&](int kb) { return base + kb * kKV1Bytes; };
  auto v_s = [&](int kb) { return base + (2 + kb) * kKV1Bytes; };
  auto stage = [&](int st) { return base + 4 * kKV1Bytes + st * kStage1; };
  // Pᵀ (which = 0) or dSᵀ (1) of buffer pb: two 64-query-row halves, adjacent
  auto pds = [&](int pb, int which) {
    return base + 4 * kKV1Bytes + 2 * kStage1 + (4 * pb + 2 * which) * kKV1Bytes;
  };
  const uint32_t bars = base + 12 * kKV1Bytes + 2 * kStage1;
  auto kv_full = [&](int s) { return bars + 8 * s; };
  auto kv_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto q_full = [&](int s) { return bars + 8 * (4 + s); };
  auto q_empty = [&](int s) { return bars + 8 * (6 + s); };

  const int q_tiles = (Sq + 127) / 128;
  const int n_work = B * H * chunks;
  const long stride = (long)H * kD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(kv_full(s), 1);
      sm90::mbar_init(kv_empty(s), 8);  // one arrival per consumer warp
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int c = 0;  // query tiles loaded so far by this block
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int bh = w / chunks, ch = w - bh * chunks;
        const int b = bh / H, h = bh - b * H;
        const int t0 = ch * q_tiles / chunks, t1 = (ch + 1) * q_tiles / chunks;
        const int kb = i & 1;
        sm90::mbar_wait(kv_empty(kb), ((i >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(kv_full(kb), 2 * kKV1Bytes);
        sm90::tma_load_4d(k_s(kb), &kmap, kv_full(kb), 0, h, 0, b);
        sm90::tma_load_4d(v_s(kb), &vmap, kv_full(kb), 0, h, 0, b);
        for (int t = t0; t < t1; ++t, ++c) {
          const int st = c & 1;
          sm90::mbar_wait(q_empty(st), ((c >> 1) & 1) ^ 1);
          sm90::mbar_expect_tx(q_full(st), kStage1);
          const uint32_t s0 = stage(st);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r0 = t * 128 + 64 * half;
            sm90::tma_load_4d(s0 + half * kBox, &qmap, q_full(st), 0, h, r0, b);
            sm90::tma_load_4d(s0 + kQTile + half * kBox, &domap, q_full(st), 0, h, r0, b);
            sm90::tma_load_4d(s0 + 2 * kQTile + half * kBox, &omap, q_full(st), 0, h, r0, b);
          }
        }
      }
    }
    return;
  }
  sm90::regs_alloc<240>();

  const int tid = threadIdx.x - 128;  // consumer thread 0 … 255
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int rloc = wg * 64 + warp * 16 + gr;  // this thread's first row in a query tile

  float s[kKV1 / 2], dp[kKV1 / 2];  // S, then P; dP, then dS (64 query rows × 80 kv)
  float acc_q[32];                  // dq' / (d^-½·g) of the tile
  float acc_kv[kKV1 / 2];           // wg 0: dvᵀ, wg 1: dkᵀ / (d^-½·g) (64 dims × 80 kv)
  uint32_t pa[kKV1 / 16][4];        // dS as the A operand of dS·K

  int c = 0;  // query tiles consumed so far by this block
  for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
    const int bh = w / chunks, ch = w - bh * chunks;
    const int b = bh / H, h = bh - b * H;
    const int t0 = ch * q_tiles / chunks, t1 = (ch + 1) * q_tiles / chunks;
    const int kb = i & 1;
    const float g = gate != nullptr ? gate[bh] : 1.0f;
    const float sl2 = scale * kLog2e * g * g;  // logits in the log2 domain
    const float cg = scale * g;                // dq' = cg · dS K, dk' = cg · dSᵀ Q
#pragma unroll
    for (int e = 0; e < kKV1 / 2; ++e) acc_kv[e] = 0.0f;
    float part = 0.0f;
    sm90::mbar_wait(kv_full(kb), (i >> 1) & 1);
    const uint32_t ks = k_s(kb), vs = v_s(kb);
    const uint64_t desc_k = sm90::desc_sw128(ks, 16, 1024);
    const uint64_t desc_v = sm90::desc_sw128(vs, 16, 1024);

    for (int t = t0; t < t1; ++t, ++c) {
      const int st = c & 1, pb = c & 1;
      const int m0 = t * 128;
      const int rows = min(128, Sq - m0);   // query rows of the tile
      const bool active = wg * 64 < rows;   // this warpgroup has rows in it
      const uint32_t qs = stage(st), dos = qs + kQTile, os = qs + 2 * kQTile;
      float lse2[2], delta[2];
      if (active) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + rloc + 8 * hh;
          lse2[hh] = row < Sq ? lse[(long)bh * Sq + row] * kLog2e : INFINITY;
        }
      }
      sm90::mbar_wait(q_full(st), (c >> 1) & 1);
      if (active) {
        row_delta(os, dos, rloc, tg, delta);
        // S = Q Kᵀ and dP = dO Vᵀ: four 16-deep steps over the head dim each
        const uint64_t desc_q = sm90::desc_sw128(qs + wg * kBox, 16, 1024);
        const uint64_t desc_do = sm90::desc_sw128(dos + wg * kBox, 16, 1024);
        sm90::fence_regs<kKV1 / 2>(s);
        sm90::fence_regs<kKV1 / 2>(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::WgmmaSS<kKV1>::mma(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::WgmmaSS<kKV1>::mma(dp, desc_do + 2 * kk, desc_v + 2 * kk, kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs<kKV1 / 2>(s);
        sm90::fence_regs<kKV1 / 2>(dp);
        // P = exp2(S·d^-½·g²·log2 e − lse₂), 0 past S_kv and past S_q (lse =
        // +inf); dS = P ∘ (g·dP − δ)
#pragma unroll
        for (int e = 0; e < kKV1 / 2; ++e) {
          const int col = 8 * (e >> 2) + 2 * tg + (e & 1);
          const int hh = (e >> 1) & 1;
          float p = fast_exp2(fmaf(s[e], sl2, -lse2[hh]));
          if (col >= Skv) p = 0.0f;
          s[e] = p;
          dp[e] = p * (dp[e] * g - delta[hh]);
        }
        store_transposed<kKV1>(pds(pb, 0) + wg * kKV1Bytes, s, warp, lane);
        store_transposed<kKV1>(pds(pb, 1) + wg * kKV1Bytes, dp, warp, lane);
        pack_a<kKV1 / 16>(pa, dp);
        sm90::fence_proxy_async();  // the stores above are read by wgmma

        // dq' / cg = dS K over the 80 kv rows, K read MN-major
        sm90::fence_regs<32>(acc_q);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKV1 / 16; ++kk)
          sm90::WgmmaRS<64, 1>::mma(acc_q, pa[kk], desc_k + 128 * kk, kk > 0);
        sm90::wgmma_commit();
      }

      // both halves of Pᵀ and dSᵀ in place: wg 0 dvᵀ += dOᵀ P, wg 1
      // dkᵀ / cg += Qᵀ dS, over the 16-row steps of the tile that hold a
      // query row (a half no warpgroup wrote is past S_q, never read)
      sm90::named_barrier(1, 256);
      const int ksteps = (rows + 15) >> 4;
      {
        const uint64_t desc_a = sm90::desc_sw128(wg == 0 ? dos : qs, 16, 1024);
        const uint32_t bt = pds(pb, wg);
        const uint64_t desc_b0 = sm90::desc_sw128(bt, 16, 1024);
        const uint64_t desc_b1 = sm90::desc_sw128(bt + kKV1Bytes, 16, 1024);
        sm90::fence_regs<kKV1 / 2>(acc_kv);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < ksteps)
            sm90::WgmmaSS<kKV1, 1>::mma(acc_kv, desc_a + 128 * kk,
                                        kk < 4 ? desc_b0 + 2 * kk : desc_b1 + 2 * (kk - 4), 1);
        }
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(acc_q);
      sm90::fence_regs<kKV1 / 2>(acc_kv);
      sm90::fence_regs<kKV1 / 4>(&pa[0][0]);

      if (active) {  // dq = g·dq' to its rows, and Σ dq'∘q
        part += cg * dot_tile(acc_q, qs, rloc, tg);
        store_rows(dq + ((long)b * Sq * H + h) * kD, acc_q, cg * g, m0 + rloc, Sq, stride, tg);
      }
      if (lane == 0) sm90::mbar_arrive(q_empty(st));
    }

    // the item's dv' = acc (wg 0) or dk' = cg·acc (wg 1), transposed: row =
    // head dim, column = kv row; Σ dv'∘v or Σ dk'∘k
    {
      const uint32_t kvs = wg == 0 ? vs : ks;
      float kvpart = 0.0f;
#pragma unroll
      for (int e = 0; e < kKV1 / 2; ++e) {
        const int d = warp * 16 + gr + 8 * ((e >> 1) & 1);
        const int kv = 8 * (e >> 2) + 2 * tg + (e & 1);
        kvpart += acc_kv[e] * lds_bf16(sw_addr(kvs, kv, d));
      }
      part += (wg == 0 ? 1.0f : cg) * kvpart;
    }
    if (lane == 0) sm90::mbar_arrive(kv_empty(kb));
    const float mul = wg == 0 ? g : cg * g;
    const long row0 = (long)b * Skv * H + h;  // (b, kv 0, h) in rows of 64
    if (chunks == 1) {
      __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
      for (int e = 0; e < kKV1 / 2; ++e) {
        const int d = warp * 16 + gr + 8 * ((e >> 1) & 1);
        const int kv = 8 * (e >> 2) + 2 * tg + (e & 1);
        if (kv < Skv) out[(row0 + (long)kv * H) * kD + d] = __float2bfloat16(acc_kv[e] * mul);
      }
    } else {  // ws (chunks, 2: dk, dv, B, S_kv, H, 64) f32
      float* out = ws + ((long)(2 * ch + (wg == 0 ? 1 : 0)) * B * Skv * H) * kD;
#pragma unroll
      for (int e = 0; e < kKV1 / 2; ++e) {
        const int d = warp * 16 + gr + 8 * ((e >> 1) & 1);
        const int kv = 8 * (e >> 2) + 2 * tg + (e & 1);
        if (kv < Skv) out[(row0 + (long)kv * H) * kD + d] = acc_kv[e] * mul;
      }
    }
    const float total = warp_sum(part);
    if (dgate_part != nullptr && lane == 0)
      dgate_part[(long)bh * 8 * chunks + 8 * ch + 4 * wg + warp] = total;
  }
}

// One pass at S_q <= 64: a work item is one b·h and one 64-row query tile,
// so each consumer warpgroup takes whole items of its own (the block's items
// 0, 2, 4, … and 1, 3, 5, …) and does all five products itself, dvᵀ and dkᵀ
// included; the two warpgroups never wait for each other. K, V, Q, dO and O
// of an item arrive together in one of four sets (two per warpgroup).
constexpr int kSetSmall = 2 * kKV1Bytes + 3 * kBox;  // K, V, Q, dO, O of one item
// four item sets | Pᵀ and dSᵀ per warpgroup | barriers
constexpr int kSmemSmall = 1024 + 4 * kSetSmall + 4 * kKV1Bytes + 64;

__global__ void __launch_bounds__(kThreads, 1)
    gated_flash_bwd_fused_small_kernel(const __grid_constant__ CUtensorMap qmap,
                                       const __grid_constant__ CUtensorMap kmap,
                                       const __grid_constant__ CUtensorMap vmap,
                                       const __grid_constant__ CUtensorMap omap,
                                       const __grid_constant__ CUtensorMap domap,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ gate,
                                       __nv_bfloat16* __restrict__ dq,
                                       __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv,
                                       float* __restrict__ dgate_part, int B, int H, int Sq,
                                       int Skv, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  auto set = [&](int s) { return base + s * kSetSmall; };  // K | V | Q | dO | O
  auto pds = [&](int wg, int which) {                       // Pᵀ (0) or dSᵀ (1)
    return base + 4 * kSetSmall + (2 * wg + which) * kKV1Bytes;
  };
  const uint32_t bars = base + 4 * kSetSmall + 4 * kKV1Bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (4 + s); };
  const int n_work = B * H;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 4; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 4);  // one arrival per warp of the warpgroup that owns it
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int b = w / H, h = w - b * H;
        const int st = i & 3;
        const uint32_t s0 = set(st);
        sm90::mbar_wait(empty(st), ((i >> 2) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), kSetSmall);
        sm90::tma_load_4d(s0, &kmap, full(st), 0, h, 0, b);
        sm90::tma_load_4d(s0 + kKV1Bytes, &vmap, full(st), 0, h, 0, b);
        sm90::tma_load_4d(s0 + 2 * kKV1Bytes, &qmap, full(st), 0, h, 0, b);
        sm90::tma_load_4d(s0 + 2 * kKV1Bytes + kBox, &domap, full(st), 0, h, 0, b);
        sm90::tma_load_4d(s0 + 2 * kKV1Bytes + 2 * kBox, &omap, full(st), 0, h, 0, b);
      }
    }
    return;
  }
  sm90::regs_alloc<240>();

  const int tid = threadIdx.x - 128;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int rloc = warp * 16 + gr;  // this thread's first query row
  const long stride = (long)H * kD;
  const int ksteps = (Sq + 15) >> 4;  // 16-row steps of dvᵀ and dkᵀ that hold a query row

  float s[kKV1 / 2], dp[kKV1 / 2], acc_q[32], acc_dv[kKV1 / 2], acc_dk[kKV1 / 2];
  uint32_t pa[kKV1 / 16][4];

  for (int i = wg, w = blockIdx.x + wg * gridDim.x; w < n_work; i += 2, w += 2 * gridDim.x) {
    const int b = w / H, h = w - b * H;
    const int st = i & 3;
    const float g = gate != nullptr ? gate[w] : 1.0f;
    const float sl2 = scale * kLog2e * g * g;
    const float cg = scale * g;
    float lse2[2], delta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rloc + 8 * hh;
      lse2[hh] = row < Sq ? lse[(long)w * Sq + row] * kLog2e : INFINITY;
    }
    const uint32_t ks = set(st), vs = ks + kKV1Bytes, qs = ks + 2 * kKV1Bytes;
    const uint32_t dos = qs + kBox, os = qs + 2 * kBox;
    sm90::mbar_wait(full(st), (i >> 2) & 1);
    row_delta(os, dos, rloc, tg, delta);

    // S = Q Kᵀ and dP = dO Vᵀ
    const uint64_t desc_k = sm90::desc_sw128(ks, 16, 1024);
    {
      const uint64_t desc_q = sm90::desc_sw128(qs, 16, 1024);
      const uint64_t desc_do = sm90::desc_sw128(dos, 16, 1024);
      const uint64_t desc_v = sm90::desc_sw128(vs, 16, 1024);
      sm90::fence_regs<kKV1 / 2>(s);
      sm90::fence_regs<kKV1 / 2>(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::WgmmaSS<kKV1>::mma(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::WgmmaSS<kKV1>::mma(dp, desc_do + 2 * kk, desc_v + 2 * kk, kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<kKV1 / 2>(s);
      sm90::fence_regs<kKV1 / 2>(dp);
    }
    // P (0 past S_kv and S_q) and dS = P ∘ (g·dP − δ)
#pragma unroll
    for (int e = 0; e < kKV1 / 2; ++e) {
      const int col = 8 * (e >> 2) + 2 * tg + (e & 1);
      const int hh = (e >> 1) & 1;
      float p = fast_exp2(fmaf(s[e], sl2, -lse2[hh]));
      if (col >= Skv) p = 0.0f;
      s[e] = p;
      dp[e] = p * (dp[e] * g - delta[hh]);
    }
    sm90::named_barrier(2 + wg, 128);  // every warp's products of the last item are done
    store_transposed<kKV1>(pds(wg, 0), s, warp, lane);
    store_transposed<kKV1>(pds(wg, 1), dp, warp, lane);
    pack_a<kKV1 / 16>(pa, dp);
    sm90::fence_proxy_async();
    sm90::named_barrier(2 + wg, 128);  // the warpgroup's Pᵀ and dSᵀ in place

    // dq' / cg = dS K; dvᵀ = dOᵀ P; dkᵀ / cg = Qᵀ dS
    {
      const uint64_t desc_dot = sm90::desc_sw128(dos, 16, 1024);
      const uint64_t desc_qt = sm90::desc_sw128(qs, 16, 1024);
      const uint64_t desc_p = sm90::desc_sw128(pds(wg, 0), 16, 1024);
      const uint64_t desc_ds = sm90::desc_sw128(pds(wg, 1), 16, 1024);
      sm90::fence_regs<32>(acc_q);
      sm90::fence_regs<kKV1 / 2>(acc_dv);
      sm90::fence_regs<kKV1 / 2>(acc_dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKV1 / 16; ++kk)
        sm90::WgmmaRS<64, 1>::mma(acc_q, pa[kk], desc_k + 128 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) sm90::WgmmaSS<kKV1, 1>::mma(acc_dv, desc_dot + 128 * kk, desc_p + 2 * kk, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) sm90::WgmmaSS<kKV1, 1>::mma(acc_dk, desc_qt + 128 * kk, desc_ds + 2 * kk, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(acc_q);
      sm90::fence_regs<kKV1 / 2>(acc_dv);
      sm90::fence_regs<kKV1 / 2>(acc_dk);
      sm90::fence_regs<kKV1 / 4>(&pa[0][0]);
    }

    // Σ dq'∘q + Σ dv'∘v + Σ dk'∘k, then the set is free
    float part = cg * dot_tile(acc_q, qs, rloc, tg);
    float vpart = 0.0f, kpart = 0.0f;
#pragma unroll
    for (int e = 0; e < kKV1 / 2; ++e) {
      const int d = warp * 16 + gr + 8 * ((e >> 1) & 1);
      const int kv = 8 * (e >> 2) + 2 * tg + (e & 1);
      vpart += acc_dv[e] * lds_bf16(sw_addr(vs, kv, d));
      kpart += acc_dk[e] * lds_bf16(sw_addr(ks, kv, d));
    }
    part += vpart + cg * kpart;
    if (lane == 0) sm90::mbar_arrive(empty(st));

    store_rows(dq + ((long)b * Sq * H + h) * kD, acc_q, cg * g, rloc, Sq, stride, tg);
    const long row0 = (long)b * Skv * H + h;
#pragma unroll
    for (int e = 0; e < kKV1 / 2; ++e) {
      const int d = warp * 16 + gr + 8 * ((e >> 1) & 1);
      const int kv = 8 * (e >> 2) + 2 * tg + (e & 1);
      if (kv < Skv) {
        dv[(row0 + (long)kv * H) * kD + d] = __float2bfloat16(acc_dv[e] * g);
        dk[(row0 + (long)kv * H) * kD + d] = __float2bfloat16(acc_dk[e] * (cg * g));
      }
    }
    const float total = warp_sum(part);
    if (dgate_part != nullptr && lane == 0) {  // one warpgroup per item: its 4 slots, 0 in the rest
      dgate_part[(long)w * 8 + warp] = total;
      dgate_part[(long)w * 8 + 4 + warp] = 0.0f;
    }
  }
}

// dk and dv of a split one pass: out = Σ_s ws[s] in slice order, rounded once
__global__ void gated_flash_bwd_reduce_kernel(const float4* __restrict__ ws, uint2* __restrict__ dk,
                                              uint2* __restrict__ dv, int chunks, long n4) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;  // over 2·n4 float4s
  if (i >= 2 * n4) return;
  float4 acc = ws[i];
  for (int s = 1; s < chunks; ++s) {
    const float4 x = ws[(long)s * 2 * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const uint2 out = make_uint2(pack_f32(acc.x, acc.y), pack_f32(acc.z, acc.w));
  if (i < n4) {
    dk[i] = out;
  } else {
    dv[i - n4] = out;
  }
}

// ---------------------------------------------------------------- dq (S_kv > 80)

constexpr int kKV2 = 128;                   // kv rows per tile of the dq kernel
constexpr int kKV2Bytes = kKV2 * kRow;      // one K or V tile, one TMA box
constexpr int kStages2 = 3;                 // K/V ring
constexpr int kQSet = 3 * kQTile;           // Q, dO, O of one work tile
// Q/dO/O ×2 | K ring | V ring | barriers
constexpr int kSmem2 = 1024 + 2 * kQSet + 2 * kStages2 * kKV2Bytes + 256;

// Persistent: each block walks the work tiles (b·h, 128-row query tile) w =
// blockIdx.x, blockIdx.x + gridDim.x, …, the query tiles of one b·h adjacent
// (K and V stay in L2); the producer loads the next work tile's Q, dO and O
// while the consumers finish this one. Also writes the row stats the dk/dv
// kernel reads: stats[bh][0][row] = lse·log2 e (+inf past S_q),
// stats[bh][1][row] = δ (0 past S_q), rows < sq_pad.
__global__ void __launch_bounds__(kThreads, 1)
    gated_flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse, const float* __restrict__ gate,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                              float* __restrict__ dgate_part, int B, int H, int Sq, int Skv,
                              int sq_pad, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  auto q_set = [&](int qb) { return base + qb * kQSet; };  // Q | dO | O
  const uint32_t k_s = base + 2 * kQSet, v_s = k_s + kStages2 * kKV2Bytes;
  const uint32_t bars = v_s + kStages2 * kKV2Bytes;
  auto q_full = [&](int s) { return bars + 8 * s; };
  auto q_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + kStages2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (4 + 2 * kStages2 + s); };
  auto v_empty = [&](int s) { return bars + 8 * (4 + 3 * kStages2 + s); };

  const int q_tiles = (Sq + 127) / 128;
  const int n_work = B * H * q_tiles;
  const int n_tiles = (Skv + kKV2 - 1) / kKV2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 8);
    }
    for (int s = 0; s < kStages2; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(k_empty(s), 8);
      sm90::mbar_init(v_empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int c = 0;  // kv tiles loaded so far by this block
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int bh = w / q_tiles, m0 = (w - bh * q_tiles) * 128;
        const int b = bh / H, h = bh - b * H;
        const int qb = i & 1;
        const uint32_t qs = q_set(qb);
        sm90::mbar_wait(q_empty(qb), ((i >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(q_full(qb), kQSet);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sm90::tma_load_4d(qs + half * kBox, &qmap, q_full(qb), 0, h, m0 + 64 * half, b);
          sm90::tma_load_4d(qs + kQTile + half * kBox, &domap, q_full(qb), 0, h, m0 + 64 * half,
                            b);
          sm90::tma_load_4d(qs + 2 * kQTile + half * kBox, &omap, q_full(qb), 0, h,
                            m0 + 64 * half, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++c) {
          const int st = c % kStages2;
          const uint32_t free_parity = ((c / kStages2) & 1) ^ 1;
          sm90::mbar_wait(k_empty(st), free_parity);
          sm90::mbar_expect_tx(k_full(st), kKV2Bytes);
          sm90::tma_load_4d(k_s + st * kKV2Bytes, &kmap, k_full(st), 0, h, j * kKV2, b);
          sm90::mbar_wait(v_empty(st), free_parity);
          sm90::mbar_expect_tx(v_full(st), kKV2Bytes);
          sm90::tma_load_4d(v_s + st * kKV2Bytes, &vmap, v_full(st), 0, h, j * kKV2, b);
        }
      }
    }
    return;
  }
  sm90::regs_alloc<240>();

  const int tid = threadIdx.x - 128;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int rloc = wg * 64 + warp * 16 + gr;

  float s[kKV2 / 2], dp[kKV2 / 2], acc[32];
  uint32_t pa[kKV2 / 16][4];
  uint64_t desc_q, desc_do;
  float sl2, g, lse2[2], delta[2];

  // S = Q Kᵀ and dP = dO Vᵀ of the block's kv tile c (issued with no
  // product in flight but the previous tile's dS K)
  auto issue_sdp = [&](int c) {
    const int st = c % kStages2;
    const uint32_t parity = (c / kStages2) & 1;
    sm90::mbar_wait(k_full(st), parity);
    sm90::mbar_wait(v_full(st), parity);
    const uint64_t desc_k = sm90::desc_sw128(k_s + st * kKV2Bytes, 16, 1024);
    const uint64_t desc_v = sm90::desc_sw128(v_s + st * kKV2Bytes, 16, 1024);
    sm90::fence_regs<kKV2 / 2>(s);
    sm90::fence_regs<kKV2 / 2>(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<kKV2>::mma(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<kKV2>::mma(dp, desc_do + 2 * kk, desc_v + 2 * kk, kk > 0);
    sm90::wgmma_commit();
  };
  // dq' / cg += dS K of the block's kv tile c, K read MN-major
  auto issue_dq = [&](int c) {
    const uint64_t desc_k = sm90::desc_sw128(k_s + (c % kStages2) * kKV2Bytes, 16, 1024);
    sm90::fence_regs<32>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKV2 / 16; ++kk)
      sm90::WgmmaRS<64, 1>::mma(acc, pa[kk], desc_k + 128 * kk, 1);
    sm90::wgmma_commit();
  };
  // dS = P ∘ (g·dP − δ) in dp, P = exp2(S·sl2 − lse₂), 0 past S_kv and S_q
  auto form_ds = [&](int j) {
    const int n0 = j * kKV2;
#pragma unroll
    for (int e = 0; e < kKV2 / 2; ++e) {
      const int col = n0 + 8 * (e >> 2) + 2 * tg + (e & 1);
      const int hh = (e >> 1) & 1;
      float p = fast_exp2(fmaf(s[e], sl2, -lse2[hh]));
      if (col >= Skv) p = 0.0f;
      dp[e] = p * (dp[e] * g - delta[hh]);
    }
  };

  int c0 = 0;  // kv tiles consumed so far by this block
  for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i, c0 += n_tiles) {
    const int bh = w / q_tiles, qt = w - bh * q_tiles, m0 = qt * 128;
    const int b = bh / H, h = bh - b * H;
    const int qb = i & 1;
    const uint32_t qs = q_set(qb), dos = qs + kQTile, os = qs + 2 * kQTile;
    g = gate != nullptr ? gate[bh] : 1.0f;
    sl2 = scale * kLog2e * g * g;
    const float cg = scale * g;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + rloc + 8 * hh;
      lse2[hh] = row < Sq ? lse[(long)bh * Sq + row] * kLog2e : INFINITY;
    }
    sm90::mbar_wait(q_full(qb), (i >> 1) & 1);
    row_delta(os, dos, rloc, tg, delta);
    if (tg == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + rloc + 8 * hh;
        if (row < sq_pad) {
          stats[(long)(2 * bh) * sq_pad + row] = lse2[hh];
          stats[(long)(2 * bh + 1) * sq_pad + row] = row < Sq ? delta[hh] : 0.0f;
        }
      }
    }
    desc_q = sm90::desc_sw128(qs + wg * kBox, 16, 1024);
    desc_do = sm90::desc_sw128(dos + wg * kBox, 16, 1024);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

    issue_sdp(c0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kKV2 / 2>(s);
    sm90::fence_regs<kKV2 / 2>(dp);
    if (lane == 0) sm90::mbar_arrive(v_empty(c0 % kStages2));
    form_ds(0);
    pack_a<kKV2 / 16>(pa, dp);
    for (int j = 1; j < n_tiles; ++j) {
      issue_sdp(c0 + j);
      issue_dq(c0 + j - 1);
      sm90::wgmma_wait<1>();  // S and dP of tile j are complete; its V stage is free
      sm90::fence_regs<kKV2 / 2>(s);
      sm90::fence_regs<kKV2 / 2>(dp);
      if (lane == 0) sm90::mbar_arrive(v_empty((c0 + j) % kStages2));
      form_ds(j);
      sm90::wgmma_wait<0>();  // tile j − 1's dS K is done; its K stage is free
      sm90::fence_regs<32>(acc);
      sm90::fence_regs<kKV2 / 4>(&pa[0][0]);
      if (lane == 0) sm90::mbar_arrive(k_empty((c0 + j - 1) % kStages2));
      pack_a<kKV2 / 16>(pa, dp);
    }
    issue_dq(c0 + n_tiles - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(acc);
    sm90::fence_regs<kKV2 / 4>(&pa[0][0]);
    if (lane == 0) sm90::mbar_arrive(k_empty((c0 + n_tiles - 1) % kStages2));

    const float part = cg * dot_tile(acc, qs, rloc, tg);
    if (lane == 0) sm90::mbar_arrive(q_empty(qb));  // this warp is done with Q, dO, O
    store_rows(dq + ((long)b * Sq * H + h) * kD, acc, cg * g, m0 + rloc, Sq, (long)H * kD, tg);
    const float total = warp_sum(part);
    if (dgate_part != nullptr && lane == 0)
      dgate_part[(long)bh * 8 * q_tiles + 8 * qt + 4 * wg + warp] = total;
  }
}

// ---------------------------------------------------------------- dk/dv (S_kv > 80)

constexpr int kStages3 = 4;                         // Q/dO/stats ring of 64-row query tiles
constexpr int kStage3 = 2 * kBox + 1024;            // Q, dO, 2 × 64 row stats (kept 1024-aligned)
// K, V ×2 | ring | barriers
constexpr int kSmem3 = 1024 + 4 * kQTile + kStages3 * kStage3 + 256;

// Persistent: each block walks the work tiles (b·h, 128-row kv tile) w =
// blockIdx.x, blockIdx.x + gridDim.x, …; each consumer warpgroup takes 64
// kv rows, in the transposed layout (kv rows × query columns); K and V are
// double-buffered across work tiles, the query side runs through the ring.
__global__ void __launch_bounds__(kThreads, 1)
    gated_flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ stats, const float* __restrict__ gate,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ dgate_part, int B, int H, int Skv, int sq_pad,
                               float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  auto k_s = [&](int kb) { return base + kb * 2 * kQTile; };
  auto v_s = [&](int kb) { return base + kb * 2 * kQTile + kQTile; };
  auto stage = [&](int st) { return base + 4 * kQTile + st * kStage3; };
  const uint32_t bars = base + 4 * kQTile + kStages3 * kStage3;
  auto kv_full = [&](int s) { return bars + 8 * s; };
  auto kv_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto q_full = [&](int s) { return bars + 8 * (4 + s); };
  auto q_empty = [&](int s) { return bars + 8 * (4 + kStages3 + s); };

  const int kv_tiles = (Skv + 127) / 128;
  const int n_work = B * H * kv_tiles;
  const int n_tiles = sq_pad / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(kv_full(s), 1);
      sm90::mbar_init(kv_empty(s), 8);
    }
    for (int s = 0; s < kStages3; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int c = 0;  // query tiles loaded so far by this block
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int bh = w / kv_tiles, n0 = (w - bh * kv_tiles) * 128;
        const int b = bh / H, h = bh - b * H;
        const int kb = i & 1;
        sm90::mbar_wait(kv_empty(kb), ((i >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(kv_full(kb), 2 * kQTile);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sm90::tma_load_4d(k_s(kb) + half * kBox, &kmap, kv_full(kb), 0, h, n0 + 64 * half, b);
          sm90::tma_load_4d(v_s(kb) + half * kBox, &vmap, kv_full(kb), 0, h, n0 + 64 * half, b);
        }
        const float* lse_b = stats + (long)(2 * bh) * sq_pad;
        const float* delta_b = lse_b + sq_pad;
        for (int j = 0; j < n_tiles; ++j, ++c) {
          const int st = c % kStages3;
          const uint32_t s0 = stage(st);
          sm90::mbar_wait(q_empty(st), ((c / kStages3) & 1) ^ 1);
          sm90::mbar_expect_tx(q_full(st), 2 * kBox + 2 * 64 * 4);
          sm90::tma_load_4d(s0, &qmap, q_full(st), 0, h, 64 * j, b);
          sm90::tma_load_4d(s0 + kBox, &domap, q_full(st), 0, h, 64 * j, b);
          sm90::bulk_load(s0 + 2 * kBox, lse_b + 64 * j, 256, q_full(st));
          sm90::bulk_load(s0 + 2 * kBox + 256, delta_b + 64 * j, 256, q_full(st));
        }
      }
    }
    return;
  }
  sm90::regs_alloc<240>();

  const int tid = threadIdx.x - 128;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int rloc = wg * 64 + warp * 16 + gr;  // this thread's first kv row in the tile

  float st_[32], dpt[32], adv[32], adk[32];
  uint32_t pp[4][4], pd[4][4];
  uint64_t desc_kr, desc_vr;
  float g, sl2;
  bool valid[2];

  // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ of the block's query tile c
  auto issue_sdp = [&](int c) {
    const int st = c % kStages3;
    sm90::mbar_wait(q_full(st), (c / kStages3) & 1);
    const uint64_t desc_q = sm90::desc_sw128(stage(st), 16, 1024);
    const uint64_t desc_do = sm90::desc_sw128(stage(st) + kBox, 16, 1024);
    sm90::fence_regs<32>(st_);
    sm90::fence_regs<32>(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<64>::mma(st_, desc_kr + 2 * kk, desc_q + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<64>::mma(dpt, desc_vr + 2 * kk, desc_do + 2 * kk, kk > 0);
    sm90::wgmma_commit();
  };
  // dv' += Pᵀ dO and dk' / cg += dSᵀ Q of the block's query tile c, dO and Q
  // read MN-major
  auto issue_dvdk = [&](int c) {
    const uint32_t s0 = stage(c % kStages3);
    const uint64_t desc_q = sm90::desc_sw128(s0, 16, 1024);
    const uint64_t desc_do = sm90::desc_sw128(s0 + kBox, 16, 1024);
    sm90::fence_regs<32>(adv);
    sm90::fence_regs<32>(adk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::WgmmaRS<64, 1>::mma(adv, pp[kk], desc_do + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::WgmmaRS<64, 1>::mma(adk, pd[kk], desc_q + 128 * kk, 1);
    sm90::wgmma_commit();
  };
  // Pᵀ = exp2(Sᵀ·sl2 − lse₂[col]) (0 at kv rows past S_kv; lse₂ = +inf at
  // query columns past S_q) and dSᵀ = Pᵀ ∘ (g·dPᵀ − δ[col])
  auto form = [&](int c) {
    const uint32_t rs = stage(c % kStages3) + 2 * kBox;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 l2 = lds_f32x2(rs + 4 * (8 * nb + 2 * tg));
      const float2 dl = lds_f32x2(rs + 256 + 4 * (8 * nb + 2 * tg));
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * nb + e4;
        float p = fast_exp2(fmaf(st_[e], sl2, -((e4 & 1) ? l2.y : l2.x)));
        if (!valid[e4 >> 1]) p = 0.0f;
        st_[e] = p;
        dpt[e] = p * (dpt[e] * g - ((e4 & 1) ? dl.y : dl.x));
      }
    }
  };

  int c0 = 0;  // query tiles consumed so far by this block
  for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i, c0 += n_tiles) {
    const int bh = w / kv_tiles, kt = w - bh * kv_tiles, n0 = kt * 128;
    const int b = bh / H, h = bh - b * H;
    const int kb = i & 1;
    g = gate != nullptr ? gate[bh] : 1.0f;
    sl2 = scale * kLog2e * g * g;
    const float cg = scale * g;
    valid[0] = n0 + rloc < Skv;
    valid[1] = n0 + rloc + 8 < Skv;
    const uint32_t ks = k_s(kb), vs = v_s(kb);
    desc_kr = sm90::desc_sw128(ks + wg * kBox, 16, 1024);
    desc_vr = sm90::desc_sw128(vs + wg * kBox, 16, 1024);
#pragma unroll
    for (int e = 0; e < 32; ++e) adv[e] = adk[e] = 0.0f;
    sm90::mbar_wait(kv_full(kb), (i >> 1) & 1);

    issue_sdp(c0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(st_);
    sm90::fence_regs<32>(dpt);
    form(c0);
    pack_a<4>(pp, st_);
    pack_a<4>(pd, dpt);
    for (int j = 1; j < n_tiles; ++j) {
      issue_sdp(c0 + j);
      issue_dvdk(c0 + j - 1);
      sm90::wgmma_wait<1>();  // Sᵀ and dPᵀ of tile j are complete
      sm90::fence_regs<32>(st_);
      sm90::fence_regs<32>(dpt);
      form(c0 + j);
      sm90::wgmma_wait<0>();  // tile j − 1's products are done; its stage is free
      sm90::fence_regs<32>(adv);
      sm90::fence_regs<32>(adk);
      sm90::fence_regs<16>(&pp[0][0]);
      sm90::fence_regs<16>(&pd[0][0]);
      if (lane == 0) sm90::mbar_arrive(q_empty((c0 + j - 1) % kStages3));
      pack_a<4>(pp, st_);
      pack_a<4>(pd, dpt);
    }
    issue_dvdk(c0 + n_tiles - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(adv);
    sm90::fence_regs<32>(adk);
    sm90::fence_regs<16>(&pp[0][0]);
    sm90::fence_regs<16>(&pd[0][0]);
    if (lane == 0) sm90::mbar_arrive(q_empty((c0 + n_tiles - 1) % kStages3));

    const float part = cg * dot_tile(adk, ks, rloc, tg) + dot_tile(adv, vs, rloc, tg);
    if (lane == 0) sm90::mbar_arrive(kv_empty(kb));  // this warp is done with K and V
    const long stride = (long)H * kD;
    const long off = ((long)b * Skv * H + h) * kD;
    store_rows(dk + off, adk, cg * g, n0 + rloc, Skv, stride, tg);
    store_rows(dv + off, adv, g, n0 + rloc, Skv, stride, tg);
    const float total = warp_sum(part);
    if (dgate_part != nullptr && lane == 0)
      dgate_part[(long)bh * 8 * kv_tiles + 8 * kt + 4 * wg + warp] = total;
  }
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream`, never
// synchronises, allocates nothing, and returns cudaGetLastError() after the
// launch (or an error before it). q/o/dout/dq: (B, Sq, H, 64), k/v/dk/dv:
// (B, Skv, H, 64), contiguous bf16, 16-byte aligned; lse (natural log, from
// the forward): (B·H, Sq) f32; gate: (B, H) f32 or null; dgate_part: f32,
// two per block-or-item (one per consumer warpgroup), or null to skip them.
// The arguments that come from `backward_plan` (chunks, blocks, sq_pad) are
// the wrapper's; their buffers are sized by it.

// One pass, Skv <= 80: `blocks` persistent blocks over B·H·chunks items; with
// chunks > 1, dk/dv go to ws (chunks, 2, B, Skv, H, 64) f32 and dk/dv are
// left to gated_flash_bwd_reduce. dgate_part: (B·H, 8·chunks).
extern "C" int gated_flash_bwd_fused(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, const float* gate,
                                     void* dq, void* dk, void* dv, float* ws, float* dgate_part,
                                     int B, int H, int Sq, int Skv, int chunks, int blocks,
                                     float scale, void* stream) {
  if (Skv > kKV1 || chunks < 1 || chunks > (Sq + 127) / 128 || blocks < 1 ||
      (chunks > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted = sm90::allow_smem(gated_flash_bwd_fused_kernel, kSmem1);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  static const cudaError_t opted_small =
      sm90::allow_smem(gated_flash_bwd_fused_small_kernel, kSmemSmall);
  if (opted_small != cudaSuccess) return static_cast<int>(opted_small);
  CUtensorMap qmap, kmap, vmap, omap, domap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, 64) || !sm90::bshd_map(&kmap, k, B, Skv, H, kKV1) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, kKV1) || !sm90::bshd_map(&omap, o, B, Sq, H, 64) ||
      !sm90::bshd_map(&domap, dout, B, Sq, H, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 64) {  // one 64-row query tile an item: the warpgroups take items of their own
    gated_flash_bwd_fused_small_kernel<<<blocks, kThreads, kSmemSmall, st>>>(
        qmap, kmap, vmap, omap, domap, lse, gate, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dgate_part, B, H, Sq,
        Skv, scale);
    return static_cast<int>(cudaGetLastError());
  }
  gated_flash_bwd_fused_kernel<<<blocks, kThreads, kSmem1, st>>>(
      qmap, kmap, vmap, omap, domap, lse, gate, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), ws, dgate_part, B, H, Sq,
      Skv, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv = Σ over the chunks of ws (chunks, 2, n) f32, n = B·Skv·H·64
extern "C" int gated_flash_bwd_reduce(const float* ws, void* dk, void* dv, int chunks, long n,
                                      void* stream) {
  if (n % 4 != 0 || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long n4 = n / 4;
  const int threads = 256;
  const long blocks = (2 * n4 + threads - 1) / threads;
  gated_flash_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(ws), static_cast<uint2*>(dk), static_cast<uint2*>(dv),
      chunks, n4);
  return static_cast<int>(cudaGetLastError());
}

// Skv > 80, first of two: dq, the row stats (B·H, 2, sq_pad) f32 (sq_pad a
// multiple of 64, >= Sq), dgate_part (B·H, 8·⌈Sq/128⌉); `blocks` persistent
// blocks over the B·H·⌈Sq/128⌉ work tiles.
extern "C" int gated_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, const float* gate, void* dq,
                                  float* stats, float* dgate_part, int B, int H, int Sq, int Skv,
                                  int sq_pad, int blocks, float scale, void* stream) {
  if (sq_pad % 64 != 0 || sq_pad < Sq || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted = sm90::allow_smem(gated_flash_bwd_dq_kernel, kSmem2);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap, omap, domap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, 64) || !sm90::bshd_map(&kmap, k, B, Skv, H, kKV2) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, kKV2) || !sm90::bshd_map(&omap, o, B, Sq, H, 64) ||
      !sm90::bshd_map(&domap, dout, B, Sq, H, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  gated_flash_bwd_dq_kernel<<<blocks, kThreads, kSmem2, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, omap, domap, lse, gate, static_cast<__nv_bfloat16*>(dq), stats,
      dgate_part, B, H, Sq, Skv, sq_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

// Skv > 80, second of two: dk and dv from the dq kernel's row stats;
// dgate_part (B·H, 8·⌈Skv/128⌉); `blocks` persistent blocks over the
// B·H·⌈Skv/128⌉ work tiles.
extern "C" int gated_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* stats, const float* gate, void* dk, void* dv,
                                   float* dgate_part, int B, int H, int Sq, int Skv, int sq_pad,
                                   int blocks, float scale, void* stream) {
  if (sq_pad % 64 != 0 || sq_pad < Sq || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted = sm90::allow_smem(gated_flash_bwd_dkv_kernel, kSmem3);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap, domap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, 64) || !sm90::bshd_map(&kmap, k, B, Skv, H, 64) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, 64) || !sm90::bshd_map(&domap, dout, B, Sq, H, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  gated_flash_bwd_dkv_kernel<<<blocks, kThreads, kSmem3, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, stats, gate, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dgate_part, B, H, Skv, sq_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
