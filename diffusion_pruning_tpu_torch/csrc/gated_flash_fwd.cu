// Head-gated flash attention forward for Hopper (sm_90a).
//
//   O[b, :, h, :] = softmax(Q Kᵀ · d^-½ · g²) · V · g,   g = gate[b, h] (1 if absent)
//
// which equals masked SDPA with q, k and v each multiplied by g. Layouts are
// (B, S, H, 64), read in place through the row stride H·64: no per-head
// transposes.
//
// Replaces the four inference forwards of the JAX package's
// diffusion_pruning_tpu/ops/flash_attention.py — `_attn_kernel` (single head,
// full kv), `_attn_kernel2` (two heads packed on 128 lanes), `_attn_kernel2_kv`
// and `_attn_kernel1_kv` (kv-blocked online softmax at S_kv >= 2048) — and,
// with an lse output, the training forwards behind `_fa_fwd`. Their head-pair
// packing, odd-head split and VMEM block sizing only fit the math to the
// TPU's 128-lane tiles; none of it is carried over.
//
// What bounds it on an H100: at S >= 256 the two products dominate
// (4·S_q·S_kv·64 FLOPs per (batch, head) against 256·S bytes of q/k/v/o), far
// above the card's ~295 FLOP/byte balance point, so the tensor cores are the
// limit, and only wgmma reaches their rate. Cross-attention (S_kv = 77) and
// the 16- and 64-token blocks do few FLOPs per byte and are bounded by
// reading q and writing o.
//
// Two kernels, chosen by the wrapper (`gated_flash_attention` and
// `gated_flash_forward_lse` in ops/flash_attention.py) by the query length:
//
// gated_flash_fwd_wgmma (S_q > 64), the Hopper design:
//  * work tiles are (b·h, 128-row query tile); one persistent block a SM
//    walks them (query tiles of one (b, h) adjacent, so K/V stay in L2), so
//    that the next tile's Q and K/V load while this one finishes. A block is
//    two consumer warpgroups of 64 query rows each and a producer warpgroup
//    that hands them its registers (setmaxnreg: 24 and 240 a thread);
//  * Q, K and V arrive by TMA through 4-D tensor maps over (B, S, H, 64), in
//    boxes of 64 rows × 64 dims of one (batch, head) with 128-byte swizzle:
//    a box that runs past S is zero-filled inside its own batch element, so
//    no read crosses into the next one. One producer thread keeps two Q
//    tiles and a four-stage ring of K and V tiles in flight, guarded by full
//    and empty mbarriers, K and V apart (K is free once S is, V once P V
//    is). A kv tile is 128 rows, or 80 where S_kv <= 80: the 77 text tokens
//    of cross-attention then leave 4 % of the tile masked, not 40 %;
//  * S = Q Kᵀ is an SS-wgmma m64nKVk16 (Q and K from shared memory, four
//    16-deep steps over the head dim); the online softmax runs on the S
//    accumulators in registers in the log2 domain (ex2.approx), the gate
//    folded into the logit scale (g²) and the final 1/l factor (g); kv
//    columns at or past S_kv get probability 0 (S_kv = 77 fits no tile);
//  * O += P V is an RS-wgmma m64n64k16: P is re-packed from the S
//    accumulators into A registers (the accumulator's column pairs are the A
//    fragment), V is read from shared memory through the transposed-B form;
//    KV / 16 16-deep steps over the kv rows;
//  * inside a warpgroup the products overlap the softmax: kv tile j's Q Kᵀ
//    is issued beside tile j − 1's P V, and tile j's softmax runs while that
//    P V does; O's rescale waits one tile, and P is rounded into its A
//    registers only with no product in flight (else ptxas serialises every
//    wgmma of the kernel). With one kv tile a work tile (S_kv <= 80) the
//    pipeline runs on across work tiles instead, O stored when its last P V
//    is done; with several it drains at each work tile's end (measured
//    faster at S_kv >= 1024, PERF.md §6);
//  * query rows past S_q are computed on zeros and never stored.
// Given up: the two warpgroups are not scheduled against each other
// (ping-pong), and O is stored from registers.
//
// gated_flash_fwd (S_q <= 64), the first version on mma.sync and cp.async,
// kept because a 128-row tile would leave most of its rows idle there (it
// led SDPA at those shapes): one block of 4 warps per (b·h, 64-row query
// tile), each warp 16 query rows; K/V tiles of 64 rows double-buffered by
// cp.async in padded shared memory; S = Q Kᵀ and O += P V through mma.sync
// m16n8k16, P re-packed in registers; the same masking and gate folding.
//
// Training forward: with a non-null `lse`, either kernel also writes one f32
// per (b·h, query row), the log-sum-exp of that row's logits q·kᵀ·d^-½·g² in
// the NATURAL log, (m + log2 l)·ln 2 from the online-softmax state it keeps
// in the log2 domain. gated_flash_bwd.cu reads it back as lse·log2(e). A null
// `lse` is the inference launch.

#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace gfa;

// ---------------------------------------------------------------- mma.sync forward (S_q <= 64)

__global__ void __launch_bounds__(kThreads)
    gated_flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ gate, __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int H, int Sq, int Skv,
                                float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kTileElems];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileElems];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * kBlock;
  const long row_stride = (long)H * kD;
  const __nv_bfloat16* qb = q + ((long)b * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + ((long)b * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + ((long)b * Skv * H + h) * kD;
  __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * kD;
  const float g = gate != nullptr ? gate[bh] : 1.0f;
  const float sl2 = scale_log2 * g * g;  // logits in the log2 domain: d^-½ · g² · log2(e)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // fragment row group
  const int tg = lane & 3;   // thread in group

  load_tile(q_s, qb, m0, Sq, row_stride, tid);
  load_tile(k_s[0], kb, 0, Skv, row_stride, tid);
  load_tile(v_s[0], vb, 0, Skv, row_stride, tid);
  cp_async_commit();

  uint32_t qf[4][4];
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (Skv + kBlock - 1) / kBlock;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(k_s[cur ^ 1], kb, (j + 1) * kBlock, Skv, row_stride, tid);
      load_tile(v_s[cur ^ 1], vb, (j + 1) * kBlock, Skv, row_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // everything but the prefetch just issued has landed
    __syncthreads();

    if (j == 0) load_a_frags(qf, q_s, warp * 16, gr, tg);

    // S = Q Kᵀ for this warp's 16 rows × 64 kv columns (8 n-tiles of 8)
    float s[8][4];
    mma_abt(s, qf, k_s[cur], gr, tg);

    // scale, mask the kv tail, running row max (rows gr and gr + 8)
    const int n0 = j * kBlock;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * tg + (e & 1);
        const float val = col < Skv ? s[nt][e] * sl2 : -INFINITY;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile (m_run = -inf)
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }

    // O += P V, P rounded to bf16 in registers
    mma_ab(acc, s, v_s[cur], gr, tg);
    __syncthreads();  // the next iteration's prefetch overwrites the buffer read here
  }

  const float inv0 = g / l_run[0];
  const float inv1 = g / l_run[1];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] *= inv0;
    acc[nt][1] *= inv0;
    acc[nt][2] *= inv1;
    acc[nt][3] *= inv1;
  }
  const int row0 = m0 + warp * 16 + gr;
  store_rows(ob, acc, 1.0f, row0, Sq, row_stride, tg);
  if (lse != nullptr && tg == 0) {  // the quad holds equal m_run/l_run after its shuffles
    float* lb = lse + (long)bh * Sq;
    if (row0 < Sq) lb[row0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (row0 + 8 < Sq) lb[row0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}


// ---------------------------------------------------------------- wgmma forward

constexpr int kQRows = 128;                // query rows per work tile: two warpgroups of 64
constexpr int kFwdStages = 4;              // K/V ring
constexpr int kFwdThreads = 3 * 128;       // a producer warpgroup, two consumer warpgroups
constexpr int kBox = 64 * kD * 2;          // bytes of one Q box: 64 rows × 64 dims
constexpr int kQTile = kQRows * kD * 2;    // bytes of one Q tile

// kv rows per tile: 128, or 80 where S_kv <= 80 (the 77 text tokens of
// cross-attention: 4 % of the tile masked instead of 40 %)
template <int KV>
struct FwdTile {
  static constexpr int kBytes = KV * kD * 2;  // one K or V tile, one TMA box
  static constexpr int kSmem =
      1024 + 2 * kQTile + 2 * kFwdStages * kBytes + (4 + 4 * kFwdStages) * 8;
  static_assert(KV % 16 == 0 && kBytes % 1024 == 0, "whole k16 steps and swizzle atoms");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile's online-softmax update on this thread's S accumulators (rows
// gr and gr + 8 of its warp, columns col0 + 8·(i / 4) + (i % 2)): running max
// and sum in the log2 domain (logit scale sl2 = d^-½·g²·log2 e >= 0), s
// overwritten by the probabilities, and `alpha` the factor by which O, which
// still lacks the previous tile's P V, must be scaled before that is added.
// kMask: the tile runs past S_kv, whose columns get probability 0.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&alpha)[2],
                                             float (&m_run)[2], float (&l_run)[2], float sl2,
                                             int col0, int Skv) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kMask && col0 + (i >> 2) * 8 + (i & 1) >= Skv) s[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * sl2);  // a row has a column below S_kv
    alpha[r] = fast_exp2(m_run[r] - m_new);             // 0 on the first tile (m_run = -inf)
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p = fast_exp2(fmaf(s[i], sl2, neg_m[(i >> 1) & 1]));
    if (kMask && col0 + (i >> 2) * 8 + (i & 1) >= Skv) p = 0.0f;  // also when sl2 = 0
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_run[r] = l_run[r] * alpha[r] + rs[r];
  }
}

// Persistent: each block walks the work tiles (b·h, 128-row query tile)
// blockIdx.x, blockIdx.x + gridDim.x, …, query tiles of one (b, h) adjacent;
// the producer loads the next work tile's Q and K/V while the consumers
// finish this one, and the consumers' pipeline runs on across work tiles.
template <int KV, bool kStream>
__global__ void __launch_bounds__(kFwdThreads, 1)
    gated_flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const float* __restrict__ gate, __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse, int B, int H, int Sq, int Skv,
                                 float scale_log2) {
  constexpr int kKVTile = FwdTile<KV>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  // Q tiles 0, 1 | K ring | V ring | barriers: Q full and empty per Q tile;
  // K full, V full, K empty, V empty per stage
  const uint32_t q_s = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + 2 * kQTile;
  const uint32_t v_s = k_s + kFwdStages * kKVTile;
  const uint32_t bars = v_s + kFwdStages * kKVTile;
  auto q_full = [&](int s) { return bars + 8 * s; };
  auto q_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + kFwdStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (4 + 2 * kFwdStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (4 + 3 * kFwdStages + s); };

  const int q_tiles = (Sq + kQRows - 1) / kQRows;
  const int n_work = q_tiles * B * H;
  const int n_tiles = (Skv + KV - 1) / KV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kFwdStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(k_empty(s), 8);
      sm90::mbar_init(v_empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int c = 0;  // kv tiles loaded so far by this block
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int bh = w / q_tiles, m0 = (w - bh * q_tiles) * kQRows;
        const int b = bh / H, h = bh - b * H;
        const int qb = i & 1;
        sm90::mbar_wait(q_empty(qb), ((i >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(q_full(qb), kQTile);
        sm90::tma_load_4d(q_s + qb * kQTile, &qmap, q_full(qb), 0, h, m0, b);
        sm90::tma_load_4d(q_s + qb * kQTile + kBox, &qmap, q_full(qb), 0, h, m0 + 64, b);
        for (int j = 0; j < n_tiles; ++j, ++c) {
          const int st = c % kFwdStages;
          const uint32_t free_parity = ((c / kFwdStages) & 1) ^ 1;
          const int r0 = j * KV;
          sm90::mbar_wait(k_empty(st), free_parity);
          sm90::mbar_expect_tx(k_full(st), kKVTile);
          sm90::tma_load_4d(k_s + st * kKVTile, &kmap, k_full(st), 0, h, r0, b);
          sm90::mbar_wait(v_empty(st), free_parity);
          sm90::mbar_expect_tx(v_full(st), kKVTile);
          sm90::tma_load_4d(v_s + st * kKVTile, &vmap, v_full(st), 0, h, r0, b);
        }
      }
    }
    return;
  }
  sm90::regs_alloc<240>();

  const int tid = threadIdx.x - 128;  // consumer thread 0 … 255
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;

  float acc[32];  // O: 8 column blocks of 8 head dims × (rows gr, gr + 8)
  float s[KV / 2];  // S of one kv tile, then its probabilities
  uint32_t pa[KV / 16][4];  // P of the tile whose P V is next, rounded to bf16
  float m_run[2], l_run[2], alpha[2];
  uint64_t desc_q;
  float sl2;

  // The block's kv tiles t = item · n_tiles + j over its work tiles (item)
  // and their kv tiles (j). kStream: one stream, step t issuing tile t's
  // Q Kᵀ beside tile t − 1's P V and running tile t's softmax beside that
  // P V also across a work tile's end, whose O is stored once its last P V
  // is done.
  struct Item {
    int bh, m0;
    float g;
  };
  Item cur;
  auto begin_item = [&](int i) {  // work tile i of this block: its Q, gate, softmax state
    const int w = blockIdx.x + i * gridDim.x;
    cur.bh = w / q_tiles;
    cur.m0 = (w - cur.bh * q_tiles) * kQRows;
    cur.g = gate != nullptr ? gate[cur.bh] : 1.0f;
    sl2 = scale_log2 * cur.g * cur.g;  // logits in the log2 domain: d^-½ · g² · log2(e)
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;
    sm90::mbar_wait(q_full(i & 1), (i >> 1) & 1);
    desc_q = sm90::desc_sw128(q_s + (i & 1) * kQTile + wg * kBox, 16, 1024);
  };
  // S = Q Kᵀ of kv tile t: four 16-deep steps over the head dim (issued with
  // no product in flight)
  auto issue_qk = [&](int t) {
    const int st = t % kFwdStages;
    sm90::mbar_wait(k_full(st), (t / kFwdStages) & 1);
    const uint64_t desc_k = sm90::desc_sw128(k_s + st * kKVTile, 16, 1024);
    sm90::fence_regs<KV / 2>(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<KV>::mma(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    sm90::wgmma_commit();
  };
  // O = alpha·O + P V of kv tile t: KV / 16 16-deep steps over its rows, P
  // from registers, V read through the transposed-B form
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const int st = t % kFwdStages;
    sm90::mbar_wait(v_full(st), (t / kFwdStages) & 1);
    const uint64_t desc_v = sm90::desc_sw128(v_s + st * kKVTile, 16, 1024);
    sm90::fence_regs<32>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      sm90::WgmmaRS<64, 1>::mma(acc, pa[kk], desc_v + 128 * kk, 1);
    sm90::wgmma_commit();
  };
  auto softmax = [&](int j) {
    const int n0 = j * KV;
    if (n0 + KV > Skv) {
      softmax_tile<true>(s, alpha, m_run, l_run, sl2, n0 + 2 * tg, Skv);
    } else {
      softmax_tile<false>(s, alpha, m_run, l_run, sl2, n0 + 2 * tg, Skv);
    }
  };
  // P rounded to bf16 in registers (with no product in flight): the
  // accumulator's column blocks 2kk and 2kk + 1 are the A fragment of step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      pa[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // O · g / l of a finished work tile to its rows, and its lse
  auto store = [&](const Item& it, const float (&m)[2], const float (&l)[2]) {
    const int b = it.bh / H, h = it.bh - b * H;
    const float inv[2] = {it.g / l[0], it.g / l[1]};
    const long row_stride = (long)H * kD;
    __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * kD;
    const int row0 = it.m0 + wg * 64 + warp * 16 + gr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= Sq) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        *reinterpret_cast<uint32_t*>(ob + (long)row * row_stride + nb * 8 + 2 * tg) =
            pack_f32(acc[4 * nb + 2 * half] * inv[half], acc[4 * nb + 2 * half + 1] * inv[half]);
      }
    }
    if (lse != nullptr && tg == 0) {  // the quad holds equal m/l after its shuffles
      float* lb = lse + (long)it.bh * Sq;
      if (row0 < Sq) lb[row0] = (m[0] + log2f(l[0])) * kLn2;
      if (row0 + 8 < Sq) lb[row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
  };

  const int items = (n_work - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // gridDim.x <= n_work
  if (!kStream) {
    // one work tile at a time: tile j's Q Kᵀ beside tile j − 1's P V, tile
    // j's softmax beside that P V; the pipeline drains at the work tile's end
    for (int i = 0; i < items; ++i) {
      const int c0 = i * n_tiles;
      begin_item(i);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
      issue_qk(c0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs<KV / 2>(s);
      if (lane == 0) sm90::mbar_arrive(k_empty(c0 % kFwdStages));
      softmax(0);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        issue_qk(c0 + j);
        issue_pv(c0 + j - 1);
        sm90::wgmma_wait<1>();  // S of tile j is complete; its K stage is free
        sm90::fence_regs<KV / 2>(s);
        if (lane == 0) sm90::mbar_arrive(k_empty((c0 + j) % kFwdStages));
        softmax(j);
        sm90::wgmma_wait<0>();  // tile j − 1's P V is done; its V stage is free
        sm90::fence_regs<32>(acc);
        sm90::fence_regs<KV / 4>(&pa[0][0]);
        if (lane == 0) sm90::mbar_arrive(v_empty((c0 + j - 1) % kFwdStages));
        pack_p();
      }
      issue_pv(c0 + n_tiles - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(acc);
      sm90::fence_regs<KV / 4>(&pa[0][0]);
      if (lane == 0) {  // this warp is done with the Q tile and the last V stage
        sm90::mbar_arrive(q_empty(i & 1));
        sm90::mbar_arrive(v_empty((c0 + n_tiles - 1) % kFwdStages));
      }
      store(cur, m_run, l_run);
    }
    return;
  }
  const int steps = items * n_tiles;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  begin_item(0);
  issue_qk(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs<KV / 2>(s);
  if (lane == 0) sm90::mbar_arrive(k_empty(0));
  softmax(0);
  pack_p();
  for (int t = 1; t < steps; ++t) {
    const int i = t / n_tiles, j = t - i * n_tiles;
    Item done = cur;  // the work tile tile t − 1 belongs to
    float done_m[2] = {m_run[0], m_run[1]}, done_l[2] = {l_run[0], l_run[1]};
    if (j == 0) {  // work tile i − 1 has issued its last Q Kᵀ: its Q buffer is free
      if (lane == 0) sm90::mbar_arrive(q_empty((i - 1) & 1));
      begin_item(i);
    }
    issue_qk(t);
    issue_pv(t - 1);
    sm90::wgmma_wait<1>();  // S of tile t is complete; its K stage is free
    sm90::fence_regs<KV / 2>(s);
    if (lane == 0) sm90::mbar_arrive(k_empty(t % kFwdStages));
    softmax(j);
    sm90::wgmma_wait<0>();  // tile t − 1's P V is done; its V stage is free
    sm90::fence_regs<32>(acc);
    sm90::fence_regs<KV / 4>(&pa[0][0]);
    if (lane == 0) sm90::mbar_arrive(v_empty((t - 1) % kFwdStages));
    if (j == 0) {  // work tile i − 1 is complete
      store(done, done_m, done_l);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    }
    pack_p();
  }
  issue_pv(steps - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs<32>(acc);
  sm90::fence_regs<KV / 4>(&pa[0][0]);
  store(cur, m_run, l_run);
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream`, never
// synchronises, allocates nothing, and returns cudaGetLastError() after the
// launch. q: (B, Sq, H, 64), k/v: (B, Skv, H, 64), o like q, all contiguous
// bf16, 16-byte aligned; gate: (B, H) f32 or null; lse: (B·H, Sq) f32 for the
// training forward, or null.
extern "C" int gated_flash_fwd(const void* q, const void* k, const void* v, const float* gate,
                               void* o, float* lse, int B, int H, int Sq, int Skv,
                               float scale_log2, void* stream) {
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  gated_flash_fwd_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), gate, static_cast<__nv_bfloat16*>(o), lse, H, Sq,
      Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int KV, bool kStream>
static int launch_fwd_wgmma(const void* q, const void* k, const void* v, const float* gate,
                            void* o, float* lse, int B, int H, int Sq, int Skv, float scale_log2,
                            cudaStream_t stream) {
  auto kernel = gated_flash_fwd_wgmma_kernel<KV, kStream>;
  static const cudaError_t opted = sm90::allow_smem(kernel, FwdTile<KV>::kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, 64) || !sm90::bshd_map(&kmap, k, B, Skv, H, KV) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int work = (Sq + kQRows - 1) / kQRows * B * H;
  kernel<<<std::min(work, sms), kFwdThreads, FwdTile<KV>::kSmem, stream>>>(
      qmap, kmap, vmap, gate, static_cast<__nv_bfloat16*>(o), lse, B, H, Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gated_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                     const float* gate, void* o, float* lse, int B, int H, int Sq,
                                     int Skv, float scale_log2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one kv tile a work tile (S_kv <= 80) has no tile to overlap inside a work
  // tile: there the pipeline runs on across work tiles; with several it
  // drains at each work tile's end, which measured faster at S_kv >= 1024
  if (Skv <= 80)
    return launch_fwd_wgmma<80, true>(q, k, v, gate, o, lse, B, H, Sq, Skv, scale_log2, s);
  return launch_fwd_wgmma<128, false>(q, k, v, gate, o, lse, B, H, Sq, Skv, scale_log2, s);
}
