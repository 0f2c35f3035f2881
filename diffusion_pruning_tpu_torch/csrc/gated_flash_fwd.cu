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
// Two kernels, chosen by `forward_plan` in ops/flash_attention.py (the
// wrappers `gated_flash_attention` and `gated_flash_forward_lse`):
//
// gated_flash_fwd_wgmma (S_q > 64, or S_kv > 80):
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
// gated_flash_fwd_small (S_q <= 64 and S_kv <= 80: the 64- and 16-token
// blocks, 12 of the 32 sites of a 256px U-Net forward). There the work is
// a few µs of latency, not throughput: at B_eff 16 the 320 items (b·h)
// move 0.65-11 MB, and a block that runs load → products → store once is
// the whole kernel. So:
//  * an item is one b·h, all its S_q query rows in one 64-row tile, its kv
//    side in one tile of 16, 64 or 80 rows (the least that holds S_kv:
//    `forward_plan`), so there is no online rescale;
//  * each consumer warpgroup takes whole items of its own; two blocks (two
//    consumer warpgroups and a producer warp each) fit an SM, so at B_eff 16
//    every item has a warpgroup to itself and every load is issued at once;
//  * the TMA boxes are S_q rows of Q and S_kv rows of K and V: S_q = 16 moves
//    16 rows, not 64, and S_kv = 16 is a 16-row tile (m64n16 products);
//  * S = Q Kᵀ (SS-wgmma m64nKVk16), the one-tile softmax on the
//    accumulators, P re-packed into A registers, O = P V (RS-wgmma
//    m64n64k16), as above;
//  * O leaves through stmatrix into a 128-byte-swizzled tile and one 4-D TMA
//    store of S_q rows (4-byte stores from registers, as the first version
//    made them, were slower at the 64-row shapes).
// What is left (PERF.md §6) is one chain of launch, load, products and
// store per SM; the kv tile's size sets the products' share.
//
// Training forward: with a non-null `lse`, either kernel also writes one f32
// per (b·h, query row), the log-sum-exp of that row's logits q·kᵀ·d^-½·g² in
// the NATURAL log, (m + log2 l)·ln 2 from the online-softmax state it keeps
// in the log2 domain. gated_flash_bwd.cu reads it back as lse·log2(e). A null
// `lse` is the inference launch.

#include <math.h>

#include <algorithm>

#include "sm90_common.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;  // head dim
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------- wgmma forward, S_q <= 64

constexpr int kSmallThreads = 2 * 128 + 32;  // two consumer warpgroups, then a producer warp

// An item set (Q, K and V of one b·h) of the S_q <= 64 forward with kv tile KV.
template <int KV>
struct SmallTile {
  static constexpr int kKV = KV * kD * 2;       // one K or V tile
  static constexpr int kSet = kBox + 2 * kKV;   // Q | K | V
  // a set per consumer warpgroup | an O tile per warpgroup | full and empty barriers
  static constexpr int kSmem = 1024 + 2 * kSet + 2 * kBox + 4 * 8;
  static_assert(KV % 16 == 0 && kKV % 1024 == 0, "whole k16 steps and swizzle atoms");
};

// Persistent: block blk walks the items (b·h; one query tile of S_q <= 64
// rows each) blk, blk + gridDim.x, …; its items 0, 2, 4, … go to consumer
// warpgroup 0, 1, 3, 5, … to warpgroup 1, each a whole item with both
// products, so the two never wait for each other. The producer warp's
// first lane loads each warpgroup's next item set (Q, K, V) once the
// warpgroup is done with its last one. Boxes are S_q rows of Q and S_kv
// rows of K and V (S_kv <= KV): no row past the sequence is moved; the
// tile's rows past the box keep the zeros written at the start (V's must be
// finite, as P = 0 multiplies them). Two blocks fit an SM (registers and
// shared memory). More sets a warpgroup in flight measured slower at every
// probed shape (PERF.md §6).
template <int KV>
__global__ void __launch_bounds__(kSmallThreads, 2)
    gated_flash_fwd_small_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const float* __restrict__ gate, float* __restrict__ lse, int B,
                                 int H, int Sq, int Skv, float scale_log2) {
  using T = SmallTile<KV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  auto set = [&](int wg) { return base + wg * T::kSet; };
  const uint32_t o_s = base + 2 * T::kSet;  // O tiles of warpgroups 0, 1
  const uint32_t bars = o_s + 2 * kBox;
  auto full = [&](int wg) { return bars + 8 * wg; };
  auto empty = [&](int wg) { return bars + 8 * (2 + wg); };
  const int n_work = B * H;

  if (threadIdx.x == 256) {
    for (int wg = 0; wg < 2; ++wg) {
      sm90::mbar_init(full(wg), 1);
      sm90::mbar_init(empty(wg), 4);  // one arrival per warp of its warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: its first lane issues every load
    if (threadIdx.x == 256) {
      const uint32_t bytes = (Sq + 2 * Skv) * kD * 2;
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int b = w / H, h = w - b * H;
        const int wg = i & 1, li = i >> 1;
        const uint32_t s0 = set(wg);
        sm90::mbar_wait(empty(wg), (li & 1) ^ 1);
        sm90::mbar_expect_tx(full(wg), bytes);
        sm90::tma_load_4d(s0, &qmap, full(wg), 0, h, 0, b);
        sm90::tma_load_4d(s0 + kBox, &kmap, full(wg), 0, h, 0, b);
        sm90::tma_load_4d(s0 + kBox + T::kKV, &vmap, full(wg), 0, h, 0, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;  // consumer thread 0 … 255
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const bool leader = (tid & 127) == 0;  // issues and waits for the warpgroup's O stores
  const uint32_t o_tile = o_s + wg * kBox;
  // this lane's stmatrix row of the O tile (matrix lane / 8: rows + 8·(lane / 8 % 2),
  // columns + 8·(lane / 16)) and its 128-byte swizzle
  const uint32_t o_row = o_tile + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 128;
  const int o_sw = lane & 7, o_half = lane >> 4;

  // zeros in the rows no box writes: Q's past S_q (rows that are computed and
  // never stored) and V's past S_kv, in this warpgroup's set
  const uint32_t qs = set(wg), ks = qs + kBox, vs = ks + T::kKV;
  for (int c = Sq * 8 + (tid & 127); c < 64 * 8; c += 128) sm90::sts_zero16(qs + 16 * c);
  for (int c = Skv * 8 + (tid & 127); c < KV * 8; c += 128) sm90::sts_zero16(vs + 16 * c);
  sm90::fence_proxy_async();
  sm90::named_barrier(2 + wg, 128);

  float s[KV / 2];          // S, then the probabilities
  float acc[32];            // O: 8 column blocks of 8 head dims × (rows gr, gr + 8)
  uint32_t pa[KV / 16][4];  // P rounded to bf16: the A fragments of P V
  float alpha[2];

  for (int i = wg, w = blockIdx.x + wg * gridDim.x; w < n_work; i += 2, w += 2 * gridDim.x) {
    const int li = i >> 1;
    const int b = w / H, h = w - b * H;
    const float g = gate != nullptr ? gate[w] : 1.0f;
    const float sl2 = scale_log2 * g * g;  // logits in the log2 domain: d^-½ · g² · log2(e)
    sm90::mbar_wait(full(wg), li & 1);

    // S = Q Kᵀ: four 16-deep steps over the head dim
    const uint64_t desc_q = sm90::desc_sw128(qs, 16, 1024);
    const uint64_t desc_k = sm90::desc_sw128(ks, 16, 1024);
    sm90::fence_regs<KV / 2>(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaSS<KV>::mma(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<KV / 2>(s);

    // the softmax of one tile: no running state to rescale; columns past
    // S_kv (stale K rows) get probability 0
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    if (Skv < KV) {
      softmax_tile<true>(s, alpha, m_run, l_run, sl2, 2 * tg, Skv);
    } else {
      softmax_tile<false>(s, alpha, m_run, l_run, sl2, 2 * tg, Skv);
    }
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      pa[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O = P V: KV / 16 16-deep steps over the kv rows, V through the transposed-B form
    const uint64_t desc_v = sm90::desc_sw128(vs, 16, 1024);
    sm90::fence_regs<32>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      sm90::WgmmaRS<64, 1>::mma(acc, pa[kk], desc_v + 128 * kk, kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(acc);
    sm90::fence_regs<KV / 4>(&pa[0][0]);
    if (lane == 0) sm90::mbar_arrive(empty(wg));  // this warp is done with Q, K and V

    // O · g / l rounded to bf16 into the warpgroup's O tile (stmatrix, in the
    // 128-byte swizzle of the map), then one TMA store of its S_q rows, which
    // runs on beside the next item
    const float inv[2] = {g / l_run[0], g / l_run[1]};
    if (leader) sm90::bulk_wait_read();  // the tile's previous store has read it
    sm90::named_barrier(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t p[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        p[2 * q] = pack_f32(acc[4 * (j + q)] * inv[0], acc[4 * (j + q) + 1] * inv[0]);
        p[2 * q + 1] = pack_f32(acc[4 * (j + q) + 2] * inv[1], acc[4 * (j + q) + 3] * inv[1]);
      }
      sm90::stmatrix_x4(o_row + (((j + o_half) ^ o_sw) << 4), p[0], p[1], p[2], p[3]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(2 + wg, 128);
    if (leader) {
      sm90::tma_store_4d(&omap, o_tile, 0, h, 0, b);
      sm90::bulk_commit();
    }
    if (lse != nullptr && tg == 0) {  // the quad holds equal m/l after its shuffles
      const int row0 = warp * 16 + gr;
      float* lb = lse + (long)w * Sq;
      if (row0 < Sq) lb[row0] = (m_run[0] + log2f(l_run[0])) * kLn2;
      if (row0 + 8 < Sq) lb[row0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
    }
  }
  if (leader) sm90::bulk_wait_read();  // the tile stays until its last store has read it
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream`, never
// synchronises, allocates nothing, and returns cudaGetLastError() after the
// launch. q: (B, Sq, H, 64), k/v: (B, Skv, H, 64), o like q, all contiguous
// bf16, 16-byte aligned; gate: (B, H) f32 or null; lse: (B·H, Sq) f32 for the
// training forward, or null.
template <int KV, bool kStream>
static int launch_fwd_wgmma(const void* q, const void* k, const void* v, const float* gate,
                            void* o, float* lse, int B, int H, int Sq, int Skv, int blocks,
                            float scale_log2, cudaStream_t stream) {
  auto kernel = gated_flash_fwd_wgmma_kernel<KV, kStream>;
  static const cudaError_t opted = sm90::allow_smem(kernel, FwdTile<KV>::kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, 64) || !sm90::bshd_map(&kmap, k, B, Skv, H, KV) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kFwdThreads, FwdTile<KV>::kSmem, stream>>>(
      qmap, kmap, vmap, gate, static_cast<__nv_bfloat16*>(o), lse, B, H, Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Work tiles of 128 query rows; `blocks` persistent blocks, at most the work
// tiles (`forward_plan`).
extern "C" int gated_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                     const float* gate, void* o, float* lse, int B, int H, int Sq,
                                     int Skv, int blocks, float scale_log2, void* stream) {
  if (blocks < 1 || blocks > (Sq + kQRows - 1) / kQRows * B * H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one kv tile a work tile (S_kv <= 80) has no tile to overlap inside a work
  // tile: there the pipeline runs on across work tiles; with several it
  // drains at each work tile's end, which measured faster at S_kv >= 1024
  if (Skv <= 80)
    return launch_fwd_wgmma<80, true>(q, k, v, gate, o, lse, B, H, Sq, Skv, blocks, scale_log2, s);
  return launch_fwd_wgmma<128, false>(q, k, v, gate, o, lse, B, H, Sq, Skv, blocks, scale_log2,
                                      s);
}

template <int KV>
static int launch_fwd_small(const void* q, const void* k, const void* v, const float* gate,
                            void* o, float* lse, int B, int H, int Sq, int Skv, int blocks,
                            float scale_log2, cudaStream_t stream) {
  auto kernel = gated_flash_fwd_small_kernel<KV>;
  static const cudaError_t opted = sm90::allow_smem(kernel, SmallTile<KV>::kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap, omap;
  if (!sm90::bshd_map(&qmap, q, B, Sq, H, Sq) || !sm90::bshd_map(&kmap, k, B, Skv, H, Skv) ||
      !sm90::bshd_map(&vmap, v, B, Skv, H, Skv) || !sm90::bshd_map(&omap, o, B, Sq, H, Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kSmallThreads, SmallTile<KV>::kSmem, stream>>>(qmap, kmap, vmap, omap, gate,
                                                                  lse, B, H, Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// S_q <= 64 and S_kv <= kv_tile (16, 64 or 80): items of one b·h, `blocks`
// persistent blocks, at most B·H (`forward_plan`; two fit an SM).
extern "C" int gated_flash_fwd_small(const void* q, const void* k, const void* v,
                                     const float* gate, void* o, float* lse, int B, int H, int Sq,
                                     int Skv, int kv_tile, int blocks, float scale_log2,
                                     void* stream) {
  if (Sq > 64 || Skv > kv_tile || blocks < 1 || blocks > B * H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_tile) {
    case 16:
      return launch_fwd_small<16>(q, k, v, gate, o, lse, B, H, Sq, Skv, blocks, scale_log2, s);
    case 64:
      return launch_fwd_small<64>(q, k, v, gate, o, lse, B, H, Sq, Skv, blocks, scale_log2, s);
    case 80:
      return launch_fwd_small<80>(q, k, v, gate, o, lse, B, H, Sq, Skv, blocks, scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
