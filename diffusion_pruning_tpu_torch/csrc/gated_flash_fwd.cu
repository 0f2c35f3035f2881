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
// and `_attn_kernel1_kv` (kv-blocked online softmax at S_kv >= 2048). Their
// head-pair packing, odd-head split and VMEM block sizing only fit the math to
// the TPU's 128-lane tiles; none of it is carried over.
//
// What bounds it on an H100: at S >= 256 the two products dominate
// (4·S_q·S_kv·64 FLOPs per (batch, head) against 256·S bytes of q/k/v/o), far
// above the card's ~295 FLOP/byte balance point, so the tensor cores are the
// limit. Cross-attention (S_kv = 77) and the 16-token mid block do few FLOPs
// per byte and are bounded by reading q and writing o.
//
// Design (FlashAttention-2 style, a first version that is right and simple):
//  * one thread block of 4 warps per (b·h, 64-row query tile); each warp owns
//    16 query rows, its Q fragments stay in registers for the whole kv loop;
//  * K/V tiles of 64 rows are staged in padded shared memory with cp.async,
//    double-buffered so the next tile loads while this one is multiplied;
//  * S = Q Kᵀ and O += P V run on the tensor cores through mma.sync
//    m16n8k16 (bf16 in, f32 accumulate); P is re-packed from the S
//    accumulator registers into A fragments without touching shared memory;
//  * the online-softmax statistics (row max, row sum) and the output stay in
//    f32 registers; the gate folds into the logit scale (g²) and the final
//    1/l factor (g), so it costs nothing;
//  * kv columns past S_kv get -inf before the row max, K/V rows past S_kv are
//    zero-filled in shared memory (no read runs past S_kv), query rows past
//    S_q are computed on zeros and never stored.
// wgmma and TMA are left for a later version.
//
// Training forward: with a non-null `lse`, the kernel also writes one f32 per
// (b·h, query row), the log-sum-exp of that row's logits q·kᵀ·d^-½·g² in the
// NATURAL log, (m + log2 l)·ln 2 from the online-softmax state it keeps in the
// log2 domain. It is the lse of the JAX package's training forwards
// (`_attn_kernel` and `_attn_kernel2` with an lse output); gated_flash_bwd.cu
// reads it back as lse·log2(e). A null `lse` is the inference launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace gfa;

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

}  // namespace

// C interface, loaded with ctypes. Launches on `stream`, never synchronises,
// allocates nothing, and returns cudaGetLastError() after the launch.
// q: (B, Sq, H, 64), k/v: (B, Skv, H, 64), o like q, all contiguous bf16;
// gate: (B, H) f32 or null; lse: (B·H, Sq) f32 for the training forward, or null.
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
