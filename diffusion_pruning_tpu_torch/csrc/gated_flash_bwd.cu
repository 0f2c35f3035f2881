// Head-gated flash attention backward for Hopper (sm_90a): two kernels.
//
// Forward (gated_flash_fwd.cu), with g = gate[b, h] and q' = g·q, k' = g·k,
// v' = g·v:  O = softmax(q'·k'ᵀ·d^-½)·v' = g · softmax(q·kᵀ·d^-½·g²)·v.
// With P the probabilities, recomputed from the forward's lse, and
// δ = rowsum(dO ∘ O):
//
//   dP = dO·v'ᵀ = g·dO·vᵀ,  dS = P ∘ (dP − δ),
//   dq' = dS·k'·d^-½,  dk' = dSᵀ·q'·d^-½,  dv' = Pᵀ·dO,
//   dq = g·dq',  dk = g·dk',  dv = g·dv',
//   dgate = Σ dq'∘q + Σ dk'∘k + Σ dv'∘v   (per (b, h), over rows and head dim).
//
// Replaces the JAX package's Pallas backward kernels in
// diffusion_pruning_tpu/ops/flash_attention.py: `_flash_bwd_dq_kernel` (:586)
// and its head-pair-packed twin `_flash_bwd_dq_kernel2` (:686) become
// `gated_flash_bwd_dq`; `_flash_bwd_dkv_kernel` (:638) and
// `_flash_bwd_dkv_kernel2` (:741) become `gated_flash_bwd_dkv`. The packing
// only fit the TPU's 128-lane tiles. The TPU kernels accumulate dgate across
// their sequential grid in a revisited block; blocks of a CUDA grid run in no
// order, so here each block writes its own partial of dgate and the wrapper
// sums the partials with one small torch reduction (deterministic, no atomics).
//
// What bounds them on an H100: dq does 3 and dk/dv 4 products of 2·S_q·S_kv·64
// operations per (batch, head) against a few bytes per row, so at S >= 256 the
// tensor cores are the limit; at S_kv = 77 and the 16-token mid block the
// bytes of q, k, v, dO and the outputs are.
//
// Design (FlashAttention-2's two-kernel backward, a first version that is
// right and simple; wgmma, TMA and a fused single pass are a later version):
//  * dq: one block of 4 warps per (b·h, 64-row query tile), each warp 16 query
//    rows with its Q and dO fragments in registers, a loop over 64-row kv
//    tiles double-buffered with cp.async; it writes δ for the dk/dv kernel and
//    one dgate partial per block. O comes from the forward, so δ is one pass
//    over O and dO (the TPU kernel rebuilt O to keep it out of HBM; autograd
//    keeps it anyway).
//  * dk/dv: one block per (b·h, 64-row kv tile), each warp 16 kv rows with its
//    K and V fragments in registers, a loop over 64-row query tiles of Q, dO,
//    lse and δ; it works in the transposed score layout Sᵀ = K·Qᵀ.
//  * all products are mma.sync m16n8k16, bf16 in and f32 accumulate; P and dS
//    are rounded to bf16 just before their products (the JAX `_prob_in`).
//  * masking: kv columns past S_kv and query rows past S_q get P = 0 before
//    anything uses it; their tiles are zero-filled in shared memory (no read
//    runs past the end) and their rows are never stored, so they add nothing
//    to any output or dgate partial.
//  * a closed gate (g = 0) runs the full computation: dq = dk = dv = 0 there,
//    but dv' = Pᵀ·dO with uniform P is not 0, and Σ dv'∘v is the dgate that
//    trains the router through the straight-through estimator.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace gfa;

// dynamic shared memory of either kernel: six bf16 tiles and 256 floats (56,320 bytes)
constexpr int kBwdSmem = 6 * kTileElems * 2 + 4 * kBlock * 4;

__global__ void __launch_bounds__(kThreads)
    gated_flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ gate,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                              float* __restrict__ dgate_part, int H, int Sq, int Skv,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;  // two buffers
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // two buffers
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kTileElems);
  float* delta_s = lse_s + kBlock;
  __shared__ float red_s[kWarps];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * kBlock;
  const long row_stride = (long)H * kD;
  const long q_off = ((long)b * Sq * H + h) * kD;
  const long kv_off = ((long)b * Skv * H + h) * kD;
  const float g = gate != nullptr ? gate[bh] : 1.0f;
  const float sl2 = scale * kLog2e * g * g;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;

  load_tile(q_s, q + q_off, m0, Sq, row_stride, tid);
  load_tile(do_s, dout + q_off, m0, Sq, row_stride, tid);
  load_tile(k_s, k + kv_off, 0, Skv, row_stride, tid);
  load_tile(v_s, v + kv_off, 0, Skv, row_stride, tid);
  cp_async_commit();

  {  // δ = rowsum(dO ∘ O) and lse (log2 domain) of this tile's rows; 2 threads a row
    const int r = tid >> 1;
    const int row = m0 + r;
    float acc = 0.0f;
    if (row < Sq) {
      const long off = q_off + (long)row * row_stride + (tid & 1) * 32;
      const uint4* op = reinterpret_cast<const uint4*>(o + off);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 a = op[i];
        const uint4 c = dp[i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 af = __bfloat1622float2(a2[j]);
          const float2 cf = __bfloat1622float2(c2[j]);
          acc += af.x * cf.x + af.y * cf.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < Sq ? lse[(long)bh * Sq + row] * kLog2e : INFINITY;
      if (row < Sq) delta[(long)bh * Sq + row] = acc;
    }
  }

  uint32_t qf[4][4], df[4][4];
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
  float lse_r[2], delta_r[2];

  const int n_tiles = (Skv + kBlock - 1) / kBlock;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(k_s + (cur ^ 1) * kTileElems, k + kv_off, (j + 1) * kBlock, Skv, row_stride, tid);
      load_tile(v_s + (cur ^ 1) * kTileElems, v + kv_off, (j + 1) * kBlock, Skv, row_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    if (j == 0) {
      load_a_frags(qf, q_s, warp * 16, gr, tg);
      load_a_frags(df, do_s, warp * 16, gr, tg);
      lse_r[0] = lse_s[warp * 16 + gr];
      lse_r[1] = lse_s[warp * 16 + gr + 8];
      delta_r[0] = delta_s[warp * 16 + gr];
      delta_r[1] = delta_s[warp * 16 + gr + 8];
    }

    const __nv_bfloat16* ks = k_s + cur * kTileElems;
    float s[8][4], dp[8][4];
    mma_abt(s, qf, ks, gr, tg);                      // Q Kᵀ
    mma_abt(dp, df, v_s + cur * kTileElems, gr, tg);  // dO Vᵀ

    // dS = P ∘ (g·dO Vᵀ − δ), P = exp2(S·d^-½·g²·log2 e − lse₂), 0 past S_kv
    const int n0 = j * kBlock;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * tg + (e & 1);
        const float p = col < Skv ? exp2f(s[nt][e] * sl2 - lse_r[e >> 1]) : 0.0f;
        s[nt][e] = p * (dp[nt][e] * g - delta_r[e >> 1]);
      }
    }
    mma_ab(acc, s, ks, gr, tg);  // dq' · (d^-½·g)⁻¹ += dS K
    __syncthreads();
  }

  const float c = scale * g;  // dq' = c · acc, dq = g · dq'
  const float part = dot_acc_tile(acc, q_s, warp * 16, gr, tg);
  store_rows(dq + q_off, acc, c * g, m0 + warp * 16 + gr, Sq, row_stride, tg);
  const float total = block_sum(part, red_s, warp, lane);
  if (dgate_part != nullptr && tid == 0) dgate_part[(long)bh * gridDim.x + blockIdx.x] = c * total;
}

__global__ void __launch_bounds__(kThreads)
    gated_flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ gate, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, float* __restrict__ dgate_part,
                               int H, int Sq, int Skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;  // two buffers
  __nv_bfloat16* do_s = q_s + 2 * kTileElems;  // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // two buffers of 64
  float* delta_s = lse_s + 2 * kBlock;  // two buffers of 64
  __shared__ float red_s[kWarps];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.x * kBlock;
  const long row_stride = (long)H * kD;
  const long q_off = ((long)b * Sq * H + h) * kD;
  const long kv_off = ((long)b * Skv * H + h) * kD;
  const float* lse_b = lse + (long)bh * Sq;
  const float* delta_b = delta + (long)bh * Sq;
  const float g = gate != nullptr ? gate[bh] : 1.0f;
  const float sl2 = scale * kLog2e * g * g;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int kv_row = n0 + warp * 16 + gr;  // and kv_row + 8

  load_tile(k_s, k + kv_off, n0, Skv, row_stride, tid);
  load_tile(v_s, v + kv_off, n0, Skv, row_stride, tid);
  load_tile(q_s, q + q_off, 0, Sq, row_stride, tid);
  load_tile(do_s, dout + q_off, 0, Sq, row_stride, tid);
  cp_async_commit();
  if (tid < kBlock) {
    lse_s[tid] = tid < Sq ? lse_b[tid] * kLog2e : 0.0f;
    delta_s[tid] = tid < Sq ? delta_b[tid] : 0.0f;
  }

  uint32_t kf[4][4], vf[4][4];
  float adk[8][4], adv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.0f;
  }

  const int n_tiles = (Sq + kBlock - 1) / kBlock;
  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_tiles) {
      const int m1 = (i + 1) * kBlock;
      load_tile(q_s + (cur ^ 1) * kTileElems, q + q_off, m1, Sq, row_stride, tid);
      load_tile(do_s + (cur ^ 1) * kTileElems, dout + q_off, m1, Sq, row_stride, tid);
      if (tid < kBlock) {
        const bool in = m1 + tid < Sq;
        lse_s[(cur ^ 1) * kBlock + tid] = in ? lse_b[m1 + tid] * kLog2e : 0.0f;
        delta_s[(cur ^ 1) * kBlock + tid] = in ? delta_b[m1 + tid] : 0.0f;
      }
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    if (i == 0) {
      load_a_frags(kf, k_s, warp * 16, gr, tg);
      load_a_frags(vf, v_s, warp * 16, gr, tg);
    }

    const __nv_bfloat16* qs = q_s + cur * kTileElems;
    const __nv_bfloat16* dos = do_s + cur * kTileElems;
    const float* lse_t = lse_s + cur * kBlock;
    const float* delta_t = delta_s + cur * kBlock;
    float st[8][4], dpt[8][4];
    mma_abt(st, kf, qs, gr, tg);    // Sᵀ = K Qᵀ
    mma_abt(dpt, vf, dos, gr, tg);  // V dOᵀ

    // Pᵀ and dSᵀ; 0 for query columns past S_q and kv rows past S_kv
    const int m0 = i * kBlock;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tg + (e & 1);
        const bool in = m0 + col < Sq && kv_row + (e >> 1) * 8 < Skv;
        const float p = in ? exp2f(st[nt][e] * sl2 - lse_t[col]) : 0.0f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] * g - delta_t[col]);
      }
    }
    mma_ab(adv, st, dos, gr, tg);  // dv' += Pᵀ dO
    mma_ab(adk, dpt, qs, gr, tg);  // dk' · (d^-½·g)⁻¹ += dSᵀ Q
    __syncthreads();
  }

  const float c = scale * g;  // dk' = c · adk, dk = g · dk'; dv' = adv, dv = g · dv'
  const float part = c * dot_acc_tile(adk, k_s, warp * 16, gr, tg) +
                     dot_acc_tile(adv, v_s, warp * 16, gr, tg);
  store_rows(dk + kv_off, adk, c * g, kv_row, Skv, row_stride, tg);
  store_rows(dv + kv_off, adv, g, kv_row, Skv, row_stride, tg);
  const float total = block_sum(part, red_s, warp, lane);
  if (dgate_part != nullptr && tid == 0) dgate_part[(long)bh * gridDim.x + blockIdx.x] = total;
}

int set_smem(const void* kernel) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem));
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream`, never
// synchronises, allocates nothing, and returns the first CUDA error (0 if
// none). q/o/dout/dq: (B, Sq, H, 64), k/v/dk/dv: (B, Skv, H, 64), contiguous
// bf16; lse (natural log, from gated_flash_fwd) and delta: (B·H, Sq) f32;
// gate: (B, H) f32 or null; dgate_part: f32 (B·H, number of 64-row tiles of
// the kernel's grid), or null to skip the dgate partials.
extern "C" int gated_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, const float* gate,
                                  void* dq, float* delta, float* dgate_part, int B, int H,
                                  int Sq, int Skv, float scale, void* stream) {
  const int rc = set_smem(reinterpret_cast<const void*>(gated_flash_bwd_dq_kernel));
  if (rc != 0) return rc;
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  gated_flash_bwd_dq_kernel<<<grid, kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, gate, static_cast<__nv_bfloat16*>(dq), delta,
      dgate_part, H, Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gated_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   const float* gate, void* dk, void* dv, float* dgate_part,
                                   int B, int H, int Sq, int Skv, float scale, void* stream) {
  const int rc = set_smem(reinterpret_cast<const void*>(gated_flash_bwd_dkv_kernel));
  if (rc != 0) return rc;
  const dim3 grid((Skv + kBlock - 1) / kBlock, B * H);
  gated_flash_bwd_dkv_kernel<<<grid, kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      gate, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dgate_part, H, Sq,
      Skv, scale);
  return static_cast<int>(cudaGetLastError());
}
