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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBlockM = 64;     // query rows per block
constexpr int kBlockN = 64;     // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSRow = kD + 8;   // padded shared row: 144 bytes, conflict-free fragment reads

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slab into shared memory;
// rows at or past n_rows are zero-filled and their source is never read.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_rows, long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlockN * kD / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int ch = (c & 7) * 8;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* g = in ? src + (long)(row0 + r) * row_stride + ch : src;
    cp_async_16(dst + r * kSRow + ch, g, in);
  }
}

__global__ void __launch_bounds__(kThreads)
    gated_flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ gate, __nv_bfloat16* __restrict__ o,
                                int H, int Sq, int Skv, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockM * kSRow];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBlockN * kSRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBlockN * kSRow];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * kBlockM;
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

  const int n_tiles = (Skv + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(k_s[cur ^ 1], kb, (j + 1) * kBlockN, Skv, row_stride, tid);
      load_tile(v_s[cur ^ 1], vb, (j + 1) * kBlockN, Skv, row_stride, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // everything but the prefetch just issued has landed
    __syncthreads();

    if (j == 0) {
      const __nv_bfloat16* q0 = q_s + (warp * 16 + gr) * kSRow + 2 * tg;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = ld_u32(q0 + kk * 16);
        qf[kk][1] = ld_u32(q0 + 8 * kSRow + kk * 16);
        qf[kk][2] = ld_u32(q0 + kk * 16 + 8);
        qf[kk][3] = ld_u32(q0 + 8 * kSRow + kk * 16 + 8);
      }
    }

    // S = Q Kᵀ for this warp's 16 rows × 64 kv columns (8 n-tiles of 8)
    const __nv_bfloat16* ks = k_s[cur];
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const __nv_bfloat16* k0 = ks + (nt * 8 + gr) * kSRow + 2 * tg;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t bf[2] = {ld_u32(k0 + kk * 16), ld_u32(k0 + kk * 16 + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // scale, mask the kv tail, running row max (rows gr and gr + 8)
    const int n0 = j * kBlockN;
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

    // O += P V: P's accumulator layout for n-tiles (2kk, 2kk+1) is the A
    // fragment of k-block kk; V fragments are gathered from shared memory
    const __nv_bfloat16* vs = v_s[cur];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = vs + (kk * 16 + 2 * tg) * kSRow + gr;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vp = v0 + nt * 8;
        const uint32_t bf[2] = {pack_bf16(vp[0], vp[kSRow]),
                                pack_bf16(vp[8 * kSRow], vp[9 * kSRow])};
        mma_16816(acc[nt], pa, bf);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites the buffer read here
  }

  const float inv0 = g / l_run[0];
  const float inv1 = g / l_run[1];
  const int row0 = m0 + warp * 16 + gr;
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + (long)row0 * row_stride + col) =
          pack_f32(acc[nt][0] * inv0, acc[nt][1] * inv0);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + (long)row1 * row_stride + col) =
          pack_f32(acc[nt][2] * inv1, acc[nt][3] * inv1);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. Launches on `stream`, never synchronises,
// allocates nothing, and returns cudaGetLastError() after the launch.
// q: (B, Sq, H, 64), k/v: (B, Skv, H, 64), o like q, all contiguous bf16;
// gate: (B, H) f32 or null.
extern "C" int gated_flash_fwd(const void* q, const void* k, const void* v, const float* gate,
                               void* o, int B, int H, int Sq, int Skv, float scale_log2,
                               void* stream) {
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  gated_flash_fwd_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), gate, static_cast<__nv_bfloat16*>(o), H, Sq, Skv,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}
