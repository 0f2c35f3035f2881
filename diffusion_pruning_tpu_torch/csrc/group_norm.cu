// One-pass GroupNorm (+ optional SiLU) for Hopper (sm_90a).
//
//   y[b, p, c] = act((x[b, p, c] - mean[b, g]) · rsqrt(var[b, g] + eps) · scale[c] + bias[c])
//
// over NHWC activations (B, HW, C) in bf16 with G groups of C/G neighbouring
// channels, statistics over the (HW, C/G) slab of one (batch, group) in f32,
// act = SiLU or the identity, f32 scale and bias, bf16 out.
//
// Replaces `_gn_kernel` of the JAX package's
// diffusion_pruning_tpu/ops/group_norm.py. That body holds the whole (HW, C)
// row of one batch element in fast memory, on a grid of B, and finds the group
// statistics with one-hot matmuls; neither fits this card (B_eff = 16 rows
// would leave most of 132 SMs idle, and a row is far above a block's shared
// memory), so none of it is carried over.
//
// What bounds it on an H100: bytes. The least is one read and one write of
// the activation; there are ~10 operations per element.
//
// Design (a first version that is right and simple):
//  * one thread block per (batch, group) slab: B·G blocks (512 at B_eff = 16);
//  * the slab is HW runs of C/G bf16 values, C apart. A run is 20-160 bytes
//    and starts at a multiple of its own length, so the widest vector that
//    divides C/G (8, 4, 2 or 1 elements) is always aligned; the kernel is
//    instantiated for each width;
//  * the block copies the slab into shared memory while it sums it, then
//    takes the variance from the centred values on chip (two passes over
//    shared memory: more accurate than E[x²] − mean², never less), then
//    normalises out of shared memory: one read and one write of device memory;
//  * a slab too large for shared memory (64×64 × 30 channels at 512px is
//    245 KB) is read three times from device memory instead; the second and
//    third read mostly hit the 50 MB L2. It does not give way to another
//    implementation.
// A group of zeros (a hard-closed width gate) has variance exactly 0 and
// gives act(bias).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlabBytes = 200 * 1024;  // shared memory a slab may take

template <int V>
struct Vec {
  __nv_bfloat16 v[V];
};
template <>
struct __align__(4) Vec<2> {
  __nv_bfloat16 v[2];
};
template <>
struct __align__(8) Vec<4> {
  __nv_bfloat16 v[4];
};
template <>
struct __align__(16) Vec<8> {
  __nv_bfloat16 v[8];
};

// Sum of one float per thread over the block, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_silu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           int HW, int C, int G, float eps, int silu, int stash) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int cg = C / G;
  const int vpr = cg / V;          // vectors per run
  const int nv = HW * vpr;         // vectors in the slab
  const int g = blockIdx.x;
  const long base = (long)blockIdx.y * HW * C + (long)g * cg;
  float* sc = reinterpret_cast<float*>(smem);   // cg scale, then cg bias
  float* bi = sc + cg;
  Vec<V>* slab = reinterpret_cast<Vec<V>*>(smem + ((2 * cg * 4 + 15) / 16) * 16);
  for (int i = threadIdx.x; i < cg; i += kThreads) {
    sc[i] = scale[g * cg + i];
    bi[i] = bias[g * cg + i];
  }

  // pass 1: sum (and the copy into shared memory)
  float s = 0.0f;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const int r = i / vpr, j = i - r * vpr;
    const Vec<V> v = *reinterpret_cast<const Vec<V>*>(x + base + (long)r * C + j * V);
    if (stash) slab[i] = v;
#pragma unroll
    for (int e = 0; e < V; ++e) s += __bfloat162float(v.v[e]);
  }
  const float n = (float)HW * (float)cg;
  const float mean = block_sum(s, red) / n;  // its barriers also publish slab, sc and bi

  // pass 2: variance of the centred values
  float ss = 0.0f;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    Vec<V> v;
    if (stash) {
      v = slab[i];
    } else {
      const int r = i / vpr, j = i - r * vpr;
      v = *reinterpret_cast<const Vec<V>*>(x + base + (long)r * C + j * V);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = __bfloat162float(v.v[e]) - mean;
      ss += d * d;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / n + eps);

  // pass 3: normalise, affine, activation, store
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const int r = i / vpr, j = i - r * vpr;
    const long off = base + (long)r * C + j * V;
    const Vec<V> v = stash ? slab[i] : *reinterpret_cast<const Vec<V>*>(x + off);
    Vec<V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float y = (__bfloat162float(v.v[e]) - mean) * inv * sc[j * V + e] + bi[j * V + e];
      if (silu) y = y / (1.0f + __expf(-y));
      o.v[e] = __float2bfloat16(y);
    }
    *reinterpret_cast<Vec<V>*>(out + off) = o;
  }
}

template <int V>
int launch(const void* x, const float* scale, const float* bias, void* out, int B, int HW, int C,
           int G, float eps, int silu, cudaStream_t stream) {
  const int cg = C / G;
  const size_t affine = ((2 * cg * 4 + 15) / 16) * 16;
  const size_t slab = (size_t)HW * cg * 2;
  const int stash = slab <= (size_t)kMaxSlabBytes;
  const size_t bytes = affine + (stash ? slab : 0);
  auto kernel = group_norm_silu_kernel<V>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<dim3(G, B), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), scale, bias, static_cast<__nv_bfloat16*>(out), HW, C,
      G, eps, silu, stash);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, HW, C) bf16, contiguous, 16-byte aligned; scale, bias: (C,) f32.
extern "C" int group_norm_silu(const void* x, const float* scale, const float* bias, void* out,
                               int B, int HW, int C, int G, float eps, int silu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cg = C / G;
  if (cg % 8 == 0) return launch<8>(x, scale, bias, out, B, HW, C, G, eps, silu, s);
  if (cg % 4 == 0) return launch<4>(x, scale, bias, out, B, HW, C, G, eps, silu, s);
  if (cg % 2 == 0) return launch<2>(x, scale, bias, out, B, HW, C, G, eps, silu, s);
  return launch<1>(x, scale, bias, out, B, HW, C, G, eps, silu, s);
}
