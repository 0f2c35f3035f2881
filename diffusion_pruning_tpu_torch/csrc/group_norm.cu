// One-pass GroupNorm (+ optional SiLU) for Hopper (sm_90a), on a thread-block
// cluster.
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
// the activation; there are ~10 operations per element. The first version
// (one block a (batch, group) slab, the group's strided runs of C/G values
// read with 2-16-byte loads, a slab above 200 KB read three times) reached
// 0.26-1.4 TB/s of the card's 3.35 (PERF.md §6).
//
// Design (the plan is chosen per shape in Python by `group_norm_plan` of
// ops/group_norm.py: the window, the cluster size, the rows a block):
//  * a block owns a channel WINDOW of whole groups whose channels make a
//    multiple of 16 bytes, at most 256 channels (multiples of 40 channels at
//    C/G = 10, 20 and 40, of 80 at 80, of 120 at 30 and 60), over a range
//    of pixel rows, so each pixel's window is one contiguous run;
//  * the rows of one (batch, window) slab are split over the blocks of a
//    thread-block cluster (1-8), each holding its part in its own shared
//    memory: its rows arrive by TMA as 2-D boxes (window × up to 256 rows),
//    all issued at once, one mbarrier a box, so a block keeps its whole part
//    in flight and starts summing as the first box lands; a part of at most
//    40 KB is read by pass 1's 16-byte loads instead (measured on the H100:
//    there the TMA set-up and latency cost more than they save);
//  * statistics in two passes over shared memory: each thread sums its own
//    eight channels over its rows, the sums are reduced per channel and then
//    per group in a fixed order (a window of one group: one block-wide sum),
//    and the blocks of the cluster read each other's group sums through
//    distributed shared memory, in rank order (every block gets the same
//    bits), behind cluster barriers: first the mean, then the centred sum of
//    squares (more accurate than E[x²] − mean², never less). Each block then
//    normalises its rows out of shared memory and writes them: one read and
//    one write of device memory;
//  * a shape the plan cannot hold in a cluster's shared memory (no window of
//    at most 256 channels, or a part above 227 KB) takes the same kernel's
//    other path: the rows are read from device memory in each of the three
//    passes, with the widest vector that divides the window.
// SiLU is y / (1 + exp(−y)), the sigmoid form of the body it replaces, on the
// special-function unit's 2^x and 1/x with denormals flushed (relative error
// about 2^-21, far below the bf16 rounding that follows). A block runs 512
// threads where it holds 64 KB or more (16 warps where one block fills a SM,
// as at the 512px slab), else 256, where a block's fixed costs weigh more.
// A group of zeros (a hard-closed width gate) has variance exactly 0 and
// gives act(bias).

#include <cstring>

#include "sm90_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // a block: 256 or 512 threads (the plan's)
constexpr int kMaxGroups = 256;   // groups a window holds at most (C/G >= 1, 256 channels)
constexpr int kSmemLimit = 232448;  // 227 KB: what one block may take
// how a block's rows reach shared memory: not kept (read from device memory
// in every pass), TMA boxes, or 16-byte loads by pass 1
constexpr int kStashNone = 0, kStashTma = 1, kStashLoads = 2;

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

// y / (1 + exp(−y)) on the special-function unit's 2^x and 1/x (flush to
// zero: exp(−y) below 2^-126 is 0, above 2^128 infinite, and y / inf = −0)
__device__ __forceinline__ float silu_ftz(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return y * r;
}

// a vector of a stashed row, from its shared-memory address (V = 8: 16 bytes)
template <int V>
__device__ __forceinline__ Vec<V> ld_vec(uint32_t addr) {
  Vec<V> v;
  if constexpr (V == 8) {
    uint4 r;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "r"(addr));
    v = *reinterpret_cast<const Vec<V>*>(&r);
  } else {
    v = *reinterpret_cast<const Vec<V>*>(__cvta_shared_to_generic(addr));
  }
  return v;
}

template <int V>
__device__ __forceinline__ void st_vec(uint32_t addr, const Vec<V>& v) {
  if constexpr (V == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(&v);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r.x), "r"(r.y),
                 "r"(r.z), "r"(r.w)
                 : "memory");
  } else {
    *reinterpret_cast<Vec<V>*>(__cvta_shared_to_generic(addr)) = v;
  }
}

__host__ __device__ inline int box_stride(int window, int box_rows) {
  return (box_rows * window * 2 + 127) / 128 * 128;
}

// shared memory of one block: the boxes of its rows (stash), the per-thread
// partial sums, the per-channel sums, the group sums exchanged in the
// cluster and the statistics, one mbarrier a box
__host__ __device__ inline int smem_bytes(int window, int rows, int box_rows, int stash,
                                          int threads) {
  const int boxes = stash ? (rows + box_rows - 1) / box_rows : 0;
  return 128 + boxes * box_stride(window, box_rows) +
         (threads * 8 + (window + 31) / 32 * 32 + 4 * kMaxGroups) * 4 + boxes * 8;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
    group_norm_silu_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           int HW, int C, int G, float eps, int silu, int window, int cluster,
                           int rows, int box_rows, int stash) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = sm90::smem_u32(smem_raw);
  uint8_t* sm = smem_raw + ((128 - (raw_s & 127)) & 127);
  const int cg = C / G;
  const int groups = window / cg;  // groups in the window
  const int win = blockIdx.x / cluster;
  const uint32_t rank = sm90::cluster_rank();
  const int bi = blockIdx.y;
  const int r0 = rank * rows;
  const int nrows = max(0, min(HW, r0 + rows) - r0);
  const int c0 = win * window;
  const long base = ((long)bi * HW + r0) * C + c0;
  const int stride = box_stride(window, box_rows);
  const int boxes = stash ? (rows + box_rows - 1) / box_rows : 0;
  uint8_t* slab = sm;
  float* red = reinterpret_cast<float*>(sm + boxes * stride);
  const int nt = blockDim.x;
  float* csum = red + nt * 8;
  float* gs1 = csum + (window + 31) / 32 * 32;  // group sums, read by the cluster
  float* gs2 = gs1 + kMaxGroups;                // centred sums of squares, likewise
  float* mean_s = gs2 + kMaxGroups;
  float* inv_s = mean_s + kMaxGroups;
  const uint32_t bars = sm90::smem_u32(inv_s + kMaxGroups);
  const uint32_t slab_s = sm90::smem_u32(slab);
  const int my_boxes = stash ? (nrows + box_rows - 1) / box_rows : 0;

  if (stash == kStashTma && threadIdx.x == 0) {
    for (int k = 0; k < my_boxes; ++k) sm90::mbar_init(bars + 8 * k, 1);
    sm90::fence_barrier_init();
    for (int k = 0; k < my_boxes; ++k) {
      sm90::mbar_expect_tx(bars + 8 * k, box_rows * window * 2);
      sm90::tma_load_3d(slab_s + k * stride, &xmap, bars + 8 * k, c0, r0 + k * box_rows, bi);
    }
  }
  __syncthreads();

  // this thread's vectors: column j0 (V channels) of rows rr, rr + rpi, …
  // (thread rr·vpr + j0: a warp covers consecutive vectors of consecutive
  // rows); where a row has more vectors than the block has threads (a
  // window of one group, `wide`), columns j0, j0 + nt, … of every row
  const int vpr = window / V;
  const bool wide = vpr > nt;
  const int rpi = wide ? 1 : nt / vpr;
  const int rr = wide ? 0 : threadIdx.x / vpr;
  const int j0 = wide ? threadIdx.x : threadIdx.x % vpr;
  const int jstep = wide ? nt : vpr;
  const bool active = rr < rpi;
  int ge[V];  // the group (in the window) of each of this thread's channels
#pragma unroll
  for (int e = 0; e < V; ++e) ge[e] = wide ? 0 : min((j0 * V + e) / cg, groups - 1);
  // scale and bias of those channels, fetched while the boxes land
  float sc0[V], bi0[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = c0 + min(j0, vpr - 1) * V + e;
    sc0[e] = __ldg(scale + c);
    bi0[e] = __ldg(bias + c);
  }

  // f(row, v) for each of this thread's rows of column j, in order; in a
  // stashed slab (V = 8) the box and the row in it advance without a
  // division, and with `land` each box is waited for as the rows reach it
  int landed = 0;
  auto for_rows = [&](int j, bool land, auto&& f) {
    int k = rr / box_rows, rin = rr - k * box_rows;
    for (int row = rr; row < nrows; row += rpi) {
      Vec<V> v;
      if (stash) {
        const uint32_t at = slab_s + k * stride + (rin * window + j * V) * 2;
        if (land && stash == kStashLoads) {  // pass 1 reads x and keeps it
          v = *reinterpret_cast<const Vec<V>*>(x + base + (long)row * C + j * V);
          st_vec<V>(at, v);
        } else {
          if (land)
            for (; landed <= k; ++landed) sm90::mbar_wait(bars + 8 * landed, 0);
          v = ld_vec<V>(at);
        }
        for (rin += rpi; rin >= box_rows; rin -= box_rows) ++k;
      } else {
        v = *reinterpret_cast<const Vec<V>*>(x + base + (long)row * C + j * V);
      }
      f(row, v);
    }
  };

  // per-thread partial sums -> this block's sum of each group of the
  // window, in a fixed order, into gs
  auto reduce = [&](float (&p)[V], float* gs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // vpr <= 32: the lanes of one column (vpr apart) add up in a tree of
    // shuffles, and lanes 0 … vpr − 1 leave the warp's sums, one slot a
    // warp; vpr > 32: one slot a row of threads. At most 16 slots, added
    // slot by slot.
    const bool tree = vpr <= 32;
    if (tree) {
      for (int d = vpr; d < 32; d <<= 1)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float o = __shfl_down_sync(0xffffffffu, p[e], d);
          if (lane + d < 32) p[e] += o;
        }
    }
    const int slot = tree ? warp : rr;
    const int slots = tree ? nt / 32 : rpi;
    if (tree ? lane < vpr : active)  // (an idle lane leaves its zeros)
#pragma unroll
      for (int e = 0; e < V; ++e) red[slot * window + j0 * V + e] = p[e];
    __syncthreads();
    for (int c = threadIdx.x; c < window; c += nt) {
      float t = 0.0f;
      for (int q = 0; q < slots; ++q) t += red[q * window + c];
      csum[c] = t;
    }
    __syncthreads();
    // a warp a group: lanes add channels lane, lane + 32, …, then a
    // shuffle tree (a fixed order)
    for (int g = warp; g < groups; g += nt / 32) {
      float t = 0.0f;
      for (int c = lane; c < cg; c += 32) t += csum[g * cg + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) gs[g] = t;
    }
  };
  // a window of one group (C/G a multiple of 8, or wider than a block's
  // threads): the block's sum in every thread, by one shuffle tree a warp
  // and the warps' sums added in order; `buf` alternates between the two
  // statistics so that no barrier guards `red` from the next use
  auto block_total = [&](const float (&p)[V], int buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float t = 0.0f;
#pragma unroll
    for (int e = 0; e < V; ++e) t += p[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) red[buf * 32 + warp] = t;
    __syncthreads();
    float s = 0.0f;
    for (int w = 0; w < nt / 32; ++w) s += red[buf * 32 + w];
    return s;
  };
  // the cluster's sum of group g, block by block in rank order (a cluster
  // of one: this block's own)
  auto cluster_sum = [&](const float* gs, int g) {
    if (cluster == 1) return gs[g];
    const uint32_t addr = sm90::smem_u32(gs + g);
    float t = 0.0f;
    for (int q = 0; q < cluster; ++q) t += sm90::ld_cluster_f32(addr, q);
    return t;
  };
  // every block of the cluster has published its group sums (a cluster of
  // one: this block's threads)
  auto cluster_sync = [&]() {
    if (cluster == 1) {
      __syncthreads();
    } else {
      sm90::cluster_arrive();
      sm90::cluster_wait();
    }
  };
  const float n = (float)HW * (float)cg;

  // pass 1: sums (the boxes are waited for as the rows reach them)
  float p[V];
#pragma unroll
  for (int e = 0; e < V; ++e) p[e] = 0.0f;
  if (active) {
    for (int j = j0; j < vpr; j += jstep) {
      for_rows(j, true, [&](int, const Vec<V>& v) {
#pragma unroll
        for (int e = 0; e < V; ++e) p[e] += __bfloat162float(v.v[e]);
      });
    }
  }
  // the statistics of each group: the cluster's sum over its blocks in
  // rank order, finished (a window of one group in a cluster of one: every
  // thread has it from block_total, and writes it where pass 2 and 3 read)
  const bool one = groups == 1;
  auto statistic = [&](float (&p)[V], float* gs, float* out_s, int buf, auto&& finish) {
    if (one && cluster == 1) {
      out_s[0] = finish(block_total(p, buf));  // the same value from every thread
      return;
    }
    if (one) {
      const float t = block_total(p, buf);
      if (threadIdx.x == 0) gs[0] = t;
    } else {
      reduce(p, gs);
    }
    cluster_sync();
    for (int g = threadIdx.x; g < groups; g += nt) out_s[g] = finish(cluster_sum(gs, g));
    __syncthreads();
  };
  statistic(p, gs1, mean_s, 0, [&](float t) { return t / n; });

  // pass 2: centred sums of squares
  float m[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean_s[ge[e]];
    p[e] = 0.0f;
  }
  if (active) {
    for (int j = j0; j < vpr; j += jstep) {
      for_rows(j, false, [&](int, const Vec<V>& v) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __bfloat162float(v.v[e]) - m[e];
          p[e] += d * d;
        }
      });
    }
  }
  statistic(p, gs2, inv_s, 1, [&](float t) { return rsqrtf(t / n + eps); });
  // this block is done reading the others' shared memory; they may leave
  // once every block has said so (the wait below, before exit)
  if (cluster > 1) sm90::cluster_arrive();

  // pass 3: normalise, affine, activation, store
  if (active) {
    for (int j = j0; j < vpr; j += jstep) {
      // y = x·a + sh with a = inv·scale, sh = bias − mean·a
      float a[V], sh[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = c0 + j * V + e;
        a[e] = inv_s[ge[e]] * (j == j0 ? sc0[e] : __ldg(scale + c));
        sh[e] = (j == j0 ? bi0[e] : __ldg(bias + c)) - m[e] * a[e];
      }
      for_rows(j, false, [&](int row, const Vec<V>& v) {
        Vec<V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float y = __bfloat162float(v.v[e]) * a[e] + sh[e];
          if (silu) y = silu_ftz(y);
          o.v[e] = __float2bfloat16(y);
        }
        *reinterpret_cast<Vec<V>*>(out + base + (long)row * C + j * V) = o;
      });
    }
  }
  if (cluster > 1) sm90::cluster_wait();
}

template <int V>
int launch(const void* x, const float* scale, const float* bias, void* out, int B, int HW, int C,
           int G, float eps, int silu, int window, int cluster, int rows, int box_rows, int stash,
           int threads, cudaStream_t stream) {
  auto kernel = group_norm_silu_kernel<V>;
  static const cudaError_t opted = sm90::allow_smem(kernel, kSmemLimit);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int bytes = smem_bytes(window, rows, box_rows, stash, threads);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  // x as (B, HW, C): a box is `window` channels × `box_rows` rows of one element
  if (stash == kStashTma) {
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)HW * C * 2};
    const cuuint32_t box[3] = {(cuuint32_t)window, (cuuint32_t)box_rows, 1};
    if (!sm90::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_NONE, x,
                          3, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C / window) * cluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, xmap, static_cast<const __nv_bfloat16*>(x), scale, bias,
      static_cast<__nv_bfloat16*>(out), HW, C, G, eps, silu, window, cluster, rows, box_rows,
      stash);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// x, out: (B, HW, C) bf16, contiguous, 16-byte aligned; scale, bias: (C,) f32. The plan
// (`group_norm_plan`): `window` channels of whole groups a block (C % window == 0), the
// slab's HW rows split over a cluster of `cluster` blocks of `threads` (256 or 512) threads,
// `rows` each, kept in shared memory in blocks of `box_rows` rows when `stash` (window % 8
// == 0, at most 256; 1: by TMA boxes, 2: by pass 1's 16-byte loads), else (0) read from
// device memory in each pass.
extern "C" int group_norm_silu(const void* x, const float* scale, const float* bias, void* out,
                               int B, int HW, int C, int G, float eps, int silu, int window,
                               int cluster, int rows, int box_rows, int stash, int threads,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cg = C / G;
  if (window <= 0 || window % cg || C % window || cluster < 1 || cluster > 8 || rows < 1 ||
      box_rows < 1 || stash < kStashNone || stash > kStashLoads ||
      (stash && (window % 8 || window > 256 || box_rows > 256)) ||
      window / cg > kMaxGroups || (threads != 256 && threads != kMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (window % 8 == 0)
    return launch<8>(x, scale, bias, out, B, HW, C, G, eps, silu, window, cluster, rows, box_rows,
                     stash, threads, s);
  if (stash) return static_cast<int>(cudaErrorInvalidValue);
  if (window % 4 == 0)
    return launch<4>(x, scale, bias, out, B, HW, C, G, eps, silu, window, cluster, rows, box_rows,
                     0, threads, s);
  if (window % 2 == 0)
    return launch<2>(x, scale, bias, out, B, HW, C, G, eps, silu, window, cluster, rows, box_rows,
                     0, threads, s);
  return launch<1>(x, scale, bias, out, B, HW, C, G, eps, silu, window, cluster, rows, box_rows,
                   0, threads, s);
}
