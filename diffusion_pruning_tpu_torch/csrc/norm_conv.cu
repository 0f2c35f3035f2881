// GroupNorm(+gate)(+SiLU) fused into the input read of the consumer product,
// for Hopper (sm_90a), on wgmma and TMA. Three kernels:
//
//   norm_conv3x3:  out = conv3x3(act(a·x + b)) + bias     stride 1, zero padding 1
//   norm_linear:   out = (a·x + b) · Wᵀ + bias            per batch element
//   conv_split_reduce: out = Σ_s ws[s] + bias, the K slices of either summed in order
//
// x is NHWC (B, H, W, C_in) bf16 (tokens (B, S, C_in) for the linear form);
// a, b are f32 (B, C_in), the normalisation folded to one multiply-add per
// (batch, channel) (`affine_coeffs` in ops/norm_conv.py: a = gate·scale·inv,
// b = bias − mean·scale·inv); act = SiLU or the identity; y = act(a·x + b) is
// rounded to bf16, the products accumulate in f32, the bias is added in f32
// and the result is rounded to bf16 once. Weights are (C_out, 3, 3, C_in) or
// (C_out, C_in) bf16: the contraction index is contiguous for every tap.
//
// Replaces `_nc_kernel` and its row-tiled form `_nc_kernel_ht`, and
// `_nl_kernel`, of the JAX package's diffusion_pruning_tpu/ops/norm_conv.py.
// Those bodies build a padded, normalised copy of a whole image (or a band of
// rows with halo reads) in fast memory and run nine shifted matmuls over it,
// on a grid that walks the images in order. A block here has 227 KB and no
// neighbour to inherit from, so the work is cut into small spatial patches
// instead and nothing of their tiling is carried over.
//
// What bounds the conv on an H100 (M = B·H·W pixels, N = C_out, K = 9·C_in):
//  * 32×32 and 16×16 maps: operations, 2·M·N·K on the tensor cores; only
//    wgmma reaches their rate (mma.sync, the first version's product, ran the
//    32×32 maps at 5.8× this bound);
//  * 8×8 maps: operations too, but M·N / (128·BN) output tiles are fewer than
//    the 132 SMs at the serving batch;
//  * 4×4 maps: the weights' bytes (29.5 MB at 1280→1280, read once), with M
//    only a few hundred rows: a block that walks the whole K alone waits on
//    its own weight stream.
//
// Design of the conv (an implicit GEMM on wgmma; the plan, chosen per shape
// in Python by `conv_plan` of ops/norm_conv.py, is the patch shape, BN and
// the split count):
//  * a block is two consumer warpgroups of 64 output pixels each (128 pixels:
//    one 8×16 patch, two 8×8 or eight 4×4 patches, so that a block at the
//    4×4 maps spans eight images) and a producer warpgroup that hands its
//    registers to them (setmaxnreg: 40 and 232 a thread); BN = 160 output
//    channels (every C_out of the SD-2.1 U-Net is a multiple), 8 at the
//    output head (C_out = 4, the rest masked);
//  * weights by TMA: the packed weight viewed as (C_out, 9, C_in) is read in
//    boxes of BN rows × 64 channels of one tap (128-byte swizzle), through a
//    ring of four stages with full/empty mbarriers; one producer thread
//    keeps three boxes in flight; channels past C_in and rows past C_out arrive as
//    zeros;
//  * the A operand cannot come by TMA: a tap reads the patch rows shifted in
//    the halo tile (a patch row is TW pixels of TW + 2), a gather no wgmma
//    descriptor expresses. So each 64-channel chunk of the patches WITH their
//    one-pixel halo is staged by the consumer threads in padded shared rows
//    (144 bytes: ldmatrix is free of bank conflicts), already normalised:
//    y = act(a·x + b) rounded to bf16, once per element for all nine taps and
//    all BN columns (applied per tap, the special-function unit and not the
//    tensor cores was the limit). Padding is in y-space: a halo pixel outside
//    the image is staged as 0. The halo tile is double-buffered: the next
//    chunk's x is loaded into registers at the start of a chunk and
//    normalised into the other buffer between the taps' products;
//  * the products are wgmma m64nBNk16 with A from registers (the RS form):
//    per tap, ldmatrix gathers the warp's 16 shifted rows × 64 channels from
//    the halo tile, four products consume them, and the group before is
//    waited for before its registers and its weight stage are reused;
//  * split over K where the grid is short (M tiles × N tiles < 2 × 132): the
//    channel chunks, never the taps, are cut into `split` slices
//    (blockIdx.z), so that no halo is normalised twice. Each slice writes f32
//    partial sums to a workspace the wrapper allocates, and the wrapper's
//    second launch, conv_split_reduce, adds them in slice order, adds the
//    bias in f32 and rounds once: the result does not depend on which block
//    finished first;
//  * SiLU is y / (1 + exp(−y)), the sigmoid form of the body it replaces, on
//    the fast exponential and divide (relative error about 2^-21, far below
//    the bf16 rounding of y that follows). y·(½ + ½·tanh.approx(y/2)) saves a
//    special-function operation but cancels for negative y (absolute error
//    about |y|·2^-12, a few percent of SiLU(y) near y = −5), so it is not used;
//  * ragged edges are masked: patches past the last image, pixels past H or
//    W, and columns past C_out; C_in % 8 == 0 is required (the TMA row
//    stride, 2·C_in bytes, must be a multiple of 16); every offset into x,
//    the workspace and out is 64-bit.
// Given up: the halo tile stays thread-produced (its loads and the
// normalisation cost issue slots the products could use); a wgmma group in
// flight holds its A registers, so the pipeline drains at each chunk's end,
// where the halo buffers swap; the split pays a workspace write and read
// (S × M × C_out f32) to fill the card.
//
// What bounds the linear on an H100 (M = B·S tokens, N = C_out, K = C_in):
// bytes at every proj_in shape of the SD-2.1 U-Net (x, the weight and out
// once: 1.4-6.3 µs at B_eff 16), the operations only at B = 64 and
// S <= 256. The first version (mma.sync, 32-channel steps, the next x chunk
// loaded synchronously and normalised with a and b read from global memory)
// took 0.9 µs a step with one block alone, about two DRAM round trips a
// step, and 35-56 µs at every shape (PERF.md §6).
//
// Design of the linear (a GEMM on wgmma; the plan, chosen per shape in
// Python by `linear_plan`, is the split count, the staging of a and b and
// the persistent grid):
//  * a tile is 128 tokens × BN = 160 output channels, two consumer
//    warpgroups of 64 rows (which at S = 16 span eight batch elements) and a
//    producer warpgroup (setmaxnreg 40 and 232); the grid is persistent: a
//    block walks (tile, K slice) items, so one item's epilogue overlaps the
//    next item's loads;
//  * every operand comes by TMA through a ring of four stages with full and
//    empty mbarriers, one producer thread keeping three stages in flight:
//    the x box of 128 rows × 64 channels and the weight box of BN rows × 64
//    channels (128-byte swizzle; a linear has no halo, so x needs no
//    gather), and a and b of the chunk for the batch elements the tile's
//    rows span (f32, at most 20 of them: S >= 7; below that a and b are read
//    from global memory); rows past M and channels past C_in arrive as zeros;
//  * each warpgroup reads its 64 rows of the x box with ldmatrix, applies
//    y = a·x + b in f32 (each row with its own batch element), rounds to bf16
//    into the A registers and issues wgmma m64n160k16 in the RS form, four a
//    chunk, retired before the registers and the stage are reused (a
//    register feeding a product is never written while one is in flight, so
//    ptxas does not serialise the products); a and b are loaded once where
//    a thread's two rows share a batch element (S a multiple of 16). Tried
//    and no faster: normalising x in place for SS products (the round trip
//    and a warpgroup barrier sat between the products); the two warpgroups
//    issuing in strict turns (ping-pong), or warpgroup 1 starting half a
//    chunk behind;
//  * the epilogue adds the bias in f32, rounds once, writes the warpgroup's
//    64 × 160 tile to shared memory with stmatrix and stores it with one TMA
//    store (rows past M, columns past C_out clipped), which runs on while the
//    next item starts;
//  * split over K where M tiles × N tiles leave at least half of the 132 SMs
//    idle (the 8×8 and 4×4 maps at B_eff 16): each slice writes f32 partial
//    sums to the workspace and conv_split_reduce adds them in slice order
//    with the bias (no atomics; the result repeats bit for bit).
// Given up: TMA multicast of the weight box across a cluster of M tiles (the
// weight is read from L2 once per M tile).

#include <algorithm>
#include <cstring>

#include "sm90_common.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// Eight bf16 of x -> eight bf16 of y = act(a·x + b); a, b point at the eight
// channels' f32 coefficients (32-byte aligned).
__device__ __forceinline__ uint4 normalise8(uint4 raw, const float* __restrict__ a,
                                            const float* __restrict__ b, int silu) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&in[e]);
    float lo = av[2 * e] * __bfloat162float(v.x) + bv[2 * e];
    float hi = av[2 * e + 1] * __bfloat162float(v.y) + bv[2 * e + 1];
    if (silu) {
      lo = silu_fast(lo);
      hi = silu_fast(hi);
    }
    o[e] = pack_f32(lo, hi);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------- conv (wgmma)

constexpr int kChunk = 64;           // channels per K chunk: one 128-byte swizzled weight row
constexpr int kHRow = kChunk + 8;    // padded halo row, 144 bytes
constexpr int kHRowBytes = kHRow * 2;
constexpr int kConvStages = 4;       // weight boxes: one in use, three in flight
constexpr int kConsumers = 256;      // two warpgroups of 64 output pixels
constexpr int kConvThreads = 128 + kConsumers;  // after the producer warpgroup

template <int TW, int TH, int NP, int BN>
struct ConvTile {
  static constexpr int kHW2 = TW + 2;               // halo row length
  static constexpr int kHP = (TH + 2) * kHW2;       // halo pixels of one patch
  static constexpr int kHR = NP * kHP;              // shared rows of the y tile
  static constexpr int kNS = (kHR * 8 + kConsumers - 1) / kConsumers;  // 16-byte slots a thread
  static constexpr int kPix = TH * TW;
  static constexpr int kBTile = BN * 128;           // bytes of one weight box
  static constexpr int kHalo = kHR * kHRowBytes;    // bytes of one halo buffer
  static constexpr int kSmem = 1024 + kConvStages * kBTile + 2 * kHalo + 2 * kConvStages * 8;
  static_assert(NP * kPix == 128, "a block's patches hold 128 pixels");
  static_assert(kNS <= 9, "the next chunk is normalised between the nine taps");
  static_assert(kBTile % 1024 == 0, "weight boxes stay on 1024-byte swizzle atoms");
};

template <int TW, int TH, int NP, int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    norm_conv3x3_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int B, int H,
                        int W, int Cin, int Cout, int silu, int split) {
  using T = ConvTile<TW, TH, NP, BN>;
  extern __shared__ uint8_t smem_raw[];
  // weight ring | halo buffers 0, 1 | full and empty barriers
  const uint32_t raw_s = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const uint32_t halo_s = ring + kConvStages * T::kBTile;
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw + (halo_s - raw_s));
  const uint32_t bars = halo_s + 2 * T::kHalo;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kConvStages + s); };

  const int px_n = (W + TW - 1) / TW, py_n = (H + TH - 1) / TH;
  const int per_img = px_n * py_n;
  const int patches = B * per_img;
  const int p0 = blockIdx.x * NP, n0 = blockIdx.y * BN;
  const int kc = (Cin + kChunk - 1) / kChunk;
  const int k_lo = blockIdx.z * kc / split, k_hi = (blockIdx.z + 1) * kc / split;
  const int steps = (k_hi - k_lo) * 9;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues the weight boxes
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kConvStages;
        sm90::mbar_wait(empty(st), ((s / kConvStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), T::kBTile);
        const int chunk = k_lo + s / 9;
        sm90::tma_load_3d(ring + st * T::kBTile, &wmap, full(st), chunk * kChunk, s % 9, n0);
      }
    }
    return;
  }
  sm90::regs_alloc<232>();

  const int tid = threadIdx.x - 128;  // consumer thread 0 … 255
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int ch = (tid & 7) * 8;  // this thread's eight channels of every staged halo row

  // the halo pixels this thread stages: shared rows tid / 8 + 32·i; img < 0
  // marks a pixel outside its image (staged as 0)
  int pix[T::kNS], img[T::kNS];
#pragma unroll
  for (int i = 0; i < T::kNS; ++i) {
    const int row = (tid >> 3) + i * (kConsumers / 8);
    img[i] = -1;
    pix[i] = 0;
    const int p = row / T::kHP, q = row - p * T::kHP;
    const int pid = p0 + p;
    if (row < T::kHR && pid < patches) {
      const int im = pid / per_img, rem = pid - im * per_img;
      const int y = (rem / px_n) * TH + q / T::kHW2 - 1;
      const int xx = (rem % px_n) * TW + q % T::kHW2 - 1;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        img[i] = im;
        pix[i] = (im * H + y) * W + xx;
      }
    }
  }

  // the shared row (at the centre tap) that this lane addresses for ldmatrix:
  // tile row r is pixel r % kPix of patch r / kPix
  uint32_t a_off;
  {
    const int r = wg * 64 + warp * 16 + (lane & 15);
    const int p = r / T::kPix, q = r - p * T::kPix;
    const int ty = q / TW, tx = q - ty * TW;
    a_off = (p * T::kHP + (ty + 1) * T::kHW2 + tx + 1) * kHRowBytes + (lane >> 4) * 16;
  }
  // the pixels of this thread's two accumulator rows (-1: masked)
  long orow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + warp * 16 + gr + half * 8;
    const int p = r / T::kPix, q = r - p * T::kPix;
    const int ty = q / TW, tx = q - ty * TW;
    orow[half] = -1;
    const int pid = p0 + p;
    if (pid < patches) {
      const int im = pid / per_img, rem = pid - im * per_img;
      const int y = (rem / px_n) * TH + ty, xx = (rem % px_n) * TW + tx;
      if (y < H && xx < W) orow[half] = ((long)im * H + y) * W + xx;
    }
  }

  uint4 raw[T::kNS];
  bool ok[T::kNS];
  auto load_x = [&](int chunk) {
    const int c = chunk * kChunk + ch;
#pragma unroll
    for (int i = 0; i < T::kNS; ++i) {
      ok[i] = img[i] >= 0 && c < Cin;
      if (ok[i]) raw[i] = __ldg(reinterpret_cast<const uint4*>(x + (long)pix[i] * Cin + c));
    }
  };
  auto store_y = [&](int i, int chunk, int buf) {
    const int row = (tid >> 3) + i * (kConsumers / 8);
    if (row >= T::kHR) return;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (ok[i]) {
      const long co = (long)img[i] * Cin + chunk * kChunk + ch;
      y = normalise8(raw[i], a + co, b + co, silu);
    }
    *reinterpret_cast<uint4*>(halo + buf * (T::kHalo / 2) + row * kHRow + ch) = y;
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  load_x(k_lo);
#pragma unroll
  for (int i = 0; i < T::kNS; ++i) store_y(i, k_lo, 0);
  sm90::named_barrier(1, kConsumers);

  int step = 0;
  for (int chunk = k_lo; chunk < k_hi; ++chunk) {
    const int cur = (chunk - k_lo) & 1;
    const bool more = chunk + 1 < k_hi;
    if (more) load_x(chunk + 1);
    const uint32_t hs = halo_s + cur * T::kHalo + a_off;
    uint32_t af[2][4][4];  // A registers of two taps: one in flight, one being loaded
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++step) {
      const int st = step % kConvStages;
      const int shift = (tap / 3 - 1) * T::kHW2 + tap % 3 - 1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::ldmatrix_x4(af[tap & 1][kk], hs + shift * kHRowBytes + kk * 32);
      sm90::mbar_wait(full(st), (step / kConvStages) & 1);
      const uint64_t desc = sm90::desc_sw128(ring + st * T::kBTile, 16, 1024);
      sm90::fence_regs<BN / 2>(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::WgmmaRS<BN, 0>::mma(acc, af[tap & 1][kk], desc + 2 * kk, 1);
      sm90::wgmma_commit();
      if (tap > 0) {
        // the previous tap's group is done: its registers and weight stage are free
        sm90::wgmma_wait<1>();
        sm90::fence_regs<16>(&af[(tap - 1) & 1][0][0]);
        if (lane == 0) sm90::mbar_arrive(empty((step - 1) % kConvStages));
      }
      if (more && tap < T::kNS) store_y(tap, chunk + 1, cur ^ 1);
    }
    // drain: the next chunk's first tap reuses these A registers
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BN / 2>(acc);
    sm90::fence_regs<16>(&af[0][0][0]);
    if (lane == 0) sm90::mbar_arrive(empty((step - 1) % kConvStages));
    // every consumer is done reading this halo buffer and has written the next
    sm90::named_barrier(1, kConsumers);
  }

  // epilogue: + bias, one rounding, to out; or the f32 partial of this slice
  const bool pairs = (Cout & 1) == 0;
  const long M = (long)B * H * W;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * tg;
    if (col >= Cout) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (orow[half] < 0) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (ws != nullptr) {  // split: Cout % 4 == 0
        float* dst = ws + ((long)blockIdx.z * M + orow[half]) * Cout + col;
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        continue;
      }
      const float b0 = bias[col];
      const float b1 = col + 1 < Cout ? bias[col + 1] : 0.0f;
      __nv_bfloat16* dst = out + orow[half] * Cout + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_f32(v0 + b0, v1 + b1);
      } else {
        dst[0] = __float2bfloat16(v0 + b0);
        if (col + 1 < Cout) dst[1] = __float2bfloat16(v1 + b1);
      }
    }
  }
}

// out = bf16(Σ_s ws[s] + bias), the slices summed in order s = 0 … split − 1;
// four columns a thread (Cout % 4 == 0)
__global__ void __launch_bounds__(256)
    conv_split_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, long M, int Cout, int split) {
  const long n4 = M * Cout / 4;
  const long slice = M * Cout;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const long e = i * 4;
    const int col = static_cast<int>(e % Cout);
    float4 s = __ldg(reinterpret_cast<const float4*>(ws + e));
    for (int k = 1; k < split; ++k) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(ws + k * slice + e));
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    uint2 o;
    o.x = pack_f32(s.x + bias[col], s.y + bias[col + 1]);
    o.y = pack_f32(s.z + bias[col + 2], s.w + bias[col + 3]);
    *reinterpret_cast<uint2*>(out + e) = o;
  }
}

template <int TW, int TH, int NP, int BN>
int launch_conv(const void* x, const float* a, const float* b, const void* w, const float* bias,
                void* out, float* ws, int B, int H, int W, int Cin, int Cout, int silu, int split,
                cudaStream_t stream) {
  using T = ConvTile<TW, TH, NP, BN>;
  auto kernel = norm_conv3x3_kernel<TW, TH, NP, BN>;
  static const cudaError_t opted = sm90::allow_smem(kernel, T::kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  // the packed weight as (C_out, 9, C_in): one box is BN rows × 64 channels of one tap
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cin * 18};
  const cuuint32_t box[3] = {kChunk, 1, BN};
  if (!sm90::encode_bf16_map(&wmap, w, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int patches = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid((patches + NP - 1) / NP, (Cout + BN - 1) / BN, split);
  kernel<<<grid, kConvThreads, T::kSmem, stream>>>(
      wmap, static_cast<const __nv_bfloat16*>(x), a, b, bias, static_cast<__nv_bfloat16*>(out),
      split > 1 ? ws : nullptr, B, H, W, Cin, Cout, silu, split);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_conv_bn(const void* x, const float* a, const float* b, const void* w, const float* bias,
                   void* out, float* ws, int B, int H, int W, int Cin, int Cout, int silu, int tw,
                   int split, cudaStream_t stream) {
  switch (tw) {
    case 16:
      return launch_conv<16, 8, 1, BN>(x, a, b, w, bias, out, ws, B, H, W, Cin, Cout, silu,
                                       split, stream);
    case 8:
      return launch_conv<8, 8, 2, BN>(x, a, b, w, bias, out, ws, B, H, W, Cin, Cout, silu, split,
                                      stream);
    case 4:
      return launch_conv<4, 4, 8, BN>(x, a, b, w, bias, out, ws, B, H, W, Cin, Cout, silu, split,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- linear (wgmma)

constexpr int kLinRows = 128;                 // output rows (tokens) a tile: two warpgroups of 64
constexpr int kLinBN = 160;                   // output channels a tile
constexpr int kLinStages = 4;                 // operand stages: one in use, three in flight
constexpr int kLinXTile = kLinRows * 128;     // bytes of one x box: 128 rows × 64 channels
constexpr int kLinWTile = kLinBN * 128;       // bytes of one weight box: BN rows × 64 channels
constexpr int kLinMaxAbRows = 20;             // batch elements of a, b staged a chunk
constexpr int kLinOutTile = 64 * kLinBN * 2;  // bytes of one warpgroup's bf16 output tile

// bytes of one stage: the x box, the weight box, then a and b of the chunk
// for `ab_rows` batch elements (f32, 64 channels each); 1024-aligned
__host__ __device__ constexpr int linear_stage_bytes(int ab_rows) {
  return (kLinXTile + kLinWTile + 2 * ab_rows * kChunk * 4 + 1023) / 1024 * 1024;
}

// the ring, the two warpgroups' output tiles, the full and empty barriers
__host__ __device__ constexpr int linear_smem_bytes(int ab_rows) {
  return 1024 + kLinStages * linear_stage_bytes(ab_rows) + 2 * kLinOutTile + 2 * kLinStages * 8;
}

// two bf16 of x -> two bf16 of y = a·x + b
__device__ __forceinline__ uint32_t affine2(uint32_t raw, float2 av, float2 bv) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  return pack_f32(av.x * __bfloat162float(v.x) + bv.x, av.y * __bfloat162float(v.y) + bv.y);
}

__device__ __forceinline__ float2 ld_f2(const float* p, bool in) {
  return in ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

// The work items of a block: items blockIdx.x, + gridDim.x, …; item w is
// output tile (mt, nt) of K slice z, w = (z·m_tiles + mt)·n_tiles + nt.
struct LinearItem {
  long m0;
  int n0, k_lo, k_hi, z;
};

__device__ __forceinline__ LinearItem linear_item(int w, int m_tiles, int n_tiles, int kc,
                                                  int split) {
  const int nt = w % n_tiles, rest = w / n_tiles;
  const int mt = rest % m_tiles, z = rest / m_tiles;
  return {(long)mt * kLinRows, nt * kLinBN, z * kc / split, (z + 1) * kc / split, z};
}

__global__ void __launch_bounds__(kConvThreads, 1)
    norm_linear_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __grid_constant__ CUtensorMap omap, const float* __restrict__ a,
                       const float* __restrict__ b, const float* __restrict__ bias,
                       float* __restrict__ ws, int B, int S, int Cin, int Cout, int split,
                       int ab_rows) {
  extern __shared__ uint8_t smem_raw[];
  // stages (x box | weight box | a | b) | output tiles | full and empty barriers
  const uint32_t raw_s = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const int stage_bytes = linear_stage_bytes(ab_rows);
  const int ab_tile = ab_rows * kChunk * 4;
  const uint32_t otile = ring + kLinStages * stage_bytes;
  const uint32_t bars = otile + 2 * kLinOutTile;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kLinStages + s); };

  const long M = (long)B * S;
  const int m_tiles = static_cast<int>((M + kLinRows - 1) / kLinRows);
  const int n_tiles = (Cout + kLinBN - 1) / kLinBN;
  const int kc = (Cin + kChunk - 1) / kChunk;
  const int items = m_tiles * n_tiles * split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLinStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every box
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      const uint32_t tx = kLinXTile + kLinWTile + 2 * ab_tile;
      int s = 0;  // the stage count over all of this block's items
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const LinearItem it = linear_item(w, m_tiles, n_tiles, kc, split);
        const int img_lo = static_cast<int>(it.m0 / S);
        for (int chunk = it.k_lo; chunk < it.k_hi; ++chunk, ++s) {
          const int st = s % kLinStages;
          sm90::mbar_wait(empty(st), ((s / kLinStages) & 1) ^ 1);
          sm90::mbar_expect_tx(full(st), tx);
          const uint32_t base = ring + st * stage_bytes;
          const int c = chunk * kChunk;
          sm90::tma_load_2d(base, &xmap, full(st), c, static_cast<int>(it.m0));
          sm90::tma_load_2d(base + kLinXTile, &wmap, full(st), c, it.n0);
          if (ab_rows > 0) {
            sm90::tma_load_2d(base + kLinXTile + kLinWTile, &amap, full(st), c, img_lo);
            sm90::tma_load_2d(base + kLinXTile + kLinWTile + ab_tile, &bmap, full(st), c, img_lo);
          }
        }
      }
    }
    return;
  }
  sm90::regs_alloc<232>();

  const int tid = threadIdx.x - 128;  // consumer thread 0 … 255
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  // the x-box row this lane addresses for ldmatrix, in the 128-byte swizzle
  const int lrow = wg * 64 + warp * 16 + (lane & 15);
  const uint32_t x_row = lrow * 128;
  const int x_sw = lrow & 7, x_half = lane >> 4;
  // this lane's stmatrix row of the warpgroup's output tile (row-major, BN
  // bf16 a row): matrix lane / 8 is rows + 8·(lane / 8 % 2), columns + 8·(lane / 16)
  const uint32_t o_lane = otile + wg * kLinOutTile +
                          ((warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLinBN +
                           (lane >> 4) * 8) * 2;
  const uint32_t o_bar = 2 + wg;  // the warpgroup's named barrier

  float acc[kLinBN / 2];
  int s = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const LinearItem it = linear_item(w, m_tiles, n_tiles, kc, split);
    const int img_lo = static_cast<int>(it.m0 / S);
    // this thread's two rows of the A fragment and of the accumulators, and
    // their batch elements (past M: the last one; those rows are not stored)
    long orow[2];
    int img[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = it.m0 + wg * 64 + warp * 16 + gr + h * 8;
      orow[h] = m < M ? m : -1;
      img[h] = static_cast<int>(m / S < B ? m / S : B - 1);
    }
    // one batch element for both rows (S a multiple of 16): a and b loaded
    // once for the two
    const bool same = img[0] == img[1];
    // each 64-channel chunk: y = a·x + b into the A registers, four products
    // of m64n160k16, retired before the registers and the stage are reused
    for (int chunk = it.k_lo; chunk < it.k_hi; ++chunk, ++s) {
      const int st = s % kLinStages;
      const uint32_t base = ring + st * stage_bytes;
      sm90::mbar_wait(full(st), (s / kLinStages) & 1);
      // a and b of each row's batch element for this chunk's channels: staged
      // (zero past C_in and past the last batch element), or from global memory
      const float* ap[2];
      const float* bp[2];
      int lim;
      if (ab_rows > 0) {
        const float* at = reinterpret_cast<const float*>(smem_raw + (base - raw_s) + kLinXTile +
                                                         kLinWTile);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ap[h] = at + (img[h] - img_lo) * kChunk;
          bp[h] = ap[h] + ab_rows * kChunk;
        }
        lim = kChunk;
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ap[h] = a + (long)img[h] * Cin + chunk * kChunk;
          bp[h] = b + (long)img[h] * Cin + chunk * kChunk;
        }
        lim = Cin - chunk * kChunk;
      }
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        sm90::ldmatrix_x4(r, base + x_row + (((2 * kk + x_half) ^ x_sw) << 4));
        // r: (row gr, channels c0, c0 + 1), (gr + 8, c0), (gr, c0 + 8), (gr + 8, c0 + 8)
        const int c0 = kk * 16 + 2 * tg, c1 = c0 + 8;
        const bool in0 = c0 < lim, in1 = c1 < lim;
        const float2 a00 = ld_f2(ap[0] + c0, in0), b00 = ld_f2(bp[0] + c0, in0);
        const float2 a01 = ld_f2(ap[0] + c1, in1), b01 = ld_f2(bp[0] + c1, in1);
        float2 a10 = a00, b10 = b00, a11 = a01, b11 = b01;
        if (!same) {
          a10 = ld_f2(ap[1] + c0, in0);
          b10 = ld_f2(bp[1] + c0, in0);
          a11 = ld_f2(ap[1] + c1, in1);
          b11 = ld_f2(bp[1] + c1, in1);
        }
        af[kk][0] = affine2(r[0], a00, b00);
        af[kk][1] = affine2(r[1], a10, b10);
        af[kk][2] = affine2(r[2], a01, b01);
        af[kk][3] = affine2(r[3], a11, b11);
      }
      const uint64_t desc = sm90::desc_sw128(base + kLinXTile, 16, 1024);
      const int first = chunk == it.k_lo;
      sm90::fence_regs<kLinBN / 2>(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::WgmmaRS<kLinBN, 0>::mma(acc, af[kk], desc + 2 * kk, !(first && kk == 0));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<kLinBN / 2>(acc);
      sm90::fence_regs<16>(&af[0][0]);
      if (lane == 0) sm90::mbar_arrive(empty(st));
    }

    if (ws != nullptr) {  // split: this slice's f32 partial (Cout % 8 == 0)
#pragma unroll
      for (int j = 0; j < kLinBN / 8; ++j) {
        const int col = it.n0 + j * 8 + 2 * tg;
        if (col >= Cout) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (orow[half] < 0) continue;
          float* dst = ws + ((long)it.z * M + orow[half]) * Cout + col;
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
      continue;
    }
    // + bias in f32, one rounding, into the warpgroup's tile, then one TMA
    // store of its 64 rows (rows past M and columns past C_out are clipped)
    if (tid % 128 == 0) sm90::bulk_wait_read();  // the tile's previous store has read it
    sm90::named_barrier(o_bar, 128);
#pragma unroll
    for (int j = 0; j < kLinBN / 8; j += 2) {
      uint32_t p[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = it.n0 + (j + q) * 8 + 2 * tg;
        const float b0 = col < Cout ? bias[col] : 0.0f;
        const float b1 = col + 1 < Cout ? bias[col + 1] : 0.0f;
        p[2 * q] = pack_f32(acc[4 * (j + q)] + b0, acc[4 * (j + q) + 1] + b1);
        p[2 * q + 1] = pack_f32(acc[4 * (j + q) + 2] + b0, acc[4 * (j + q) + 3] + b1);
      }
      sm90::stmatrix_x4(o_lane + j * 16, p[0], p[1], p[2], p[3]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(o_bar, 128);
    if (tid % 128 == 0) {
      sm90::tma_store_2d(&omap, otile + wg * kLinOutTile, it.n0,
                         static_cast<int>(it.m0) + wg * 64);
      sm90::bulk_commit();
    }
  }
  if (tid % 128 == 0) sm90::bulk_wait_read();  // the tile stays until its last store has read it
}

}  // namespace

// x: (B, H, W, Cin) bf16; a, b: (B, Cin) f32; w: (Cout, 3, 3, Cin) bf16; bias: (Cout,) f32;
// out: (B, H, W, Cout) bf16, written when split == 1; ws: (split, B·H·W, Cout) f32, the
// slices' partial sums, written when split > 1 (conv_split_reduce then makes out). All
// contiguous and 16-byte aligned; Cin % 8 == 0; Cout % 4 == 0 when split > 1. The plan (tw:
// patch width 16, 8 or 4; bn: 160 or 8; split: 1 … ceil(Cin / 64)) comes from `conv_plan`.
extern "C" int norm_conv3x3(const void* x, const float* a, const float* b, const void* w,
                            const float* bias, void* out, float* ws, int B, int H, int W, int Cin,
                            int Cout, int silu, int tw, int bn, int split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 160)
    return launch_conv_bn<160>(x, a, b, w, bias, out, ws, B, H, W, Cin, Cout, silu, tw, split, s);
  if (bn == 8)
    return launch_conv_bn<8>(x, a, b, w, bias, out, ws, B, H, W, Cin, Cout, silu, tw, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ws: (split, M, Cout) f32 from norm_conv3x3; bias: (Cout,) f32; out: (M, Cout) bf16 (the
// NHWC output, M = B·H·W). Contiguous, 16-byte aligned; Cout % 4 == 0.
extern "C" int conv_split_reduce(const float* ws, const float* bias, void* out, long M, int Cout,
                                 int split, void* stream) {
  const long n4 = M * Cout / 4;
  const int blocks = static_cast<int>(std::min<long>((n4 + 255) / 256, 132L * 8));
  conv_split_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, bias, static_cast<__nv_bfloat16*>(out), M, Cout, split);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, S, Cin) bf16; a, b: (B, Cin) f32; w: (Cout, Cin) bf16; bias: (Cout,) f32;
// out: (B, S, Cout) bf16, written when split == 1; ws: (split, B·S, Cout) f32, the slices'
// partial sums, written when split > 1 (conv_split_reduce then makes out). All contiguous
// and 16-byte aligned; Cin % 8 == 0 and Cout % 8 == 0. The plan (split: 1 … ceil(Cin / 64);
// ab_rows: the batch elements of a, b staged a chunk, at most 20, 0 to read them from
// global memory; blocks: the persistent grid) comes from `linear_plan`.
extern "C" int norm_linear(const void* x, const float* a, const float* b, const void* w,
                           const float* bias, void* out, float* ws, int B, int S, int Cin,
                           int Cout, int split, int ab_rows, int blocks, void* stream) {
  if (ab_rows < 0 || ab_rows > kLinMaxAbRows || split < 1 || blocks < 1 || Cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted =
      sm90::allow_smem(norm_linear_kernel, linear_smem_bytes(kLinMaxAbRows));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const long M = (long)B * S;
  CUtensorMap xmap, wmap, amap, bmap, omap;
  memset(&amap, 0, sizeof(amap));
  memset(&bmap, 0, sizeof(bmap));
  const cuuint64_t xdims[2] = {(cuuint64_t)Cin, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)Cin, (cuuint64_t)Cout};
  const cuuint64_t odims[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t row[1] = {(cuuint64_t)Cin * 2};
  const cuuint64_t orow[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t xbox[2] = {kChunk, kLinRows};
  const cuuint32_t wbox[2] = {kChunk, kLinBN};
  const cuuint32_t obox[2] = {kLinBN, 64};
  if (!sm90::encode_bf16_map(&xmap, x, 2, xdims, row, xbox) ||
      !sm90::encode_bf16_map(&wmap, w, 2, wdims, row, wbox) ||
      !sm90::encode_map(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_NONE, out, 2,
                        odims, orow, obox))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ab_rows > 0) {
    const cuuint64_t adims[2] = {(cuuint64_t)Cin, (cuuint64_t)B};
    const cuuint64_t arow[1] = {(cuuint64_t)Cin * 4};
    const cuuint32_t abox[2] = {kChunk, (cuuint32_t)ab_rows};
    if (!sm90::encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, a,
                          2, adims, arow, abox) ||
        !sm90::encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, b,
                          2, adims, arow, abox))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  norm_linear_kernel<<<blocks, kConvThreads, linear_smem_bytes(ab_rows),
                       static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, amap, bmap, omap, a, b, bias, split > 1 ? ws : nullptr, B, S, Cin, Cout, split,
      ab_rows);
  return static_cast<int>(cudaGetLastError());
}
