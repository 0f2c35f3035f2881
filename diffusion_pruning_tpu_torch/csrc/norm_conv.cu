// GroupNorm(+gate)(+SiLU) fused into the input read of the consumer product,
// for Hopper (sm_90a). Three kernels:
//
//   norm_conv3x3:  out = conv3x3(act(a·x + b)) + bias     stride 1, zero padding 1
//   norm_linear:   out = (a·x + b) · Wᵀ + bias            per batch element
//   conv_split_reduce: out = Σ_s ws[s] + bias, norm_conv3x3's K slices summed in order
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
// The linear form is the first version's GEMM on mma.sync: 128 rows × 64
// columns a block, x normalised on its way from registers into shared memory,
// weight tiles by cp.async.

#include <algorithm>

#include "sm90_common.cuh"

namespace {

using namespace hopper;

// the linear form (mma.sync)
constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // contraction step (channels)
constexpr int kThreads = 256;
constexpr int kRow = kBK + 8;  // padded shared row

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

// One 32-deep step of the warp's 32 × 32 product: A rows from `a_s` at the
// four shared rows `arow` (+ `shift` rows), B from the 64 × 32 tile `b_s`.
__device__ __forceinline__ void mma_step(float acc[2][4][4], const __nv_bfloat16* a_s,
                                         const int arow[2][2], int shift,
                                         const __nv_bfloat16* b_s, int wn, int gr, int tg) {
  const __nv_bfloat16* bt = b_s + (wn * 32 + gr) * kRow + 2 * tg;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p0 = a_s + (arow[mi][0] + shift) * kRow + kk * 16 + 2 * tg;
      const __nv_bfloat16* p1 = a_s + (arow[mi][1] + shift) * kRow + kk * 16 + 2 * tg;
      af[mi][0] = ld_u32(p0);
      af[mi][1] = ld_u32(p1);
      af[mi][2] = ld_u32(p0 + 8);
      af[mi][3] = ld_u32(p1 + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* q = bt + ni * 8 * kRow + kk * 16;
      bf[ni][0] = ld_u32(q);
      bf[ni][1] = ld_u32(q + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
  }
}

// acc + bias in f32, one rounding; the warp's 32 × 32 block to the rows whose
// first element sits at out + orow (orow < 0: masked), columns from col0.
__device__ __forceinline__ void store_block(const float acc[2][4][4], const long orow[2][2],
                                            const float* __restrict__ bias,
                                            __nv_bfloat16* __restrict__ out, int col0, int Cout,
                                            int tg) {
  const bool pairs = (Cout & 1) == 0;  // then every pair of columns is 4-byte aligned
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + ni * 8 + 2 * tg;
    if (col >= Cout) continue;
    const float b0 = bias[col];
    const float b1 = col + 1 < Cout ? bias[col + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (orow[mi][half] < 0) continue;
        const float v0 = acc[mi][ni][2 * half] + b0;
        const float v1 = acc[mi][ni][2 * half + 1] + b1;
        __nv_bfloat16* dst = out + orow[mi][half] + col;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst) = pack_f32(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < Cout) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

__device__ __forceinline__ void load_b_tile(__nv_bfloat16* dst, const __nv_bfloat16* w,
                                            long row_stride, long offset, int n0, int Cout, int c,
                                            int Cin, int tid) {
  const int n = tid >> 2;
  const bool in = n0 + n < Cout && c < Cin;
  const __nv_bfloat16* src = in ? w + (long)(n0 + n) * row_stride + offset + c : w;
  cp_async_16(dst + n * kRow + (tid & 3) * 8, src, in);
  cp_async_commit();
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

// ---------------------------------------------------------------- linear (mma.sync)

__global__ void __launch_bounds__(kThreads)
    norm_linear_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                       int S, int Cin, int Cout) {
  constexpr int NS = kBM * 4 / kThreads;  // 2
  __shared__ __align__(16) __nv_bfloat16 a_s[2][kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 b_s[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kc = (Cin + kBK - 1) / kBK;
  const int ch = (tid & 3) * 8;

  int img[NS];  // the batch element of each staged row; < 0 past M
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int m = m0 + (tid >> 2) + i * (kThreads / 4);
    img[i] = m < M ? m / S : -1;
  }
  int arow[2][2];
  long orow[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + gr + half * 8;
      arow[mi][half] = r;
      orow[mi][half] = m0 + r < M ? (long)(m0 + r) * Cout : -1;
    }
  }

  uint4 raw[NS];
  bool ok[NS];
  auto load_a = [&](int chunk) {
    const int c = chunk * kBK + ch;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const long m = m0 + (tid >> 2) + i * (kThreads / 4);
      ok[i] = img[i] >= 0 && c < Cin;
      if (ok[i]) raw[i] = *reinterpret_cast<const uint4*>(x + m * Cin + c);
    }
  };
  auto store_a = [&](int chunk, __nv_bfloat16* dst) {
    const int c = chunk * kBK + ch;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      uint4 y = make_uint4(0u, 0u, 0u, 0u);
      if (ok[i]) {
        const long co = (long)img[i] * Cin + c;
        y = normalise8(raw[i], a + co, b + co, 0);
      }
      *reinterpret_cast<uint4*>(dst + ((tid >> 2) + i * (kThreads / 4)) * kRow + ch) = y;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  load_a(0);
  load_b_tile(b_s[0], w, Cin, 0, n0, Cout, ch, Cin, tid);
  store_a(0, a_s[0]);
  for (int chunk = 0; chunk < kc; ++chunk) {
    const int cur = chunk & 1;
    const bool more = chunk + 1 < kc;
    cp_async_wait<0>();
    // this step's tiles are complete, and every warp is done with the
    // previous step's, which the loads below overwrite
    __syncthreads();
    if (more) {
      load_b_tile(b_s[cur ^ 1], w, Cin, 0, n0, Cout, (chunk + 1) * kBK + ch, Cin, tid);
      load_a(chunk + 1);
    }
    mma_step(acc, a_s[cur], arow, 0, b_s[cur], wn, gr, tg);
    if (more) store_a(chunk + 1, a_s[cur ^ 1]);
  }
  store_block(acc, orow, bias, out, n0 + wn * 32, Cout, tg);
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
// out: (B, S, Cout) bf16. All contiguous and 16-byte aligned; Cin % 8 == 0.
extern "C" int norm_linear(const void* x, const float* a, const float* b, const void* w,
                           const float* bias, void* out, int B, int S, int Cin, int Cout,
                           void* stream) {
  const int M = B * S;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  norm_linear_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), a, b, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), M, S, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
