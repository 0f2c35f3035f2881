// GroupNorm(+gate)(+SiLU) fused into the input read of the consumer product,
// for Hopper (sm_90a). Two kernels:
//
//   norm_conv3x3:  out = conv3x3(act(a·x + b)) + bias     stride 1, zero padding 1
//   norm_linear:   out = (a·x + b) · Wᵀ + bias            per batch element
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
// What bounds them on an H100: the conv is bound by operations at the large
// maps (2·M·C_out·9·C_in against the bytes of x, the weights and out, M =
// B·H·W) and by the weights' bytes at the 4×4 maps, where M is a few hundred
// rows; the linear form by bytes at most of its shapes.
//
// Design of the conv (an implicit GEMM, M = pixels, N = C_out, K = 9·C_in):
//  * a block of 8 warps computes 128 output pixels × 64 output channels, each
//    warp 32 × 32 on mma.sync m16n8k16 (bf16 in, f32 accumulate). The 128
//    pixels are NP spatial patches of TH × TW pixels (8×16, two of 8×8, or
//    eight of 4×4, by the map's width), so that a block at a 4×4 map spans
//    eight images;
//  * K runs in steps of 32 channels. For each step the block stages the
//    patches WITH their one-pixel halo in shared memory, already normalised:
//    y = act(a·x + b), rounded to bf16. The affine and the SiLU are thus
//    applied once per staged element and serve all nine taps (applied per tap
//    they cost more than the products: the special-function unit, not the
//    tensor cores, was the limit). Padding is in y-space: a halo pixel outside
//    the image is staged as 0 and never passes through the affine;
//  * the nine taps then multiply out of that one tile: a tap only shifts the
//    shared row a fragment is read from. Weight tiles (64 × 32 per tap) arrive
//    by cp.async through a ring of four buffers, three tiles in flight: at the
//    small maps a block is bound by the latency of its own weight stream, not
//    by products. The next step's x is loaded into registers before the taps
//    and normalised into shared memory after them;
//  * SiLU is y / (1 + exp(−y)), the sigmoid form of the body it replaces, on
//    the fast exponential and divide (relative error about 2^-21, far below
//    the bf16 rounding of y that follows). y·(½ + ½·tanh.approx(y/2)) saves a
//    special-function operation but cancels for negative y (absolute error
//    about |y|·2^-12, a few percent of SiLU(y) near y = −5), so it is not used;
//  * shared rows are padded to 40 elements (80 bytes): fragment reads of
//    neighbouring pixels are free of bank conflicts;
//  * ragged edges are masked: patches past the last image, pixels past H or W,
//    channels past C_in (in chunks of 8: C_in % 8 == 0 is required) and
//    columns past C_out (C_out = 4 at the U-Net's output head);
//  * every offset into x, the weights and out is 64-bit.
// The linear form is the same GEMM without taps or patches: 128 rows × 64
// columns a block, x normalised on its way from registers into shared memory.
// wgmma, TMA, wider N tiles and a split over K for the small maps are left
// for a later version.

#include "mma_common.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;  // output pixels (rows) per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // contraction step (channels)
constexpr int kThreads = 256;
constexpr int kRow = kBK + 8;  // padded shared row
constexpr int kStages = 4;     // weight tiles of the conv: one in use, three in flight

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

template <int TW, int TH, int NP>
__global__ void __launch_bounds__(kThreads)
    norm_conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B,
                        int H, int W, int Cin, int Cout, int silu) {
  static_assert(NP * TH * TW == kBM, "a block's patches hold 128 pixels");
  constexpr int HW2 = TW + 2;                  // halo row length
  constexpr int HP = (TH + 2) * HW2;           // halo pixels of one patch
  constexpr int HR = NP * HP;                  // shared rows of the y tile
  constexpr int NS = (HR * 4 + kThreads - 1) / kThreads;  // 16-byte slots per thread
  constexpr int PIX = TH * TW;
  __shared__ __align__(16) __nv_bfloat16 a_s[HR * kRow];
  __shared__ __align__(16) __nv_bfloat16 b_s[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int px_n = (W + TW - 1) / TW, py_n = (H + TH - 1) / TH;
  const int per_img = px_n * py_n;
  const int patches = B * per_img;
  const int p0 = blockIdx.x * NP, n0 = blockIdx.y * kBN;
  const int kc = (Cin + kBK - 1) / kBK;
  const int ch = (tid & 3) * 8;

  // the halo pixels this thread stages: shared rows tid / 4 + 64·i, channel
  // chunk tid % 4 of the step; img < 0 marks a pixel outside its image
  long pix[NS];
  int img[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int row = (tid >> 2) + i * (kThreads / 4);
    img[i] = -1;
    pix[i] = 0;
    const int p = row / HP, q = row - p * HP;
    const int pid = p0 + p;
    if (row < HR && pid < patches) {
      const int im = pid / per_img, rem = pid - im * per_img;
      const int y = (rem / px_n) * TH + q / HW2 - 1;
      const int xx = (rem % px_n) * TW + q % HW2 - 1;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        img[i] = im;
        pix[i] = ((long)im * H + y) * W + xx;
      }
    }
  }

  // the shared rows (at the centre tap) and the output rows of this thread's
  // accumulator rows: tile row r is pixel r % PIX of patch r / PIX
  int arow[2][2];
  long orow[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + gr + half * 8;
      const int p = r / PIX, q = r - p * PIX;
      const int ty = q / TW, tx = q - ty * TW;
      arow[mi][half] = p * HP + (ty + 1) * HW2 + tx + 1;
      orow[mi][half] = -1;
      const int pid = p0 + p;
      if (pid < patches) {
        const int im = pid / per_img, rem = pid - im * per_img;
        const int y = (rem / px_n) * TH + ty, xx = (rem % px_n) * TW + tx;
        if (y < H && xx < W) orow[mi][half] = (((long)im * H + y) * W + xx) * Cout;
      }
    }
  }

  uint4 raw[NS];
  bool ok[NS];
  auto load_a = [&](int chunk) {
    const int c = chunk * kBK + ch;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      ok[i] = img[i] >= 0 && c < Cin;
      if (ok[i]) raw[i] = *reinterpret_cast<const uint4*>(x + pix[i] * Cin + c);
    }
  };
  auto store_a = [&](int chunk) {
    const int c = chunk * kBK + ch;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int row = (tid >> 2) + i * (kThreads / 4);
      if (row >= HR) continue;
      uint4 y = make_uint4(0u, 0u, 0u, 0u);
      if (ok[i]) {
        const long co = (long)img[i] * Cin + c;
        y = normalise8(raw[i], a + co, b + co, silu);
      }
      *reinterpret_cast<uint4*>(a_s + row * kRow + ch) = y;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // weight tile of step s (tap s % 9 of chunk s / 9) into ring slot s % kStages;
  // past the last step an empty group keeps the count of pending groups even
  const int steps = kc * 9;
  auto load_b = [&](int s) {
    if (s < steps) {
      const int chunk = s / 9, tap = s - chunk * 9;
      load_b_tile(b_s[s % kStages], w, 9L * Cin, (long)tap * Cin, n0, Cout, chunk * kBK + ch,
                  Cin, tid);
    } else {
      cp_async_commit();
    }
  };

  load_a(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_b(s);
  int step = 0;
  for (int chunk = 0; chunk < kc; ++chunk) {
    __syncthreads();  // every warp is done with the previous chunk's y tile
    store_a(chunk);
    if (chunk + 1 < kc) load_a(chunk + 1);
    for (int tap = 0; tap < 9; ++tap, ++step) {
      cp_async_wait<kStages - 2>();
      // this step's weight tile has landed (and, at tap 0, the y tile is
      // written), and every warp is done with the slot the next load fills
      __syncthreads();
      load_b(step + kStages - 1);
      const int shift = (tap / 3 - 1) * HW2 + tap % 3 - 1;
      mma_step(acc, a_s, arow, shift, b_s[step % kStages], wn, gr, tg);
    }
  }
  store_block(acc, orow, bias, out, n0 + wn * 32, Cout, tg);
}

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

template <int TW, int TH, int NP>
int launch_conv(const void* x, const float* a, const float* b, const void* w, const float* bias,
                void* out, int B, int H, int W, int Cin, int Cout, int silu, void* stream) {
  const int patches = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid((patches + NP - 1) / NP, (Cout + kBN - 1) / kBN);
  norm_conv3x3_kernel<TW, TH, NP><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), a, b, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), B, H, W, Cin, Cout, silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, Cin) bf16; a, b: (B, Cin) f32; w: (Cout, 3, 3, Cin) bf16; bias: (Cout,) f32;
// out: (B, H, W, Cout) bf16. All contiguous and 16-byte aligned; Cin % 8 == 0.
extern "C" int norm_conv3x3(const void* x, const float* a, const float* b, const void* w,
                            const float* bias, void* out, int B, int H, int W, int Cin, int Cout,
                            int silu, void* stream) {
  if (W > 8) return launch_conv<16, 8, 1>(x, a, b, w, bias, out, B, H, W, Cin, Cout, silu, stream);
  if (W > 4) return launch_conv<8, 8, 2>(x, a, b, w, bias, out, B, H, W, Cin, Cout, silu, stream);
  return launch_conv<4, 4, 8>(x, a, b, w, bias, out, B, H, W, Cin, Cout, silu, stream);
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
