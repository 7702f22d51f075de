// Modulated deformable 3x3 convolution (DCNv2), backward, for Hopper (sm_90a).
//
// Replaces the two TPU backward kernels of the JAX package:
//   side_tpu/ops/dcn_pallas_bwd.py:104  _dx_kernel      (K2: d_x, "col2im")
//   side_tpu/ops/dcn_pallas_bwd.py:193  _dcoord_kernel  (K3: d_offset, d_mask, d_weight, "col2im_coord")
// The TPU kernels turn the scatter of col2im into an all-read sum over statically
// shifted windows and lane-pack the batch, because Mosaic can neither gather nor
// scatter.  A GPU does both, so these kernels take the native DCNv2 form and
// compute the gradient of csrc/dcn_fwd.cu's forward, sample for sample:
//
//   per (pixel p, tap k): the offset is clamped to [-R, R] (R >= 0; R < 0 =
//   unbounded, "exact"), split into base = floor and frac = d - base; the four
//   corners outside the image count as zero, m = mask[p, k], and
//     gW[c]   = sum_o g[p, o] * W[k, c, o]           (inside the kernels)
//     d_x[corner_q, c]  += m * w_q * gW[c]           (K2)
//     d_mask[p, k]       = sum_c val[c] * gW[c]
//     d_dy[p, k]         = m * sum_c dval/dy[c] * gW[c] * [|raw dy| <= R]
//     d_dx[p, k]         = m * sum_c dval/dx[c] * gW[c] * [|raw dx| <= R]
//     d_W[k, c, o]       = sum_p col[p, k, c] * g[p, o]   (col = round_T(val * m), as the forward)
//   with dval/dy = (1-fx)(v10-v00) + fx(v11-v01) and dval/dx = (1-fy)(v01-v00) + fy(v11-v10).
//   At an integer offset frac = 0, so this is the right-derivative: nonzero at
//   offset 0 (the init value), as the production lerp body of the TPU kernel
//   (dcn_pallas_bwd.py:44-56) and the reference DCNv2 col2im_coord.  A NaN offset
//   gets zero offset gradient (the window test is false for NaN); its sample
//   position is the one the forward used (fmaxf turns NaN into the lower bound).
//
// Bound at the training shapes (flagship dla_34 / cost_volume, 384x1280, batch 4
// pairs = 8 images through the 16 DeformBlocks): each kernel does the tap-wise
// product g·W_k^T (2*P*9*Cin*Cout FLOP) and K3 the d_W product once more, against
// bytes of tens of MB: K3 is bound by operations, K2 by operations except at the
// 64-channel 96x320 layers, where the bytes of g and d_x weigh more.  In bf16 on
// tensor cores the two together need ~0.73 ms per step (chip_smoke.py's bound).
//
// K2 has three bodies; the wrapper picks from dtype, widths and window alone
// (ops/dcn_cuda.py: dcn_route, dx_plan).  What bounded the first design (the
// CUDA-core body below) was both halves: the product on f32 FMA units, 15 times
// under the tensor cores' rate, and the scatter, one scalar f32 atomicAdd to
// device memory per (sample, corner, channel), all resolved in L2; around it a
// memset of an f32 d_x and a cast (tools/dx_split.py times each alone).
//   CUDA cores (f32, and bf16 at other widths; `dcn_bwd_dx_kernel`): 256
//   threads, 64 pixels x 64 channels a block, 4 x 4 f32 micro-tiles.  The geometry
//   of its 64 x 9 samples goes to shared memory once; per tap it forms the tile
//   of g·W_k^T from 32-wide chunks of g and W staged in shared memory, then adds
//   m * w_q * gW into the four corners with atomicAdd into an f32 buffer (the
//   wrapper casts it to g's dtype).
//   Tensor cores, scatter in device memory ("tile": bf16 g, Cin % 64 == 0, Cout in
//   {64, 128, 256}, any window; `dcn_bwd_dx_mma_kernel`): one block owns 64
//   pixels x 64 channels and loops over the taps.  The g tile is staged once for
//   all taps, W_k's rows per tap (rounded to bf16, the route's one new rounding),
//   gW = g·W_k^T is mma.sync with f32 accumulators (dcn_mma.cuh: gw_product_64,
//   shared with K3), and the scatter is one 16-byte atomicAdd (float4: four
//   neighbouring channels of a pixel) per corner.  That takes the product off
//   the critical path; what is left is the L2's rate for f32 reductions, which
//   the vector form does not raise (the bytes, not the instructions, bound it).
//   Tensor cores, scatter kept in the block ("patch": the same operands with
//   Cout = 64 and the window R = 1; `dcn_bwd_dx_patch_kernel`): a block owns
//   a patch of d_x in registers and gathers it from gW of the patch grown by
//   the halo R + 1; it writes d_x once, in bf16: no atomics, no memset, no cast,
//   the same bits every run.  The product runs over the halo too (1.9 to 2.5
//   times the pixels), which at Cout 128 and 256 costs more than the device
//   scatter it saves, as do the 25 slots of R = 2: there the "tile" body stays
//   (PERF.md has both per shape).  Under torch.use_deterministic_algorithms the
//   wrapper takes the patch body at every width of the window R = 1 (4 rows at
//   Cout 256), so that d_x is the same bits every run.
//   Its design is described at the kernel.
// K3 has two routes, picked from dtype and shape alone (ops/dcn_cuda.py:
// dcn_route).
//   Route 1, tensor cores (bf16 x and g, Cin % 64 == 0, Cout in {64, 128, 256}:
//   every DeformBlock of the model).  What bounded the CUDA-core design was the
//   f32 FMA rate for both products (15 times under the tensor cores') and the
//   corners, gathered Cout/64 + 1 times with 2-byte loads.  Here one kind of
//   block owns (tap k, 64 input channels, a slice of the 64-pixel tiles):
//     * W_k's 64 x Cout rows go to shared memory once a block, rounded to bf16;
//     * per pixel tile the g tile (64 x Cout bf16) is staged once and feeds both
//       products: gW = g·W_k^T (M = pixels, N = 64 channels, K = Cout) and
//       d_W += col^T·g (M = 64 channels, N = Cout, K = pixels; the transposed
//       operands through ldmatrix.trans), both mma.sync bf16 with f32
//       accumulators (dcn_mma.cuh); the d_W accumulators (64 x Cout f32) stay in
//       registers over the whole slice and are added to d_W with one atomicAdd
//       per element at the end;
//     * the four corners of each (pixel, channel) are gathered once, 16 bytes a
//       thread, eight threads on one pixel's 128-byte line; from them the thread
//       forms the column value (rounded to bf16 as the forward rounds it, for
//       d_W) and val, dval/dy, dval/dx, which it multiplies with its gW values
//       (through shared memory) and reduces over its channels: shuffles over the
//       eight threads of a pixel, then per (pixel, tap) one value of d_mask
//       and the pair of d_offset.  At Cin = 64 one block holds the whole sum and
//       writes it; at Cin > 64 the Cin/64 blocks of a pixel add theirs with f32
//       atomics (one scalar, one float2), so the wrapper hands the two outputs
//       in zeroed then.  Atomics and not a second pass: at most 8 partial sums
//       meet per value, and the second pass would write and read Cin/64 copies
//       of d_offset and d_mask;
//     * the corner loads are started before the gW product (Cout <= 128, where
//       the d_W accumulators leave registers for them): the phases of a tile
//       are separated by barriers, and memory latency paid inside a phase is
//       paid by the whole block.
//   What bounds it now is not the products but the per-sample f32 arithmetic of
//   step 3 (val, two derivatives and the column value per corner quadruple, ~30
//   operations a channel) and the latency between the four barriers of a tile.
//   The order of those atomics changes from run to run: d_offset and d_mask move
//   in their last f32 bits where Cin > 64 (d_W did before and does now).  Under
//   torch.use_deterministic_algorithms each block writes its partial sums to a
//   copy of its own (d_W one per slice, d_offset and d_mask one per channel
//   tile) and the wrapper sums the copies in a fixed order: the same bits every
//   run, for the bytes of those copies.
//   Its one new rounding is W's, f32 to bf16, inside gW; col and g are bf16 on
//   both routes already.
//   Route 0, CUDA cores (f32, and bf16 at any other width): one launch, two kinds
//   of block.  The first blocks each own one (tap, 64-channel, 64-output-channel)
//   tile of d_W and a slice of the pixels: they recompute the column tile
//   (rounded to x's dtype, as the forward), stage the matching g tile, accumulate
//   col^T g in registers and add the partial sum to d_W with one f32 atomicAdd
//   per element.  The other blocks each own (64 pixels, one tap): they form
//   g·W_k^T for every 64-channel chunk, read the four corners, and reduce val·gW,
//   dval/dy·gW and dval/dx·gW over the channels (registers, then warp shuffles):
//   d_offset and d_mask are written once, without atomics.
//
// Tolerance against autograd of the plain version (ops/deform_conv.py:
// deform_conv_plain) on the same inputs, max |diff| / max |plain| per cotangent:
// 1e-4 in f32 (sums in another order, atomics in no fixed order) and 2e-2 in bf16
// (the plain version rounds the column gradient and d_x to bf16 where these
// kernels keep f32 and round d_x once; the tensor-core routes of K2 and K3 round
// W to bf16, 2^-9 relative per term, far inside that: 2.3e-3 .. 3.0e-3 measured
// for K3 over the model's shapes on an H100).  chip_smoke.py and
// tests/test_torch_cuda.py assert both, for d_x also over the image-border and
// patch-seam pixels alone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "dcn_mma.cuh"

// Measurement builds of K2 only (tools/dx_split.py compiles them into libraries
// of their own): 1 forms the product and leaves the scatter out (one store a
// thread), 2 leaves the product out (a constant in its place) and keeps the
// scatter.  0, the default, is the kernel.
#ifndef DCN_DX_SPLIT
#define DCN_DX_SPLIT 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTilePix = 64;   // pixels per tile
constexpr int kTileC = 64;     // channels per tile
constexpr int kChunk = 32;     // output channels per staged chunk of g·W_k^T
constexpr int kTaps = 9;
constexpr int kWeightBlocks = 1056;  // aim for 8 d_W blocks per SM of an H100

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sampling geometry of (pixel p, tap k), the same as the forward's: element offset
// of each corner's channel 0 (-1 outside the image), the fractions, the mask, and
// whether the clamp passes the offset gradient (1) or not (0).
struct Sample {
  int idx[4];
  float fy, fx, m, pass_y, pass_x;
};

// A raw offset clamped to [-R, R] (R >= 0; NaN becomes -R, as in the forward),
// split into floor (returned) and fraction.  At the clamp's upper end the floor
// is R and the fraction 0, so no corner beyond tap + R carries weight.
__device__ __forceinline__ int window_split(float raw, int R, float& frac) {
  const float d = fminf(fmaxf(raw, -(float)R), (float)R);
  const float b = floorf(d);
  frac = d - b;
  return (int)b;
}

// from the raw offset (rdy, rdx) and mask m of (pixel p, tap k)
__device__ __forceinline__ Sample sample_from(float rdy, float rdx, float m, int p, int k,
                                              int H, int W, int C, int R) {
  Sample s;
  const int HW = H * W;
  const int b = p / HW;
  const int rem = p - b * HW;
  const int y = rem / W;
  const int xq = rem - y * W;
  s.m = m;
  const int ky = y + k / 3 - 1;
  const int kx = xq + k % 3 - 1;
  int y0, x0;
  if (R >= 0) {
    y0 = ky + window_split(rdy, R, s.fy);
    x0 = kx + window_split(rdx, R, s.fx);
    s.pass_y = fabsf(rdy) <= (float)R ? 1.f : 0.f;   // false for NaN
    s.pass_x = fabsf(rdx) <= (float)R ? 1.f : 0.f;
  } else {
    float sy = (float)ky + rdy, sx = (float)kx + rdx;
    sy = fminf(fmaxf(sy, -2.f), (float)(H + 1));
    sx = fminf(fmaxf(sx, -2.f), (float)(W + 1));
    const float by = floorf(sy), bx = floorf(sx);
    s.fy = sy - by;
    s.fx = sx - bx;
    y0 = (int)by;
    x0 = (int)bx;
    // beyond [-2, size+1] every corner is outside, so the clamp's zero gradient
    // there changes nothing; only NaN needs the test
    s.pass_y = rdy == rdy ? 1.f : 0.f;
    s.pass_x = rdx == rdx ? 1.f : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = y0 + (q >> 1);
    const int xx = x0 + (q & 1);
    s.idx[q] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? ((b * H + yy) * W + xx) * C : -1;
  }
  return s;
}

__device__ __forceinline__ Sample sample_at(const float* __restrict__ off,
                                            const float* __restrict__ mask, int p, int k,
                                            int H, int W, int C, int R) {
  return sample_from(off[(size_t)p * 18 + 2 * k], off[(size_t)p * 18 + 2 * k + 1],
                     mask[(size_t)p * kTaps + k], p, k, H, W, C, R);
}

__device__ __forceinline__ void corner_weights(float fy, float fx, float cw[4]) {
  cw[0] = (1.f - fy) * (1.f - fx);
  cw[1] = (1.f - fy) * fx;
  cw[2] = fy * (1.f - fx);
  cw[3] = fy * fx;
}

// acc[i][j] = sum_o g[p0 + ty + 16 i, o] * W[k, c0 + tx + 16 j, o] (tx = tid % 16,
// ty = tid / 16): the tap-k tile of g·W^T for 64 pixels x 64 input channels, with g
// and W staged through shared memory 32 output channels at a time.  Starts with a
// barrier, so the caller may have written shared memory just before.
template <typename T>
__device__ __forceinline__ void gw_tile(const T* __restrict__ g, const float* __restrict__ w,
                                        int k, int p0, int c0, int P, int C, int Cout,
                                        float (*s_g)[kTilePix + 1], float (*s_w)[kTileC + 1],
                                        float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int o0 = 0; o0 < Cout; o0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * kTilePix; e += kThreads) {
      const int oo = e % kChunk;
      const int lp = e / kChunk;
      const int p = p0 + lp, o = o0 + oo;
      s_g[oo][lp] = (p < P && o < Cout) ? load_f32(g + (size_t)p * Cout + o) : 0.f;
    }
    for (int e = tid; e < kChunk * kTileC; e += kThreads) {
      const int oo = e % kChunk;
      const int cc = e / kChunk;
      const int c = c0 + cc, o = o0 + oo;
      s_w[oo][cc] = (c < C && o < Cout) ? w[((size_t)k * C + c) * Cout + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int oo = 0; oo < kChunk; ++oo) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_g[oo][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = s_w[oo][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }
}

#if DCN_DX_SPLIT == 1
// where a thread of the scatter-less measurement build leaves its one value
__device__ __forceinline__ size_t split_slot() {
  return ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
}
#endif

// ------------------------------------------------- K2, CUDA-core route: d_x
// g: (B, H, W, Cout) T; off (B, H, W, 9, 2) f32; mask (B, H, W, 9) f32;
// w (3, 3, C, Cout) f32; dx (B, H, W, C) f32, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_dx_kernel(const T* __restrict__ g, const float* __restrict__ off,
                  const float* __restrict__ mask, const float* __restrict__ w,
                  float* __restrict__ dx, int B, int H, int W, int C, int Cout, int R) {
  __shared__ int s_idx[kTilePix * kTaps][4];
  __shared__ float s_wt[kTilePix * kTaps][4];   // mask * bilinear weight of each corner
  __shared__ float s_g[kChunk][kTilePix + 1];
  __shared__ float s_w[kChunk][kTileC + 1];

  const int tid = threadIdx.x;
  const int P = B * H * W;
  const int p0 = blockIdx.x * kTilePix;
  const int c0 = blockIdx.y * kTileC;

  for (int e = tid; e < kTilePix * kTaps; e += kThreads) {
    const int lp = e / kTaps;
    const int k = e - lp * kTaps;
    const int p = p0 + lp;
    if (p < P) {
      const Sample s = sample_at(off, mask, p, k, H, W, C, R);
      float cw[4];
      corner_weights(s.fy, s.fx, cw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[e][q] = s.idx[q];
        s_wt[e][q] = s.m * cw[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[e][q] = -1;
        s_wt[e][q] = 0.f;
      }
    }
  }

  const int tx = tid % 16;
  const int ty = tid / 16;
#if DCN_DX_SPLIT == 1
  float kept = 0.f;
#endif
  for (int k = 0; k < kTaps; ++k) {
    float acc[4][4];
#if DCN_DX_SPLIT == 2
    __syncthreads();   // gw_tile's first barrier: the geometry is in shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 1.f;
#else
    gw_tile<T>(g, w, k, p0, c0, P, C, Cout, s_g, s_w, acc);
#endif
#if DCN_DX_SPLIT == 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kept += s_wt[(ty + 16 * i) * kTaps + k][j] * acc[i][j];
    continue;
#endif
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = (ty + 16 * i) * kTaps + k;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i0 = s_idx[e][q];
        if (i0 < 0) continue;
        const float wq = s_wt[e][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < C) atomicAdd(dx + (size_t)i0 + c, wq * acc[i][j]);
        }
      }
    }
  }
#if DCN_DX_SPLIT == 1
  dx[split_slot()] = kept;
#endif
}

// ----------------------- K3, CUDA-core route: d_offset, d_mask, d_weight
struct CoordSmem {
  int idx[kTilePix][4];
  float fy[kTilePix], fx[kTilePix], m[kTilePix], pass_y[kTilePix], pass_x[kTilePix];
  float g[kChunk][kTilePix + 1];
  float w[kChunk][kTileC + 1];
};

struct WeightSmem {
  int idx[kTilePix][4];
  float wt[kTilePix][4];
  float m[kTilePix];
  float col[kTilePix][kTileC];
  float g[kTilePix][kTileC];
};

union DcoordSmem {
  CoordSmem c;
  WeightSmem w;
};

// One (tap, 64-channel, 64-output-channel) tile of d_W over a slice of the pixel
// tiles: d_W[k, c, o] += sum_p col[p, k, c] * g[p, o].
template <typename T>
__device__ __forceinline__ void dweight_block(const T* __restrict__ x, const T* __restrict__ g,
                                              const float* __restrict__ off,
                                              const float* __restrict__ mask,
                                              float* __restrict__ dw, int t, int splits,
                                              int H, int W, int C, int Cout, int P, int R,
                                              WeightSmem& sm) {
  const int tid = threadIdx.x;
  const int n_ct = (C + kTileC - 1) / kTileC;
  const int n_ot = (Cout + kTileC - 1) / kTileC;
  const int tiles = kTaps * n_ct * n_ot;
  const int split = t / tiles;
  const int tile = t - split * tiles;
  const int k = tile % kTaps;
  const int c0 = ((tile / kTaps) % n_ct) * kTileC;
  const int o0 = (tile / (kTaps * n_ct)) * kTileC;
  const int n_pt = (P + kTilePix - 1) / kTilePix;
  const int per = (n_pt + splits - 1) / splits;
  const int pt_end = min(n_pt, (split + 1) * per);

  const int to = tid % 16;   // output channel o0 + to + 16 j
  const int tc = tid / 16;   // input channel c0 + tc + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int pt = split * per; pt < pt_end; ++pt) {
    const int p0 = pt * kTilePix;
    __syncthreads();  // previous tile consumed
    if (tid < kTilePix) {
      const int p = p0 + tid;
      if (p < P) {
        const Sample s = sample_at(off, mask, p, k, H, W, C, R);
        float cw[4];
        corner_weights(s.fy, s.fx, cw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sm.idx[tid][q] = s.idx[q];
          sm.wt[tid][q] = cw[q];
        }
        sm.m[tid] = s.m;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) sm.idx[tid][q] = -1;
        sm.m[tid] = 0.f;
      }
    }
    __syncthreads();
    // the column tile, rounded to T as the forward rounds it, and the g tile
    for (int e = tid; e < kTilePix * kTileC; e += kThreads) {
      const int cc = e % kTileC;
      const int lp = e / kTileC;
      const int c = c0 + cc;
      float v = 0.f;
      if (c < C && p0 + lp < P) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i0 = sm.idx[lp][q];
          if (i0 >= 0) v += load_f32(x + (size_t)i0 + c) * sm.wt[lp][q];
        }
        v = round_to<T>(v * sm.m[lp]);
      }
      sm.col[lp][cc] = v;
      const int o = o0 + cc;
      sm.g[lp][cc] = (o < Cout && p0 + lp < P) ? load_f32(g + (size_t)(p0 + lp) * Cout + o) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int lp = 0; lp < kTilePix; ++lp) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.col[lp][tc + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.g[lp][to + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tc + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + to + 16 * j;
      if (o < Cout) atomicAdd(dw + ((size_t)k * C + c) * Cout + o, acc[i][j]);
    }
  }
}

// One (64 pixels, tap k): d_mask and d_offset, reduced over all input channels.
template <typename T>
__device__ __forceinline__ void dcoord_block(const T* __restrict__ x, const T* __restrict__ g,
                                             const float* __restrict__ off,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ w,
                                             float* __restrict__ doff, float* __restrict__ dmask,
                                             int t, int H, int W, int C, int Cout, int P, int R,
                                             CoordSmem& sm) {
  const int tid = threadIdx.x;
  const int k = t % kTaps;
  const int p0 = (t / kTaps) * kTilePix;
  if (tid < kTilePix) {
    const int p = p0 + tid;
    if (p < P) {
      const Sample s = sample_at(off, mask, p, k, H, W, C, R);
#pragma unroll
      for (int q = 0; q < 4; ++q) sm.idx[tid][q] = s.idx[q];
      sm.fy[tid] = s.fy;
      sm.fx[tid] = s.fx;
      sm.m[tid] = s.m;
      sm.pass_y[tid] = s.pass_y;
      sm.pass_x[tid] = s.pass_x;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) sm.idx[tid][q] = -1;
      sm.fy[tid] = sm.fx[tid] = sm.m[tid] = sm.pass_y[tid] = sm.pass_x[tid] = 0.f;
    }
  }
  const int tx = tid % 16;
  const int ty = tid / 16;
  float s_val[4] = {0.f, 0.f, 0.f, 0.f};
  float s_dy[4] = {0.f, 0.f, 0.f, 0.f};
  float s_dx[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += kTileC) {
    float acc[4][4];
    gw_tile<T>(g, w, k, p0, c0, P, C, Cout, sm.g, sm.w, acc);  // begins with a barrier
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lp = ty + 16 * i;
      const float fy = sm.fy[lp], fx = sm.fx[lp];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= C) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i0 = sm.idx[lp][q];
          v[q] = i0 >= 0 ? load_f32(x + (size_t)i0 + c) : 0.f;
        }
        const float val = (1.f - fy) * ((1.f - fx) * v[0] + fx * v[1]) +
                          fy * ((1.f - fx) * v[2] + fx * v[3]);
        const float dvy = (1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]);
        const float dvx = (1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]);
        const float gw = acc[i][j];
        s_val[i] = fmaf(val, gw, s_val[i]);
        s_dy[i] = fmaf(dvy, gw, s_dy[i]);
        s_dx[i] = fmaf(dvx, gw, s_dx[i]);
      }
    }
  }
  // the 16 threads of one pixel group are the two halves of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int sh = 8; sh > 0; sh >>= 1) {
      s_val[i] += __shfl_xor_sync(0xffffffffu, s_val[i], sh);
      s_dy[i] += __shfl_xor_sync(0xffffffffu, s_dy[i], sh);
      s_dx[i] += __shfl_xor_sync(0xffffffffu, s_dx[i], sh);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lp = ty + 16 * i;
      const int p = p0 + lp;
      if (p >= P) continue;
      const size_t e = (size_t)p * kTaps + k;
      dmask[e] = s_val[i];
      doff[2 * e] = sm.m[lp] * s_dy[i] * sm.pass_y[lp];
      doff[2 * e + 1] = sm.m[lp] * s_dx[i] * sm.pass_x[lp];
    }
  }
}

// Blocks [0, n_weight) accumulate d_W; the rest write d_offset / d_mask.  The d_W
// blocks come first so that their longer pixel loops start early.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_dcoord_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ off, const float* __restrict__ mask,
                      const float* __restrict__ w, float* __restrict__ doff,
                      float* __restrict__ dmask, float* __restrict__ dw, int B, int H, int W,
                      int C, int Cout, int R, int n_weight, int splits) {
  __shared__ DcoordSmem sm;
  const int P = B * H * W;
  const int t = blockIdx.x;
  if (t < n_weight) {
    dweight_block<T>(x, g, off, mask, dw, t, splits, H, W, C, Cout, P, R, sm.w);
  } else {
    dcoord_block<T>(x, g, off, mask, w, doff, dmask, t - n_weight, H, W, C, Cout, P, R, sm.c);
  }
}


// ------------------------------- K3, tensor-core route (see the file's header)
// dynamic shared memory of one block: W_k rows and the g tile (64 x BN bf16
// each), the column tile (64 x 64 bf16), gW (64 x 72 f32), the tile's geometry
constexpr int dcoord_mma_smem_bytes(int bn) {
  return 2 * 64 * bn * 2 + 64 * 128 + 64 * dcn_mma::kGwStride * 4 + 64 * (16 + 5 * 4);
}

// x (P, C) bf16, g (P, BN) bf16, w (9, C, BN) f32; dw f32, zeroed; doff, dmask
// f32, zeroed when C > 64 (at C == 64 they are written, not added to).
// Block t: combo = t % (9 * C/64) -> (tap k, channel tile c0); slice = t / combos
// -> a contiguous range of 64-pixel tiles.
// det != 0 (torch.use_deterministic_algorithms): no atomics.  dw is (slices, 9,
// C, BN) and doff, dmask (C/64, P, 9, 2), (C/64, P, 9) where C > 64, each written
// in full by one block per element; the wrapper sums the copies in a fixed order.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_dcoord_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                          const float* __restrict__ off, const float* __restrict__ mask,
                          const float* __restrict__ w, float* __restrict__ doff,
                          float* __restrict__ dmask, float* __restrict__ dw, int B, int H, int W,
                          int C, int R, int slices, int det) {
  using namespace dcn_mma;
  constexpr int WN = BN / 4;        // d_W warp tile: 32 channels x WN outputs
  constexpr int NI = WN / 8;
  constexpr int kRowBytes = BN * 2;
  constexpr int kGroups = BN / 8;
  constexpr bool kEarlyCorners = BN <= 128;

  extern __shared__ uint4 dcn_dyn_smem[];
  unsigned char* sW = reinterpret_cast<unsigned char*>(dcn_dyn_smem);   // [c][o]
  unsigned char* sG = sW + 64 * kRowBytes;                              // [p][o]
  unsigned char* sCol = sG + 64 * kRowBytes;                            // [p][c]
  float* sGW = reinterpret_cast<float*>(sCol + 64 * 128);               // [p][c], stride 72
  int4* s_idx = reinterpret_cast<int4*>(sGW + 64 * kGwStride);
  float* s_geo = reinterpret_cast<float*>(s_idx + 64);   // fy, fx, m, pass_y, pass_x: [5][64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int P = B * H * W;
  const int combos = kTaps * (C / 64);
  const int combo = blockIdx.x % combos;
  const int slice = blockIdx.x / combos;
  const int k = combo % kTaps;
  const int c0 = (combo / kTaps) * 64;
  const int n_pt = (P + 63) / 64;
  const int per = (n_pt + slices - 1) / slices;
  const int pt_begin = slice * per;
  const int pt_end = min(n_pt, pt_begin + per);

  // W_k[c0 .. c0 + 64, :] as bf16, once (read after the loop's first barriers)
  stage_weight_rows<BN>(w, k * C + c0, sW);

  const int wm = warp & 1;       // both products: 2 warps along M, 4 along N
  const int wn = warp >> 1;
  float acc_w[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_w[mi][ni][r] = 0.f;

  const uint32_t w_base = smem_addr(sW);
  const uint32_t g_base = smem_addr(sG);
  const uint32_t col_base = smem_addr(sCol);

  // The g tile and the raw geometry of a pixel tile go through registers, so
  // that their loads are in flight together and across the barrier.
  constexpr int kGItems = (64 * kGroups) / kThreads;
  uint4 g_regs[kGItems];
  float raw_dy = 0.f, raw_dx = 0.f, raw_m = 0.f;
  auto load_tile = [&](int pt) {
    const int p0 = pt * 64;
#pragma unroll
    for (int i = 0; i < kGItems; ++i) {
      const int item = tid + kThreads * i;
      const int lp = item / kGroups;
      const int gq = item - lp * kGroups;
      g_regs[i] = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + lp < P)
        g_regs[i] = __ldg(reinterpret_cast<const uint4*>(g + (size_t)(p0 + lp) * BN + gq * 8));
    }
    if (tid < 64 && p0 + tid < P) {
      const size_t e = (size_t)(p0 + tid) * kTaps + k;
      raw_dy = off[2 * e];
      raw_dx = off[2 * e + 1];
      raw_m = mask[e];
    }
  };
  // d_offset and d_mask of a (pixel, tap) sum over the C / 64 channel tiles:
  // one tile writes them, more add them
  const bool one_ctile = C == 64;

  for (int pt = pt_begin; pt < pt_end; ++pt) {
    const int p0 = pt * 64;
    load_tile(pt);
    __syncthreads();   // the previous tile's d_W product has read sG and sCol
    // 1. the g tile, and the geometry of (pixel, tap k)
#pragma unroll
    for (int i = 0; i < kGItems; ++i) {
      const int item = tid + kThreads * i;
      const int lp = item / kGroups;
      *reinterpret_cast<uint4*>(sG + swz(lp, item - lp * kGroups, kRowBytes)) = g_regs[i];
    }
    if (tid < 64) {
      const int p = p0 + tid;
      int4 id = make_int4(-1, -1, -1, -1);
      float fy = 0.f, fx = 0.f, m = 0.f, py = 0.f, px = 0.f;
      if (p < P) {
        const Sample sp = sample_from(raw_dy, raw_dx, raw_m, p, k, H, W, C, R);
        id = make_int4(sp.idx[0], sp.idx[1], sp.idx[2], sp.idx[3]);
        fy = sp.fy; fx = sp.fx; m = sp.m; py = sp.pass_y; px = sp.pass_x;
      }
      s_idx[tid] = id;
      s_geo[tid] = fy;
      s_geo[64 + tid] = fx;
      s_geo[128 + tid] = m;
      s_geo[192 + tid] = py;
      s_geo[256 + tid] = px;
    }
    __syncthreads();

    // The corners, gathered once.  The 8 loads of a thread's two (pixel, 8-channel
    // group) items are started together, each from a valid address (a corner
    // outside the image reads pixel 0 and is zeroed); where the d_W accumulators
    // leave registers for it they are started before the gW product, which hides
    // their latency.
    uint32_t raws[2][4][4];   // item, corner q, channel pair jj: two bf16
    auto load_corners = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int4 id = s_idx[(tid >> 3) + 32 * i];
        const int ids[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint4 t = __ldg(reinterpret_cast<const uint4*>(x + (size_t)max(ids[q], 0) + c0 +
                                                         (tid & 7) * 8));
          if (ids[q] < 0) t = make_uint4(0u, 0u, 0u, 0u);
          raws[i][q][0] = t.x; raws[i][q][1] = t.y; raws[i][q][2] = t.z; raws[i][q][3] = t.w;
        }
      }
    };
    if (kEarlyCorners) load_corners();

    // 2. gW[p, c] = sum_o g[p, o] * W_k[c, o] -> sGW
    gw_product_64<BN>(g_base, w_base, GwTileStore{sGW});
    __syncthreads();

    // 3. the corner values meet gW: the column tile for d_W, d_mask, d_offset
    if (!kEarlyCorners) load_corners();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lp = (tid >> 3) + 32 * i;
      const int cg = tid & 7;
      const int4 id = s_idx[lp];
      const float fy = s_geo[lp], fx = s_geo[64 + lp], m = s_geo[128 + lp];
      const int ids[4] = {id.x, id.y, id.z, id.w};
      const uint32_t (&raw)[4][4] = raws[i];
      float cw[4];
      corner_weights(fy, fx, cw);
      const float* gw_row = sGW + lp * kGwStride + cg * 8;
      const int swap4 = (cg >> 2) << 2;
      const float4 gw_lo = *reinterpret_cast<const float4*>(gw_row + swap4);
      const float4 gw_hi = *reinterpret_cast<const float4*>(gw_row + (swap4 ^ 4));
      const float gws[8] = {gw_lo.x, gw_lo.y, gw_lo.z, gw_lo.w,
                            gw_hi.x, gw_hi.y, gw_hi.z, gw_hi.w};
      float s_val = 0.f, s_dy = 0.f, s_dx = 0.f;
      uint32_t packed[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float colv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = h == 0 ? bf16_lo(raw[q][jj]) : bf16_hi(raw[q][jj]);
          // the forward's column value: corners outside the image are skipped
          float cv = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (ids[q] >= 0) cv += v[q] * cw[q];
          colv[h] = cv * m;
          const float val = (1.f - fy) * ((1.f - fx) * v[0] + fx * v[1]) +
                            fy * ((1.f - fx) * v[2] + fx * v[3]);
          const float dvy = (1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]);
          const float dvx = (1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]);
          const float gwj = gws[2 * jj + h];
          s_val = fmaf(val, gwj, s_val);
          s_dy = fmaf(dvy, gwj, s_dy);
          s_dx = fmaf(dvx, gwj, s_dx);
        }
        packed[jj] = pack_bf16(colv[0], colv[1]);   // rounds to bf16
      }
      *reinterpret_cast<uint4*>(sCol + swz(lp, cg, 128)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      // the eight threads of one pixel are neighbours in a warp
#pragma unroll
      for (int sh = 4; sh > 0; sh >>= 1) {
        s_val += __shfl_xor_sync(0xffffffffu, s_val, sh);
        s_dy += __shfl_xor_sync(0xffffffffu, s_dy, sh);
        s_dx += __shfl_xor_sync(0xffffffffu, s_dx, sh);
      }
      if (cg == 0 && p0 + lp < P) {
        const size_t e = (size_t)(p0 + lp) * kTaps + k;
        const float2 d_yx = make_float2(m * s_dy * s_geo[192 + lp], m * s_dx * s_geo[256 + lp]);
        if (one_ctile || det) {
          // deterministic: channel tile c0 / 64 writes its own partial sums
          const size_t pe = e + (one_ctile ? 0 : (size_t)(c0 / 64) * P * kTaps);
          dmask[pe] = s_val;
          *reinterpret_cast<float2*>(doff + 2 * pe) = d_yx;
        } else {
          atomicAdd(dmask + e, s_val);
          atomicAdd(reinterpret_cast<float2*>(doff + 2 * e), d_yx);
        }
      }
    }
    __syncthreads();

    // 4. d_W[c, o] += sum_p col[p, c] * g[p, o]: warp tile 32 channels x WN outputs
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // col is stored [k = p][m = c]: tiles (p 0-7, c 0-7), (p 0-7, c 8-15),
        // (p 8-15, c 0-7), (p 8-15, c 8-15), each transposed
        const int prow = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4_trans(af[mi], col_base + swz(prow, (wm * 32 + mi * 16) / 8 + ((lane >> 3) & 1), 128));
      }
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t bf[4];
        const int prow = ks * 16 + (lane & 15);
        ldmatrix_x4_trans(bf, g_base + swz(prow, (wn * WN + nj * 16) / 8 + (lane >> 4), kRowBytes));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc_w[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc_w[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

  // 5. this slice's share of d_W[k, c0 .. c0 + 64, :]: added to d_W, or
  // (deterministic) written to the slice's own copy, zeros for an empty slice
  if (det || pt_begin < pt_end) {
    float* dst = dw + (det ? (size_t)slice * kTaps * C * BN : 0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * half;
        float* row = dst + ((size_t)k * C + c) * BN;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int o = wn * WN + ni * 8 + (lane & 3) * 2;
          if (det) {
            *reinterpret_cast<float2*>(row + o) =
                make_float2(acc_w[mi][ni][2 * half], acc_w[mi][ni][2 * half + 1]);
          } else {
            atomicAdd(row + o, acc_w[mi][ni][2 * half]);
            atomicAdd(row + o + 1, acc_w[mi][ni][2 * half + 1]);
          }
        }
      }
  }
}

template <int BN>
int launch_dcoord_mma(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* off,
                      const float* mask, const float* w, float* doff, float* dmask, float* dw,
                      int B, int H, int W, int C, int R, int slices, int det, int smem_bytes,
                      cudaStream_t s) {
  constexpr int kSmem = dcoord_mma_smem_bytes(BN);
  if (smem_bytes != kSmem) return (int)cudaErrorInvalidValue;   // the caller's plan is another's
  auto kernel = dcn_bwd_dcoord_mma_kernel<BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(kTaps * (C / 64) * slices);
  kernel<<<blocks, kThreads, kSmem, s>>>(x, g, off, mask, w, doff, dmask, dw, B, H, W, C, R, slices,
                                         det);
  return (int)cudaGetLastError();
}


// ------------------------------ K2, tensor-core routes (see the file's header)
// Both stage the g rows they need once, for all nine taps, and per tap W_k's 64
// rows (rounded to bf16) and form gW = g·W_k^T with gw_product_64.

// g rows [r0, r0 + rows) of a block's row list into the swizzled tile sG; `pix`
// maps a row to its pixel (< 0: no pixel, the row is zero)
template <int BN, typename PixelOf>
__device__ __forceinline__ void stage_g_rows(const __nv_bfloat16* __restrict__ g, int rows,
                                             PixelOf pix, unsigned char* sG) {
  using namespace dcn_mma;
  constexpr int kGroups = BN / 8;
  for (int item = threadIdx.x; item < rows * kGroups; item += kThreads) {
    const int r = item / kGroups;
    const int gq = item - r * kGroups;
    const int p = pix(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p >= 0) v = __ldg(reinterpret_cast<const uint4*>(g + (size_t)p * BN + gq * 8));
    *reinterpret_cast<uint4*>(sG + swz(r, gq, BN * 2)) = v;
  }
}

// Route 1: 64 pixels x 64 channels a block, the scatter to device memory.
// dynamic shared memory: W_k and the g tile (64 x BN bf16 each), gW (64 x 72
// f32), the corner offsets and weights of the tile's 64 x 9 samples
constexpr int dx_tile_smem_bytes(int bn) {
  return 2 * 64 * bn * 2 + 64 * dcn_mma::kGwStride * 4 + 64 * kTaps * (16 + 16);
}

// g (P, BN) bf16, w (9, C, BN) f32; dx (P, C) f32, zeroed.  Block (x, y, z):
// pixel tile x, channel tile y, share z of the taps (a small layer's nine taps are
// split over gridDim.z blocks so that every SM has one).
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ g, const float* __restrict__ off,
                      const float* __restrict__ mask, const float* __restrict__ w,
                      float* __restrict__ dx, int B, int H, int W, int C, int R) {
  using namespace dcn_mma;
  constexpr int kRowBytes = BN * 2;
  extern __shared__ uint4 dcn_dyn_smem[];
  unsigned char* sW = reinterpret_cast<unsigned char*>(dcn_dyn_smem);   // [c][o]
  unsigned char* sG = sW + 64 * kRowBytes;                              // [p][o]
  float* sGW = reinterpret_cast<float*>(sG + 64 * kRowBytes);           // [p][c], stride 72
  int4* s_idx = reinterpret_cast<int4*>(sGW + 64 * kGwStride);          // [k][p]
  float4* s_wt = reinterpret_cast<float4*>(s_idx + 64 * kTaps);         // mask * corner weight

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int P = B * H * W;
  const int p0 = blockIdx.x * 64;
  const int c0 = blockIdx.y * 64;

  stage_g_rows<BN>(g, 64, [&](int r) { return p0 + r < P ? p0 + r : -1; }, sG);
  for (int e = tid; e < 64 * kTaps; e += kThreads) {
    const int lp = e / kTaps;
    const int k = e - lp * kTaps;
    int4 id = make_int4(-1, -1, -1, -1);
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + lp < P) {
      const Sample sp = sample_at(off, mask, p0 + lp, k, H, W, C, R);
      float cw[4];
      corner_weights(sp.fy, sp.fx, cw);
      id = make_int4(sp.idx[0], sp.idx[1], sp.idx[2], sp.idx[3]);
      wt = make_float4(sp.m * cw[0], sp.m * cw[1], sp.m * cw[2], sp.m * cw[3]);
    }
    s_idx[k * 64 + lp] = id;
    s_wt[k * 64 + lp] = wt;
  }
  const int taps_per = (kTaps + gridDim.z - 1) / gridDim.z;
  const int k_begin = blockIdx.z * taps_per;
  const int k_end = min(kTaps, k_begin + taps_per);
  stage_weight_rows<BN>(w, k_begin * C + c0, sW);
  __syncthreads();

  const uint32_t w_base = smem_addr(sW);
  const uint32_t g_base = smem_addr(sG);
  // a half-warp per sample: lane j of it owns channels 4 j .. 4 j + 3
  const int half = lane >> 4;
  const int j = lane & 15;
  float* dst = dx + c0 + 4 * j;
#if DCN_DX_SPLIT == 1
  float kept = 0.f;
#endif
  for (int k = k_begin; k < k_end; ++k) {
#if DCN_DX_SPLIT != 2
    gw_product_64<BN>(g_base, w_base, GwTileStore{sGW});
#endif
    __syncthreads();   // gW complete; W_k consumed
    if (k + 1 < k_end) stage_weight_rows<BN>(w, (k + 1) * C + c0, sW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lp = warp * 8 + i * 2 + half;
#if DCN_DX_SPLIT == 2
      const float4 gw = make_float4(1.f, 1.f, 1.f, 1.f);
#else
      const float4 gw = *reinterpret_cast<const float4*>(sGW + lp * kGwStride + gw_col(4 * j));
#endif
      const int4 id = s_idx[k * 64 + lp];
      const float4 wt = s_wt[k * 64 + lp];
#if DCN_DX_SPLIT == 1
      kept += (wt.x + wt.y + wt.z + wt.w) * (gw.x + gw.y + gw.z + gw.w) + (float)id.x;
#else
      // one 16-byte reduction a corner: four neighbouring channels of one pixel
      if (id.x >= 0)
        atomicAdd(reinterpret_cast<float4*>(dst + id.x),
                  make_float4(wt.x * gw.x, wt.x * gw.y, wt.x * gw.z, wt.x * gw.w));
      if (id.y >= 0)
        atomicAdd(reinterpret_cast<float4*>(dst + id.y),
                  make_float4(wt.y * gw.x, wt.y * gw.y, wt.y * gw.z, wt.y * gw.w));
      if (id.z >= 0)
        atomicAdd(reinterpret_cast<float4*>(dst + id.z),
                  make_float4(wt.z * gw.x, wt.z * gw.y, wt.z * gw.z, wt.z * gw.w));
      if (id.w >= 0)
        atomicAdd(reinterpret_cast<float4*>(dst + id.w),
                  make_float4(wt.w * gw.x, wt.w * gw.y, wt.w * gw.z, wt.w * gw.w));
#endif
    }
    __syncthreads();   // gW consumed; W_{k+1} staged
  }
#if DCN_DX_SPLIT == 1
  dx[split_slot()] = kept;
#endif
}

template <int BN>
int launch_dx_mma(const __nv_bfloat16* g, const float* off, const float* mask, const float* w,
                  float* dx, int B, int H, int W, int C, int R, int tap_splits, int smem_bytes,
                  cudaStream_t s) {
  constexpr int kSmem = dx_tile_smem_bytes(BN);
  // the caller's plan is another's, or leaves a block without a tap
  if (smem_bytes != kSmem || tap_splits < 1 || tap_splits > kTaps ||
      (kTaps + tap_splits - 1) / tap_splits * (tap_splits - 1) >= kTaps)
    return (int)cudaErrorInvalidValue;
  auto kernel = dcn_bwd_dx_mma_kernel<BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long P = (long long)B * H * W;
  const dim3 grid((unsigned)((P + 63) / 64), (unsigned)(C / 64), (unsigned)tap_splits);
  kernel<<<grid, kThreads, kSmem, s>>>(g, off, mask, w, dx, B, H, W, C, R);
  return (int)cudaGetLastError();
}

// Route 2 (R = 1, the model's window): a block owns a patch of d_x, PH x 16 pixels of one image
// x 64 channels, in registers: thread (pixel d of each band of 4 patch rows,
// channel quarter) holds 16 f32 sums a pixel.  With offsets clamped to [-R, R]
// pixel p receives, per tap, from the output pixels p - tap - e, e in [-R, R]^2
// (window_split: the corner at floor + 1 = R + 1 has weight 0), all inside the
// patch grown by the halo R + 1 (the region).  Per tap:
//   phase 1  gW of the region's rows -> shared memory (tensor cores; a warp
//            forms 32 rows x 64 channels), and each of the region's samples
//            writes, for every e, mask * corner weight (or 0 where none of its
//            corners falls there) into the slot (e, pixel p = sample + tap + e)
//            of the weight list: one writer a slot, so nothing is added and
//            the order of the sum is fixed;
//   phase 2  every thread walks the (2R+1)^2 slots of its pixels and adds
//            weight * gW[p - tap - e] for its 16 channels, weights of 0
//            included: without a branch all of a tap's loads are independent
//            and can be in flight together, and the reads cost shared-memory
//            bandwidth by the warp whatever the weights.  Lanes are
//            neighbouring pixels, so they read neighbouring rows of gW; rows are
//            72 f32 apart and the 16-byte groups of rows 4..7 (mod 8) swap in
//            pairs, which keeps both these reads and the tensor-core fragments'
//            8-byte stores off each other's banks.
// The formulation holds for any window; the kernel is built for R = 1 alone (the
// slot loops unroll): at R = 2 it walks 25 slots over a halo of 3 and measured
// slower than the device-memory scatter, which serves the other windows.
// The next tap's W_k is loaded before phase 2 and stored after it, the next
// tap's raw offsets one tap ahead.
constexpr int kPatchW = 16;
constexpr int kPatchRadius = 1;
__host__ __device__ constexpr int dx_region(int ph, int halo) {
  return (ph + 2 * halo) * (kPatchW + 2 * halo);
}
// dynamic shared memory: the region's g rows (to a multiple of 32) and W_k
// (bf16), the region's gW (f32), the weight list of (2R+1)^2 slots x patch
// pixels (f32)
__host__ __device__ constexpr int dx_patch_smem_bytes(int bn, int ph, int halo) {
  return (dx_region(ph, halo) + 31) / 32 * 32 * bn * 2 + 64 * bn * 2 +
         dx_region(ph, halo) * dcn_mma::kGwStride * 4 +
         (2 * halo - 1) * (2 * halo - 1) * ph * kPatchW * 4;
}

// column of gW's row `row` that holds channel group (of 4) `c4`
__device__ __forceinline__ int gather_col(int row, int c4) { return (c4 ^ ((row >> 2) & 1)) * 4; }

struct GwRegionStore {
  float* sGW;
  int rows;
  __device__ __forceinline__ void operator()(int row, int col, float2 v) const {
    if (row < rows)
      *reinterpret_cast<float2*>(sGW + row * dcn_mma::kGwStride + gather_col(row, col >> 2) +
                                 (col & 3)) = v;
  }
};

// g (B, H, W, BN) bf16, w (9, C, BN) f32; dx (B, H, W, C) bf16, written in full.
// Block (x, y): patch x = (image, patch row, patch column), channel tile y.
template <int BN, int PH>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_dx_patch_kernel(const __nv_bfloat16* __restrict__ g, const float* __restrict__ off,
                        const float* __restrict__ mask, const float* __restrict__ w,
                        __nv_bfloat16* __restrict__ dx, int B, int H, int W, int C) {
  using namespace dcn_mma;
  constexpr int kRowBytes = BN * 2;
  constexpr int kOwn = PH / 4;                   // pixels a thread owns
  constexpr int kPix = PH * kPatchW;
  constexpr int R = kPatchRadius;
  constexpr int halo = R + 1;
  constexpr int RW = kPatchW + 2 * halo;
  constexpr int NR = (PH + 2 * halo) * RW;       // region pixels
  constexpr int g_rows = (NR + 31) / 32 * 32;
  constexpr int ne = 2 * R + 1;                  // slots along an axis

  extern __shared__ uint4 dcn_dyn_smem[];
  unsigned char* sG = reinterpret_cast<unsigned char*>(dcn_dyn_smem);   // [region row][o]
  unsigned char* sW = sG + (size_t)g_rows * kRowBytes;                  // [c][o]
  float* sGW = reinterpret_cast<float*>(sW + 64 * kRowBytes);           // [region row][c]
  float* s_wl = sGW + NR * kGwStride;                                   // [slot][pixel]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tiles_x = (W + kPatchW - 1) / kPatchW;
  const int tiles_y = (H + PH - 1) / PH;
  int t = blockIdx.x;
  const int px0 = (t % tiles_x) * kPatchW;
  t /= tiles_x;
  const int py0 = (t % tiles_y) * PH;
  const int b = t / tiles_y;
  const int c0 = blockIdx.y * 64;

  // pixel of region row r: -1 beyond the region or outside the image
  auto pixel_of = [&](int r, int& y, int& x) {
    const int ry = r / RW;
    y = py0 - halo + ry;
    x = px0 - halo + (r - ry * RW);
    return (r < NR && y >= 0 && y < H && x >= 0 && x < W) ? (b * H + y) * W + x : -1;
  };
  stage_g_rows<BN>(g, g_rows, [&](int r) { int y, x; return pixel_of(r, y, x); }, sG);
  stage_weight_rows<BN>(w, c0, sW);

  // as a sample: region row tid
  static_assert(NR <= kThreads, "one sample a thread");
  int my_y, my_x;
  const int my_p = pixel_of(tid, my_y, my_x);
  const int my_ry = tid / RW;
  const int my_rx = tid - my_ry * RW;
  float raw_dy = 0.f, raw_dx = 0.f, raw_m = 0.f;
  auto load_raw = [&](int k) {
    if (my_p < 0) return;
    const size_t e = (size_t)my_p * kTaps + k;
    raw_dy = __ldg(off + 2 * e);
    raw_dx = __ldg(off + 2 * e + 1);
    raw_m = __ldg(mask + e);
  };
  load_raw(0);

  // as an owner: pixel d of every band of 4 patch rows, channels cq * 16 .. + 16
  const int d = tid & 63;
  const int d_y = d >> 4;
  const int d_x = d & 15;
  const int cq = tid >> 6;
  float acc[kOwn][16];
#pragma unroll
  for (int o = 0; o < kOwn; ++o)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[o][i] = 0.f;

  const uint32_t w_base = smem_addr(sW);
  const uint32_t g_base = smem_addr(sG);
  __syncthreads();

#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const int ty = k / 3 - 1, tx = k % 3 - 1;
    // phase 1: the region's gW, and its samples' weights
#if DCN_DX_SPLIT != 2
    for (int row0 = warp * 32; row0 < g_rows; row0 += 32 * (kThreads / 32))
      gw_product_slab<BN>(g_base, row0, w_base, GwRegionStore{sGW, NR});
#endif
    if (tid < NR) {
      const bool live = my_p >= 0;
      float fy, fx;
      const int by = window_split(raw_dy, R, fy);
      const int bx = window_split(raw_dx, R, fx);
      float cw[4];
      corner_weights(fy, fx, cw);
#pragma unroll
      for (int ey = -R; ey <= R; ++ey) {
        const int py = my_ry - halo + ty + ey;           // the receiving pixel, in the patch
        if (py < 0 || py >= PH) continue;
        const int iy = my_y + ty + ey;                   // and in the image
#pragma unroll
        for (int ex = -R; ex <= R; ++ex) {
          const int px = my_rx - halo + tx + ex;
          if (px < 0 || px >= kPatchW) continue;
          const int ix = my_x + tx + ex;
          const int a = ey - by, bq = ex - bx;           // which corner of the sample, if any
          float wq = 0.f;
          if (live && a >= 0 && a <= 1 && bq >= 0 && bq <= 1 && iy >= 0 && iy < H && ix >= 0 &&
              ix < W)
            wq = raw_m * cw[2 * a + bq];
          s_wl[((ey + R) * ne + ex + R) * kPix + py * kPatchW + px] = wq;
        }
      }
    }
    if (k + 1 < kTaps) load_raw(k + 1);
    __syncthreads();

    // phase 2: gather; the next W_k comes in around it
    WeightRows<BN> w_next;
    if (k + 1 < kTaps) load_weight_rows<BN>(w, (k + 1) * C + c0, w_next);
#if DCN_DX_SPLIT != 1
#pragma unroll
    for (int ey = -R; ey <= R; ++ey) {
#pragma unroll
      for (int ex = -R; ex <= R; ++ex) {
        const float* wl = s_wl + ((ey + R) * ne + ex + R) * kPix + d;
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          const float wq = wl[o * 64];
          const int row = (o * 4 + d_y + halo - ty - ey) * RW + d_x + halo - tx - ex;
          const float* src = sGW + row * kGwStride;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(src + gather_col(row, cq * 4 + i));
            acc[o][4 * i] = fmaf(wq, v.x, acc[o][4 * i]);
            acc[o][4 * i + 1] = fmaf(wq, v.y, acc[o][4 * i + 1]);
            acc[o][4 * i + 2] = fmaf(wq, v.z, acc[o][4 * i + 2]);
            acc[o][4 * i + 3] = fmaf(wq, v.w, acc[o][4 * i + 3]);
          }
        }
      }
    }
#else
    acc[0][0] += sGW[(tid & 63) * kGwStride + (tid >> 6)] + s_wl[tid & 63];
#endif
    if (k + 1 < kTaps) store_weight_rows<BN>(w_next, sW);
    __syncthreads();
  }

  // the patch, rounded to bf16 once: 16 channels (32 bytes) of a pixel a thread
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int y = py0 + o * 4 + d_y;
    const int x = px0 + d_x;
    if (y >= H || x >= W) continue;
    uint4* dst = reinterpret_cast<uint4*>(dx + ((size_t)(b * H + y) * W + x) * C + c0 + cq * 16);
    const float(&v)[16] = acc[o];
    dst[0] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                        pack_bf16(v[6], v[7]));
    dst[1] = make_uint4(pack_bf16(v[8], v[9]), pack_bf16(v[10], v[11]), pack_bf16(v[12], v[13]),
                        pack_bf16(v[14], v[15]));
  }
}

template <int BN, int PH>
int launch_dx_patch(const __nv_bfloat16* g, const float* off, const float* mask, const float* w,
                    __nv_bfloat16* dx, int B, int H, int W, int C, int R, int smem_bytes,
                    cudaStream_t s) {
  constexpr int smem = dx_patch_smem_bytes(BN, PH, kPatchRadius + 1);
  // the caller's plan is another's
  if (R != kPatchRadius || smem_bytes != smem) return (int)cudaErrorInvalidValue;
  auto kernel = dcn_bwd_dx_patch_kernel<BN, PH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long patches =
      (long long)B * ((H + PH - 1) / PH) * ((W + kPatchW - 1) / kPatchW);
  const dim3 grid((unsigned)patches, (unsigned)(C / 64));
  kernel<<<grid, kThreads, smem, s>>>(g, off, mask, w, dx, B, H, W, C);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_dx_tensor(const __nv_bfloat16* g, const float* off, const float* mask, const float* w,
                     void* dx, int B, int H, int W, int C, int R, int patch_h, int tap_splits,
                     int smem_bytes, cudaStream_t s) {
  if (patch_h == 0)
    return launch_dx_mma<BN>(g, off, mask, w, static_cast<float*>(dx), B, H, W, C, R, tap_splits,
                             smem_bytes, s);
  // the patch route: Cout 64, and every width in deterministic mode
  // (ops/dcn_cuda.py:dx_plan); 8 rows at Cout 256 exceed a block's shared memory
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dx);
  if constexpr (BN <= 128) {
    if (patch_h == 8)
      return launch_dx_patch<BN, 8>(g, off, mask, w, out, B, H, W, C, R, smem_bytes, s);
  }
  if (patch_h == 4)
    return launch_dx_patch<BN, 4>(g, off, mask, w, out, B, H, W, C, R, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and g).  Each launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).

// K2.  route 0 (CUDA cores): dx (B, H, W, C) f32 must be zero.  route 1 (tensor
// cores, bf16 g only; `patch_h`, `tap_splits` and `smem_bytes` from
// ops/dcn_cuda.py:dx_plan):
// patch_h == 0 scatters to device memory, dx f32 and zero as on route 0;
// patch_h 4 or 8 (radius 1; Cout 64, or any in deterministic mode; 4 only at
// Cout 256) keeps the scatter in the block and writes dx (B, H, W, C) bf16 in
// full.
int dcn_bwd_dx_launch(const void* g, const void* off, const void* mask, const void* w, void* dx,
                      int B, int H, int W, int C, int Cout, int radius, int dtype, int route,
                      int patch_h, int tap_splits, int smem_bytes, void* stream) {
  const long long P = (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || C <= 0 || C % 64 != 0) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
    const float* of = static_cast<const float*>(off);
    const float* mf = static_cast<const float*>(mask);
    const float* wf = static_cast<const float*>(w);
    switch (Cout) {
      case 64:
        return launch_dx_tensor<64>(gb, of, mf, wf, dx, B, H, W, C, radius, patch_h, tap_splits,
                                     smem_bytes, s);
      case 128:
        return launch_dx_tensor<128>(gb, of, mf, wf, dx, B, H, W, C, radius, patch_h, tap_splits,
                                     smem_bytes, s);
      case 256:
        return launch_dx_tensor<256>(gb, of, mf, wf, dx, B, H, W, C, radius, patch_h, tap_splits,
                                     smem_bytes, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((unsigned)((P + kTilePix - 1) / kTilePix), (unsigned)((C + kTileC - 1) / kTileC));
  if (dtype == 0) {
    dcn_bwd_dx_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(off),
        static_cast<const float*>(mask), static_cast<const float*>(w), static_cast<float*>(dx),
        B, H, W, C, Cout, radius);
  } else {
    dcn_bwd_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(off),
        static_cast<const float*>(mask), static_cast<const float*>(w), static_cast<float*>(dx),
        B, H, W, C, Cout, radius);
  }
  return (int)cudaGetLastError();
}

// K3.  route 0 (CUDA cores): doff (B, H, W, 9, 2) f32 and dmask (B, H, W, 9) f32
// are written in full and dw (3, 3, C, Cout) f32 must be zero.  route 1 (tensor
// cores, bf16 only; `slices` and `smem_bytes` from ops/dcn_cuda.py:dcoord_plan):
// dw must be zero, and doff and dmask too when C > 64 (at C == 64 they are
// written in full); with `deterministic` (route 1 only) dw holds `slices`
// copies and doff, dmask C/64 copies where C > 64, all written in full.
int dcn_bwd_dcoord_launch(const void* x, const void* g, const void* off, const void* mask,
                          const void* w, void* doff, void* dmask, void* dw, int B, int H, int W,
                          int C, int Cout, int radius, int dtype, int route, int slices,
                          int deterministic, int smem_bytes, void* stream) {
  const long long P = (long long)B * H * W;
  const long long n_pt = (P + kTilePix - 1) / kTilePix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || C <= 0 || C % 64 != 0 || slices < 1 || slices > n_pt)
      return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
    const float* of = static_cast<const float*>(off);
    const float* mf = static_cast<const float*>(mask);
    const float* wf = static_cast<const float*>(w);
    float* d1 = static_cast<float*>(doff);
    float* d2 = static_cast<float*>(dmask);
    float* d3 = static_cast<float*>(dw);
    switch (Cout) {
      case 64:
        return launch_dcoord_mma<64>(xb, gb, of, mf, wf, d1, d2, d3, B, H, W, C, radius, slices,
                                     deterministic, smem_bytes, s);
      case 128:
        return launch_dcoord_mma<128>(xb, gb, of, mf, wf, d1, d2, d3, B, H, W, C, radius, slices,
                                      deterministic, smem_bytes, s);
      case 256:
        return launch_dcoord_mma<256>(xb, gb, of, mf, wf, d1, d2, d3, B, H, W, C, radius, slices,
                                      deterministic, smem_bytes, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (deterministic) return (int)cudaErrorInvalidValue;   // route 0 adds d_W with atomics
  const long long tiles =
      (long long)kTaps * ((C + kTileC - 1) / kTileC) * ((Cout + kTileC - 1) / kTileC);
  long long splits = (kWeightBlocks + tiles - 1) / tiles;
  if (splits > n_pt) splits = n_pt;
  if (splits < 1) splits = 1;
  const long long n_weight = tiles * splits;
  const long long blocks = n_weight + n_pt * kTaps;
  if (dtype == 0) {
    dcn_bwd_dcoord_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(off), static_cast<const float*>(mask),
        static_cast<const float*>(w), static_cast<float*>(doff), static_cast<float*>(dmask),
        static_cast<float*>(dw), B, H, W, C, Cout, radius, (int)n_weight, (int)splits);
  } else {
    dcn_bwd_dcoord_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const float*>(off), static_cast<const float*>(mask),
        static_cast<const float*>(w), static_cast<float*>(doff), static_cast<float*>(dmask),
        static_cast<float*>(dw), B, H, W, C, Cout, radius, (int)n_weight, (int)splits);
  }
  return (int)cudaGetLastError();
}

const char* dcn_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
