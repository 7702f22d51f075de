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
//     d_x[corner_q, c]  += m * w_q * gW[c]           (K2, f32 atomics)
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
// This first design runs the products on CUDA cores in f32 (no mma/wgmma, no
// TMA), and K2 scatters with f32 atomics.
//
// Design (256 threads, 64 pixels x 64 channels per tile, 4 x 4 micro-tiles):
//   K2: one block per (64 pixels, 64 input channels).  The geometry of its 64 x 9
//       (pixel, tap) samples goes to shared memory once; per tap it forms the
//       64 x 64 tile of g·W_k^T from 32-wide chunks of g and W staged in shared
//       memory, then adds m * w_q * gW into the four corners with atomicAdd into an
//       f32 buffer (the wrapper casts it to x's dtype).
//   K3: one launch, two kinds of block.  The first blocks each own one
//       (tap, 64-channel, 64-output-channel) tile of d_W and a slice of the pixels:
//       they recompute the column tile (rounded to x's dtype, as the forward),
//       stage the matching g tile, accumulate col^T g in registers and add the
//       partial sum to d_W with one f32 atomicAdd per element.  The other blocks
//       each own (64 pixels, one tap): they form g·W_k^T for every 64-channel
//       chunk, read the four corners, and reduce val·gW, dval/dy·gW and dval/dx·gW
//       over the channels (registers, then warp shuffles): d_offset and d_mask are
//       written once, without atomics.
//
// Tolerance against autograd of the plain version (ops/deform_conv.py:
// deform_conv_plain) on the same inputs, max |diff| / max |plain| per cotangent:
// 1e-4 in f32 (sums in another order, atomics in no fixed order) and 2e-2 in bf16
// (the plain version rounds the column gradient and d_x to bf16 where these
// kernels keep f32).  chip_smoke.py and tests/test_torch_cuda.py assert both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

__device__ __forceinline__ Sample sample_at(const float* __restrict__ off,
                                            const float* __restrict__ mask, int p, int k,
                                            int H, int W, int C, int R) {
  Sample s;
  const int HW = H * W;
  const int b = p / HW;
  const int rem = p - b * HW;
  const int y = rem / W;
  const int xq = rem - y * W;
  const float rdy = off[(size_t)p * 18 + 2 * k];
  const float rdx = off[(size_t)p * 18 + 2 * k + 1];
  s.m = mask[(size_t)p * kTaps + k];
  const int ky = y + k / 3 - 1;
  const int kx = xq + k % 3 - 1;
  int y0, x0;
  if (R >= 0) {
    const float dy = fminf(fmaxf(rdy, -(float)R), (float)R);
    const float dx = fminf(fmaxf(rdx, -(float)R), (float)R);
    const float by = floorf(dy), bx = floorf(dx);
    s.fy = dy - by;
    s.fx = dx - bx;
    y0 = ky + (int)by;
    x0 = kx + (int)bx;
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

// ------------------------------------------------------------------------- K2: d_x
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
  for (int k = 0; k < kTaps; ++k) {
    float acc[4][4];
    gw_tile<T>(g, w, k, p0, c0, P, C, Cout, s_g, s_w, acc);
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
}

// ------------------------------------------------ K3: d_offset, d_mask, d_weight
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and g).  Each launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).

// K2.  dx (B, H, W, C) f32 must be zero.
int dcn_bwd_dx_launch(const void* g, const void* off, const void* mask, const void* w, void* dx,
                      int B, int H, int W, int C, int Cout, int radius, int dtype,
                      void* stream) {
  const long long P = (long long)B * H * W;
  const dim3 grid((unsigned)((P + kTilePix - 1) / kTilePix), (unsigned)((C + kTileC - 1) / kTileC));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// K3.  doff (B, H, W, 9, 2) f32 and dmask (B, H, W, 9) f32 are written in full;
// dw (3, 3, C, Cout) f32 must be zero.
int dcn_bwd_dcoord_launch(const void* x, const void* g, const void* off, const void* mask,
                          const void* w, void* doff, void* dmask, void* dw, int B, int H, int W,
                          int C, int Cout, int radius, int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  const long long n_pt = (P + kTilePix - 1) / kTilePix;
  const long long tiles =
      (long long)kTaps * ((C + kTileC - 1) / kTileC) * ((Cout + kTileC - 1) / kTileC);
  long long splits = (kWeightBlocks + tiles - 1) / tiles;
  if (splits > n_pt) splits = n_pt;
  if (splits < 1) splits = 1;
  const long long n_weight = tiles * splits;
  const long long blocks = n_weight + n_pt * kTaps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
