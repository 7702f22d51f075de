// Modulated deformable 3x3 convolution (DCNv2), forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   side_tpu/ops/dcn_pallas.py:240  _dcn_kernel         (per-image, C > 128 or B == 1)
//   side_tpu/ops/dcn_pallas.py:402  _dcn_kernel_packed  (batch packed into TPU lanes)
// The TPU kernels decompose the bilinear sample into statically shifted windows
// and lane-pack the batch because Mosaic cannot gather.  A GPU gathers, so this
// kernel takes the native DCNv2 form: for every (output pixel, tap) clamp the
// offset to [-R, R] (R >= 0; R < 0 = unbounded, the "exact" mode), read the four
// bilinear corners of the NHWC input with zero outside the image, multiply by
// the mask, round the column value to x's dtype (the TPU kernel writes its
// im2col columns in the activation dtype), and contract against the
// (9*Cin, Cout) weight with f32 accumulation, then add the bias.
//
// Bound at the serving shapes (flagship dla_34 / cost_volume, 384x1280, the 16
// DeformBlocks of one stereo frame = 2 images): 2 * sum H*W*9*Cin*Cout*2 =
// 53.2 GFLOP, while the bytes that must move (inputs once, output once) are
// tens of MB.  On tensor cores that is compute-bound: 53.2e9 / 989e12 = 54 us
// per frame in bf16.  This first design runs the contraction on CUDA cores in
// f32 (no mma/wgmma, no TMA, no pipelining), so its own ceiling is the f32
// FMA rate, 67 TFLOP/s.
//
// Design: one block of 256 threads owns 64 output pixels x 64 output channels.
//   1. It computes the 4 corner offsets, the 4 bilinear weights and the mask of
//      each of its 64 x 9 (pixel, tap) pairs once, into shared memory.
//   2. For each tap and each chunk of 32 input channels it samples the 64 x 32
//      column tile into shared memory (a warp reads 32 neighbouring channels of
//      one corner: coalesced) and stages the matching 32 x 64 weight rows.
//   3. Each thread accumulates a 4 x 4 micro-tile in f32 registers.
//   4. Bias is added and the tile is stored in x's dtype.
//
// Tolerance against the plain version (ops/deform_conv.py:deform_conv_plain,
// same column rounding): max |diff| <= 1e-5 of the output's max in f32 (the
// 9*Cin-term sums are taken in another order) and 8e-3 in bf16 (that, plus
// the output's rounding to bf16: two ulps).  chip_smoke.py asserts both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTilePix = 64;    // output pixels per block
constexpr int kTileOut = 64;    // output channels per block
constexpr int kChunk = 32;      // input channels per staged chunk
constexpr int kThreads = 256;
constexpr int kTaps = 9;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// v rounded to T's precision, kept in f32 for the contraction
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x: (B, H, W, C) NHWC; off: (B, H, W, 9, 2) f32 as (dy, dx); mask: (B, H, W, 9) f32;
// w: (3, 3, C, Cout) f32 = (9*C, Cout); bias: (Cout,) f32; out: (B, H, W, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int B, int H, int W, int C, int Cout, int R) {
  __shared__ int s_idx[kTilePix * kTaps][4];   // element offset of each corner pixel, -1 = outside
  __shared__ float s_wt[kTilePix * kTaps][4];  // bilinear weight of each corner
  __shared__ float s_mask[kTilePix * kTaps];
  __shared__ float s_col[kChunk][kTilePix + 1];  // +1: conflict-free transposed writes
  __shared__ float s_w[kChunk][kTileOut];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int P = B * HW;
  const int p0 = blockIdx.x * kTilePix;
  const int n0 = blockIdx.y * kTileOut;

  // 1. sampling geometry of every (pixel, tap) of the tile
  for (int e = tid; e < kTilePix * kTaps; e += kThreads) {
    const int lp = e / kTaps;
    const int k = e - lp * kTaps;
    const int p = p0 + lp;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float m = 0.f;
    if (p < P) {
      const int b = p / HW;
      const int rem = p - b * HW;
      const int y = rem / W;
      const int xq = rem - y * W;
      float dy = off[(size_t)p * 18 + 2 * k];
      float dx = off[(size_t)p * 18 + 2 * k + 1];
      m = mask[(size_t)p * kTaps + k];
      const int ky = y + k / 3 - 1;
      const int kx = xq + k % 3 - 1;
      int y0, x0;
      float fy, fx;
      if (R >= 0) {
        // windowed: clamp the offset, split it into an integer base and a fraction
        dy = fminf(fmaxf(dy, -(float)R), (float)R);
        dx = fminf(fmaxf(dx, -(float)R), (float)R);
        const float by = floorf(dy), bx = floorf(dx);
        fy = dy - by;
        fx = dx - bx;
        y0 = ky + (int)by;
        x0 = kx + (int)bx;
      } else {
        // exact: unbounded absolute sample position; beyond [-2, size+1] every
        // corner is outside, so the clamp only keeps the integer conversion defined
        float sy = (float)ky + dy, sx = (float)kx + dx;
        sy = fminf(fmaxf(sy, -2.f), (float)(H + 1));
        sx = fminf(fmaxf(sx, -2.f), (float)(W + 1));
        const float by = floorf(sy), bx = floorf(sx);
        fy = sy - by;
        fx = sx - bx;
        y0 = (int)by;
        x0 = (int)bx;
      }
      const float cw[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx), fy * fx};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int yy = y0 + (c >> 1);
        const int xx = x0 + (c & 1);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          idx[c] = ((b * H + yy) * W + xx) * C;
          wt[c] = cw[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[e][c] = idx[c];
      s_wt[e][c] = wt[c];
    }
    s_mask[e] = m;
  }

  const int tx = tid % 16;  // output-channel group: n0 + tx + 16*j
  const int ty = tid / 16;  // pixel group: p0 + ty + 16*i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int cl = tid % kChunk;              // channel this thread samples
  const int lp_start = tid / kChunk;        // first pixel this thread samples
  constexpr int kPixStep = kThreads / kChunk;

  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      __syncthreads();  // geometry written / previous chunk consumed
      // 2a. sample the column tile: value = bilinear(x) * mask, rounded to T
      const int c = c0 + cl;
      for (int lp = lp_start; lp < kTilePix; lp += kPixStep) {
        const int e = lp * kTaps + k;
        float v = 0.f;
        if (c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i0 = s_idx[e][q];
            if (i0 >= 0) v += load_f32(x + (size_t)i0 + c) * s_wt[e][q];
          }
          v = round_to<T>(v * s_mask[e]);
        }
        s_col[cl][lp] = v;
      }
      // 2b. stage the weight rows k*C + c0 .. + kChunk, columns n0 .. + kTileOut
      for (int e = tid; e < kChunk * kTileOut; e += kThreads) {
        const int kk = e / kTileOut;
        const int j = e - kk * kTileOut;
        float wv = 0.f;
        if (c0 + kk < C && n0 + j < Cout) wv = w[((size_t)k * C + c0 + kk) * Cout + n0 + j];
        s_w[kk][j] = wv;
      }
      __syncthreads();
      // 3. f32 micro-tile update
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_col[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = s_w[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
  }

  // 4. bias, store in x's dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[(size_t)p * Cout + n] = store_as<T>(acc[i][j] + bias[n]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
int dcn_fwd_launch(const void* x, const void* off, const void* mask, const void* w,
                   const void* bias, void* out, int B, int H, int W, int C, int Cout,
                   int radius, int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  const dim3 grid((unsigned)((P + kTilePix - 1) / kTilePix),
                  (unsigned)((Cout + kTileOut - 1) / kTileOut));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcn_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(off),
        static_cast<const float*>(mask), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, Cout, radius);
  } else {
    dcn_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(off),
        static_cast<const float*>(mask), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout,
        radius);
  }
  return (int)cudaGetLastError();
}

const char* dcn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
