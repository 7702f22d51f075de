// Device code shared by the two forward DCN kernels for Hopper (sm_90a):
//   dcn_fwd.cu     offsets and mask as separate f32 operands (K1),
//   dcn_fwd_om.cu  the raw 27-channel offset/mask conv output (K4).
// They replace the TPU kernels side_tpu/ops/dcn_pallas.py:240 `_dcn_kernel`,
// :402 `_dcn_kernel_packed` and :691 `_dcn_kernel_packed_om`.  What differs
// between the two files is only how (dy, dx, mask) of one (pixel, tap) is read,
// which the caller passes as a functor `geom(p, k, dy, dx, m)`; everything else
// is one of the two bodies below, chosen by the launcher from dtype and shape
// alone (ops/dcn_cuda.py:dcn_route):
//
//   dcn_fwd_mma_tile  the tensor-core body: bf16 x with Cin a multiple of 64 and
//                     Cout of 64, 128 or 256 (every DeformBlock of the model);
//   dcn_fwd_tile      the CUDA-core body: f32 x, and bf16 at any other width.
//
// What both compute, per (output pixel, tap): clamp the offset to [-R, R]
// (R >= 0; R < 0 = unbounded, "exact"), split it into floor and fraction, read
// the four bilinear corners of the NHWC input with zero outside the image,
// multiply by the mask in f32, round the column value once to x's dtype, and
// contract the (pixels, 9*Cin) column against the (9*Cin, Cout) weight with f32
// accumulation; then add the bias and store in x's dtype.
//
// Bound.  The function is bound by operations at every model shape
// (2*P*9*Cin*Cout FLOP against tens of MB): 0.26 ms for the 16 DeformBlocks of
// a training step on the bf16 tensor cores.  The CUDA-core body's own ceiling
// is the f32 FMA rate, 15 times lower, and it samples the column once per 64
// output channels.  What the tensor-core body does about it:
//   * the contraction is `wgmma.mma_async` m64nNk16 in bf16 with f32
//     accumulators: each of the block's two warpgroups starts four asynchronous
//     64 x N x 16 products per 64-deep stage, both operands read by the tensor
//     cores straight from shared memory in the 128-byte swizzle (dcn_mma.cuh):
//     the column tile K-major, the weight tile N-major as it lies in memory;
//   * one block owns a pixel tile and all of Cout (BN = Cout; BM = 64 pixels at
//     Cout 256, else 128, 64 accumulators or fewer a thread), so every column
//     value is sampled once;
//   * the producer (all 8 warps) reads 16 bytes (8 channels) a thread per
//     corner, eight threads covering one pixel's 128-byte line, lerps and masks
//     in f32, rounds once to bf16 and writes the swizzled A tile.  It runs
//     while the stage's wgmma are in flight, and its corner loads are started
//     one item ahead of their use, across stages too: with one barrier a stage,
//     latency paid between load and use is paid by the whole block;
//   * a pixel tile is a 4 x 16 or 8 x 16 patch of one image and the reduction
//     runs channel chunk outer, tap inner, so the 9 taps of a 64-channel chunk
//     read the same 24 or 35 KB of x;
//   * A and B tiles have two stages in dynamic shared memory, one barrier a
//     stage, and two blocks share an SM;
//   * the weight is staged from its f32 master copy and rounded to bf16 on the
//     way into shared memory (no conversion launch, no bf16 copy in memory);
//   * where the pixel tiles alone give fewer blocks than the card has SMs, the
//     (chunk, tap) list is split over blockIdx.y.  Each split writes its f32
//     partial tile to a scratch buffer and a second small kernel adds the
//     splits in a fixed order, the bias, and rounds.  A second pass and not
//     atomics: the sum order then never changes, so the kernel's output is the
//     same bits run to run, and K4 equals K1 on the split operands exactly.
// What bounds it after that, on an H100: not the products but the producer on
// CUDA cores (the corner gathers, by their count and latency and not by their
// bytes: sampling the regular grid is hardly faster than random offsets; and
// the f32 lerp), then staging the f32 weight, which every pixel tile re-reads
// from L2 (largest at Cout 256), then the geometry pass.  chip_smoke.py prints
// each shape's time, the regular grid's, the CUDA-core body's and the bound.
//
// Numerics of the tensor-core body.  Its one new rounding is the weight's, f32
// to bf16, as the TPU's matrix unit does at default precision; the column is
// bf16 in both bodies and in the plain version.  A single bf16 weight, not a
// high + low pair: against the plain version (f32 weight) the f32 sums differ
// by at most 2.0e-3 of the output's largest value at 9*Cin = 576 .. 4608
// (tests/test_torch_dcn_mma.py), less than one bf16 ulp there, so after the
// output's rounding the two differ by at most one ulp, 2^-7 = 7.8e-3 of the
// largest value: inside the 8e-3 that chip_smoke.py and tests/test_torch_cuda.py
// hold the kernels to.  The f32 route keeps 1e-5 (sum order only).  Measured on
// an H100 (chip_smoke.py, max |diff| / max |plain|, bf16, Cin->Cout at B = 2 /
// B = 8): 512->256 3.0e-3 / 5.9e-3; 256->256 5.8e-3 / 5.0e-3; 256->128 6.1e-3 /
// 4.1e-3; 256->64 6.1e-3 / 5.7e-3; 128->128 5.7e-3 / 5.0e-3 (exact mode 6.2e-3);
// 128->64 5.6e-3 / 5.2e-3; 64->64 4.8e-3 / 4.8e-3; ragged 64->64 at B = 3 6.6e-3.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "dcn_mma.cuh"

namespace dcn {

constexpr int kTilePix = 64;    // output pixels per block (CUDA-core body)
constexpr int kTileOut = 64;    // output channels per block (CUDA-core body)
constexpr int kChunk = 32;      // input channels per staged chunk (CUDA-core body)
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

// Where tap k of flat pixel p (< P) samples: image b, the top-left corner
// (y0, x0) of the bilinear cell, the fractions inside it, and the mask.
struct TapSample {
  int b, y0, x0;
  float fy, fx, m;
};

// the same from the pixel's image, row and column and the tap's raw (dy, dx, m)
__device__ __forceinline__ TapSample tap_sample_at(int b, int y, int xq, int k, float dy,
                                                   float dx, float m, int H, int W, int R) {
  TapSample t;
  t.b = b;
  t.m = m;
  const int ky = y + k / 3 - 1;
  const int kx = xq + k % 3 - 1;
  if (R >= 0) {
    // windowed: clamp the offset, split it into an integer base and a fraction
    dy = fminf(fmaxf(dy, -(float)R), (float)R);
    dx = fminf(fmaxf(dx, -(float)R), (float)R);
    const float by = floorf(dy), bx = floorf(dx);
    t.fy = dy - by;
    t.fx = dx - bx;
    t.y0 = ky + (int)by;
    t.x0 = kx + (int)bx;
  } else {
    // exact: unbounded absolute sample position; beyond [-2, size+1] every
    // corner is outside, so the clamp only keeps the integer conversion defined
    float sy = (float)ky + dy, sx = (float)kx + dx;
    sy = fminf(fmaxf(sy, -2.f), (float)(H + 1));
    sx = fminf(fmaxf(sx, -2.f), (float)(W + 1));
    const float by = floorf(sy), bx = floorf(sx);
    t.fy = sy - by;
    t.fx = sx - bx;
    t.y0 = (int)by;
    t.x0 = (int)bx;
  }
  return t;
}

template <typename Geom>
__device__ __forceinline__ TapSample tap_sample(const Geom& geom, int p, int k, int H, int W,
                                                int R) {
  const int HW = H * W;
  const int b = p / HW;
  const int rem = p - b * HW;
  const int y = rem / W;
  float dy, dx, m;
  geom(p, k, dy, dx, m);
  return tap_sample_at(b, y, rem - y * W, k, dy, dx, m, H, W, R);
}

// the bilinear weights of the four corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1)
__device__ __forceinline__ void corner_weights(float fy, float fx, float (&cw)[4]) {
  cw[0] = (1.f - fy) * (1.f - fx);
  cw[1] = (1.f - fy) * fx;
  cw[2] = fy * (1.f - fx);
  cw[3] = fy * fx;
}

__device__ __forceinline__ bool corner_inside(const TapSample& t, int c, int H, int W) {
  const int yy = t.y0 + (c >> 1);
  const int xx = t.x0 + (c & 1);
  return yy >= 0 && yy < H && xx >= 0 && xx < W;
}

// Sampling geometry of tap k at flat pixel p: the element offset of channel 0 of
// each bilinear corner (-1 = outside the image or p >= P), the corner's weight
// and the mask.
template <typename Geom>
__device__ __forceinline__ void tap_geometry(const Geom& geom, int p, int k, int P, int H, int W,
                                             int C, int R, int (&idx)[4], float (&wt)[4],
                                             float& m) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    idx[c] = -1;
    wt[c] = 0.f;
  }
  m = 0.f;
  if (p >= P) return;
  const TapSample t = tap_sample(geom, p, k, H, W, R);
  m = t.m;
  float cw[4];
  corner_weights(t.fy, t.fx, cw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (corner_inside(t, c, H, W)) {
      idx[c] = ((t.b * H + t.y0 + (c >> 1)) * W + t.x0 + (c & 1)) * C;
      wt[c] = cw[c];
    }
  }
}

// ------------------------------------------------------------ CUDA-core body
// x: (B, H, W, C) NHWC; geom(p, k, dy, dx, m): offset (dy, dx) and mask of tap k at
// flat pixel p; w: (3, 3, C, Cout) f32 = (9*C, Cout); bias: (Cout,) f32;
// out: (B, H, W, Cout).  One block of kThreads threads, blockIdx.x = pixel tile,
// blockIdx.y = output-channel tile; f32 FMA in 4 x 4 register micro-tiles.
template <typename T, typename Geom>
__device__ __forceinline__ void
dcn_fwd_tile(const T* __restrict__ x, const Geom geom, const float* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ out,
             int B, int H, int W, int C, int Cout, int R) {
  __shared__ int s_idx[kTilePix * kTaps][4];   // element offset of each corner pixel, -1 = outside
  __shared__ float s_wt[kTilePix * kTaps][4];  // bilinear weight of each corner
  __shared__ float s_mask[kTilePix * kTaps];
  __shared__ float s_col[kChunk][kTilePix + 1];  // +1: conflict-free transposed writes
  __shared__ float s_w[kChunk][kTileOut];

  const int tid = threadIdx.x;
  const int P = B * H * W;
  const int p0 = blockIdx.x * kTilePix;
  const int n0 = blockIdx.y * kTileOut;

  // 1. sampling geometry of every (pixel, tap) of the tile
  for (int e = tid; e < kTilePix * kTaps; e += kThreads) {
    const int lp = e / kTaps;
    const int k = e - lp * kTaps;
    int idx[4];
    float wt[4];
    float m;
    tap_geometry(geom, p0 + lp, k, P, H, W, C, R, idx, wt, m);
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

template <typename T, typename Geom>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const T* __restrict__ x, const Geom geom, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int B, int H, int W, int C, int Cout, int R) {
  dcn_fwd_tile<T>(x, geom, w, bias, out, B, H, W, C, Cout, R);
}

template <typename T, typename Geom>
inline int launch_fwd_cuda_core(const T* x, const Geom& geom, const float* w, const float* bias,
                                T* out, int B, int H, int W, int C, int Cout, int R,
                                cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const dim3 grid((unsigned)((P + kTilePix - 1) / kTilePix),
                  (unsigned)((Cout + kTileOut - 1) / kTileOut));
  dcn_fwd_kernel<T, Geom><<<grid, kThreads, 0, s>>>(x, geom, w, bias, out, B, H, W, C, Cout, R);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- tensor-core body
// Pixel tile by Cout: 64 x 256, 128 x 128 or 128 x 64, two warpgroups.
// A pixel tile is a patch of one image, 16 pixels wide and 4 (BM = 64) or 8
// (BM = 128) high, not a run along a row: with its halo the patch spans
// 9 x 21 or 13 x 21 pixels, 24 or 35 KB per 64-channel chunk, which the 9 taps
// of the chunk read again and again.
constexpr int kTileW = 16;
constexpr int fwd_mma_bm(int cout) { return cout == 256 ? 64 : 128; }

// dynamic shared memory of one block: two stages of A (BM x 64 bf16) and B
// (64 x BN bf16), the geometry of BM x 9 (pixel, tap) pairs (20 bytes each)
// and the flat pixel index of the tile's BM pixels
constexpr int fwd_mma_smem_bytes(int bm, int bn) {
  return 2 * bm * 128 + 2 * dcn_mma::kChunkK * bn * 2 + bm * kTaps * 20 + bm * 4;
}

// x (B, H, W, C) bf16 with C % 64 == 0; w (9*C, BN) f32; out (P, BN) bf16.
// blockIdx.x = pixel tile (image, patch row, patch column), blockIdx.y = split
// of the (chunk, tap) list.  With splits == 1 the block adds the bias and writes
// `out`; else it writes its f32 partial sums to part[blockIdx.y] (P, BN) and
// dcn_fwd_finish_kernel ends the job.
template <typename Geom, int BM, int BN>
__device__ __forceinline__ void
dcn_fwd_mma_tile(const __nv_bfloat16* __restrict__ x, const Geom geom,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int B, int H, int W, int C, int R, int splits) {
  using namespace dcn_mma;
  constexpr int kTileH = BM / kTileW;
  constexpr int kABytes = BM * 128;
  constexpr int kBBytes = kChunkK * BN * 2;

  extern __shared__ __align__(1024) uint4 dcn_dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dcn_dyn_smem);
  if (smem_addr(smem) & 1023u) __trap();   // the 128-byte swizzle needs 1024-byte tiles
  unsigned char* sA = smem;
  unsigned char* sB = sA + 2 * kABytes;
  // per (pixel, tap): {element offset of corner (y0, x0), may lie outside; bit c
  // set = corner c inside the image; fy; fx}, and the mask
  int4* s_geo = reinterpret_cast<int4*>(sB + 2 * kBBytes);
  float* s_mask = reinterpret_cast<float*>(s_geo + BM * kTaps);
  int* s_pix = reinterpret_cast<int*>(s_mask + BM * kTaps);   // flat pixel, -1 = outside

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int P = B * H * W;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tile_b = blockIdx.x / (tiles_x * tiles_y);
  const int tile_r = blockIdx.x - tile_b * tiles_x * tiles_y;
  const int ty0 = (tile_r / tiles_x) * kTileH;
  const int tx0 = (tile_r % tiles_x) * kTileW;
  const int WC = W * C;

  // 1. sampling geometry of every (pixel, tap) of the tile, once: first every
  // offset and mask this thread needs (the loads in flight together), then the
  // arithmetic
  constexpr int kGeoTurns = (BM * kTaps + kThreads - 1) / kThreads;
  float g_dy[kGeoTurns], g_dx[kGeoTurns], g_m[kGeoTurns];
#pragma unroll
  for (int i = 0; i < kGeoTurns; ++i) {
    const int e = tid + kThreads * i;
    const int lp = e / kTaps;
    const int y = ty0 + lp / kTileW, xq = tx0 + lp % kTileW;
    g_dy[i] = g_dx[i] = g_m[i] = 0.f;
    if (e < BM * kTaps && y < H && xq < W)
      geom((tile_b * H + y) * W + xq, e - lp * kTaps, g_dy[i], g_dx[i], g_m[i]);
  }
#pragma unroll
  for (int i = 0; i < kGeoTurns; ++i) {
    const int e = tid + kThreads * i;
    if (e >= BM * kTaps) break;
    const int lp = e / kTaps;
    const int k = e - lp * kTaps;
    const int y = ty0 + lp / kTileW, xq = tx0 + lp % kTileW;
    int4 geo = make_int4(0, 0, 0, 0);
    float m = 0.f;
    int p = -1;
    if (y < H && xq < W) {
      p = (tile_b * H + y) * W + xq;
      const TapSample t = tap_sample_at(tile_b, y, xq, k, g_dy[i], g_dx[i], g_m[i], H, W, R);
      int inside = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) inside |= corner_inside(t, c, H, W) ? (1 << c) : 0;
      geo = make_int4(((t.b * H + t.y0) * W + t.x0) * C, inside, __float_as_int(t.fy),
                      __float_as_int(t.fx));
      m = t.m;
    }
    s_geo[e] = geo;
    s_mask[e] = m;
    if (k == 0) s_pix[lp] = p;
  }

  // this block's share of the (channel chunk, tap) list, chunk outer
  const int n_iter = (C / kChunkK) * kTaps;
  const int per = (n_iter + splits - 1) / splits;
  const int it_begin = blockIdx.y * per;
  const int it_end = min(n_iter, it_begin + per);

  // 2. producer of one stage (the column tile and the weight rows of one
  // (chunk, tap)), in kRounds rounds.  In a round a thread owns one (pixel lp,
  // 8-channel group cg) item: 8 neighbouring threads read the 128 bytes of one
  // corner pixel.  The four corner loads of a round are started one round ahead
  // of their use, across stages too, so that the lerp of one item runs while
  // the next item's loads are in flight; each load reads a valid address (a
  // corner outside the image reads pixel 0 and is dropped when summed).
  constexpr int kRounds = BM / 32;
  constexpr int kWItems = BN / 32;                    // 8-column weight groups a thread stages
  constexpr bool kWInRounds = kWItems <= kRounds;     // one at most a round, else after them
  constexpr int kWEvery = kWInRounds ? kRounds / kWItems : kRounds;   // rounds per weight item
  const int cg = tid & 7;
  struct Corners {
    uint4 raw[4];
    int4 geo;
  };
  auto start_loads = [&](Corners& c, int it, int r) {
    const int c0 = (it / kTaps) * kChunkK;
    const int k = it - (it / kTaps) * kTaps;
    c.geo = s_geo[((tid >> 3) + 32 * r) * kTaps + k];
    const __nv_bfloat16* xc = x + c0 + cg * 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i_q = c.geo.x + (q >> 1) * WC + (q & 1) * C;
      c.raw[q] = __ldg(reinterpret_cast<const uint4*>(
          xc + (size_t)(((c.geo.y >> q) & 1) ? i_q : 0)));
    }
  };
  auto finish = [&](const Corners& c, int it, int r, int buf) {
    const int k = it - (it / kTaps) * kTaps;
    const int lp = (tid >> 3) + 32 * r;
    const float m = s_mask[lp * kTaps + k];
    float cw[4];
    corner_weights(__int_as_float(c.geo.z), __int_as_float(c.geo.w), cw);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((c.geo.y >> q) & 1) {
        float f[8];
        unpack8(c.raw[q], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += f[j] * cw[q];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] *= m;
    *reinterpret_cast<uint4*>(sA + buf * kABytes + swz(lp, cg, 128)) = pack8(v);   // rounds to bf16
  };
  // one stage; `next_it` >= 0 is the stage whose first round's loads are started
  // during this stage's last round
  Corners ring[2];
  auto produce = [&](int it, int buf, int next_it) {
    const int w_row0 = (it - (it / kTaps) * kTaps) * C + (it / kTaps) * kChunkK;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      float4 w_lo, w_hi;
      // a weight item's f32 loads are in flight while the round's lerp runs
      const bool w_here = kWInRounds && r % kWEvery == 0;
      const int w_item = r / kWEvery;
      if (w_here) load_weight_item<BN>(w, w_row0, w_item, w_lo, w_hi);
      if (r + 1 < kRounds) {
        start_loads(ring[(r + 1) & 1], it, r + 1);
      } else if (next_it >= 0) {
        start_loads(ring[0], next_it, 0);
      }
      finish(ring[r & 1], it, r, buf);
      if (w_here) store_weight_item<BN>(w_lo, w_hi, w_item, sB + buf * kBBytes);
    }
    if (!kWInRounds) stage_weight_rows_blocked<BN>(w, w_row0, sB + buf * kBBytes);
  };

  // 3. the product.  Warpgroup wg (4 warps) owns 64 rows x WGN columns of the
  // tile: at BM = 128 its own 64 pixels and all of BN, at BM = 64 (BN = 256) all
  // the pixels and its half of BN.  It starts the four 64 x WGN x 16 wgmma of a
  // stage, then samples the next stage while the tensor cores work, then waits.
  constexpr int WGN = BM == 128 ? BN : BN / 2;
  const int wg = warp >> 2;
  const int row0 = BM == 128 ? wg * 64 : 0;
  const int col0 = BM == 128 ? 0 : wg * WGN;
  float acc[WGN / 2];
#pragma unroll
  for (int r = 0; r < WGN / 2; ++r) acc[r] = 0.f;

  __syncthreads();   // geometry written
  if (it_begin < it_end) {
    start_loads(ring[0], it_begin, 0);
    produce(it_begin, 0, it_begin + 1 < it_end ? it_begin + 1 : -1);
  }
  fence_async_smem();
  __syncthreads();

  for (int it = it_begin; it < it_end; ++it) {
    const int buf = (it - it_begin) & 1;
    const uint32_t a_addr = smem_addr(sA + buf * kABytes) + row0 * 128;
    const uint32_t b_addr = smem_addr(sB + buf * kBBytes) + (col0 / 64) * 8192;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks)
      Wgmma<WGN>::mma(acc, wgmma_desc(a_addr + ks * 32, 16, 1024),
                      wgmma_desc(b_addr + ks * 2048, 8192, 1024));
    wgmma_commit();
    // the other stage was last read by the products that ended before the
    // barrier of the previous turn
    if (it + 1 < it_end) produce(it + 1, buf ^ 1, it + 2 < it_end ? it + 2 : -1);
    wgmma_wait_all();
    fence_async_smem();
    __syncthreads();
  }

  // 4. bias and store in bf16, or the f32 partial sums of this split.  Thread
  // (warp q of the warpgroup, lane) holds rows 16 q + lane / 4 (+ 8) and, per
  // group j of 8 columns, columns 8 j + 2 (lane % 4) (+ 1).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = s_pix[row0 + 16 * (warp & 3) + (lane >> 2) + 8 * half];
    if (p < 0) continue;
#pragma unroll
    for (int j = 0; j < WGN / 8; ++j) {
      const int n = col0 + 8 * j + (lane & 3) * 2;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(out + (size_t)p * BN + n) =
            pack_bf16(v0 + bias[n], v1 + bias[n + 1]);
      } else {
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * P + p) * BN + n) =
            make_float2(v0, v1);
      }
    }
  }
}

template <typename Geom, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
dcn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const Geom geom,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int B, int H, int W, int C, int R, int splits) {
  dcn_fwd_mma_tile<Geom, BM, BN>(x, geom, w, bias, out, part, B, H, W, C, R, splits);
}

// out[p, n] = bf16(sum_s part[s, p, n] + bias[n]), splits added in order
__global__ void __launch_bounds__(kThreads)
dcn_fwd_finish_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, long long n_pairs, int Cout, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const int n = (int)((2 * i) % Cout);
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 t = *reinterpret_cast<const float2*>(part + (size_t)s * 2 * n_pairs + 2 * i);
    v0 += t.x;
    v1 += t.y;
  }
  *reinterpret_cast<uint32_t*>(out + 2 * i) = dcn_mma::pack_bf16(v0 + bias[n], v1 + bias[n + 1]);
}

template <typename Geom, int BN>
inline int launch_fwd_mma_bn(const __nv_bfloat16* x, const Geom& geom, const float* w,
                             const float* bias, __nv_bfloat16* out, float* part, int B, int H,
                             int W, int C, int R, int splits, int smem_bytes, cudaStream_t s) {
  constexpr int BM = fwd_mma_bm(BN);
  constexpr int kSmem = fwd_mma_smem_bytes(BM, BN);
  if (smem_bytes != kSmem) return (int)cudaErrorInvalidValue;   // the caller's plan is another's
  auto kernel = dcn_fwd_mma_kernel<Geom, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long P = (long long)B * H * W;
  const long long tiles =
      (long long)B * ((H + BM / kTileW - 1) / (BM / kTileW)) * ((W + kTileW - 1) / kTileW);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  kernel<<<grid, kThreads, kSmem, s>>>(x, geom, w, bias, out, part, B, H, W, C, R, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n_pairs = P * BN / 2;
  dcn_fwd_finish_kernel<<<(unsigned)((n_pairs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, bias, out, n_pairs, BN, splits);
  return (int)cudaGetLastError();
}

// The tensor-core route.  The caller (ops/dcn_cuda.py:fwd_plan) chose `splits`
// and states the dynamic shared memory it planned for; `part` is its scratch of
// splits * P * Cout f32 (unused when splits == 1).
template <typename Geom>
inline int launch_fwd_mma(const __nv_bfloat16* x, const Geom& geom, const float* w,
                          const float* bias, __nv_bfloat16* out, float* part, int B, int H, int W,
                          int C, int Cout, int R, int splits, int smem_bytes, cudaStream_t s) {
  if (C <= 0 || C % dcn_mma::kChunkK != 0 || splits < 1 || splits > (C / dcn_mma::kChunkK) * kTaps ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (Cout) {
    case 64:
      return launch_fwd_mma_bn<Geom, 64>(x, geom, w, bias, out, part, B, H, W, C, R, splits,
                                         smem_bytes, s);
    case 128:
      return launch_fwd_mma_bn<Geom, 128>(x, geom, w, bias, out, part, B, H, W, C, R, splits,
                                          smem_bytes, s);
    case 256:
      return launch_fwd_mma_bn<Geom, 256>(x, geom, w, bias, out, part, B, H, W, C, R, splits,
                                          smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dcn
