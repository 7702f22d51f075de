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
// The kernel body lives in dcn_fwd_body.cuh (shared with dcn_fwd_om.cu, which
// reads the raw offset/mask conv output instead of split operands).
//
// Tolerance against the plain version (ops/deform_conv.py:deform_conv_plain,
// same column rounding): max |diff| <= 1e-5 of the output's max in f32 (the
// 9*Cin-term sums are taken in another order) and 8e-3 in bf16 (that, plus
// the output's rounding to bf16: two ulps).  chip_smoke.py asserts both.

#include "dcn_fwd_body.cuh"

using namespace dcn;

namespace {

// off: (B, H, W, 9, 2) f32 as (dy, dx); mask: (B, H, W, 9) f32
struct SplitGeom {
  const float* off;
  const float* mask;
  __device__ __forceinline__ void operator()(int p, int k, float& dy, float& dx,
                                             float& m) const {
    dy = off[(size_t)p * 18 + 2 * k];
    dx = off[(size_t)p * 18 + 2 * k + 1];
    m = mask[(size_t)p * kTaps + k];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int B, int H, int W, int C, int Cout, int R) {
  dcn_fwd_tile<T>(x, SplitGeom{off, mask}, w, bias, out, B, H, W, C, Cout, R);
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
