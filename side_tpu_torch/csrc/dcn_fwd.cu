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
// per frame in bf16.
//
// Two routes, picked from dtype and shape alone (ops/dcn_cuda.py:dcn_route);
// both bodies, their design and the numerics are in dcn_fwd_body.cuh, shared
// with dcn_fwd_om.cu (which reads the raw offset/mask conv output instead of
// split operands):
//   route 1, tensor cores: bf16 x, Cin % 64 == 0, Cout in {64, 128, 256}.
//       wgmma bf16 with f32 accumulators; one block owns a pixel tile and all
//       of Cout, samples each column value once with 16-byte loads, two stages
//       in dynamic shared memory; small layers split the reduction.
//   route 0, CUDA cores: f32 x and every other bf16 width.  One block of 256
//       threads owns 64 output pixels x 64 output channels and accumulates 4 x 4
//       micro-tiles with f32 FMA; its ceiling is the 67 TFLOP/s f32 rate.
//
// Tolerance against the plain version (ops/deform_conv.py:deform_conv_plain,
// same column rounding): max |diff| <= 1e-5 of the output's max in f32 (the
// 9*Cin-term sums are taken in another order) and 8e-3 in bf16 (sum order, on
// route 1 the weight's rounding to bf16, and the output's rounding: at most one
// bf16 ulp of the largest value, 2^-7).  chip_smoke.py asserts both.

#include "dcn_fwd_body.cuh"

namespace dcn {

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

}  // namespace dcn

using namespace dcn;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  route: 0 = CUDA cores, 1 =
// tensor cores (bf16 only; `splits`, `smem_bytes` and the scratch `part` of
// splits * P * Cout f32 come from ops/dcn_cuda.py:fwd_plan and are unused on
// route 0).  Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int dcn_fwd_launch(const void* x, const void* off, const void* mask, const void* w,
                   const void* bias, void* out, void* part, int B, int H, int W, int C,
                   int Cout, int radius, int dtype, int route, int splits, int smem_bytes,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SplitGeom geom{static_cast<const float*>(off), static_cast<const float*>(mask)};
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_fwd_mma(static_cast<const __nv_bfloat16*>(x), geom, wf, bf,
                          static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), B, H, W,
                          C, Cout, radius, splits, smem_bytes, s);
  }
  if (dtype == 0)
    return launch_fwd_cuda_core(static_cast<const float*>(x), geom, wf, bf,
                                static_cast<float*>(out), B, H, W, C, Cout, radius, s);
  return launch_fwd_cuda_core(static_cast<const __nv_bfloat16*>(x), geom, wf, bf,
                              static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout, radius, s);
}

const char* dcn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
