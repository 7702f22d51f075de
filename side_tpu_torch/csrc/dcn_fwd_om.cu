// Modulated deformable 3x3 convolution (DCNv2) forward fed the raw offset/mask
// conv output, for Hopper (sm_90a).
//
// Replaces the TPU kernel side_tpu/ops/dcn_pallas.py:691 _dcn_kernel_packed_om
// (the packed body at :402 with om_layout=True), launched by
// _pallas_forward_packed_fused (:718): K1's function with one operand `om`
// (B, H, W, 27) in place of separate offsets and mask.  Per tap k, channel 3k
// is dy, 3k+1 is dx (both clamped to [-R, R] here) and 3k+2 is the mask logit
// (sigmoid here, in f32).  The TPU version also evaluates the 27-channel conv
// on the lane-packed input with a block-diagonal kernel, because Mosaic cannot
// gather and an unpacked 27-lane conv wastes its matrix unit; a GPU gathers,
// so the conv stays an ordinary convolution outside this kernel and this
// kernel reads `om` exactly as that conv leaves it: NHWC, 27 channels, in x's
// dtype.  What the fusion saves on this card is the split into an (…, 9, 2)
// f32 offset tensor and an (…, 9) f32 mask, the sigmoid pass and their casts:
// several elementwise launches and 27 f32 values written and read again per
// pixel.
//
// Bound: K1's operations (2 * B*H*W * 9*Cin * Cout, on tensor cores
// compute-bound at every model shape) against bytes with `om` at 27 values of
// x's dtype per pixel.  The bodies are dcn_fwd.cu's (dcn_fwd_body.cuh): route 1
// on the tensor cores for bf16 at the model's widths, route 0 on CUDA cores
// (f32 FMA, ceiling 67 TFLOP/s) for f32 and every other width.  On either route
// this kernel and dcn_fwd fed the split operands give the same bits.
//
// NaN: a NaN dy or dx is clamped to -R (fmaxf returns its non-NaN operand), as
// in dcn_fwd.cu.  A NaN mask logit gives a NaN mask, and every output channel
// of that pixel is NaN, as in the unfused route.
//
// Tolerance against the plain version (ops/deform_conv.py:
// deform_conv_om_plain): as dcn_fwd.cu, 1e-5 of the output's max in f32 and
// 8e-3 in bf16 (on route 1 that includes the weight's rounding to bf16).

#include "dcn_fwd_body.cuh"

namespace dcn {

// om: (B, H, W, 27) in x's dtype, per tap [dy, dx, mask logit]
template <typename T>
struct OmGeom {
  const T* om;
  __device__ __forceinline__ void operator()(int p, int k, float& dy, float& dx,
                                             float& m) const {
    const T* q = om + (size_t)p * 27 + 3 * k;
    dy = load_f32(q);
    dx = load_f32(q + 1);
    m = 1.f / (1.f + expf(-load_f32(q + 2)));
  }
};

}  // namespace dcn

using namespace dcn;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, om and out).  radius >= 0.  route,
// splits, smem_bytes and part as dcn_fwd_launch.  Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
int dcn_fwd_om_launch(const void* x, const void* om, const void* w, const void* bias,
                      void* out, void* part, int B, int H, int W, int C, int Cout, int radius,
                      int dtype, int route, int splits, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0) {
    if (route == 1) return (int)cudaErrorInvalidValue;
    return launch_fwd_cuda_core(static_cast<const float*>(x),
                                OmGeom<float>{static_cast<const float*>(om)}, wf, bf,
                                static_cast<float*>(out), B, H, W, C, Cout, radius, s);
  }
  const OmGeom<__nv_bfloat16> geom{static_cast<const __nv_bfloat16*>(om)};
  if (route == 1)
    return launch_fwd_mma(static_cast<const __nv_bfloat16*>(x), geom, wf, bf,
                          static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), B, H, W,
                          C, Cout, radius, splits, smem_bytes, s);
  return launch_fwd_cuda_core(static_cast<const __nv_bfloat16*>(x), geom, wf, bf,
                              static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout, radius, s);
}

const char* dcn_om_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
