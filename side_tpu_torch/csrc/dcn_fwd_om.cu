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
// x's dtype per pixel.  The body is dcn_fwd.cu's (dcn_fwd_body.cuh): f32 FMA
// on CUDA cores, so its own ceiling is the 67 TFLOP/s f32 rate.
//
// NaN: a NaN dy or dx is clamped to -R (fmaxf returns its non-NaN operand), as
// in dcn_fwd.cu.  A NaN mask logit gives a NaN mask, and every output channel
// of that pixel is NaN, as in the unfused route.
//
// Tolerance against the plain version (ops/deform_conv.py:
// deform_conv_om_plain): as dcn_fwd.cu, 1e-5 of the output's max in f32 and
// 8e-3 in bf16.

#include "dcn_fwd_body.cuh"

using namespace dcn;

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_om_kernel(const T* __restrict__ x, const T* __restrict__ om,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  T* __restrict__ out, int B, int H, int W, int C, int Cout, int R) {
  dcn_fwd_tile<T>(x, OmGeom<T>{om}, w, bias, out, B, H, W, C, Cout, R);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, om and out).  radius >= 0.  Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
int dcn_fwd_om_launch(const void* x, const void* om, const void* w, const void* bias,
                      void* out, int B, int H, int W, int C, int Cout, int radius,
                      int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  const dim3 grid((unsigned)((P + kTilePix - 1) / kTilePix),
                  (unsigned)((Cout + kTileOut - 1) / kTileOut));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcn_fwd_om_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(om),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(out), B, H, W, C, Cout, radius);
  } else {
    dcn_fwd_om_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(om),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout, radius);
  }
  return (int)cudaGetLastError();
}

const char* dcn_om_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
