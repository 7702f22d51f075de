// Bilinear 4-corner gather for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX probe tools/gather_microbench.py:111
// (variant_E.kernel, launched at :130): for every sample s of image b = s / P,
//   out[s, :] = sum over dy, dx in {0, 1} of
//               x[b, min(y0[s]+dy, H-1), min(x0[s]+dx, W-1), :] * w_dydx(fy[s], fx[s])
// with f32 accumulation, stored in x's dtype.  The TPU version holds one whole
// image in VMEM per grid step and gathers rows from it; on a GPU the gather is
// the native access, so each sample's four rows are read straight from device
// memory (the image, 3.9 MB per batch element at the probe's shape, stays in
// L2).
//
// Bound: bytes.  The output (S*C values) dominates: at the probe's shape
// (B=2, 96x320x64 bf16, S = 552,960) 70.8 MB of output + 8.8 MB of
// coordinates + 7.9 MB of x; there are 8 operations per output value.
//
// Design: one thread per (sample, group of 8 channels): 16-byte loads in bf16,
// two in f32, neighbouring threads on neighbouring channel groups of one
// sample, so a sample's C/8 threads read each corner row and write the output
// row coalesced.  Requires C % 8 == 0 (the wrapper checks).
//
// Tolerance against the plain version (ops/gather_cuda.py:
// gather_bilinear_plain, same corner order and f32 accumulation): equal up to
// fused multiply-add contraction: 1e-6 of the largest value in f32; in bf16
// one ulp of each value plus that f32 noise (it shows where the four terms
// cancel to a small value).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kVec = 8;        // channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// x: (B, H, W, C); y0, x0: (S,) int32; fy, fx: (S,) f32; out: (S, C); S = B * P.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_bilinear_kernel(const T* __restrict__ x, const int* __restrict__ y0,
                       const int* __restrict__ x0, const float* __restrict__ fy,
                       const float* __restrict__ fx, T* __restrict__ out,
                       long long S, int P, int H, int W, int C) {
  const int groups = C / kVec;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= S * groups) return;
  const long long s = t / groups;
  const int c = (int)(t - s * groups) * kVec;
  const int b = (int)(s / P);
  const int ya = y0[s], xa = x0[s];
  const float wy = fy[s], wx = fx[s];
  const int yb = min(ya + 1, H - 1), xb = min(xa + 1, W - 1);
  const int yy[2] = {min(ya, H - 1), yb};
  const int xx[2] = {min(xa, W - 1), xb};
  const float cwy[2] = {1.f - wy, wy};
  const float cwx[2] = {1.f - wx, wx};
  const T* img = x + (size_t)b * H * W * C + c;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      float v[kVec];
      load8(img + ((size_t)yy[dy] * W + xx[dx]) * C, v);
      const float wt = cwy[dy] * cwx[dx];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += v[i] * wt;
    }
  }
  store8(out + (size_t)s * C + c, acc);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  S = B * P samples, image b of
// sample s is s / P.  Launches on `stream` and returns cudaGetLastError().
int gather_bilinear_launch(const void* x, const void* y0, const void* x0, const void* fy,
                           const void* fx, void* out, long long S, int P, int H, int W,
                           int C, int dtype, void* stream) {
  const long long threads = S * (C / kVec);
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gather_bilinear_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(y0),
        static_cast<const int*>(x0), static_cast<const float*>(fy),
        static_cast<const float*>(fx), static_cast<float*>(out), S, P, H, W, C);
  } else {
    gather_bilinear_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(y0),
        static_cast<const int*>(x0), static_cast<const float*>(fy),
        static_cast<const float*>(fx), static_cast<__nv_bfloat16*>(out), S, P, H, W, C);
  }
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
