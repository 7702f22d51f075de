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
// coordinates + 7.9 MB of x go to or come from device memory; there are 8
// operations per output value.  What the card can reach is set by L2, not by
// device memory: the probe's positions are uniform over the image, so every
// sample pulls four 128-byte rows out of L2 (283 MB, 3.2 times the device-memory
// bytes), and `gather_l2_read_kernel` below measures the rate at which plain
// 16-byte reads of the same footprint come out of L2 (chip_smoke.py prints it
// beside the kernel's time).
//
// Design (C / 8 = G a power of two up to 32, i.e. C = 8 .. 256): a thread owns 8
// channels of a sample (16-byte loads in bf16, two in f32), the G threads of a
// sample are neighbours in a warp, and a warp takes 32 samples at a time:
//   * lane l loads the coordinates of sample l of the 32 (four coalesced
//     128-byte loads a warp in place of four broadcast loads per G threads),
//     clamps them and folds them into one pixel index, and hands that and the
//     two fractions to the sample's threads with __shfl_sync; the coordinates of
//     the warp's next 32 samples are loaded before the current ones are used, so
//     the corner loads never wait for a coordinate load;
//   * a thread has up to 4 samples (2 in f32) in flight: all their corner loads
//     are issued before any arithmetic;
//   * the grid is the card's resident blocks (8 of 256 threads an SM) and each
//     warp strides over the 32-sample chunks;
//   * the image is read through the read-only path and the output leaves with
//     streaming stores (st.global.cs), so that the output, larger than L2, does
//     not push the image out of it.  (An L2 evict-last policy on the image's
//     loads on top of that measured no difference and is not taken.)
// Other widths (C % 8 == 0 is required; the wrapper checks) take the plain
// kernel: one thread per (sample, 8 channels), coordinates loaded by each.
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

// ---------------------------------------------------- the warp-chunk kernel
struct Raw8f { float4 a, b; };

// eight values of a corner, still as loaded (read-only path, 16 bytes a load)
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, uint4& raw) {
  raw = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_raw(const float* p, Raw8f& raw) {
  raw.a = __ldg(reinterpret_cast<const float4*>(p));
  raw.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ void unpack_raw(const uint4& raw, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack_raw(const Raw8f& raw, float (&v)[kVec]) {
  v[0] = raw.a.x; v[1] = raw.a.y; v[2] = raw.a.z; v[3] = raw.a.w;
  v[4] = raw.b.x; v[5] = raw.b.y; v[6] = raw.b.z; v[7] = raw.b.w;
}

__device__ __forceinline__ void store8_stream(float* p, const float (&v)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void store8_stream(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), raw);
}

template <typename T> struct RawOf { using type = uint4; };
template <> struct RawOf<float> { using type = Raw8f; };

// One lane's sample of a 32-sample chunk: the pixel index of its first corner in
// the whole tensor (bit 30: the corner row below is another row, bit 29: the
// corner column to the right another column) and the two fractions.
struct Coord {
  int pix;
  float fy, fx;
};

__device__ __forceinline__ Coord load_coord(const int* __restrict__ y0, const int* __restrict__ x0,
                                            const float* __restrict__ fy,
                                            const float* __restrict__ fx, long long s,
                                            long long S, int P, int H, int W) {
  Coord c = {0, 0.f, 0.f};
  if (s < S) {
    const int ya = min(__ldg(y0 + s), H - 1), xa = min(__ldg(x0 + s), W - 1);
    c.fy = __ldg(fy + s);
    c.fx = __ldg(fx + s);
    const int b = (int)s / P;   // S < 2^31 (the wrapper checks)
    c.pix = ((b * H + ya) * W + xa) | (ya < H - 1 ? 1 << 30 : 0) | (xa < W - 1 ? 1 << 29 : 0);
  }
  return c;
}

// x: (B, H, W, C), C = 8 G; y0, x0: (S,) int32; fy, fx: (S,) f32; out: (S, C).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gather_bilinear_warp_kernel(const T* __restrict__ x, const int* __restrict__ y0,
                            const int* __restrict__ x0, const float* __restrict__ fy,
                            const float* __restrict__ fx, T* __restrict__ out,
                            long long S, int P, int H, int W) {
  using Raw = typename RawOf<T>::type;
  constexpr int C = G * kVec;
  constexpr int kPer = 32 / G;                        // samples per warp instruction
  constexpr int kMost = sizeof(T) == 2 ? 4 : 2;       // samples a thread has in flight
  constexpr int kU = G < kMost ? G : kMost;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int c = (lane % G) * kVec;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long chunks = (S + 31) / 32;

  long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  Coord next = load_coord(y0, x0, fy, fx, chunk * 32 + lane, S, P, H, W);
  for (; chunk < chunks; chunk += warps) {
    const Coord cur = next;
    next = load_coord(y0, x0, fy, fx, (chunk + warps) * 32 + lane, S, P, H, W);
#pragma unroll 1
    for (int it = 0; it < G; it += kU) {
      Raw raw[kU][4];
      float wy[kU], wx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int src = (it + u) * kPer + sub;
        const int packed = __shfl_sync(0xffffffffu, cur.pix, src);
        wy[u] = __shfl_sync(0xffffffffu, cur.fy, src);
        wx[u] = __shfl_sync(0xffffffffu, cur.fx, src);
        const T* p00 = x + (size_t)(packed & 0x1fffffff) * C + c;
        const size_t down = (packed >> 30) & 1 ? (size_t)W * C : 0;
        const size_t right = (packed >> 29) & 1 ? C : 0;
        load_raw(p00, raw[u][0]);
        load_raw(p00 + right, raw[u][1]);
        load_raw(p00 + down, raw[u][2]);
        load_raw(p00 + down + right, raw[u][3]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float cwy[2] = {1.f - wy[u], wy[u]};
        const float cwx[2] = {1.f - wx[u], wx[u]};
        float acc[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[kVec];
          unpack_raw(raw[u][q], v);
          const float wt = cwy[q >> 1] * cwx[q & 1];
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += v[i] * wt;
        }
        const long long s = chunk * 32 + (it + u) * kPer + sub;
        if (s < S) store8_stream(out + (size_t)s * C + c, acc);
      }
    }
  }
}

template <typename T>
int launch_warp(const T* x, const int* y0, const int* x0, const float* fy, const float* fx,
                T* out, long long S, int P, int H, int W, int G, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (S + 31) / 32;
  const long long want = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = (long long)sms * (2048 / kThreads);
  const unsigned grid = (unsigned)(want < resident ? want : resident);
#define GATHER_LAUNCH(GG)                                                                   \
  case GG:                                                                                  \
    gather_bilinear_warp_kernel<T, GG><<<grid, kThreads, 0, s>>>(x, y0, x0, fy, fx, out, S, \
                                                                 P, H, W);                  \
    break;
  switch (G) {
    GATHER_LAUNCH(1)
    GATHER_LAUNCH(2)
    GATHER_LAUNCH(4)
    GATHER_LAUNCH(8)
    GATHER_LAUNCH(16)
    GATHER_LAUNCH(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GATHER_LAUNCH
  return (int)cudaGetLastError();
}

// -------------------------------------------------------- the L2 yardstick
// Plain 16-byte reads of n16 * 16 bytes, `passes` times over, by the same grid
// as the gather: what this card's L2 delivers for a footprint that stays in it.
__global__ void __launch_bounds__(kThreads)
gather_l2_read_kernel(const uint4* __restrict__ x, long long n16, int passes,
                      uint4* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int pass = 0; pass < passes; ++pass) {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16; i += stride) {
      const uint4 v = __ldg(x + i);
      acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
    }
  }
  // never true for the data the probe reads; keeps the loads
  if (acc.x == 0x9e3779b9u && acc.y == 0x7f4a7c15u) *out = acc;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  S = B * P samples, image b of
// sample s is s / P.  body 1 is the warp-chunk kernel (C / 8 a power of two up to
// 32), body 0 the one-thread-per-(sample, 8 channels) kernel.  Launches on
// `stream` and returns cudaGetLastError().
int gather_bilinear_launch(const void* x, const void* y0, const void* x0, const void* fy,
                           const void* fx, void* out, long long S, int P, int H, int W,
                           int C, int dtype, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yi = static_cast<const int*>(y0);
  const int* xi = static_cast<const int*>(x0);
  const float* fyf = static_cast<const float*>(fy);
  const float* fxf = static_cast<const float*>(fx);
  if (body == 1) {
    if (dtype == 0)
      return launch_warp(static_cast<const float*>(x), yi, xi, fyf, fxf, static_cast<float*>(out),
                         S, P, H, W, C / kVec, s);
    return launch_warp(static_cast<const __nv_bfloat16*>(x), yi, xi, fyf, fxf,
                       static_cast<__nv_bfloat16*>(out), S, P, H, W, C / kVec, s);
  }
  const long long threads = S * (C / kVec);
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  if (dtype == 0) {
    gather_bilinear_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), yi, xi, fyf, fxf, static_cast<float*>(out), S, P, H, W, C);
  } else {
    gather_bilinear_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), yi, xi, fyf, fxf,
        static_cast<__nv_bfloat16*>(out), S, P, H, W, C);
  }
  return (int)cudaGetLastError();
}

// Reads `bytes` (a multiple of 16) at x `passes` times with the gather's grid;
// out: 16 bytes of scratch.
int gather_l2_read_launch(const void* x, long long bytes, int passes, void* out, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  gather_l2_read_kernel<<<(unsigned)(sms * (2048 / kThreads)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), bytes / 16, passes, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
