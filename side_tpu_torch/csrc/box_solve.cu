// Damped Gauss-Newton 3-DoF box solve for Hopper (sm_90a): the whole of
// side_tpu_torch/postprocess/box_solver.py:solve_x_y_theta_plain for N rows in
// one launch, one thread per row.
//
// Replaces no TPU kernel: the JAX package computes this solve with jnp ops
// under vmap(jacfwd) (side_tpu/postprocess/box_solver.py), which XLA fuses into
// a few programs.  It was added because the PyTorch form of the solve launches
// about 260 small operations per iteration, 5,200 per solve: the device tail
// of a validation group of 8 frames runs two solves, and their launches, each
// a few microseconds of host dispatch for a few microseconds of device work on
// 800 floats, paced the validation pass.
//
// Bound: launch latency, not bytes.  A row reads its 21 constants and z and
// writes 3 floats, 22 * 4 B + 12 B, about 80 KB at N = 800 (a group of 8 frames
// at K = 100; N = 100 for one frame); its arithmetic is one dependent chain of
// about 20 * 330 operations (the iterations cannot overlap), which a single
// thread runs in tens of microseconds.  Both lie below what a launch costs on
// the host.
//
// Arithmetic, per row, as the plain path does it (f32 throughout; sinf, cosf
// and atan2f, no fast-math and no __sinf-style intrinsics):
//   * the initial state from z and the constants;
//   * 20 iterations, each: the 6 residuals of `residuals_xytheta` and the
//     closed-form 6 x 3 Jacobian of `jacobian_xytheta` (the same masks, the
//     keypoint term weighted 2), J^T J + 1e-4 I and J^T r, the 3 x 3 system
//     solved by LU with partial pivoting in the order of LAPACK's getrf and
//     getrs (pivot = the first largest magnitude, the column below it scaled by
//     the pivot's reciprocal, then forward and column-wise back substitution
//     dividing by the pivots); x - step is taken only if all its components
//     are finite and its cost is at most the old cost + 1e-9, otherwise the
//     row keeps its state.
//
// Bit for bit the plain path on the card, run at a batch of 2,400 rows.  The
// residuals, the Jacobian and the step follow the plain code's operation order
// with the rounding intrinsics (__fmul_rn etc.), which nvcc never fuses into
// multiply-adds, so they equal PyTorch's chain of elementwise kernels.  The
// sums and the solve follow the order in which PyTorch 2.11 with CUDA 12.8
// computes them on the H100, read off its results: J^T J as one fused
// multiply-add chain over the 6 rows in order (cuBLAS's bmm); J^T r as two
// such chains, over the even and the odd rows, then their sum (cuBLAS's
// order at 2,400 rows; at 800 and at 100 it splits the 6 terms otherwise);
// the cost as the reduction kernel adds a row of 6 (four accumulators, then a
// tree); the LU as LAPACK orders it, every update one fused multiply-add.
// So the plain path itself rounds differently at another batch size, and
// where a row's cost stalls at f32's resolution (steps rejected by the
// `<= cost + 1e-9` test while the state still drifts) its accept tests part:
// such rows, about 2 % of a group's, move by up to ~2e-3 between two batch
// sizes of the plain path, and the kernel differs from the plain path at 800
// rows by exactly that much (tests/test_torch_cuda.py).
// A zero pivot gives a non-finite step (plain division by it), which the
// accept test rejects, as linalg.solve_ex does.  The residual of an accepted
// state is kept as the next iteration's r: the plain path computes the same
// value again.
//
// The constants are read in place: the launcher gets a table of kFields
// pointers and element strides (one per field, in the order of `Field`, which
// ops/box_solve_cuda.py:FIELDS mirrors and tests/test_torch_tail.py checks),
// so no pack is copied before the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// the fields of SolveConsts the residuals read, in table order
enum Field : int {
  left_u, right_u, top_v, bottom_v, kpt_u, alpha, h,
  lw, ll, rw, rl, bw, bot_l, kw, kl,
  m_ul, m_ur, m_uk, m_vt, m_vb, m_alpha,
  kFields
};

constexpr int kThreads = 128;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kDamping = 1e-4f;
constexpr float kCostSlack = 1e-9f;

struct Table {
  const float* ptr[kFields];
  long long stride[kFields];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// numerator and denominator of the projected u of vertex (vw, vl):
// (x + c vw + s vl) / (z - s vw + c vl)
__device__ __forceinline__ void edge_parts(float x, float z, float s, float c, float vw,
                                           float vl, float& num, float& den) {
  num = add(add(x, mul(c, vw)), mul(s, vl));
  den = add(sub(z, mul(s, vw)), mul(c, vl));
}

// residuals_xytheta at (x, y, t); s, c = sin t, cos t
__device__ __forceinline__ void residuals(const float (&k)[kFields], float z, float x,
                                          float y, float t, float s, float c, float (&r)[6]) {
  float num, den;
  edge_parts(x, z, s, c, k[lw], k[ll], num, den);
  r[0] = mul(sub(dvd(num, den), k[left_u]), k[m_ul]);
  edge_parts(x, z, s, c, k[rw], k[rl], num, den);
  r[1] = mul(sub(dvd(num, den), k[right_u]), k[m_ur]);
  edge_parts(x, z, s, c, k[kw], k[kl], num, den);
  r[2] = mul(mul(2.0f, sub(dvd(num, den), k[kpt_u])), k[m_uk]);
  const float den_b = add(sub(z, mul(s, k[bw])), mul(c, k[bot_l]));
  r[3] = mul(sub(dvd(y, den_b), k[bottom_v]), k[m_vb]);
  const float den_t = sub(add(z, mul(s, k[bw])), mul(c, k[bot_l]));
  r[4] = mul(sub(dvd(sub(y, k[h]), den_t), k[top_v]), k[m_vt]);
  r[5] = mul(sub(add(sub(t, kHalfPi), atan2f(-x, z)), k[alpha]), k[m_alpha]);
}

// d (residuals) / d (x, y, theta) of one box edge with weight m
__device__ __forceinline__ void edge_row(float x, float z, float s, float c, float vw, float vl,
                                         float m, float (&row)[3]) {
  float num, den;
  edge_parts(x, z, s, c, vw, vl, num, den);
  const float d_num = add(mul(-s, vw), mul(c, vl));
  const float d_den = sub(mul(-c, vw), mul(s, vl));
  row[0] = dvd(m, den);
  row[1] = 0.0f;
  row[2] = dvd(mul(m, sub(mul(d_num, den), mul(num, d_den))), mul(den, den));
}

// jacobian_xytheta at (x, y, t)
__device__ __forceinline__ void jacobian(const float (&k)[kFields], float z, float x, float y,
                                         float s, float c, float (&J)[6][3]) {
  edge_row(x, z, s, c, k[lw], k[ll], k[m_ul], J[0]);
  edge_row(x, z, s, c, k[rw], k[rl], k[m_ur], J[1]);
  edge_row(x, z, s, c, k[kw], k[kl], mul(2.0f, k[m_uk]), J[2]);
  const float den_b = add(sub(z, mul(s, k[bw])), mul(c, k[bot_l]));
  J[3][0] = 0.0f;
  J[3][1] = dvd(k[m_vb], den_b);
  J[3][2] = dvd(mul(mul(-k[m_vb], y), sub(mul(-c, k[bw]), mul(s, k[bot_l]))),
                mul(den_b, den_b));
  const float den_t = sub(add(z, mul(s, k[bw])), mul(c, k[bot_l]));
  J[4][0] = 0.0f;
  J[4][1] = dvd(k[m_vt], den_t);
  J[4][2] = dvd(mul(mul(-k[m_vt], sub(y, k[h])), add(mul(c, k[bw]), mul(s, k[bot_l]))),
                mul(den_t, den_t));
  // d atan2(-x, z) / dx = -z / (x^2 + z^2)
  J[5][0] = dvd(mul(-k[m_alpha], z), add(mul(x, x), mul(z, z)));
  J[5][1] = 0.0f;
  J[5][2] = k[m_alpha];
}

// sum of the squared residuals, in the order of PyTorch's reduction over a
// row of 6 (four accumulators, then a tree)
__device__ __forceinline__ float cost(const float (&r)[6]) {
  float q[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) q[i] = mul(r[i], r[i]);
  return add(add(add(q[0], q[4]), q[2]), add(add(q[1], q[5]), q[3]));
}

// c - a * b, rounded once (the LU's updates)
__device__ __forceinline__ float fnms(float a, float b, float c) { return fmaf(-a, b, c); }

// A step = b by LU with partial pivoting, LAPACK's getrf / getrs order; A is
// overwritten, b becomes the step.
__device__ __forceinline__ void lu_solve3(float (&A)[3][3], float (&b)[3]) {
  int piv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int p = j;
    float best = fabsf(A[j][j]);
#pragma unroll
    for (int i = j + 1; i < 3; ++i) {
      if (fabsf(A[i][j]) > best) {
        best = fabsf(A[i][j]);
        p = i;
      }
    }
    piv[j] = p;
    if (A[p][j] != 0.0f) {
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        if (p != j) {
          const float tmp = A[j][col];
          A[j][col] = A[p][col];
          A[p][col] = tmp;
        }
      }
      if (fabsf(A[j][j]) >= 1.17549435e-38f) {  // LAPACK's sfmin
        const float inv = dvd(1.0f, A[j][j]);
#pragma unroll
        for (int i = j + 1; i < 3; ++i) A[i][j] = mul(A[i][j], inv);
      } else {
#pragma unroll
        for (int i = j + 1; i < 3; ++i) A[i][j] = dvd(A[i][j], A[j][j]);
      }
    }
#pragma unroll
    for (int i = j + 1; i < 3; ++i) {
#pragma unroll
      for (int col = j + 1; col < 3; ++col) A[i][col] = fnms(A[i][j], A[j][col], A[i][col]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (piv[j] != j) {
      const float tmp = b[j];
      b[j] = b[piv[j]];
      b[piv[j]] = tmp;
    }
  }
  // unit lower, then upper with division by the pivots (a zero pivot gives a
  // non-finite component)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = j + 1; i < 3; ++i) b[i] = fnms(b[j], A[i][j], b[i]);
  }
#pragma unroll
  for (int j = 2; j >= 0; --j) {
    b[j] = dvd(b[j], A[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) b[i] = fnms(b[j], A[i][j], b[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
box_solve_kernel(Table table, const float* __restrict__ zs, long long z_stride,
                 float* __restrict__ out, int n, int num_iters) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  float k[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) k[f] = __ldg(table.ptr[f] + row * table.stride[f]);
  const float z = __ldg(zs + row * z_stride);

  // the initial state (solve_x_y_theta_plain)
  float x = dvd(mul(z, add(k[left_u], k[right_u])), 2.0f);
  float y = add(dvd(mul(z, add(k[bottom_v], k[top_v])), 2.0f), dvd(k[h], 2.0f));
  float t = sub(add(k[alpha], kHalfPi), atan2f(-x, z));
  float s = sinf(t), c = cosf(t);
  float r[6];
  residuals(k, z, x, y, t, s, c, r);
  float r_cost = cost(r);

  for (int it = 0; it < num_iters; ++it) {
    float J[6][3];
    jacobian(k, z, x, y, s, c, J);
    float A[3][3], g[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = i; j < 3; ++j) {
        float acc = mul(J[0][i], J[0][j]);
#pragma unroll
        for (int m = 1; m < 6; ++m) acc = fmaf(J[m][i], J[m][j], acc);
        A[i][j] = acc;
        A[j][i] = acc;
      }
      // J^T r: even and odd terms apart, then their sum
      const float even = fmaf(J[4][i], r[4], fmaf(J[2][i], r[2], mul(J[0][i], r[0])));
      const float odd = fmaf(J[5][i], r[5], fmaf(J[3][i], r[3], mul(J[1][i], r[1])));
      g[i] = add(even, odd);
      A[i][i] = add(A[i][i], kDamping);
    }
    lu_solve3(A, g);
    const float x_new = sub(x, g[0]), y_new = sub(y, g[1]), t_new = sub(t, g[2]);
    if (!(isfinite(x_new) && isfinite(y_new) && isfinite(t_new))) continue;
    const float s_new = sinf(t_new), c_new = cosf(t_new);
    float r_new[6];
    residuals(k, z, x_new, y_new, t_new, s_new, c_new, r_new);
    const float new_cost = cost(r_new);
    if (new_cost <= add(r_cost, kCostSlack)) {
      x = x_new; y = y_new; t = t_new; s = s_new; c = c_new;
      r_cost = new_cost;
#pragma unroll
      for (int i = 0; i < 6; ++i) r[i] = r_new[i];
    }
  }
  out[3 * row + 0] = x;
  out[3 * row + 1] = y;
  out[3 * row + 2] = t;
}

}  // namespace

extern "C" {

// fields: kFields device pointers to f32 (one per Field, in that order), each
// element `row` at ptr + row * stride; z likewise with z_stride; out: (n, 3)
// f32, contiguous.  Launches ceil(n / 128) blocks on `stream` and returns
// cudaGetLastError(); a table of another length, n < 1 or num_iters < 0 is
// refused with cudaErrorInvalidValue before any launch.
int box_solve_launch(const void* const* fields, const long long* strides, int n_fields,
                     const void* z, long long z_stride, void* out, int n, int num_iters,
                     void* stream) {
  if (n_fields != kFields || n < 1 || num_iters < 0) return (int)cudaErrorInvalidValue;
  Table table;
  for (int f = 0; f < kFields; ++f) {
    table.ptr[f] = static_cast<const float*>(fields[f]);
    table.stride[f] = strides[f];
  }
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  box_solve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const float*>(z), z_stride, static_cast<float*>(out), n, num_iters);
  return (int)cudaGetLastError();
}

const char* box_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
