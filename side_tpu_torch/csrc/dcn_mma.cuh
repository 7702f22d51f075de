// Tensor-core building blocks shared by the DCN kernels for Hopper (sm_90a):
// the forward body (dcn_fwd_body.cuh) and the backward kernels K2 and K3
// (dcn_bwd.cu).
//
// Two ways to the tensor cores, both bf16 with f32 accumulators:
//   * warp-level `mma.sync.aligned.m16n8k16`, operands read from shared memory
//     into registers with `ldmatrix` (K2 and K3: `gw_product_64` is the product
//     g·W_k^T both form; K3's second product needs both operands transposed,
//     which `ldmatrix.trans` gives for free);
//   * warpgroup-level `wgmma.mma_async` m64nNk16, operands read by the tensor
//     cores from shared memory through matrix descriptors (the forward body).
// Every shared tile is a row-major array of bf16 whose rows are a multiple of
// 128 bytes; the 16-byte groups of a row are XOR-swizzled with the row's low
// three bits (`swz`), so the eight row addresses of one 8x8 `ldmatrix` tile fall
// into eight different bank groups, and so do the 16-byte stores of the
// producers.  With 128-byte rows on a 1024-byte aligned tile this is the
// hardware's 128-byte swizzle, which the wgmma descriptors name.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dcn_mma {

constexpr int kThreads = 256;   // 8 warps per block
constexpr int kChunkK = 64;     // reduction elements per staged chunk (128 bytes of bf16)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte group `group` of row `row`; rows hold row_bytes bytes
__device__ __forceinline__ uint32_t swz(int row, int group, int row_bytes) {
  return (uint32_t)(row * row_bytes + ((group ^ (row & 7)) << 4));
}

// four 8x8 b16 tiles; lane l gives the address of row l % 8 of tile l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each tile transposed on its way into the registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// eight bf16 (16 bytes) as f32
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  v[0] = bf16_lo(raw.x); v[1] = bf16_hi(raw.x);
  v[2] = bf16_lo(raw.y); v[3] = bf16_hi(raw.y);
  v[4] = bf16_lo(raw.z); v[5] = bf16_hi(raw.z);
  v[6] = bf16_lo(raw.w); v[7] = bf16_hi(raw.w);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Stage rows [row0, row0 + 64) x columns [0, BN) of a row-major f32 matrix with
// `BN` columns into the swizzled bf16 tile `dst` (64 rows of BN * 2 bytes),
// rounding to nearest-even on the way: the one rounding of the weight that the
// tensor-core route adds (see dcn_fwd_body.cuh).  Loading and storing are
// apart so that a caller can put work between them.
template <int BN>
struct WeightRows {               // a thread's share of a 64 x BN f32 tile in flight
  float4 v[(kChunkK * (BN / 8)) / kThreads][2];
};

template <int BN>
__device__ __forceinline__ void load_weight_rows(const float* __restrict__ src, int row0,
                                                 WeightRows<BN>& regs) {
  constexpr int kGroups = BN / 8;
#pragma unroll
  for (int i = 0; i < (kChunkK * kGroups) / kThreads; ++i) {
    const int item = threadIdx.x + kThreads * i;
    const int r = item / kGroups;
    const int gq = item - r * kGroups;
    const float4* q = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * BN + gq * 8);
    regs.v[i][0] = __ldg(q);
    regs.v[i][1] = __ldg(q + 1);
  }
}

template <int BN>
__device__ __forceinline__ void store_weight_rows(const WeightRows<BN>& regs, unsigned char* dst) {
  constexpr int kGroups = BN / 8;
#pragma unroll
  for (int i = 0; i < (kChunkK * kGroups) / kThreads; ++i) {
    const int item = threadIdx.x + kThreads * i;
    const int r = item / kGroups;
    const int gq = item - r * kGroups;
    const float4 lo = regs.v[i][0], hi = regs.v[i][1];
    *reinterpret_cast<uint4*>(dst + swz(r, gq, BN * 2)) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                   pack_bf16(hi.z, hi.w));
  }
}

template <int BN>
__device__ __forceinline__ void stage_weight_rows(const float* __restrict__ src, int row0,
                                                  unsigned char* dst) {
  WeightRows<BN> regs;
  load_weight_rows<BN>(src, row0, regs);
  store_weight_rows<BN>(regs, dst);
}


// ------------------------------------------- the backward's product g·W_k^T
constexpr int kGwStride = 72;   // f32 per row of the gW tile: 64 + 8, conflict-free

// Column of the gW tile that holds channel `col`: columns 32..63 swap their
// halves of 4, so that float4 reads of channel groups cg and cg + 4 of one row
// miss each other's banks.
__device__ __forceinline__ int gw_col(int col) { return col ^ ((col >> 3) & 4); }

// Where K3 and K2's device-memory route keep gW: 64 rows of kGwStride f32,
// channel c at column gw_col(c).
struct GwTileStore {
  float* sGW;
  __device__ __forceinline__ void operator()(int row, int col, float2 v) const {
    *reinterpret_cast<float2*>(sGW + row * kGwStride + gw_col(col)) = v;
  }
};

// gW[p, c] = sum_o g[p, o] * W_k[c, o] for 64 pixels x 64 channels, by the 8
// warps of a block: `g_base` is the shared address of row 0 of the 64 pixel
// rows inside a swizzled bf16 tile with rows of BN values (the row's index in
// the tile a multiple of 8), `w_base` that of W_k's 64 x BN tile; each thread
// hands its 16 values to `store(row, channel, two neighbouring channels)`.
// Warp tile 32 pixels x 16 channels.  No barrier inside.
template <int BN, typename Store>
__device__ __forceinline__ void gw_product_64(uint32_t g_base, uint32_t w_base, Store store) {
  constexpr int kRowBytes = BN * 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;       // 2 warps along the pixels, 4 along the channels
  const int wn = warp >> 1;
  float acc_g[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_g[mi][ni][r] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < BN / 16; ++ks) {
    uint32_t af[2][4], bf[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16 + (lane & 15);
      ldmatrix_x4(af[mi], g_base + swz(row, ks * 2 + (lane >> 4), kRowBytes));
    }
    // W_k is stored [n = c][k = o]: tiles (n 0-7, k 0-7), (n 0-7, k 8-15),
    // (n 8-15, k 0-7), (n 8-15, k 8-15), no transpose
    const int nrow = wn * 16 + (lane & 7) + ((lane >> 4) << 3);
    ldmatrix_x4(bf, w_base + swz(nrow, ks * 2 + ((lane >> 3) & 1), kRowBytes));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16(acc_g[mi][0], af[mi], bf[0], bf[1]);
      mma_bf16(acc_g[mi][1], af[mi], bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 32 + mi * 16 + (lane >> 2) + 8 * half;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        store(row, wn * 16 + ni * 8 + (lane & 3) * 2,
              make_float2(acc_g[mi][ni][2 * half], acc_g[mi][ni][2 * half + 1]));
    }
}


// The same product for one warp alone: 32 pixels (rows row0 .. row0 + 31 of the g
// tile at `g_base`, row0 a multiple of 8) x all 64 channels.  Each A fragment is
// read once and W_k once per 32 pixels, half the shared-memory traffic of
// gw_product_64's 32 x 16 warp tiles, for 64 accumulators a thread.
template <int BN, typename Store>
__device__ __forceinline__ void gw_product_slab(uint32_t g_base, int row0, uint32_t w_base,
                                                Store store) {
  constexpr int kRowBytes = BN * 2;
  const int lane = threadIdx.x & 31;
  float acc_g[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_g[mi][ni][r] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < BN / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], g_base + swz(row0 + mi * 16 + (lane & 15), ks * 2 + (lane >> 4), kRowBytes));
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bf[4];
      const int nrow = nb * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(bf, w_base + swz(nrow, ks * 2 + ((lane >> 3) & 1), kRowBytes));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc_g[mi][2 * nb], af[mi], bf[0], bf[1]);
        mma_bf16(acc_g[mi][2 * nb + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mi * 16 + (lane >> 2) + 8 * half;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        store(row, ni * 8 + (lane & 3) * 2,
              make_float2(acc_g[mi][ni][2 * half], acc_g[mi][ni][2 * half + 1]));
    }
}


// ------------------------------------------------------------------ wgmma
// Warpgroup MMA: four warps start one asynchronous 64 x N x 16 product whose
// operands the tensor cores read straight from shared memory through 64-bit
// matrix descriptors.  Both operand tiles here use the 128-byte swizzle (16-byte
// groups XORed with the row's low three bits: `swz` with 128-byte rows, on a
// tile whose base is 1024-byte aligned):
//   A, K-major: rows of 64 bf16 (128 bytes) along K, 8-row groups 1024 bytes
//      apart (stride byte offset); the leading byte offset is unused.  A step
//      of 16 along K moves the start address by 32 bytes.
//   B, N-major: blocks of 64 output columns; a block is 64 K-rows of 64 bf16
//      (128 bytes), 8-row groups 1024 bytes apart (stride byte offset), blocks
//      `block_bytes` apart (leading byte offset).  A step of 16 along K moves
//      the start address by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_byte_addr, uint32_t leading_bytes,
                                               uint32_t stride_bytes) {
  return (uint64_t)((smem_byte_addr & 0x3FFFFu) >> 4) | ((uint64_t)(leading_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32) | (1ull << 62);   // layout type 1: 128-byte swizzle
}

// shared-memory writes of this thread become visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, f32, 4 warps) += a (64 x 16 bf16, K-major in shared memory) * b (16 x 64
// bf16, N-major in shared memory: trans-b = 1); asynchronous
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"   // scale-d = 1: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32, 4 warps) += a (64 x 16 bf16, K-major in shared memory) * b (16 x 128
// bf16, N-major in shared memory: trans-b = 1); asynchronous
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"   // scale-d = 1: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    wgmma_m64n64k16(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_m64n128k16(d, a, b);
  }
};

// The N-major wgmma B tile of the weight: blocks of 64 columns, each 64 rows of
// 128 bytes (8192 bytes a block), 128-byte swizzle.  A thread stages BN / 32
// items of 8 columns; item i of thread t is row (t + 256 i) / (BN / 8), column
// group (t + 256 i) % (BN / 8).  Loading (f32 from the master copy) and storing
// (rounded to bf16) are apart so that a caller can put work between them.
template <int BN>
__device__ __forceinline__ void load_weight_item(const float* __restrict__ src, int row0, int i,
                                                 float4& lo, float4& hi) {
  constexpr int kGroups = BN / 8;
  const int item = threadIdx.x + kThreads * i;
  const int r = item / kGroups;
  const int gq = item - r * kGroups;
  const float4* q = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * BN + gq * 8);
  lo = __ldg(q);
  hi = __ldg(q + 1);
}

template <int BN>
__device__ __forceinline__ void store_weight_item(const float4& lo, const float4& hi, int i,
                                                  unsigned char* dst) {
  constexpr int kGroups = BN / 8;
  const int item = threadIdx.x + kThreads * i;
  const int r = item / kGroups;
  const int gq = item - r * kGroups;
  *reinterpret_cast<uint4*>(dst + (gq >> 3) * 8192 + swz(r, gq & 7, 128)) =
      make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                 pack_bf16(hi.z, hi.w));
}

template <int BN>
__device__ __forceinline__ void stage_weight_rows_blocked(const float* __restrict__ src, int row0,
                                                          unsigned char* dst) {
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    float4 lo, hi;
    load_weight_item<BN>(src, row0, i, lo, hi);
    store_weight_item<BN>(lo, hi, i, dst);
  }
}

}  // namespace dcn_mma
