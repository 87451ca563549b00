// Tensor-core building blocks shared by the port's mma.sync kernels (K5 in
// flash_attn/csrc/flash_attn.cu, K6 in ssd_scan/csrc/ssd_scan.cu), and by
// their CPU tests, which compile them with g++ (each kernel's
// csrc/host_step_test.cpp, with -I on this directory, as nvcc is given in
// kernels/build.py).
//
// mma.sync.m16n8k16 takes bfloat16 inputs and float32 accumulators.  Lane
// l's fragment elements follow the PTX ISA's layout with g = l / 4 and
// t = l % 4:
//
//   A (16 x 16, row-major), element i < 8 of 4 registers:
//     row g + 8 * ((i / 2) % 2), column 2t + i % 2 + 8 * (i / 4)
//   B (16 x 8, k x n), element i < 4 of 2 registers:
//     k = 2t + i % 2 + 8 * (i / 2), n = g
//   C / D (16 x 8 float32), element i < 4:
//     row g + 8 * (i / 2), column 2t + i % 2
//
// A register holds two bf16 values, the lower column in its low half.  A
// float32 operand goes in as two bfloat16 parts, hi = bf16(x) and lo =
// bf16(x - hi), in two mma into one accumulator (tc_split_bf16), or in
// three parts (tc_split_parts) where float32's precision must hold.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define TC_HD __host__ __device__ __forceinline__
#define TC_UNROLL _Pragma("unroll")
#include <cuda_bf16.h>
#else
#define TC_HD inline
#define TC_UNROLL
#endif

#define TC_LOG2E 1.4426950408889634f

TC_HD int tc_a_row(int lane, int i) { return lane / 4 + 8 * ((i / 2) % 2); }
TC_HD int tc_a_col(int lane, int i) { return 2 * (lane % 4) + i % 2 + 8 * (i / 4); }
TC_HD int tc_b_k(int lane, int i) { return 2 * (lane % 4) + i % 2 + 8 * (i / 2); }
TC_HD int tc_b_n(int lane, int i) { return lane / 4; }
TC_HD int tc_c_row(int lane, int i) { return lane / 4 + 8 * (i / 2); }
TC_HD int tc_c_col(int lane, int i) { return 2 * (lane % 4) + i % 2; }

TC_HD uint32_t tc_f32_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

TC_HD float tc_bits_f32(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

// Round a float to the nearest bfloat16 (ties to even), kept as a float.
TC_HD float tc_round_bf16(float x) {
  uint32_t u = tc_f32_bits(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;  // inf / nan
  u += 0x7fffu + ((u >> 16) & 1u);
  return tc_bits_f32(u & 0xffff0000u);
}

// Two floats that are already bfloat16 values, packed into one register:
// `lo` (the lower column) in bits 0-15, `hi` in bits 16-31.
TC_HD uint32_t tc_pack_bf16x2(float lo, float hi) {
  return (tc_f32_bits(lo) >> 16) | (tc_f32_bits(hi) & 0xffff0000u);
}
TC_HD float tc_unpack_lo(uint32_t r) { return tc_bits_f32(r << 16); }
TC_HD float tc_unpack_hi(uint32_t r) { return tc_bits_f32(r & 0xffff0000u); }

// x = hi + lo with both parts bfloat16: hi = bf16(x), lo = bf16(x - hi).
// x - hi is exact in float32, so hi + lo differs from x by at most half a
// bfloat16 step of x - hi: about 2^-17 of x, and never more than 2^-134
// (half of bfloat16's finest subnormal step) where x is that small.
TC_HD void tc_split_bf16(float x, float* hi, float* lo) {
  *hi = tc_round_bf16(x);
  *lo = tc_round_bf16(x - *hi);
}

// bf16(x0), bf16(x1) packed into one register (x0 in the low half): one
// cvt.rn.bf16x2.f32 on the card, tc_round_bf16 on the host.
TC_HD uint32_t tc_pack_round(float x0, float x1) {
#if defined(__CUDA_ARCH__)
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
#else
  return tc_pack_bf16x2(tc_round_bf16(x0), tc_round_bf16(x1));
#endif
}

// tc_split_bf16 of two values, packed as registers of two bf16 (x0 in the
// low half).  On the card each rounding is one cvt.rn.bf16x2.f32, which
// rounds as tc_round_bf16 does.
TC_HD void tc_split_pack(float x0, float x1, uint32_t* hi, uint32_t* lo) {
#if defined(__CUDA_ARCH__)
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
#else
  float h0, l0, h1, l1;
  tc_split_bf16(x0, &h0, &l0);
  tc_split_bf16(x1, &h1, &l1);
  *hi = tc_pack_bf16x2(h0, h1);
  *lo = tc_pack_bf16x2(l0, l1);
#endif
}

// x0, x1 as K bf16 parts each, packed in registers: part k is
// bf16(x - parts 0 .. k-1), the differences exact in float32.  A product
// of a-part and b-part operands takes the pairs of parts (i, j) with
// i + j < max(a, b): two parts a side (three products) hold it to about
// 2^-16, three (six products) to about 2^-24, float32's own precision.
template <int K>
TC_HD void tc_split_parts(float x0, float x1, uint32_t out[K]) {
  TC_UNROLL for (int k = 0; k < K; ++k) {
    out[k] = tc_pack_round(x0, x1);
    x0 -= tc_unpack_lo(out[k]);
    x1 -= tc_unpack_hi(out[k]);
  }
}

// Shared-memory layout of a (rows x width) bf16 tile: rows of `width`
// values, each row cut into width / 8 chunks of 16 bytes whose order is
// XOR-swizzled by the row, so that the 8 row addresses of one ldmatrix (8
// rows, one chunk column) fall into 8 different 16-byte bank groups of a
// 128-byte line.  Rows of 8 or more chunks swizzle by row % 8; rows of 4
// chunks (two rows a line) by (row / 2) % 4; rows of 2 chunks (four rows a
// line) by (row / 4) % 2.
TC_HD int tc_swizzle(int row, int chunk, int chunks_per_row) {
  if (chunks_per_row >= 8) return chunk ^ (row & 7);
  if (chunks_per_row == 4) return chunk ^ ((row >> 1) & 3);
  if (chunks_per_row == 2) return chunk ^ ((row >> 2) & 1);
  return chunk;
}

// Element offset of (row, col) in such a tile.
TC_HD int tc_smem_off(int row, int col, int width) {
  return row * width + tc_swizzle(row, col / 8, width / 8) * 8 + col % 8;
}

// The row and column whose 16-byte row segment lane `lane` addresses in an
// ldmatrix.x4 (lanes 8m .. 8m + 7 give matrix m's 8 rows).
//  A fragments (registers a0..a3) of k-step kk of the 16-row strip at
//    `row0` of a tile stored (m rows, k columns): matrices (rows 0-7,
//    cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
TC_HD void tc_ldm_a(int lane, int row0, int kk, int* row, int* col) {
  *row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  *col = kk * 16 + (lane >> 4) * 8;
}
//  A fragments, with .trans, of k-step kk of the 16-row strip at `m0` of a
//    tile stored transposed (k rows, m columns).
TC_HD void tc_ldm_at(int lane, int m0, int kk, int* row, int* col) {
  *row = kk * 16 + (lane & 7) + (lane >> 4) * 8;
  *col = m0 + ((lane >> 3) & 1) * 8;
}
//  B fragments of k-step kk for the n-tiles 2 np and 2 np + 1 of a tile
//    stored (n rows, k columns): b0, b1 of n-tile 2 np, then b0, b1 of
//    n-tile 2 np + 1.
TC_HD void tc_ldm_b(int lane, int np, int kk, int* row, int* col) {
  *row = np * 16 + (lane & 7) + (lane >> 4) * 8;
  *col = kk * 16 + ((lane >> 3) & 1) * 8;
}
//  B fragments, with .trans, of k-step j for the n-tiles 2 dp and
//    2 dp + 1 of a tile stored (k rows, n columns): b0, b1 of n-tile 2 dp,
//    then of 2 dp + 1.
TC_HD void tc_ldm_bt(int lane, int j, int dp, int* row, int* col) {
  *row = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  *col = dp * 16 + (lane >> 4) * 8;
}

// 2^x: the card's ex2.approx (relative error about 2^-22, subnormal
// results flushed to 0), exp2f on the host.
TC_HD float tc_exp2(float x) {
#if defined(__CUDA_ARCH__)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

#if defined(__CUDACC__)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b on one m16n8k16 tile: bf16 a (4 registers), b (2), float32 c.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#endif  // __CUDACC__
