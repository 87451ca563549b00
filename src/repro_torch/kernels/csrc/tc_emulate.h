// A warp's tensor-core instructions emulated on the host, for the CPU tests
// of the mma.sync kernels (each kernel's csrc/host_step_test.cpp): tiles
// are shared-memory images of bfloat16 values held as float, laid out with
// tc_smem_off; fragments are indexed [lane][register][half].  The port
// itself never compiles this header.
#pragma once
#include <math.h>

#include <utility>

#include "tc_frag.h"

// One ldmatrix.x4 from a tile image of `width` columns: lanes 8 m ..
// 8 m + 7 address matrix m's rows; lane l receives, in register m, the
// elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) of matrix m, or
// of its transpose with `trans`.  addr(lane, &row, &col) gives a lane's
// row segment.
template <typename Addr>
void tce_ldmatrix_x4(const float* tile, int width, bool trans, Addr addr, float frag[32][4][2]) {
  int row[32], col[32];
  for (int l = 0; l < 32; ++l) addr(l, &row[l], &col[l]);
  for (int l = 0; l < 32; ++l)
    for (int m = 0; m < 4; ++m)
      for (int e = 0; e < 2; ++e) {
        int r = l / 4, c = 2 * (l % 4) + e;
        if (trans) std::swap(r, c);
        const int src = 8 * m + r;  // the lane that addressed this row
        frag[l][m][e] = tile[tc_smem_off(row[src], col[src] + c, width)];
      }
}

// c += a b for one m16n8k16 tile held as fragments: a[lane][reg][half]
// (registers a0..a3), b[lane][reg][half] (b0, b1), c[lane][i].  Products
// and sums in float32.
inline void tce_mma(float c[32][4], const float a[32][4][2], const float b[32][2][2]) {
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 8; ++i) A[tc_a_row(l, i)][tc_a_col(l, i)] = a[l][i / 2][i % 2];
    for (int i = 0; i < 4; ++i) B[tc_b_k(l, i)][tc_b_n(l, i)] = b[l][i / 2][i % 2];
  }
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      float sum = c[l][i];
      for (int kk = 0; kk < 16; ++kk) sum += A[tc_c_row(l, i)][kk] * B[kk][tc_c_col(l, i)];
      c[l][i] = sum;
    }
}

// floor(log2 |x|) of a finite float x != 0.
inline int tce_exponent(float x) {
  const int biased = (int)((tc_f32_bits(x) >> 23) & 0xffu);
  if (biased) return biased - 127;
  int e;
  frexpf(x, &e);  // a subnormal: |x| = m 2^e, m in [0.5, 1)
  return e - 1;
}

// tce_mma with each output summed as the H100's mma.sync m16n8k16 sums it
// (the model that tools/mma_accumulation.py fits to the card's results,
// bit for bit on all of its outputs): the 16 products are exact; each
// product's exponent is the sum of its factors' exponents (its leading bit
// may lie one above it), the addend's its own; every term, the addend
// included, is cut toward zero to a multiple of 2^(E - TCE_MMA_FRAC), E the
// largest of those exponents; the cut terms' exact sum is rounded to
// float32 toward zero.  For the emulations whose tolerance is float32's
// own, where the order of a float32 sum, or its rounding, would differ
// from the card's.  Inputs are finite.
#define TCE_MMA_FRAC 25
#define TCE_ZERO_EXP (-(1 << 20))  // the exponent taken for a zero factor
inline void tce_mma_fused(float c[32][4], const float a[32][4][2], const float b[32][2][2]) {
  float A[16][16], B[16][8];
  int eA[16][16], eB[16][8];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 8; ++i) A[tc_a_row(l, i)][tc_a_col(l, i)] = a[l][i / 2][i % 2];
    for (int i = 0; i < 4; ++i) B[tc_b_k(l, i)][tc_b_n(l, i)] = b[l][i / 2][i % 2];
  }
  for (int r = 0; r < 16; ++r)
    for (int k = 0; k < 16; ++k) eA[r][k] = A[r][k] != 0.0f ? tce_exponent(A[r][k]) : TCE_ZERO_EXP;
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < 8; ++n) eB[k][n] = B[k][n] != 0.0f ? tce_exponent(B[k][n]) : TCE_ZERO_EXP;
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      const int row = tc_c_row(l, i), col = tc_c_col(l, i);
      const float addend = c[l][i];
      int top = addend != 0.0f ? tce_exponent(addend) : 2 * TCE_ZERO_EXP;
      for (int k = 0; k < 16; ++k) top = eA[row][k] + eB[k][col] > top ? eA[row][k] + eB[k][col] : top;
      if (top < TCE_ZERO_EXP / 2) {  // no term is nonzero
        c[l][i] = 0.0f;
        continue;
      }
      const double step = ldexp(1.0, top - TCE_MMA_FRAC), inv = ldexp(1.0, TCE_MMA_FRAC - top);
      double sum = trunc(addend * inv) * step;  // exact: fewer than 2^32 steps in all
      for (int k = 0; k < 16; ++k) sum += trunc((double)A[row][k] * B[k][col] * inv) * step;
      float f = (float)sum;
      if (fabs((double)f) > fabs(sum)) f = nextafterf(f, 0.0f);
      c[l][i] = f;
    }
}

// Registers of two packed bf16 as [register][half] floats.
inline void tce_unpack(const uint32_t r[4], float out[4][2]) {
  for (int i = 0; i < 4; ++i) {
    out[i][0] = tc_unpack_lo(r[i]);
    out[i][1] = tc_unpack_hi(r[i]);
  }
}

// The b0, b1 registers of n-tile `half` (0 or 1) of an x4 fragment that
// holds two n-tiles (registers 0-1 and 2-3).
inline void tce_b_half(const float x4[32][4][2], int half, float b[32][2][2]) {
  for (int l = 0; l < 32; ++l)
    for (int r = 0; r < 2; ++r)
      for (int e = 0; e < 2; ++e) b[l][r][e] = x4[l][2 * half + r][e];
}
