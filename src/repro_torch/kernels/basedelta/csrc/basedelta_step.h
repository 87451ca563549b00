// Per-row step of the BaseDelta tile kernels (K3a compress, K3b
// decompress), shared by the CUDA kernels in basedelta.cu and by the CPU
// tests, which compile this header with g++ through host_step_test.cpp.
//
// The arithmetic is the JAX package's: int32 that wraps.  `x - base` and
// `jnp.abs` wrap in int32 there, so abs(INT32_MIN) stays INT32_MIN, which
// is negative and so never raises a row's maximum.  Signed overflow is
// undefined in C++, so every subtraction, addition and negation below is
// done in uint32_t and cast back (two's complement, as on every target).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define BD_HD __host__ __device__ __forceinline__
#else
#define BD_HD inline
#endif

BD_HD int32_t bd_wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

BD_HD int32_t bd_wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

BD_HD int32_t bd_wrap_abs(int32_t d) {
  return d < 0 ? (int32_t)(0u - (uint32_t)d) : d;
}

// Mode of a row from the largest |delta|: 0, 1 or 2 for 1-, 2- or 4-byte
// deltas.  Mode 3 (wider than int32) cannot occur for int32 input.
BD_HD int32_t bd_mode(int32_t absmax) {
  return absmax <= 127 ? 0 : (absmax <= 32767 ? 1 : 2);
}

// Columns lane0, lane0 + step, ... of one entry row: writes the deltas
// against the row's base (its column 0) on valid columns (< count) and 0
// on pad columns, and returns the largest wrapped |delta| it wrote (0 when
// it wrote none, the identity of the row maximum since every row has
// delta 0 at column 0 or only zeros).
BD_HD int32_t bd_compress_cols(const int32_t* row, int32_t count, int w,
                               int lane0, int step, int32_t* delta_row) {
  const int32_t base = row[0];
  int32_t absmax = 0;
  for (int c = lane0; c < w; c += step) {
    const int32_t d = c < count ? bd_wrap_sub(row[c], base) : 0;
    delta_row[c] = d;
    const int32_t a = bd_wrap_abs(d);
    absmax = a > absmax ? a : absmax;
  }
  return absmax;
}
