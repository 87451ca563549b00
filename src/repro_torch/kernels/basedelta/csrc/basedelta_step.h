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

// K3b's thread-to-element map, shared by the kernels and the CPU tests.
//
// A row of w int32 is `units` units: w / 4 16-byte vectors on the vector
// route (w % 4 == 0, deltas and out 16-byte aligned), else w elements.  A
// block of BD_BLOCK threads takes `rpb` rows at a time, `tpr` threads a
// row; thread x takes row group x / tpr and units x % tpr, x % tpr + tpr,
// ... of each of its rows, rows block * rpb + x / tpr, then + grid * rpb,
// ... (a grid-stride loop).  The division happens once a thread, not once
// an element, and the row's base is loaded once a row into a register.
#define BD_BLOCK 256
// A few waves of an H100: 132 SMs x 8 blocks of 256 threads, 4 times over.
#define BD_MAX_GRID (132 * 8 * 4)

#if defined(__CUDACC__)
typedef int4 bd_int4;
#else
struct alignas(16) bd_int4 {
  int32_t x, y, z, w;
};
#endif

struct BdMap {
  int64_t units;  // units a row
  int tpr;        // threads a row
  int rpb;        // rows a block takes at a time
  int grid;       // blocks
};

BD_HD bool bd_vec_ok(const void* deltas, const void* out, int w) {
  return w % 4 == 0 && (uintptr_t)deltas % 16 == 0 && (uintptr_t)out % 16 == 0;
}

BD_HD BdMap bd_decompress_map(int64_t e, int w, bool vec) {
  BdMap m;
  m.units = vec ? w / 4 : w;
  m.tpr = m.units < BD_BLOCK ? (int)m.units : BD_BLOCK;
  m.rpb = BD_BLOCK / m.tpr;
  const int64_t g = (e + m.rpb - 1) / m.rpb;
  m.grid = (int)(g < BD_MAX_GRID ? g : BD_MAX_GRID);
  return m;
}

BD_HD int32_t bd_add_unit(int32_t base, int32_t d) { return bd_wrap_add(base, d); }

BD_HD bd_int4 bd_add_unit(int32_t base, bd_int4 d) {
  bd_int4 r;
  r.x = bd_wrap_add(base, d.x);
  r.y = bd_wrap_add(base, d.y);
  r.z = bd_wrap_add(base, d.z);
  r.w = bd_wrap_add(base, d.w);
  return r;
}

// Thread x of block `block`: out = base[:, None] + deltas on its units.
// U is int32_t (the scalar route) or bd_int4 (the vector route).
template <typename U>
BD_HD void bd_decompress_thread(const int32_t* base, const U* deltas, int64_t e,
                                const BdMap& m, int block, int x, U* out) {
  const int ry = x / m.tpr;
  if (ry >= m.rpb) return;
  const int c0 = x - ry * m.tpr;
  for (int64_t r = (int64_t)block * m.rpb + ry; r < e; r += (int64_t)m.grid * m.rpb) {
    const int32_t b = base[r];
    const U* d = deltas + r * m.units;
    U* o = out + r * m.units;
    for (int64_t c = c0; c < m.units; c += m.tpr) o[c] = bd_add_unit(b, d[c]);
  }
}
