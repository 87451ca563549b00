// Host driver of basedelta_step.h, for the CPU tests only.
//
// Runs the same per-row functions the CUDA kernels run, one row after the
// other (for compress, with the columns split over 32 "lanes" and
// max-reduced as a warp does; for decompress, also every thread of the
// kernel's grid through its thread-to-element map), so a g++ build of this file checks the
// GPU's step logic bit for bit against the plain PyTorch versions and the
// JAX package.  The port itself never loads this build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libbasedelta_host.so host_step_test.cpp
#include "basedelta_step.h"

extern "C" int host_basedelta_compress(const int32_t* blocks,
                                       const int32_t* counts, int64_t e, int w,
                                       int32_t* deltas, int32_t* mode) {
  if (w <= 0) return 1;
  for (int64_t r = 0; r < e; ++r) {
    int32_t absmax = 0;
    for (int lane = 0; lane < 32; ++lane) {
      const int32_t a = bd_compress_cols(blocks + r * w, counts[r], w, lane, 32,
                                         deltas + r * w);
      absmax = a > absmax ? a : absmax;
    }
    mode[r] = bd_mode(absmax);
  }
  return 0;
}

extern "C" int host_basedelta_decompress(const int32_t* base,
                                         const int32_t* deltas, int64_t e,
                                         int w, int32_t* out) {
  for (int64_t i = 0; i < e * w; ++i) out[i] = bd_wrap_add(base[i / w], deltas[i]);
  return 0;
}

// K3b's kernels as launched (basedelta_decompress_launch): every thread of
// every block of bd_decompress_map's grid, one after the other, on the
// route `vec` names (1: 16-byte units, refused unless bd_vec_ok).
extern "C" int host_basedelta_decompress_map(const int32_t* base,
                                             const int32_t* deltas, int64_t e,
                                             int w, int vec, int32_t* out) {
  if (e <= 0 || w <= 0) return 0;
  if (vec && !bd_vec_ok(deltas, out, w)) return 2;
  const BdMap m = bd_decompress_map(e, w, vec != 0);
  for (int block = 0; block < m.grid; ++block)
    for (int x = 0; x < BD_BLOCK; ++x) {
      if (vec)
        bd_decompress_thread<bd_int4>(base, (const bd_int4*)deltas, e, m, block, x,
                                      (bd_int4*)out);
      else
        bd_decompress_thread<int32_t>(base, deltas, e, m, block, x, out);
    }
  return 0;
}

// bd_decompress_map for the tests: units, tpr, rpb, grid.
extern "C" int host_basedelta_map(int64_t e, int w, int vec, int64_t* out) {
  const BdMap m = bd_decompress_map(e, w, vec != 0);
  out[0] = m.units;
  out[1] = m.tpr;
  out[2] = m.rpb;
  out[3] = m.grid;
  return 0;
}
