// Host driver of basedelta_step.h, for the CPU tests only.
//
// Runs the same per-row functions the CUDA kernels run, one row after the
// other (and, for compress, with the columns split over 32 "lanes" and
// max-reduced as a warp does), so a g++ build of this file checks the
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
