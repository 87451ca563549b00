// Host driver of cache_sim_step.h, for the CPU tests only.
//
// Runs the same per-row functions the CUDA kernels run, one row after the
// other, so a g++ build of this file checks the GPU's step logic bit for
// bit against the plain PyTorch versions and the JAX package.  The port
// itself never loads this build.
//
//   g++ -O2 -shared -fPIC -o libhost_step_test.so host_step_test.cpp
#include "cache_sim_step.h"

extern "C" int host_lru_hits(const int32_t* blocks, const int64_t* offsets,
                             int rows, int ways, const int32_t* tags_in,
                             const int32_t* age_in, int32_t* tags_out,
                             int32_t* age_out, uint8_t* hits) {
  if (ways < 1 || ways > CS_MAX_WAYS) return 1;
  for (int64_t row = 0; row < rows; ++row) {
    const int64_t s = row * ways;
    lru_row<CS_MAX_WAYS>(blocks, offsets[row], offsets[row + 1], ways,
                         tags_in + s, age_in + s, tags_out + s, age_out + s,
                         hits);
  }
  return 0;
}

extern "C" int host_fused_levels(const int32_t* blocks, const int64_t* offsets,
                                 int rows, int k, int lg, const int* rmask,
                                 const int* ways, const int* lanes,
                                 int32_t* const* tags, int32_t* const* age,
                                 int8_t* lvl) {
  if (k < 1 || k > CS_MAX_LEVELS) return 1;
  FusedLevels lv;
  lv.k = k;
  lv.lg = lg;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    const bool on = i < k;
    if (on && (ways[i] < 1 || ways[i] > CS_MAX_WAYS)) return 1;
    lv.rmask[i] = on ? rmask[i] : 0;
    lv.ways[i] = on ? ways[i] : 1;
    lv.lanes[i] = on ? lanes[i] : 0;
    lv.tags[i] = on ? tags[i] : nullptr;
    lv.age[i] = on ? age[i] : nullptr;
  }
  for (int64_t row = 0; row < rows; ++row)
    fused_row(lv, row, blocks, offsets[row], offsets[row + 1], lvl);
  return 0;
}
