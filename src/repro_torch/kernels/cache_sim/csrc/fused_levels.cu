// K2: fused L1 -> L2 -> LLC demand pass, one thread per (stream, group).
//
// Replaces repro/kernels/cache_sim/fused_sim.py::fused_levels_pallas
// (_fused_tile_kernel) and the lax.scan machine memsim/fused.py::_fused_scan
// it mirrors.
//
// With G = min(sets) groups, a group owns R_i = sets_i / G whole sets at
// every level, so one thread can carry a group through the whole hierarchy.
// Input is the group-sorted, run-collapsed stream (collapse stays on the
// host, as on the TPU) plus per-row offsets, row = stream * G + group.
// Per-level state lives in global memory, (rows, R_i * ways_i) lanes per
// level, and is updated in place in the output state tensors.  Each step
// touches only the accessed set's ways_i lanes at each level it reaches
// (fused_step in cache_sim_step.h), not the TPU kernel's full R_i * ways_i
// lane mask.  The output is the int8 hit level.
//
// What bounds it on an H100: the dependent chain of steps per row, not
// bytes or operations.  Under the paper's hierarchy G = 128, so one stream
// runs 128 threads, each walking ~1/128 of the stream; a step's latency is
// a few dependent L1-cache round trips for the state rows.  The design
// keeps the step to the lanes it must touch, keeps the level table in a
// by-value kernel argument, uses blocks of 32 threads so rows spread over
// SMs, and batches streams into one launch (the stream axis).
#include <cuda_runtime.h>

#include "cache_sim_step.h"

__global__ void fused_levels_kernel(const int32_t* __restrict__ blocks,
                                    const int64_t* __restrict__ offsets,
                                    int rows, FusedLevels lv,
                                    int8_t* __restrict__ lvl) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  fused_row(lv, row, blocks, offsets[row], offsets[row + 1], lvl);
}

// `tags` / `age` are host arrays of k device pointers; `rmask`, `ways`,
// `lanes` host arrays of k ints.
extern "C" int fused_levels_launch(const void* blocks, const void* offsets,
                                   int rows, int k, int lg, const int* rmask,
                                   const int* ways, const int* lanes,
                                   void* const* tags, void* const* age,
                                   void* lvl, void* stream) {
  if (k < 1 || k > CS_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  FusedLevels lv;
  lv.k = k;
  lv.lg = lg;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    const bool on = i < k;
    if (on && (ways[i] < 1 || ways[i] > CS_MAX_WAYS))
      return (int)cudaErrorInvalidValue;
    lv.rmask[i] = on ? rmask[i] : 0;
    lv.ways[i] = on ? ways[i] : 1;
    lv.lanes[i] = on ? lanes[i] : 0;
    lv.tags[i] = on ? (int32_t*)tags[i] : nullptr;
    lv.age[i] = on ? (int32_t*)age[i] : nullptr;
  }
  if (rows <= 0) return 0;
  const int threads = 32;
  fused_levels_kernel<<<(rows + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)blocks, (const int64_t*)offsets, rows, lv, (int8_t*)lvl);
  return (int)cudaGetLastError();
}
