// K1: set-parallel true-LRU cache pass, one thread per (stream, set).
//
// Replaces repro/kernels/cache_sim/cache_sim.py::lru_hits and
// ::lru_hits_carry (the Pallas TPU kernels behind the `pallas` engine), and
// the lax.scan machines memsim/engine.py::_batched_pass and
// ::_fused_select_pass they mirror.
//
// Input is ragged, not padded: the stably set-sorted stream `blocks` plus
// per-row offsets, row = stream * sets + set.  A thread walks its row in
// stream order with the set's tags and ages in registers (lru_row in
// cache_sim_step.h), so there is no pad work and no set-skew blow-up.
//
// What bounds it on an H100: neither bytes nor operations.  A row is a
// chain of dependent steps (each step reads the state the previous one
// wrote), so the time is the longest row times the step latency, and the
// card is mostly idle: 16 to 8192 threads per stream against 132 SMs.
// The design keeps each step short (state in registers, one 4-byte load,
// one 1-byte store, blocks of 32 threads so rows spread over SMs) and
// puts every stream of a scoring family into one launch (the stream
// axis), which is what fills the card.
#include <cuda_runtime.h>

#include "cache_sim_step.h"

template <int CAP>
__global__ void lru_hits_kernel(const int32_t* __restrict__ blocks,
                                const int64_t* __restrict__ offsets, int rows,
                                int ways, const int32_t* __restrict__ tags_in,
                                const int32_t* __restrict__ age_in,
                                int32_t* __restrict__ tags_out,
                                int32_t* __restrict__ age_out,
                                uint8_t* __restrict__ hits) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t s = row * ways;
  lru_row<CAP>(blocks, offsets[row], offsets[row + 1], ways, tags_in + s,
               age_in + s, tags_out + s, age_out + s, hits);
}

template <int CAP>
static void launch(dim3 grid, dim3 block, cudaStream_t stream,
                   const int32_t* blocks, const int64_t* offsets, int rows,
                   int ways, const int32_t* tags_in, const int32_t* age_in,
                   int32_t* tags_out, int32_t* age_out, uint8_t* hits) {
  lru_hits_kernel<CAP><<<grid, block, 0, stream>>>(
      blocks, offsets, rows, ways, tags_in, age_in, tags_out, age_out, hits);
}

extern "C" int lru_hits_launch(const void* blocks, const void* offsets,
                               int rows, int ways, const void* tags_in,
                               const void* age_in, void* tags_out,
                               void* age_out, void* hits, void* stream) {
  if (rows <= 0) return 0;
  const int threads = 32;
  const dim3 grid((rows + threads - 1) / threads), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* b = (const int32_t*)blocks;
  const int64_t* o = (const int64_t*)offsets;
  const int32_t* ti = (const int32_t*)tags_in;
  const int32_t* ai = (const int32_t*)age_in;
  int32_t* to = (int32_t*)tags_out;
  int32_t* ao = (int32_t*)age_out;
  uint8_t* h = (uint8_t*)hits;
  if (ways <= 1)
    launch<1>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else if (ways <= 2)
    launch<2>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else if (ways <= 4)
    launch<4>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else if (ways <= 8)
    launch<8>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else if (ways <= 16)
    launch<16>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else if (ways <= CS_MAX_WAYS)
    launch<CS_MAX_WAYS>(grid, block, st, b, o, rows, ways, ti, ai, to, ao, h);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
