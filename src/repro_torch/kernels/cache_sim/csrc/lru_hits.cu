// K1: set-parallel true-LRU cache pass, one group of lanes per (stream,
// set) row, the set's ways across the group.
//
// Replaces repro/kernels/cache_sim/cache_sim.py::lru_hits and
// ::lru_hits_carry (the Pallas TPU kernels behind the `pallas` engine), and
// the lax.scan machines memsim/engine.py::_batched_pass and
// ::_fused_select_pass they mirror.
//
// Input is ragged, not padded: the stably set-sorted stream `blocks` plus
// per-row offsets, row = stream * sets + set.  A group walks its row in
// stream order with the set's tags and ages in registers, one way a lane,
// so there is no pad work and no set-skew blow-up.
//
// What bounds it on an H100: neither bytes nor operations.  A row is a
// chain of dependent steps (each step reads the state the previous one
// wrote), so the time is the longest row times the step's latency.  One
// thread a row that loads each access from global memory and stores each
// hit byte waits a memory round trip a step (the store may alias the next
// load, so the load is not issued early).  Here no step touches global
// memory (cache_sim_step.h, lru_group_lanes .. lru_store_word): G lanes a
// row (G = the ways rounded up to a power of two, 32 / G rows a warp), the
// row's accesses loaded 4 G at a time in one coalesced 16-byte load a lane,
// one batch ahead of the walk; a step takes its access by shuffle, the hit
// from a ballot and the touched way from log2 G xor-shuffle rounds of min
// and a ballot, all in registers; a lane stores the hit bytes of its 4
// accesses as one word.  Rows of 8 ways put 4 rows in a warp, so path B's
// launches of 512 and 1,024 rows spread over 128 and 256 warps.
#include <cuda_runtime.h>

#include "cache_sim_step.h"

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

template <int G>
__global__ void __launch_bounds__(THREADS)
lru_hits_kernel(const int32_t* __restrict__ blocks, const int64_t* __restrict__ offsets, int rows,
                int ways, const int32_t* __restrict__ tags_in, const int32_t* __restrict__ age_in,
                int32_t* __restrict__ tags_out, int32_t* __restrict__ age_out,
                uint8_t* __restrict__ hits) {
  constexpr int BATCH = 4 * G;
  constexpr int ROUNDS = G <= 1 ? 0 : G <= 2 ? 1 : G <= 4 ? 2 : G <= 8 ? 3 : G <= 16 ? 4 : 5;
  const int lane = threadIdx.x & 31, grp = lane / G, way = lane % G;
  const int64_t row =
      ((int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * (32 / G) + grp;
  const bool has = row < rows;
  const int64_t lo = has ? offsets[row] : 0, hi = has ? offsets[row + 1] : 0;
  const bool real = has && way < ways;
  int32_t tag = real ? tags_in[row * ways + way] : -2;
  int32_t age = real ? age_in[row * ways + way] : CS_INT32_MAX;
  const unsigned shift = grp * G;
  const unsigned gmask = (G == 32 ? FULL : ((1u << G) - 1u)) << shift;
  const int64_t base = lru_batch_base(lo, G);
  const int batches = (int)__reduce_max_sync(FULL, (unsigned)lru_batches(lo, hi, G));
  int32_t cur[4], nxt[4];
  lru_load4(blocks, base + 4 * way, hi, cur);
  for (int k = 0; k < batches; ++k) {
    const int64_t b0 = base + (int64_t)k * BATCH;
    lru_load4(blocks, b0 + BATCH + 4 * way, hi, nxt);  // the next batch, ahead of the walk
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int32_t b = __shfl_sync(FULL, cur[j & 3], j / 4, G);
      const int64_t i = b0 + j;
      const bool hit = (__ballot_sync(FULL, real && tag == b) & gmask) != 0;
      const int32_t key = lru_lane_key(real, tag, age, b);
      int32_t m = key;
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) m = min(m, __shfl_xor_sync(FULL, m, 1 << r, G));
      const unsigned wins = (__ballot_sync(FULL, key == m) & gmask) >> shift;
      if (i >= lo && i < hi && b >= 0 && lru_lane_touched(wins, way)) {
        tag = b;
        age = (int32_t)(i - lo + 1);
      }
      if (way == j / 4) word |= (uint32_t)hit << (8 * (j & 3));
    }
    lru_store_word(hits, b0 + 4 * way, lo, hi, word);
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
  }
  if (real) {
    tags_out[row * ways + way] = tag;
    age_out[row * ways + way] = age;
  }
}

template <int G>
void launch(int rows, cudaStream_t stream, const int32_t* blocks, const int64_t* offsets,
            int ways, const int32_t* tags_in, const int32_t* age_in, int32_t* tags_out,
            int32_t* age_out, uint8_t* hits) {
  const int64_t threads = (int64_t)rows * G;
  lru_hits_kernel<G><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      blocks, offsets, rows, ways, tags_in, age_in, tags_out, age_out, hits);
}

}  // namespace

// blocks must be 16-byte aligned, hits 4-byte aligned.
extern "C" int lru_hits_launch(const void* blocks, const void* offsets, int rows, int ways,
                               const void* tags_in, const void* age_in, void* tags_out,
                               void* age_out, void* hits, void* stream) {
  if (rows <= 0) return 0;
  if ((uintptr_t)blocks % 16 || (uintptr_t)hits % 4) return (int)cudaErrorMisalignedAddress;
  if (ways < 1 || ways > CS_MAX_WAYS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* b = (const int32_t*)blocks;
  const int64_t* o = (const int64_t*)offsets;
  const int32_t* ti = (const int32_t*)tags_in;
  const int32_t* ai = (const int32_t*)age_in;
  int32_t* to = (int32_t*)tags_out;
  int32_t* ao = (int32_t*)age_out;
  uint8_t* h = (uint8_t*)hits;
  switch (lru_group_lanes(ways)) {
    case 1: launch<1>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
    case 2: launch<2>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
    case 4: launch<4>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
    case 8: launch<8>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
    case 16: launch<16>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
    default: launch<32>(rows, st, b, o, ways, ti, ai, to, ao, h); break;
  }
  return (int)cudaGetLastError();
}
