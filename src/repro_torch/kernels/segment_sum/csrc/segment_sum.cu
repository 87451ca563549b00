// Ordered float32 segment sum: a warp for each long segment, a thread for
// each short one.
//
// Not a port of a TPU kernel: it stands in for jax.ops.segment_sum in
// PageRankDelta's EDGEMAP (repro/apps/pagerank_delta.py:59).  The JAX
// package adds each destination's contributions sequentially in edge order
// (XLA-CPU's scatter-add), and the rank delta it yields feeds a threshold
// test that decides frontier membership, so the port must produce the same
// float sequence.  torch's index_add_ on CUDA uses atomics in an order
// that changes from run to run; this kernel instead walks each segment's
// edges in their original order, through a stable destination sort of the
// edge ids computed once per graph on the host (`perm`, `offsets`), and
// adds from 0.0f (the steps are segment_sum_step.h's).
//
// What bounds it on an H100: the longest segment's chain.  Each edge costs
// two dependent loads (perm[j], then values[perm[j]]) and one add that
// waits on the add before it; nothing may reorder the adds.  At google's
// push order (640,000 edges into 110,000 segments) the bytes take ~2 us,
// and the longest segment's 2,038 adds at 4 cycles each ~4 us.  One thread
// a segment walking its edges (the design before) waited on both loads at
// every edge, ~68 cycles an edge.  So the loads leave the chain:
//
//   heavy role (segments of more than SS_CHUNK edges, listed by the host
//   longest first, in the first blocks, so the longest starts first): one
//   warp a segment, each lane loading one edge of a chunk of SS_CHUNK.  A
//   lane's values of the next SS_RING chunks and its perm entries of the
//   SS_RING chunks after those are in flight in registers, so a values
//   load never waits on its perm load.  Each chunk goes through the warp's
//   shared-memory buffers (STAGES of them, so one __syncwarp a chunk
//   keeps the writes clear of the reads); every lane reads it back as
//   float4 broadcasts, half a chunk ahead of the adds, and adds it in edge
//   order, so the chain holds only adds.  (Shuffles in place of the
//   buffers put a shuffle's latency before every add; whole chunks read
//   ahead by volatile asm took 108 registers in place of 63 and ran no
//   faster; tools/kernel_variants.py segsum times these choices.)  The
//   longest warp alone still takes ~300 cycles a chunk of 32 adds that
//   take 130-170.
//   light role (the rest): one thread a segment, its loads sent SS_HOIST
//   edges at a time ahead of their adds.
//
// No --use_fast_math: it would flush subnormal sums to zero.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum_step.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;  // chunk buffers of a heavy warp
static_assert((STAGES & (STAGES - 1)) == 0 && STAGES >= 3, "STAGES: a power of two, >= 3");

constexpr int HALF = SS_CHUNK / 2;

// Half a chunk (HALF values) from a warp's buffer, as float4 broadcasts.
__device__ __forceinline__ void read_half(float x[HALF], const float* buf) {
#pragma unroll
  for (int k = 0; k < HALF / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(buf)[k];
    x[4 * k] = v.x, x[4 * k + 1] = v.y, x[4 * k + 2] = v.z, x[4 * k + 3] = v.w;
  }
}

// Blocks [0, heavy_blocks) hold WARPS heavy segments each (heavy[w], w <
// nheavy, longest first); the rest one light segment a thread.  A light
// thread leaves heavy segments to their warps.
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ values, const int32_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets, int n, const int32_t* __restrict__ heavy,
                   int nheavy, int heavy_blocks, float* __restrict__ out) {
  __shared__ __align__(16) float stage[WARPS][STAGES][SS_CHUNK];
  if ((int)blockIdx.x < heavy_blocks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int w = blockIdx.x * WARPS + warp;
    if (w >= nheavy) return;
    const int d = heavy[w];
    const int64_t lo = offsets[d], hi = offsets[d + 1], nc = ss_chunks(hi - lo);
    float* buf = &stage[warp][0][0];
    float ring[SS_RING];     // values of chunks c .. c + SS_RING - 1, slot c % SS_RING
    int32_t pidx[SS_RING];  // perm entries of the SS_RING chunks after those
#pragma unroll
    for (int s = 0; s < SS_RING; ++s)
      ring[s] = ss_lane_value(values, ss_lane_perm(perm, lo, hi, s, lane));
#pragma unroll
    for (int s = 0; s < SS_RING; ++s) pidx[s] = ss_lane_perm(perm, lo, hi, s + SS_RING, lane);
    buf[lane] = ring[0];  // chunk 0
    __syncwarp();
    float cur[HALF], nxt[HALF];
    read_half(cur, buf);
    float acc = 0.0f;
    for (int64_t c0 = 0; c0 < nc; c0 += SS_RING) {
#pragma unroll
      for (int s = 0; s < SS_RING; ++s) {
        const int64_t c = c0 + s;
        if (c >= nc) break;
        const float* now = buf + (c & (STAGES - 1)) * SS_CHUNK;
        float* next = buf + ((c + 1) & (STAGES - 1)) * SS_CHUNK;
        next[lane] = ring[(s + 1) % SS_RING];  // chunk c + 1
        ring[s] = ss_lane_value(values, pidx[s]);  // chunk c + SS_RING
        pidx[s] = ss_lane_perm(perm, lo, hi, c + 2 * SS_RING, lane);
        __syncwarp();
        const int len = ss_chunk_len(lo, hi, c);
        read_half(nxt, now + HALF);
        acc = ss_chain(acc, len, cur, HALF);
        read_half(cur, next);  // chunk c + 1's first half
        acc = ss_chain(acc, len - HALF, nxt, HALF);
      }
    }
    if (lane == 0) out[d] = acc;
    return;
  }
  const int64_t d = (int64_t)(blockIdx.x - heavy_blocks) * THREADS + threadIdx.x;
  if (d >= n) return;
  const int64_t lo = offsets[d], hi = offsets[d + 1];
  if (ss_is_heavy(hi - lo)) return;
  out[d] = ss_light(values, perm, lo, hi);
}

}  // namespace

// heavy: the nheavy segments with ss_is_heavy lengths, longest first.
extern "C" int segment_sum_launch(const void* values, const void* perm, const void* offsets,
                                  int n, const void* heavy, int nheavy, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int heavy_blocks = (nheavy + WARPS - 1) / WARPS;
  const int light_blocks = (n + THREADS - 1) / THREADS;
  segment_sum_kernel<<<heavy_blocks + light_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n,
      (const int32_t*)heavy, nheavy, heavy_blocks, (float*)out);
  return (int)cudaGetLastError();
}
