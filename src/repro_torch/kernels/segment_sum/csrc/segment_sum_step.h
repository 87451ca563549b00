// Steps of the ordered segment sum (segment_sum.cu), shared by the CUDA
// kernel and by the CPU tests, which compile this header with g++ through
// host_step_test.cpp.
//
// Every segment's sum is one chain of float32 adds in edge order, from
// 0.0f: acc = ((0 + v0) + v1) + ...  Nothing here reorders it, starts it
// from the first value (0.0f + -0.0f is +0.0f, -0.0f alone is not) or
// flushes a subnormal; only the loads in front of the adds move.
//
// Two roles (see segment_sum.cu):
//   heavy: a segment of more than SS_CHUNK edges, one warp.  Lane l holds
//          edge lo + SS_CHUNK c + l of chunk c.  The warp keeps SS_RING
//          chunks of values and the next SS_RING chunks' perm entries in
//          flight, one register a lane each (so no load waits on the load
//          before it: a chunk's values are loaded from perm entries that
//          came SS_RING chunks earlier), passes each chunk through shared
//          memory, and every lane adds its values in lane order
//          (ss_chain), half a chunk at a time, the next half's reads started
//          before this half's adds.
//   light: any other segment, one thread, its perm and values loads for
//          SS_HOIST edges started before their adds (ss_light).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define SS_HD __host__ __device__ __forceinline__
#define SS_UNROLL _Pragma("unroll")
#else
#define SS_HD inline
#define SS_UNROLL
#endif

#define SS_CHUNK 32  // edges a chunk of a heavy segment: one a lane
#ifndef SS_RING
#define SS_RING 8  // chunks of a heavy segment in flight
#endif
#define SS_HOIST 8  // edges whose loads a light thread starts together

// Whether a segment of `len` edges takes a warp.  The host's plan lists
// exactly these segments (segment_sum.py: CHUNK).
SS_HD bool ss_is_heavy(int64_t len) { return len > SS_CHUNK; }

// Chunks of a heavy segment of `len` edges.
SS_HD int64_t ss_chunks(int64_t len) { return (len + SS_CHUNK - 1) / SS_CHUNK; }

// Edges of chunk c of [lo, hi) (SS_CHUNK, fewer at the end, 0 past it).
SS_HD int ss_chunk_len(int64_t lo, int64_t hi, int64_t c) {
  const int64_t n = hi - lo - c * SS_CHUNK;
  return n <= 0 ? 0 : n >= SS_CHUNK ? SS_CHUNK : (int)n;
}

// Lane `lane`'s perm entry of chunk c of [lo, hi): perm[j] for edge
// j = lo + SS_CHUNK c + lane, and -1 past the segment.
SS_HD int32_t ss_lane_perm(const int32_t* perm, int64_t lo, int64_t hi, int64_t c, int lane) {
  const int64_t j = lo + c * SS_CHUNK + lane;
  return j < hi ? perm[j] : -1;
}

// The value of a lane's perm entry: 0.0f (never added) past the segment.
SS_HD float ss_lane_value(const float* values, int32_t p) { return p >= 0 ? values[p] : 0.0f; }

// acc + x[i] for each i < count with i < n, in order: the adds of one
// stretch of a chunk, whose values are all in registers first.  Every add
// is predicated: a branch to unpredicated adds for full stretches (a
// predicated add waits 5.3 cycles on the one before it on the card, a
// plain one 4.1) made the kernel slower (tools/kernel_variants.py segsum).
SS_HD float ss_chain(float acc, int n, const float* x, int count) {
  SS_UNROLL for (int i = 0; i < count; ++i)
    if (i < n) acc += x[i];
  return acc;
}

// One thread's sum of the light segment [lo, hi).
SS_HD float ss_light(const float* values, const int32_t* perm, int64_t lo, int64_t hi) {
  float acc = 0.0f;
  for (int64_t j0 = lo; j0 < hi; j0 += SS_HOIST) {
    int32_t p[SS_HOIST];
    float v[SS_HOIST];
    SS_UNROLL for (int i = 0; i < SS_HOIST; ++i) p[i] = j0 + i < hi ? perm[j0 + i] : -1;
    SS_UNROLL for (int i = 0; i < SS_HOIST; ++i) v[i] = ss_lane_value(values, p[i]);
    acc = ss_chain(acc, (int)(hi - j0), v, SS_HOIST);
  }
  return acc;
}
