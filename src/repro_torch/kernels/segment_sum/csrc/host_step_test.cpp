// Host harness of segment_sum_step.h, for the CPU tests only.
//
// host_segment_sum_warp runs segment_sum.cu's grid on the host: the
// heavy blocks' warps with their 32 lanes emulated in step (each lane's
// ring of SS_RING chunk values and of the next SS_RING chunks' perm
// entries, refilled slot by slot as the kernel refills them; the warp's
// shared-memory chunk buffers, written a chunk ahead and read back half a
// chunk at a time), then the light blocks' threads, each with the header's
// ss_light.  Segments that no role writes keep what `out` held, so a test
// that fills it with NaN sees them.  The port itself never loads this
// build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libsegment_sum_host.so host_step_test.cpp
#include <string.h>

#include "segment_sum_step.h"

extern "C" int host_segment_sum_warp(const float* values, const int32_t* perm,
                                     const int64_t* offsets, int n, const int32_t* heavy,
                                     int nheavy, float* out) {
  constexpr int STAGES = 4, HALF = SS_CHUNK / 2;
  for (int w = 0; w < nheavy; ++w) {  // the heavy blocks, warp by warp
    const int d = heavy[w];
    if (d < 0 || d >= n) return 1;
    const int64_t lo = offsets[d], hi = offsets[d + 1], nc = ss_chunks(hi - lo);
    if (!ss_is_heavy(hi - lo)) return 2;
    float ring[32][SS_RING], buf[STAGES][SS_CHUNK], cur[32][HALF], nxt[32][HALF], acc[32];
    int32_t pidx[32][SS_RING];
    for (int l = 0; l < 32; ++l) {
      for (int s = 0; s < SS_RING; ++s) ring[l][s] = ss_lane_value(values, ss_lane_perm(perm, lo, hi, s, l));
      for (int s = 0; s < SS_RING; ++s) pidx[l][s] = ss_lane_perm(perm, lo, hi, s + SS_RING, l);
      buf[0][l] = ring[l][0];
      acc[l] = 0.0f;
    }
    for (int l = 0; l < 32; ++l) memcpy(cur[l], buf[0], sizeof(cur[l]));
    for (int64_t c0 = 0; c0 < nc; c0 += SS_RING)
      for (int s = 0; s < SS_RING; ++s) {
        const int64_t c = c0 + s;
        if (c >= nc) break;
        float* now = buf[c & (STAGES - 1)];
        float* next = buf[(c + 1) & (STAGES - 1)];
        for (int l = 0; l < 32; ++l) {
          next[l] = ring[l][(s + 1) % SS_RING];
          ring[l][s] = ss_lane_value(values, pidx[l][s]);
          pidx[l][s] = ss_lane_perm(perm, lo, hi, c + 2 * SS_RING, l);
        }
        // __syncwarp: every lane's write is seen by every lane's reads
        const int len = ss_chunk_len(lo, hi, c);
        for (int l = 0; l < 32; ++l) {
          memcpy(nxt[l], now + HALF, sizeof(nxt[l]));
          acc[l] = ss_chain(acc[l], len, cur[l], HALF);
          memcpy(cur[l], next, sizeof(cur[l]));
          acc[l] = ss_chain(acc[l], len - HALF, nxt[l], HALF);
        }
      }
    out[d] = acc[0];
  }
  for (int64_t d = 0; d < n; ++d) {  // the light blocks, thread by thread
    const int64_t lo = offsets[d], hi = offsets[d + 1];
    if (!ss_is_heavy(hi - lo)) out[d] = ss_light(values, perm, lo, hi);
  }
  return 0;
}

extern "C" int host_segment_sum_chunk() { return SS_CHUNK; }
