// Per-set and per-group steps of the cache-simulation kernels.
//
// Everything here is __host__ __device__: the CUDA kernels (lru_hits.cu,
// fused_levels.cu) are thin thread-indexing wrappers around lru_row and
// fused_row, and the host test driver (host_step_test.cpp) compiles the
// same functions with g++ so the logic the GPU runs is tested bit for bit
// on a machine without a GPU.
//
// Semantics (repro/memsim/engine.py::_fused_select_pass, fused.py::_fused_scan):
//   - a set holds `ways` lanes of (tag, age); tag -1 is an empty way;
//   - the touched way is argmin(where(tag == b, INT32_MIN, age)) over the
//     set's lanes, the first lane winning ties (tags are unique in a set
//     and ages pairwise distinct, so the winner is the hit way on a hit
//     and the LRU victim on a miss);
//   - the touched way gets tag b and age t, where t is the access's
//     position within its row's substream plus 1.  Carried (canonical)
//     ages are negative, so carried lines are older than any new access.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define CS_HD __host__ __device__ __forceinline__
#define CS_UNROLL _Pragma("unroll")
#else
#define CS_HD inline
#define CS_UNROLL
#endif

#define CS_INT32_MIN (-2147483647 - 1)
#define CS_INT32_MAX 2147483647
#define CS_MAX_LEVELS 4
#define CS_MAX_WAYS 32

// One true-LRU step on a set's `ways` (<= CAP) lanes.  Returns the hit bit;
// writes the touched way only when `update`.  With CAP a compile-time
// constant and the loops unrolled, lanes held in local arrays stay in
// registers.
template <int CAP>
CS_HD bool lru_step(int32_t* tags, int32_t* age, int ways, int32_t b, int32_t t,
                    bool update) {
  bool hit = false;
  int way = 0;
  int32_t best = 0;
CS_UNROLL
  for (int w = 0; w < CAP; ++w) {
    if (w < ways) {
      const bool h = tags[w] == b;
      const int32_t key = h ? CS_INT32_MIN : age[w];
      if (w == 0 || key < best) {
        best = key;
        way = w;
      }
      hit = hit || h;
    }
  }
  if (update) {
CS_UNROLL
    for (int w = 0; w < CAP; ++w) {
      if (w == way) {
        tags[w] = b;
        age[w] = t;
      }
    }
  }
  return hit;
}

// K1: walk one (stream, set) row of the set-sorted stream
// blocks[lo, hi) from the carried state tags_in/age_in (`ways` lanes),
// writing a 0/1 hit per access and the final raw state.
template <int CAP>
CS_HD void lru_row(const int32_t* blocks, int64_t lo, int64_t hi, int ways,
                   const int32_t* tags_in, const int32_t* age_in,
                   int32_t* tags_out, int32_t* age_out, uint8_t* hits) {
  int32_t tg[CAP];
  int32_t ag[CAP];
CS_UNROLL
  for (int w = 0; w < CAP; ++w) {
    tg[w] = w < ways ? tags_in[w] : -2;
    ag[w] = w < ways ? age_in[w] : CS_INT32_MAX;
  }
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t b = blocks[i];
    hits[i] = lru_step<CAP>(tg, ag, ways, b, (int32_t)(i - lo + 1), b >= 0) ? 1 : 0;
  }
CS_UNROLL
  for (int w = 0; w < CAP; ++w) {
    if (w < ways) {
      tags_out[w] = tg[w];
      age_out[w] = ag[w];
    }
  }
}

// K2's level table.  Level i of a K-level hierarchy has R_i = sets_i / G
// relative sets of ways_i lanes per group; a group's row of that level is
// R_i * ways_i lanes (relative set major), at tags[i] / age[i] + row * lanes.
struct FusedLevels {
  int k;   // number of levels, <= CS_MAX_LEVELS
  int lg;  // log2(G), G = min(sets) = number of groups per stream
  int rmask[CS_MAX_LEVELS];  // R_i - 1
  int ways[CS_MAX_LEVELS];
  int lanes[CS_MAX_LEVELS];  // R_i * ways_i
  int32_t* tags[CS_MAX_LEVELS];
  int32_t* age[CS_MAX_LEVELS];
};

// K2 step: one access through every level until one hits.  Level i is
// updated only when the access reached it (it missed every level above),
// and only the accessed set's `ways` lanes are touched.  Returns the hit
// level, or k when every level missed (or b is a pad).
CS_HD int fused_step(const FusedLevels& lv, int32_t* const* tags,
                     int32_t* const* age, int32_t b, int32_t t) {
  if (b < 0) return lv.k;
CS_UNROLL
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    if (i < lv.k) {
      const int lane0 = ((b >> lv.lg) & lv.rmask[i]) * lv.ways[i];
      if (lru_step<CS_MAX_WAYS>(tags[i] + lane0, age[i] + lane0, lv.ways[i], b, t,
                                true))
        return i;
    }
  }
  return lv.k;
}

// K2: walk one (stream, group) row of the group-sorted, run-collapsed
// stream blocks[lo, hi), updating the row's per-level state in place and
// writing each access's hit level.
CS_HD void fused_row(const FusedLevels& lv, int64_t row, const int32_t* blocks,
                     int64_t lo, int64_t hi, int8_t* lvl) {
  int32_t* tags[CS_MAX_LEVELS];
  int32_t* age[CS_MAX_LEVELS];
CS_UNROLL
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    tags[i] = i < lv.k ? lv.tags[i] + row * lv.lanes[i] : nullptr;
    age[i] = i < lv.k ? lv.age[i] + row * lv.lanes[i] : nullptr;
  }
  for (int64_t i = lo; i < hi; ++i)
    lvl[i] = (int8_t)fused_step(lv, tags, age, blocks[i], (int32_t)(i - lo + 1));
}
