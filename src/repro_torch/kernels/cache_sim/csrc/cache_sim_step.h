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

// K1's lane-group walk (lru_hits.cu): a row of `ways` ways is walked by a
// group of G lanes, G the ways rounded up to a power of two, 32 / G rows a
// warp; lane `way` of a group holds that way's (tag, age) in registers
// (lanes at or past `ways` hold tag -2 and age INT32_MAX and never hit or
// win).  The group loads its row's accesses in batches of 4 G, lane `way`
// the 4 at batch base + 4 way (one 16-byte load), one batch ahead of the
// walk; batches are aligned to 4 G accesses from the row's first.  A step
// takes the access from its lane by shuffle; a ballot of tag == b gives
// the hit; the touched way is the lowest lane whose key
// (lru_lane_key) equals the group's minimum (log2 G xor-shuffle rounds of
// min, then a ballot); it takes tag b and age t unless b is a pad.  Lane
// `way` keeps the hit bytes of its 4 accesses in one word and stores it
// whole where all 4 lie in the row.

// Lanes of the group that walks a row of `ways` ways.
CS_HD int lru_group_lanes(int ways) {
  return ways <= 1 ? 1 : ways <= 2 ? 2 : ways <= 4 ? 4 : ways <= 8 ? 8 : ways <= 16 ? 16 : 32;
}

// First access index of a row's batches (aligned to 4 G accesses, so that
// every lane's 4 are one aligned 16-byte load), and the batches the row
// [lo, hi) takes.
CS_HD int64_t lru_batch_base(int64_t lo, int g) { return lo & ~(int64_t)(4 * g - 1); }
CS_HD int lru_batches(int64_t lo, int64_t hi, int g) {
  return hi > lo ? (int)((hi - lru_batch_base(lo, g) + 4 * g - 1) / (4 * g)) : 0;
}

// A lane's 4 accesses at a (a multiple of 4): zero past the row's end hi,
// so nothing past the stream is read.
CS_HD void lru_load4(const int32_t* blocks, int64_t a, int64_t hi, int32_t v[4]) {
#if defined(__CUDA_ARCH__)
  if (a + 4 <= hi) {
    const int4 q = *reinterpret_cast<const int4*>(blocks + a);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#endif
CS_UNROLL
  for (int e = 0; e < 4; ++e) v[e] = a + e < hi ? blocks[a + e] : 0;
}

// lru_step's key of one lane: INT32_MIN on a hit, else its age; lanes past
// the set's ways never win.
CS_HD int32_t lru_lane_key(bool real, int32_t tag, int32_t age, int32_t b) {
  return !real ? CS_INT32_MAX : tag == b ? CS_INT32_MIN : age;
}

// Whether lane `way` is its group's touched way: the lowest lane of
// `wins`, the group's ballot of key == minimum shifted to bit 0 (lru_step's
// first lane on ties).
CS_HD bool lru_lane_touched(uint32_t wins, int way) { return (wins & (0u - wins)) == (1u << way); }

// Store lane's hit word (one byte per access, a..a+3) where those accesses
// lie in [lo, hi): whole where all 4 do, byte by byte otherwise.
CS_HD void lru_store_word(uint8_t* hits, int64_t a, int64_t lo, int64_t hi, uint32_t word) {
  if (a >= lo && a + 4 <= hi) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint32_t*>(hits + a) = word;
#else
    for (int e = 0; e < 4; ++e) hits[a + e] = (uint8_t)(word >> (8 * e));
#endif
    return;
  }
CS_UNROLL
  for (int e = 0; e < 4; ++e)
    if (a + e >= lo && a + e < hi) hits[a + e] = (uint8_t)(word >> (8 * e));
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
