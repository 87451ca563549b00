// K2's warp step: one warp walks one (stream, group) row, every level's
// ways looked up at once.
//
// The lanes of the warp are split among the levels' ways: level i takes
// ways_i consecutive lanes (its segment), levels in order.  When the ways
// sum to more than 32, the levels are packed in order into turns of at
// most 32 lanes, each level whole in one turn; the step runs a turn only
// when every level of the turns before it missed.  Under the paper's and
// the scaled hierarchy (8 + 8 + 16 ways) a step is one turn.
//
// A turn, for access b at position t of its row:
//   1. each lane reads its way's (tag, age) in the set its level maps b to,
//      ((b >> lg) & rmask_i) * ways_i + way;
//   2. one ballot of tag == b gives the hit ways of every level of the turn;
//      the first level with a hit is the hit level;
//   3. a segmented suffix-min (shuffles down, within each level's segment)
//      of the key, INT32_MIN on a hit and the age otherwise, then one ballot
//      of key == suffix minimum: the lowest such lane of a segment holds the
//      segment's first minimum, its level's touched way (lru_step's rule:
//      the first lane wins ties);
//   4. the touched way of every level up to the hit level takes tag b and
//      age t.
// A pad (b < 0) touches nothing and has hit level k.
//
// The per-lane pieces are __host__ __device__: fused_levels.cu runs them
// with warp intrinsics, and host_step_test.cpp runs them for 32 emulated
// lanes (ballots as loops, shuffles as array reads), so the CPU tests check
// the warp step bit for bit.  During the walk each lane only ever touches
// its own way of its level's sets, so lanes share no state word.
#pragma once

#include "cache_sim_step.h"

#define FW_LANES 32
#define FW_FULL 0xffffffffu

// 1: levels packed greedily into turns of up to 32 lanes (the kernel);
// 0: every level a turn of its own, looked up one after the other (a
// design-step variant, tools/kernel_variants.py).
#ifndef FW_PACK_LEVELS
#define FW_PACK_LEVELS 1
#endif

// Lanes lo .. lo + n - 1 as a bit mask.
CS_HD uint32_t fw_lanes(int lo, int n) {
  return (n >= 32 ? FW_FULL : ((1u << n) - 1u)) << lo;
}

// Levels first[j] .. first[j + 1] - 1 run in turn j; off[i] is the lane of
// way 0 of level i within its turn; mask[j] the lanes turn j uses.
struct FusedTurns {
  int n;
  int first[CS_MAX_LEVELS + 1];
  int off[CS_MAX_LEVELS];
  uint32_t mask[CS_MAX_LEVELS];
};

CS_HD FusedTurns fw_turns(const FusedLevels& lv) {
  FusedTurns ft;
  ft.n = 0;
  int used = FW_LANES;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    ft.off[i] = 0;
    ft.mask[i] = 0;
    ft.first[i] = lv.k;
  }
  ft.first[CS_MAX_LEVELS] = lv.k;
  for (int i = 0; i < lv.k; ++i) {
    if (!FW_PACK_LEVELS || used + lv.ways[i] > FW_LANES) {
      ft.first[ft.n++] = i;
      used = 0;
    }
    ft.off[i] = used;
    used += lv.ways[i];
    ft.mask[ft.n - 1] = fw_lanes(0, used);
  }
  ft.first[ft.n] = lv.k;
  return ft;
}

// Rounds of the segmented reduce: the least R with 2^R >= every level's ways.
CS_HD int fw_rounds(const FusedLevels& lv) {
  int r = 0;
  for (int i = 0; i < lv.k; ++i)
    while ((1 << r) < lv.ways[i]) ++r;
  return r;
}

// Where a level's row state lives.  FwPairs: (tag, age) pairs side by side
// (the shared-memory route: one 8-byte access a lane).  FwSplit: the
// separate tag and age rows of the state tensors (the global-memory route).
struct FwPairs {
  int32_t* p;
  CS_HD void load(int idx, int32_t& tag, int32_t& age) const {
#if defined(__CUDA_ARCH__)
    const int2 v = reinterpret_cast<const int2*>(p)[idx];
    tag = v.x;
    age = v.y;
#else
    tag = p[2 * idx];
    age = p[2 * idx + 1];
#endif
  }
  CS_HD void store(int idx, int32_t tag, int32_t age) const {
#if defined(__CUDA_ARCH__)
    reinterpret_cast<int2*>(p)[idx] = make_int2(tag, age);
#else
    p[2 * idx] = tag;
    p[2 * idx + 1] = age;
#endif
  }
};

struct FwSplit {
  int32_t* tags;
  int32_t* age;
  CS_HD void load(int idx, int32_t& tag, int32_t& a) const {
    tag = tags[idx];
    a = age[idx];
  }
  CS_HD void store(int idx, int32_t tag, int32_t a) const {
    tags[idx] = tag;
    age[idx] = a;
  }
};

// One lane's part in one turn: its level (-1: a neutral lane, one beyond
// the turn's ways, which reads way 0 of the turn's first level and never
// wins), its way, the reduce rounds r in which it takes the value of lane
// lane + 2^r (bit r of `take`: that lane is in its segment), the level's
// geometry, the lanes of its level (`seg`), of the levels before it in the
// turn (`below`), its own bit, and where the level's row state lives.
template <class S>
struct FwSlot {
  int level;
  int way;
  uint32_t take;
  int ways;
  int rmask;
  uint32_t seg;
  uint32_t below;
  uint32_t bit;
  S st;
};

// Lane `lane`'s slot in turn j; `st[i]` is level i's row state.
template <class S>
CS_HD FwSlot<S> fw_slot(const FusedLevels& lv, const FusedTurns& ft, int j,
                        int lane, const S* st) {
  FwSlot<S> s;
  s.level = -1;
  s.way = 0;
  s.take = 0;
  s.ways = 1;
  s.rmask = 0;
  s.seg = 0;
  s.below = 0;
  s.bit = 1u << lane;
  s.st = st[0];
CS_UNROLL
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    if (j < ft.n && i == ft.first[j]) s.st = st[i];
    if (j < ft.n && i >= ft.first[j] && i < ft.first[j + 1] && lane >= ft.off[i] &&
        lane < ft.off[i] + lv.ways[i]) {
      s.level = i;
      s.way = lane - ft.off[i];
      for (int r = 0; r < 5; ++r)
        if (lane + (1 << r) < ft.off[i] + lv.ways[i]) s.take |= 1u << r;
      s.ways = lv.ways[i];
      s.rmask = lv.rmask[i];
      s.seg = fw_lanes(ft.off[i], lv.ways[i]);
      s.below = fw_lanes(0, ft.off[i]);
      s.st = st[i];
    }
  }
  return s;
}

// Index of the slot's way in its level's row state, for block b >= 0.
template <class S>
CS_HD int fw_index(const FwSlot<S>& s, int lg, int32_t b) {
  return ((b >> lg) & s.rmask) * s.ways + s.way;
}

// lru_step's key: INT32_MIN on a hit, else the age; neutral lanes never win.
template <class S>
CS_HD int32_t fw_key(const FwSlot<S>& s, int32_t tag, int32_t age, int32_t b) {
  if (s.level < 0) return CS_INT32_MAX;
  return tag == b ? CS_INT32_MIN : age;
}

// Round r of the segmented suffix-min: `other` is the value of lane
// lane + 2^r (a shuffle down by 2^r); it is taken only from inside the
// segment.  After rounds 0 .. R - 1 (fw_rounds), every lane holds the
// minimum of its own key and the keys of the lanes after it in the
// segment.  A lane whose key equals that has no smaller key after it; the
// lowest such lane is the first lane holding the segment's minimum (every
// lane before it sees that minimum after it, above its own key).
template <class S>
CS_HD int32_t fw_seg_min(int32_t mine, int32_t other, int r, const FwSlot<S>& s) {
  return ((s.take >> r) & 1u) && other < mine ? other : mine;
}

// Whether the lane writes its way: it is the lowest lane of its segment in
// `wins` (the ballot of key == minimum) and no level before its own in the
// turn hit (`hits`, the turn's ballot of tag == b).
template <class S>
CS_HD bool fw_writes(const FwSlot<S>& s, uint32_t wins, uint32_t hits) {
  const uint32_t w = wins & s.seg;
  return (w & (0u - w)) == s.bit && (hits & s.below) == 0;
}

// A lane loads the next step's (tag, age) before this step stores; where
// this step wrote (tag b, age t) at the index the next step reads, the
// loaded pair is stale and takes the written one.  Each lane reads and
// writes only its own way of each level, so no other lane's store can
// make its load stale, and the warp needs no barrier between steps.
CS_HD void fw_forward(bool wrote, int idx, int32_t b, int32_t t, int idx_next,
                      int32_t& tag_next, int32_t& age_next) {
  if (wrote && idx == idx_next) {
    tag_next = b;
    age_next = t;
  }
}

CS_HD int fw_lowest(uint32_t mask) {
#if defined(__CUDA_ARCH__)
  return __ffs(mask) - 1;
#else
  return __builtin_ctz(mask);
#endif
}

// The level of turn j that holds lane `lane`.
CS_HD int fw_level_at(const FusedTurns& ft, int j, int lane) {
  int level = ft.first[j];
CS_UNROLL
  for (int i = 1; i < CS_MAX_LEVELS; ++i)
    if (i > ft.first[j] && i < ft.first[j + 1] && lane >= ft.off[i]) level = i;
  return level;
}

// Open a level's row state: bind it and copy the carried state in (lanes
// lane, lane + 32, ...).  FwPairs fills `buf` (shared memory on the card);
// FwSplit walks the output rows in place, so it copies the input there.
CS_HD void fw_open(FwPairs& s, int32_t* buf, const int32_t* tin, const int32_t* ain,
                   int32_t*, int32_t*, int n, int lane) {
  s.p = buf;
  for (int c = lane; c < n; c += FW_LANES) s.store(c, tin[c], ain[c]);
}

CS_HD void fw_open(FwSplit& s, int32_t*, const int32_t* tin, const int32_t* ain,
                   int32_t* tout, int32_t* aout, int n, int lane) {
  s.tags = tout;
  s.age = aout;
  for (int c = lane; c < n; c += FW_LANES) s.store(c, tin[c], ain[c]);
}

// Close it: write the final state to the output rows (FwSplit is there).
CS_HD void fw_close(const FwPairs& s, int32_t* tout, int32_t* aout, int n, int lane) {
  for (int c = lane; c < n; c += FW_LANES) s.load(c, tout[c], aout[c]);
}

CS_HD void fw_close(const FwSplit&, int32_t*, int32_t*, int, int) {}
