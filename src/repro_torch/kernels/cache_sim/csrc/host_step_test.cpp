// Host driver of cache_sim_step.h, for the CPU tests only.
//
// Runs the same per-row functions the CUDA kernels run, one row after the
// other (for K1's and K2's warp kernels, their 32 lanes emulated: ballots
// as loops, shuffles as array reads), so a g++ build of this file checks the GPU's
// step logic bit for bit against the plain PyTorch versions and the JAX
// package.  The port itself never loads this build.
//
//   g++ -O2 -shared -fPIC -o libhost_step_test.so host_step_test.cpp
#include <vector>

#include "cache_sim_step.h"
#include "fused_warp_step.h"

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

// lru_hits.cu's kernel for one warp, its 32 lanes emulated: 32 / G rows
// from `row0`, each walked by a group of G lanes with one way a lane; the
// shuffles read the source lane's registers, the ballots OR the lanes'
// bits, and the xor-shuffle min rounds are the group's minimum (min is
// exact in any order).  Loads, hit words and stores as the kernel's.
static void host_lru_group_warp(const int32_t* blocks, const int64_t* offsets, int rows,
                                int ways, int g, int64_t row0, const int32_t* tags_in,
                                const int32_t* age_in, int32_t* tags_out, int32_t* age_out,
                                uint8_t* hits) {
  const int batch = 4 * g;
  int64_t lo[32], hi[32];
  bool real[32];
  int32_t tag[32], age[32], cur[32][4], nxt[32][4];
  int batches = 0;
  for (int lane = 0; lane < 32; ++lane) {
    const int grp = lane / g, way = lane % g;
    const int64_t row = row0 + grp;
    const bool has = row < rows;
    lo[lane] = has ? offsets[row] : 0;
    hi[lane] = has ? offsets[row + 1] : 0;
    real[lane] = has && way < ways;
    tag[lane] = real[lane] ? tags_in[row * ways + way] : -2;
    age[lane] = real[lane] ? age_in[row * ways + way] : CS_INT32_MAX;
    const int nb = lru_batches(lo[lane], hi[lane], g);
    batches = nb > batches ? nb : batches;
    lru_load4(blocks, lru_batch_base(lo[lane], g) + 4 * way, hi[lane], cur[lane]);
  }
  for (int k = 0; k < batches; ++k) {
    uint32_t word[32] = {0};
    for (int lane = 0; lane < 32; ++lane)
      lru_load4(blocks, lru_batch_base(lo[lane], g) + (int64_t)(k + 1) * batch + 4 * (lane % g),
                hi[lane], nxt[lane]);
    for (int j = 0; j < batch; ++j)
      for (int grp = 0; grp < 32 / g; ++grp) {
        const int l0 = grp * g;
        const int32_t b = cur[l0 + j / 4][j & 3];  // __shfl_sync from lane j / 4 of the group
        const int64_t i = lru_batch_base(lo[l0], g) + (int64_t)k * batch + j;
        bool hit = false;
        int32_t key[32], m = CS_INT32_MAX;
        for (int w = 0; w < g; ++w) {
          hit = hit || (real[l0 + w] && tag[l0 + w] == b);
          key[w] = lru_lane_key(real[l0 + w], tag[l0 + w], age[l0 + w], b);
          m = key[w] < m ? key[w] : m;
        }
        uint32_t wins = 0;
        for (int w = 0; w < g; ++w)
          if (key[w] == m) wins |= 1u << w;
        for (int w = 0; w < g; ++w) {
          const int lane = l0 + w;
          if (i >= lo[lane] && i < hi[lane] && b >= 0 && lru_lane_touched(wins, w)) {
            tag[lane] = b;
            age[lane] = (int32_t)(i - lo[lane] + 1);
          }
          if (w == j / 4) word[lane] |= (uint32_t)hit << (8 * (j & 3));
        }
      }
    for (int lane = 0; lane < 32; ++lane) {
      lru_store_word(hits, lru_batch_base(lo[lane], g) + (int64_t)k * batch + 4 * (lane % g),
                     lo[lane], hi[lane], word[lane]);
      for (int e = 0; e < 4; ++e) cur[lane][e] = nxt[lane][e];
    }
  }
  for (int lane = 0; lane < 32; ++lane)
    if (real[lane]) {
      const int64_t row = row0 + lane / g;
      tags_out[row * ways + lane % g] = tag[lane];
      age_out[row * ways + lane % g] = age[lane];
    }
}

extern "C" int host_lru_hits_group(const int32_t* blocks, const int64_t* offsets, int rows,
                                   int ways, const int32_t* tags_in, const int32_t* age_in,
                                   int32_t* tags_out, int32_t* age_out, uint8_t* hits) {
  if (ways < 1 || ways > CS_MAX_WAYS) return 1;
  const int g = lru_group_lanes(ways);
  for (int64_t row0 = 0; row0 < rows; row0 += 32 / g)
    host_lru_group_warp(blocks, offsets, rows, ways, g, row0, tags_in, age_in, tags_out, age_out,
                        hits);
  return 0;
}

static int fill_levels(FusedLevels* lv, int k, int lg, const int* rmask,
                       const int* ways, const int* lanes, int32_t* const* tags,
                       int32_t* const* age) {
  if (k < 1 || k > CS_MAX_LEVELS) return 1;
  lv->k = k;
  lv->lg = lg;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    const bool on = i < k;
    if (on && (ways[i] < 1 || ways[i] > CS_MAX_WAYS)) return 1;
    lv->rmask[i] = on ? rmask[i] : 0;
    lv->ways[i] = on ? ways[i] : 1;
    lv->lanes[i] = on ? lanes[i] : 0;
    lv->tags[i] = on ? tags[i] : nullptr;
    lv->age[i] = on ? age[i] : nullptr;
  }
  return 0;
}

extern "C" int host_fused_levels(const int32_t* blocks, const int64_t* offsets,
                                 int rows, int k, int lg, const int* rmask,
                                 const int* ways, const int* lanes,
                                 int32_t* const* tags, int32_t* const* age,
                                 int8_t* lvl) {
  FusedLevels lv;
  if (fill_levels(&lv, k, lg, rmask, ways, lanes, tags, age)) return 1;
  for (int64_t row = 0; row < rows; ++row)
    fused_row(lv, row, blocks, offsets[row], offsets[row + 1], lvl);
  return 0;
}

// Lane `lane`'s view of one step: its state index and the (tag, age) it
// loaded there, per turn.
struct HostLoads {
  int idx[FW_LANES][CS_MAX_LEVELS];
  int32_t tag[FW_LANES][CS_MAX_LEVELS];
  int32_t age[FW_LANES][CS_MAX_LEVELS];
};

template <class S>
static void host_fw_load(FwSlot<S> (*sl)[CS_MAX_LEVELS], int lg, int32_t b, HostLoads& ld) {
  for (int lane = 0; lane < FW_LANES; ++lane)
    for (int j = 0; j < CS_MAX_LEVELS; ++j) {
      ld.idx[lane][j] = fw_index(sl[lane][j], lg, b);
      sl[lane][j].st.load(ld.idx[lane][j], ld.tag[lane][j], ld.age[lane][j]);
    }
}

// fused_levels.cu's fw_step for 32 emulated lanes: each collective is a
// loop over the lanes (a ballot ORs their bits, a shuffle reads another
// lane's value from the round before).
template <class S>
static int host_fw_step(FwSlot<S> (*sl)[CS_MAX_LEVELS], const FusedLevels& lv,
                        const FusedTurns& ft, int32_t b, const HostLoads& ld,
                        int32_t t, uint32_t* wrote) {
  const int k = lv.k;
  if (b < 0) return k;
  for (int j = 0; j < ft.n; ++j) {
    int32_t key[FW_LANES], m[FW_LANES];
    uint32_t hits = 0, wins = 0;
    for (int lane = 0; lane < FW_LANES; ++lane) {
      if (ld.tag[lane][j] == b) hits |= 1u << lane;
      key[lane] = m[lane] = fw_key(sl[lane][j], ld.tag[lane][j], ld.age[lane][j], b);
    }
    hits &= ft.mask[j];
    for (int r = 0; r < fw_rounds(lv); ++r) {  // __shfl_down_sync by 2^r
      int32_t m2[FW_LANES];
      for (int lane = 0; lane < FW_LANES; ++lane) {
        const int32_t other = lane + (1 << r) < FW_LANES ? m[lane + (1 << r)] : m[lane];
        m2[lane] = fw_seg_min(m[lane], other, r, sl[lane][j]);
      }
      for (int lane = 0; lane < FW_LANES; ++lane) m[lane] = m2[lane];
    }
    for (int lane = 0; lane < FW_LANES; ++lane)
      if (key[lane] == m[lane]) wins |= 1u << lane;
    for (int lane = 0; lane < FW_LANES; ++lane)
      if (fw_writes(sl[lane][j], wins, hits)) {
        sl[lane][j].st.store(ld.idx[lane][j], b, t);
        wrote[lane] |= 1u << j;
      }
    if (hits) return fw_level_at(ft, j, fw_lowest(hits));
  }
  return k;
}

// fused_levels_warp_kernel for one row, its 32 lanes emulated: the next
// step's loads happen before this step's stores, then fw_forward.
template <class S>
static void host_fw_row(const FusedLevels& lv, const FusedLevels& src,
                        const FusedTurns& ft, int64_t row, const int32_t* blocks,
                        const int64_t* offsets, int8_t* lvl, int32_t* buf) {
  S st[CS_MAX_LEVELS];
  int used = 0;
  for (int i = 0; i < lv.k; ++i) {
    const int64_t r0 = row * lv.lanes[i];
    for (int lane = 0; lane < FW_LANES; ++lane)
      fw_open(st[i], buf + 2 * used, src.tags[i] + r0, src.age[i] + r0,
              lv.tags[i] + r0, lv.age[i] + r0, lv.lanes[i], lane);
    used += lv.lanes[i];
  }
  for (int i = lv.k; i < CS_MAX_LEVELS; ++i) st[i] = st[0];
  FwSlot<S> sl[FW_LANES][CS_MAX_LEVELS];
  for (int lane = 0; lane < FW_LANES; ++lane)
    for (int j = 0; j < CS_MAX_LEVELS; ++j) sl[lane][j] = fw_slot(lv, ft, j, lane, st);
  const int64_t lo = offsets[row], hi = offsets[row + 1];
  static HostLoads ld, next;
  int32_t cur[FW_LANES], nxt[FW_LANES];  // one coalesced load of 32 block ids each
  for (int lane = 0; lane < FW_LANES; ++lane) cur[lane] = lo + lane < hi ? blocks[lo + lane] : -1;
  int32_t b = cur[0];
  host_fw_load(sl, lv.lg, b, ld);
  for (int64_t base = lo; base < hi; base += FW_LANES) {
    for (int lane = 0; lane < FW_LANES; ++lane)
      nxt[lane] = base + FW_LANES + lane < hi ? blocks[base + FW_LANES + lane] : -1;
    const int m = hi - base < FW_LANES ? (int)(hi - base) : FW_LANES;
    for (int s = 0; s < m; ++s) {
      const int32_t bn = (s + 1 < FW_LANES ? cur : nxt)[(s + 1) & 31];
      host_fw_load(sl, lv.lg, bn, next);
      const int32_t t = (int32_t)(base - lo + s + 1);
      uint32_t wrote[FW_LANES] = {0};
      lvl[base + s] = (int8_t)host_fw_step(sl, lv, ft, b, ld, t, wrote);
      for (int lane = 0; lane < FW_LANES; ++lane)
        for (int j = 0; j < CS_MAX_LEVELS; ++j)
          fw_forward((wrote[lane] >> j) & 1u, ld.idx[lane][j], b, t, next.idx[lane][j],
                     next.tag[lane][j], next.age[lane][j]);
      ld = next;
      b = bn;
    }
    for (int lane = 0; lane < FW_LANES; ++lane) cur[lane] = nxt[lane];
  }
  for (int i = 0; i < lv.k; ++i) {
    const int64_t r0 = row * lv.lanes[i];
    for (int lane = 0; lane < FW_LANES; ++lane)
      fw_close(st[i], lv.tags[i] + r0, lv.age[i] + r0, lv.lanes[i], lane);
  }
}

// The warp kernel of fused_levels.cu, emulated: `shared` 1 keeps each row's
// state as (tag, age) pairs in a scratch buffer (the shared-memory route),
// 0 walks the output rows in place (the global-memory route).
extern "C" int host_fused_levels_warp(const int32_t* blocks, const int64_t* offsets,
                                      int rows, int k, int lg, const int* rmask,
                                      const int* ways, const int* lanes,
                                      int32_t* const* tags_in, int32_t* const* age_in,
                                      int32_t* const* tags_out, int32_t* const* age_out,
                                      int shared, int8_t* lvl) {
  FusedLevels lv, src;
  if (fill_levels(&lv, k, lg, rmask, ways, lanes, tags_out, age_out) ||
      fill_levels(&src, k, lg, rmask, ways, lanes, tags_in, age_in))
    return 1;
  const FusedTurns ft = fw_turns(lv);
  int64_t pairs = 0;
  for (int i = 0; i < k; ++i) pairs += lanes[i];
  std::vector<int32_t> buf(2 * pairs + 2);
  for (int64_t row = 0; row < rows; ++row) {
    if (shared)
      host_fw_row<FwPairs>(lv, src, ft, row, blocks, offsets, lvl, buf.data());
    else
      host_fw_row<FwSplit>(lv, src, ft, row, blocks, offsets, lvl, buf.data());
  }
  return 0;
}

// fw_turns for the tests: turn count, first level of each turn, lane offset
// of each level (k + 1 + k ints into `out`).
extern "C" int host_fused_turns(int k, const int* ways, int* out) {
  FusedLevels lv;
  lv.k = k;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) lv.ways[i] = i < k ? ways[i] : 1;
  const FusedTurns ft = fw_turns(lv);
  out[0] = ft.n;
  for (int j = 0; j < k; ++j) out[1 + j] = ft.first[j];
  for (int i = 0; i < k; ++i) out[1 + k + i] = ft.off[i];
  return 0;
}
