// K2: fused L1 -> L2 -> LLC demand pass, one warp per (stream, group) row.
//
// Replaces repro/kernels/cache_sim/fused_sim.py::fused_levels_pallas
// (_fused_tile_kernel) and the lax.scan machine memsim/fused.py::_fused_scan
// it mirrors.
//
// With G = min(sets) groups, a group owns R_i = sets_i / G whole sets at
// every level, so one warp can carry a group through the whole hierarchy.
// Input is the group-sorted, run-collapsed stream (collapse stays on the
// host, as on the TPU) plus per-row offsets, row = stream * G + group, and
// the rows' launch order (longest first).  The output is the int8 hit
// level and the rows' final raw per-level states.
//
// What bounds it on an H100: the dependent chain of steps of the longest
// row, not bytes or operations (under the paper's hierarchy B's longest row
// has 121,004 steps).  So the design shortens a step:
//   - one warp per row, a block each, so rows spread over all SMs, longest
//     first when there are more rows than fit at once;
//   - the row's state (tags and ages of every level, 8.5 KB under the
//     paper's hierarchy) copied into dynamic shared memory at the start and
//     written back at the end; a row whose state exceeds the block's shared
//     memory walks the output tensors in global memory instead (the same
//     step, the state's place a template parameter);
//   - every level's ways looked up at once, the warp's lanes split among
//     them (fused_warp_step.h): one load a lane, two ballots and log2 of
//     the widest level's ways shuffles a step, where one thread per row
//     made up to three dependent rounds of 16 loads each;
//   - the next step's block and state loaded before this step stores, a
//     way this step writes forwarded in registers (fw_forward), so the loads
//     leave the chain; each lane reads and writes only its own ways, so no
//     barrier is needed between steps;
//   - the reduce rounds and the number of turns compile-time constants (one
//     instantiation each), so a step has no loop or dead turn;
//   - block ids read 32 at a time by one coalesced load (the next 32
//     prefetched) and broadcast by shuffle; hit levels stored 32 at a time.
#include <cuda_runtime.h>

#include "cache_sim_step.h"
#include "fused_warp_step.h"

// H100: the most dynamic shared memory a block may opt in to (227 KB).
#define FW_SMEM_MAX 232448

// One step of the warp: access b at position t of the row.  idx[j], tag[j]
// and age[j] are the lane's state index in turn j and the (tag, age) there,
// loaded ahead of the step.  Sets bit j of `wrote` where the lane wrote its
// way in turn j.  Returns the hit level (k: every level missed, or a pad),
// the same in every lane.
template <class S, int R, int NT>
__device__ __forceinline__ int fw_step(const FwSlot<S> (&sl)[CS_MAX_LEVELS],
                                       const FusedTurns& ft, int k, int32_t b,
                                       const int (&idx)[CS_MAX_LEVELS],
                                       const int32_t (&tag)[CS_MAX_LEVELS],
                                       const int32_t (&age)[CS_MAX_LEVELS], int32_t t,
                                       uint32_t& wrote) {
  if (b < 0) return k;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const FwSlot<S>& s = sl[j];
    const uint32_t hits = __ballot_sync(FW_FULL, tag[j] == b) & ft.mask[j];
    const int32_t key = fw_key(s, tag[j], age[j], b);
    int32_t m = key;
#pragma unroll
    for (int r = 0; r < R; ++r)
      m = fw_seg_min(m, __shfl_down_sync(FW_FULL, m, 1 << r), r, s);
    const uint32_t wins = __ballot_sync(FW_FULL, key == m);
    if (fw_writes(s, wins, hits)) {
      s.st.store(idx[j], b, t);
      wrote |= 1u << j;
    }
    if (hits) return fw_level_at(ft, j, fw_lowest(hits));
  }
  return k;
}

// `lv` holds the output states (and the geometry), `src` the input states;
// R = fw_rounds(lv), NT = ft.n.
template <class S, int R, int NT>
__global__ void __launch_bounds__(FW_LANES)
    fused_levels_warp_kernel(const int32_t* __restrict__ blocks,
                             const int64_t* __restrict__ offsets,
                             const int32_t* __restrict__ order, FusedLevels lv,
                             FusedLevels src, FusedTurns ft,
                             int8_t* __restrict__ lvl) {
  extern __shared__ int2 fw_smem[];
  const int lane = threadIdx.x;
  const int64_t row = order[blockIdx.x];
  S st[CS_MAX_LEVELS];
  int used = 0;  // shared-memory pairs taken by the levels before
#pragma unroll
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    if (i < lv.k) {
      const int64_t r0 = row * lv.lanes[i];
      fw_open(st[i], reinterpret_cast<int32_t*>(fw_smem + used), src.tags[i] + r0,
              src.age[i] + r0, lv.tags[i] + r0, lv.age[i] + r0, lv.lanes[i], lane);
      used += lv.lanes[i];
    } else {
      st[i] = st[0];
    }
  }
  FwSlot<S> sl[CS_MAX_LEVELS];
#pragma unroll
  for (int j = 0; j < CS_MAX_LEVELS; ++j) sl[j] = fw_slot(lv, ft, j, lane, st);
  __syncwarp();  // the state copied in before any lane reads another's copy

  const int64_t lo = offsets[row], hi = offsets[row + 1];
  int32_t cur = lo + lane < hi ? blocks[lo + lane] : -1;
  int32_t b = __shfl_sync(FW_FULL, cur, 0);
  int idx[CS_MAX_LEVELS];
  int32_t tag[CS_MAX_LEVELS], age[CS_MAX_LEVELS];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    idx[j] = fw_index(sl[j], lv.lg, b);
    sl[j].st.load(idx[j], tag[j], age[j]);
  }
  for (int64_t base = lo; base < hi; base += FW_LANES) {
    const int64_t next = base + FW_LANES;
    const int32_t nxt = next + lane < hi ? blocks[next + lane] : -1;
    const int m = hi - base < FW_LANES ? (int)(hi - base) : FW_LANES;
    int mine = 0;
    for (int s = 0; s < m; ++s) {
      // the next step's block and state, loaded before this step stores:
      // the loads leave this step's chain, and a way this step writes is
      // forwarded from registers (fw_forward)
      const int32_t bn = __shfl_sync(FW_FULL, s + 1 < FW_LANES ? cur : nxt, (s + 1) & 31);
      int idxn[CS_MAX_LEVELS];
      int32_t tagn[CS_MAX_LEVELS], agen[CS_MAX_LEVELS];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        idxn[j] = fw_index(sl[j], lv.lg, bn);
        sl[j].st.load(idxn[j], tagn[j], agen[j]);
      }
      const int32_t t = (int32_t)(base - lo + s + 1);
      uint32_t wrote = 0;
      const int h = fw_step<S, R, NT>(sl, ft, lv.k, b, idx, tag, age, t, wrote);
      if (lane == s) mine = h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        fw_forward((wrote >> j) & 1u, idx[j], b, t, idxn[j], tagn[j], agen[j]);
        idx[j] = idxn[j];
        tag[j] = tagn[j];
        age[j] = agen[j];
      }
      b = bn;
    }
    if (base + lane < hi) lvl[base + lane] = (int8_t)mine;
    cur = nxt;
  }
  __syncwarp();  // every lane's last stores before the state is written out
#pragma unroll
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    if (i < lv.k) {
      const int64_t r0 = row * lv.lanes[i];
      fw_close(st[i], lv.tags[i] + r0, lv.age[i] + r0, lv.lanes[i], lane);
    }
  }
}

template <class S, int R, int NT>
static int launch_one(int64_t bytes, int rows, const int32_t* b, const int64_t* off,
                      const int32_t* ord, const FusedLevels& lv, const FusedLevels& src,
                      const FusedTurns& ft, void* lvl, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_levels_warp_kernel<S, R, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fused_levels_warp_kernel<S, R, NT><<<rows, FW_LANES, (size_t)bytes, s>>>(
      b, off, ord, lv, src, ft, (int8_t*)lvl);
  return (int)cudaGetLastError();
}

// One instantiation per state place, reduce rounds and number of turns.
template <int R, int NT>
static int launch_route(int shared, int64_t bytes, int rows, const int32_t* b,
                        const int64_t* off, const int32_t* ord, const FusedLevels& lv,
                        const FusedLevels& src, const FusedTurns& ft, void* lvl,
                        cudaStream_t s) {
  return shared ? launch_one<FwPairs, R, NT>(bytes, rows, b, off, ord, lv, src, ft, lvl, s)
                : launch_one<FwSplit, R, NT>(0, rows, b, off, ord, lv, src, ft, lvl, s);
}

template <int R>
static int launch_rounds(int shared, int64_t bytes, int rows, const int32_t* b,
                         const int64_t* off, const int32_t* ord, const FusedLevels& lv,
                         const FusedLevels& src, const FusedTurns& ft, void* lvl,
                         cudaStream_t s) {
  switch (ft.n) {
    case 1: return launch_route<R, 1>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 2: return launch_route<R, 2>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 3: return launch_route<R, 3>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    default: return launch_route<R, 4>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
  }
}

static int fill_levels(FusedLevels* lv, int k, int lg, const int* rmask,
                       const int* ways, const int* lanes, void* const* tags,
                       void* const* age) {
  lv->k = k;
  lv->lg = lg;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    const bool on = i < k;
    if (on && (ways[i] < 1 || ways[i] > CS_MAX_WAYS)) return 1;
    lv->rmask[i] = on ? rmask[i] : 0;
    lv->ways[i] = on ? ways[i] : 1;
    lv->lanes[i] = on ? lanes[i] : 0;
    lv->tags[i] = on ? (int32_t*)tags[i] : nullptr;
    lv->age[i] = on ? (int32_t*)age[i] : nullptr;
  }
  return 0;
}

// `order` (rows,) int32 is the launch order of the rows; `tags_in` /
// `age_in` / `tags_out` / `age_out` are host arrays of k device pointers,
// `rmask`, `ways`, `lanes` host arrays of k ints.  `shared` picks the route:
// 1 = the rows' state in shared memory (it must fit FW_SMEM_MAX), 0 = in
// the output tensors in global memory.
extern "C" int fused_levels_launch(const void* blocks, const void* offsets,
                                   const void* order, int rows, int k, int lg,
                                   const int* rmask, const int* ways,
                                   const int* lanes, void* const* tags_in,
                                   void* const* age_in, void* const* tags_out,
                                   void* const* age_out, int shared, void* lvl,
                                   void* stream) {
  if (k < 1 || k > CS_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  FusedLevels lv, src;
  if (fill_levels(&lv, k, lg, rmask, ways, lanes, tags_out, age_out) ||
      fill_levels(&src, k, lg, rmask, ways, lanes, tags_in, age_in))
    return (int)cudaErrorInvalidValue;
  const FusedTurns ft = fw_turns(lv);
  if (rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* b = (const int32_t*)blocks;
  const int64_t* off = (const int64_t*)offsets;
  const int32_t* ord = (const int32_t*)order;
  int64_t pairs = 0;
  for (int i = 0; i < k; ++i) pairs += lanes[i];
  const int64_t bytes = shared ? pairs * 8 : 0;
  if (bytes > FW_SMEM_MAX) return (int)cudaErrorInvalidValue;
  switch (fw_rounds(lv)) {
    case 0: return launch_rounds<0>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 1: return launch_rounds<1>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 2: return launch_rounds<2>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 3: return launch_rounds<3>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    case 4: return launch_rounds<4>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
    default: return launch_rounds<5>(shared, bytes, rows, b, off, ord, lv, src, ft, lvl, s);
  }
}
