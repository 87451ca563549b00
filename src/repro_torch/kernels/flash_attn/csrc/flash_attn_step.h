// Steps of the K5 flash attention kernels (flash_attn.cu), shared by the
// CUDA kernels and by the CPU tests, which compile this header with g++
// through host_step_test.cpp.
//
// Both routes run on the tensor cores: one warp owns strips of 16 query
// rows and runs mma.sync.m16n8k16 (bf16 inputs, float32 accumulators);
// the fragment maps, the swizzle, the ldmatrix addresses and the bf16
// splits are tc_frag.h's.  The masks, the tile skipping and the online
// softmax on fragments are shared; the bfloat16 route's strips and P
// split, then the float32 route's tiles and three-part split follow.
// Masked scores are -1e30, as in blocked_attention and the Pallas kernel,
// so a tile that is wholly masked for a row contributes exp(0) terms that
// the next real tile's rescale exp(m_prev - m_new) wipes out exactly.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tc_frag.h"

#if defined(__CUDACC__)
#define FA_HD __host__ __device__ __forceinline__
#define FA_UNROLL _Pragma("unroll")
#else
#define FA_HD inline
#define FA_UNROLL
#endif

#define FA_NEG_INF (-1e30f)

// blocked_attention's query scaling: `(q * scale)` in the input dtype, then
// float32.  For bfloat16 inputs the scale is rounded to bfloat16 first (the
// caller passes it rounded) and so is the product.  The Pallas kernel
// instead scales after the float32 cast; the two agree when the scale is a
// power of two (hd = 64) and differ by a rounding for hd = 32 and 128.
FA_HD float fa_scale_q(float q, float scale, int is_bf16) {
  const float v = q * scale;
  return is_bf16 ? tc_round_bf16(v) : v;
}

// Whether query position qpos may attend to key position kpos.
FA_HD bool fa_allowed(int64_t qpos, int64_t kpos, int64_t skv, int causal,
                      int64_t window) {
  if (kpos >= skv) return false;
  if (causal && kpos > qpos) return false;
  if (window > 0 && kpos <= qpos - window) return false;
  return true;
}

// The KV tiles [*t_lo, *t_hi) that a block of query rows
// [q0, q0 + bq) (positions q_offset + q0 ...) must visit: tiles wholly
// above the causal diagonal or wholly before the window of the block's
// first row are skipped.  Skipping is exact (see the header comment).
FA_HD void fa_kv_tiles(int64_t q0, int64_t bq, int64_t q_offset, int64_t skv,
                       int causal, int64_t window, int64_t bk, int64_t* t_lo,
                       int64_t* t_hi) {
  int64_t k_end = skv;
  if (causal) {
    const int64_t last = q_offset + q0 + bq;  // one past the last row's key
    k_end = last < k_end ? last : k_end;
  }
  int64_t k_begin = 0;
  if (window > 0) {
    const int64_t first = q_offset + q0 - window + 1;
    k_begin = first > 0 ? first : 0;
  }
  if (k_end < 0) k_end = 0;
  *t_lo = k_begin / bk;
  *t_hi = (k_end + bk - 1) / bk;
  if (*t_hi < *t_lo) *t_hi = *t_lo;
}

// The output of a row: acc / max(l, 1e-30).
FA_HD float fa_finish(float acc, float l) { return acc / (l > 1e-30f ? l : 1e-30f); }

// ------------------------------------------------------------------------
// The tensor-core routes.

// Whether a tile of query positions [qpos0, qpos0 + nq) against key
// positions [kpos0, kpos0 + nk) needs the mask: false only if fa_allowed
// holds for every pair of the tile.
FA_HD bool fa_tile_needs_mask(int64_t qpos0, int64_t nq, int64_t kpos0, int64_t nk,
                              int64_t skv, int causal, int64_t window) {
  if (kpos0 + nk > skv) return true;
  if (causal && kpos0 + nk - 1 > qpos0) return true;
  if (window > 0 && kpos0 <= qpos0 + nq - 1 - window) return true;
  return false;
}

// The query tile that block i of n takes: longest first, so the tiles
// that reach the causal diagonal's far end do not start last.
FA_HD int64_t fa_tile_order(int64_t i, int64_t n) { return n - 1 - i; }

// Mask one strip's score fragments (nt n-tiles of 4 accumulators): lane
// `lane` holds rows `qpos_row0` + tc_c_row and keys `kpos0` + 8 n +
// tc_c_col.
template <int NT>
FA_HD void fa_frag_mask(float* s, int lane, int64_t qpos_row0, int64_t kpos0,
                        int64_t skv, int causal, int64_t window) {
  FA_UNROLL for (int n = 0; n < NT; ++n)
    FA_UNROLL for (int i = 0; i < 4; ++i)
      if (!fa_allowed(qpos_row0 + tc_c_row(lane, i), kpos0 + 8 * n + tc_c_col(lane, i), skv,
                      causal, window))
        s[4 * n + i] = FA_NEG_INF;
}

// This lane's maxima of its two rows (g and g + 8) over a strip's scores.
template <int NT>
FA_HD void fa_frag_rowmax(const float* s, float mx[2]) {
  mx[0] = mx[1] = FA_NEG_INF;
  FA_UNROLL for (int n = 0; n < NT; ++n)
    FA_UNROLL for (int i = 0; i < 4; ++i) {
      const float x = s[4 * n + i];
      mx[i / 2] = x > mx[i / 2] ? x : mx[i / 2];
    }
}

// The online-softmax step of a strip once `mx` holds each row's maximum
// over the 4 lanes that share it: the new running max, the rescale `corr`
// of the accumulator and of this lane's partial sum `lpart`, and the
// scores replaced by p = exp(s - m_new) in float32, taken as
// 2^((s - m_new) log2(e)).  The difference comes first: s log2(e) -
// m_new log2(e), which the compiler fuses into one fma, is not 0 where
// s = m_new = -1e30 (a row whose scores so far are all masked), and 2 to
// its power is inf.  `lpart` sums this lane's p; the 4 lanes'
// parts are added at the end.
template <int NT>
FA_HD void fa_frag_update(float* s, float m[2], const float mx[2], float lpart[2],
                          float corr[2]) {
  float m_new[2];
  FA_UNROLL for (int r = 0; r < 2; ++r) {
    m_new[r] = mx[r] > m[r] ? mx[r] : m[r];
    corr[r] = tc_exp2((m[r] - m_new[r]) * TC_LOG2E);
  }
  float ps[2] = {0.0f, 0.0f};
  FA_UNROLL for (int n = 0; n < NT; ++n)
    FA_UNROLL for (int i = 0; i < 4; ++i) {
      const float p = tc_exp2((s[4 * n + i] - m_new[i / 2]) * TC_LOG2E);
      s[4 * n + i] = p;
      ps[i / 2] += p;
    }
  FA_UNROLL for (int r = 0; r < 2; ++r) {
    lpart[r] = lpart[r] * corr[r] + ps[r];
    m[r] = m_new[r];
  }
}

// ------------------------------------------------------------------------
// The bfloat16 route (flash_attn_tc_kernel).

// 16-row strips a warp owns in the bfloat16 kernel (4 warps a block): two
// at hd <= 64, so that every K and V fragment from shared memory serves
// two mma, and one at hd 128, where two would not fit the registers.
#define FA_TC_STRIPS(hd) ((hd) <= 64 ? 2 : 1)

// The A fragment (registers a0..a3) of P's key k-step j, straight from
// the accumulators of key n-tiles 2 j (`c0`) and 2 j + 1 (`c1`), split
// into bf16 parts: a0 = c0[0..1], a1 = c0[2..3], a2 = c1[0..1],
// a3 = c1[2..3].
FA_HD void fa_p_fragments(const float* c0, const float* c1, uint32_t a_hi[4],
                          uint32_t a_lo[4]) {
  tc_split_pack(c0[0], c0[1], &a_hi[0], &a_lo[0]);
  tc_split_pack(c0[2], c0[3], &a_hi[1], &a_lo[1]);
  tc_split_pack(c1[0], c1[1], &a_hi[2], &a_lo[2]);
  tc_split_pack(c1[2], c1[3], &a_hi[3], &a_lo[3]);
}

// ------------------------------------------------------------------------
// The float32 route (flash_attn_f32tc_kernel): every float32 operand as
// FA_F32_PARTS bf16 parts (tc_split_parts), each product as the pairs of
// parts (i, j) with i + j < FA_F32_PARTS (fa_pair_used), into float32
// accumulators.  One 16-row strip a warp, 4 warps a block.

#define FA_F32_PARTS 3
// Keys a K / V tile: 32, and 64 at hd 32.  With each tile split once into
// bf16 planes, 32-key tiles keep two blocks an SM at hd 64 and ran fastest
// (tools/kernel_variants.py k5f32); at hd 32 they spill.
#ifndef FA_F32_BK
#define FA_F32_BK(hd) ((hd) <= 32 ? 64 : 32)
#endif
// Whether a warp holds its Q parts in registers for the whole block (hd
// <= 64: 12 registers a k-step) or loads them from shared memory each
// k-step (hd 128, where 96 registers of Q beside a 64-register accumulator
// would spill).
#define FA_F32_QREG(hd) ((hd) <= 64)

// Whether a product of two FA_F32_PARTS-part operands takes parts (i, j).
FA_HD bool fa_pair_used(int i, int j) { return i + j < FA_F32_PARTS; }

// P's A fragment of key k-step j (as fa_p_fragments) in FA_F32_PARTS parts:
// a[q] holds part q of a0..a3.
FA_HD void fa_p_parts(const float* c0, const float* c1, uint32_t a[FA_F32_PARTS][4]) {
  const float* src[4] = {c0, c0 + 2, c1, c1 + 2};
  FA_UNROLL for (int r = 0; r < 4; ++r) {
    uint32_t part[FA_F32_PARTS];
    tc_split_parts<FA_F32_PARTS>(src[r][0], src[r][1], part);
    FA_UNROLL for (int q = 0; q < FA_F32_PARTS; ++q) a[q][r] = part[q];
  }
}
