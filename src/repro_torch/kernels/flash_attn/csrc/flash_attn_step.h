// Steps of the K5 flash attention kernels (flash_attn.cu), shared by the
// CUDA kernels and by the CPU tests, which compile this header with g++
// through host_step_test.cpp.
//
// The float32 route's per-row step comes first; the bfloat16 tensor-core
// route's fragment maps, swizzle, masks and softmax step follow below.
//
// One query row's online softmax over one KV tile: the masked scores of the
// tile, the new running max, the rescale of the running sum and of the
// float32 accumulator, and the accumulation of the tile's values.  A row's
// dimensions may be split over several threads (`d0`, `dstep`, `nd`: the
// thread owns dimensions d0, d0 + dstep, ...); on the host one "thread"
// owns them all.  Masked scores are -1e30, as in blocked_attention and the
// Pallas kernel, so a tile that is wholly masked for a row contributes
// exp(0) terms that the next real tile's rescale exp(m_prev - m_new)
// wipes out exactly.
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

// This thread's part of the dot product of a scaled query row with one
// key row: sum over d = d0 + i * dstep, i < nd.
FA_HD float fa_partial_dot(const float* q_part, const float* k_row, int d0,
                           int dstep, int nd) {
  float s = 0.0f;
  for (int i = 0; i < nd; ++i) s += q_part[i] * k_row[d0 + i * dstep];
  return s;
}

// One row's online-softmax update over a tile of `n` scores `s` (already
// masked to FA_NEG_INF) and the tile's value rows (`v_tile`, row stride
// `v_stride`): m, l and this thread's accumulator part are updated in
// place.  `s` is overwritten with the probabilities.
FA_HD void fa_online_update(float* s, int n, const float* v_tile, int v_stride,
                            int d0, int dstep, int nd, float* m, float* l,
                            float* acc_part) {
  float m_new = *m;
  for (int j = 0; j < n; ++j) m_new = s[j] > m_new ? s[j] : m_new;
  const float corr = expf(*m - m_new);
  float psum = 0.0f;
  for (int j = 0; j < n; ++j) {
    s[j] = expf(s[j] - m_new);
    psum += s[j];
  }
  *l = *l * corr + psum;
  for (int i = 0; i < nd; ++i) {
    float a = acc_part[i] * corr;
    const int d = d0 + i * dstep;
    for (int j = 0; j < n; ++j) a += s[j] * v_tile[j * v_stride + d];
    acc_part[i] = a;
  }
  *m = m_new;
}

// The output of a row: acc / max(l, 1e-30).
FA_HD float fa_finish(float acc, float l) { return acc / (l > 1e-30f ? l : 1e-30f); }

// ------------------------------------------------------------------------
// The bfloat16 route: one warp owns strips of 16 query rows and runs
// mma.sync.m16n8k16 (bf16 inputs, float32 accumulators) on fragments that
// ldmatrix brings from shared memory; the fragment maps, the swizzle, the
// ldmatrix addresses and the bf16 split are tc_frag.h's.

// 16-row strips a warp owns in the bfloat16 kernel (4 warps a block): two
// at hd <= 64, so that every K and V fragment from shared memory serves
// two mma, and one at hd 128, where two would not fit the registers.
#define FA_TC_STRIPS(hd) ((hd) <= 64 ? 2 : 1)

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
