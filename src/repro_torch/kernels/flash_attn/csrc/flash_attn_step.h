// Per-row step of the K5 flash attention kernel (flash_attn.cu), shared by
// the CUDA kernel and by the CPU tests, which compile this header with g++
// through host_step_test.cpp.
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

#if defined(__CUDACC__)
#define FA_HD __host__ __device__ __forceinline__
#else
#define FA_HD inline
#endif

#define FA_NEG_INF (-1e30f)

// Round a float to the nearest bfloat16 (ties to even), kept as a float.
FA_HD float fa_round_bf16(float x) {
  uint32_t u;
#if defined(__CUDA_ARCH__)
  u = __float_as_uint(x);
#else
  memcpy(&u, &x, 4);
#endif
  if ((u & 0x7f800000u) == 0x7f800000u) return x;  // inf / nan
  u += 0x7fffu + ((u >> 16) & 1u);
  u &= 0xffff0000u;
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  memcpy(&x, &u, 4);
  return x;
#endif
}

// blocked_attention's query scaling: `(q * scale)` in the input dtype, then
// float32.  For bfloat16 inputs the scale is rounded to bfloat16 first (the
// caller passes it rounded) and so is the product.  The Pallas kernel
// instead scales after the float32 cast; the two agree when the scale is a
// power of two (hd = 64) and differ by a rounding for hd = 32 and 128.
FA_HD float fa_scale_q(float q, float scale, int is_bf16) {
  const float v = q * scale;
  return is_bf16 ? fa_round_bf16(v) : v;
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
