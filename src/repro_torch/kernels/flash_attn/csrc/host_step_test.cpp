// Host harness of flash_attn_step.h, for the CPU tests only.
//
// Walks the same (batch x head, 64-row query block, KV tile) structure as
// flash_attn.cu, with the same tile skipping, and runs the header's
// per-row functions with one "thread" owning all of a row's dimensions, so
// a g++ build of this file checks the GPU's step logic against the plain
// PyTorch version and the JAX package.  Inputs are float32 (bfloat16 values
// when is_bf16); the output is the float32 value before the cast to the
// input dtype.  The port itself never loads this build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libflash_attn_host.so host_step_test.cpp
#include <vector>

#include "flash_attn_step.h"

extern "C" int host_flash_attn(const float* q, const float* k, const float* v,
                               float* o, int64_t b, int64_t sq, int64_t skv,
                               int h, int kvh, int hd, int is_bf16, float scale,
                               int causal, int64_t window, int64_t q_offset,
                               int bk) {
  if (kvh <= 0 || h % kvh != 0 || bk <= 0) return 1;
  const int64_t bq = 64;
  std::vector<float> qp(hd), acc(hd), s(bk), ks(bk * hd), vs(bk * hd);
  for (int64_t bi = 0; bi < b; ++bi)
    for (int head = 0; head < h; ++head) {
      const int kv_head = head / (h / kvh);
      for (int64_t q0 = 0; q0 < sq; q0 += bq) {
        int64_t t_lo, t_hi;
        fa_kv_tiles(q0, bq, q_offset, skv, causal, window, bk, &t_lo, &t_hi);
        for (int64_t qi = q0; qi < q0 + bq && qi < sq; ++qi) {
          const float* qrow = q + ((bi * sq + qi) * h + head) * hd;
          for (int d = 0; d < hd; ++d) {
            qp[d] = fa_scale_q(qrow[d], scale, is_bf16);
            acc[d] = 0.0f;
          }
          float m = FA_NEG_INF, l = 0.0f;
          for (int64_t t = t_lo; t < t_hi; ++t) {
            for (int j = 0; j < bk; ++j) {
              const int64_t kpos = t * bk + j;
              for (int d = 0; d < hd; ++d) {
                const bool in = kpos < skv;
                const int64_t off = ((bi * skv + kpos) * kvh + kv_head) * hd + d;
                ks[j * hd + d] = in ? k[off] : 0.0f;
                vs[j * hd + d] = in ? v[off] : 0.0f;
              }
              const float p = fa_partial_dot(qp.data(), &ks[j * hd], 0, 1, hd);
              s[j] = fa_allowed(q_offset + qi, kpos, skv, causal, window) ? p : FA_NEG_INF;
            }
            fa_online_update(s.data(), bk, vs.data(), hd, 0, 1, hd, &m, &l, acc.data());
          }
          float* orow = o + ((bi * sq + qi) * h + head) * hd;
          for (int d = 0; d < hd; ++d) orow[d] = fa_finish(acc[d], l);
        }
      }
    }
  return 0;
}
