// Host harness of ssm_gate_step.h, for the CPU tests only.
//
// host_ssm_gate: every position as a block of ssm_gate.cu computes it, with
// the kernel's geometry (ssm_gate_per_thread, ssm_gate_threads): each
// thread's units in its order, each warp's xor butterfly over its 32 lanes
// (lane l's own sum first, as the kernel adds what __shfl_xor_sync gives
// it), the warps' sums in order, the scale, the outputs.  Inputs and
// outputs are float32, in the kernel's layout: row (b, s) of y / x / z at
// b * yb + s * ys (xb, xs; zb, zs) elements, d_inner dense channels; out
// dense (B, S, d_inner).  e is the unit's elements: 8 for bfloat16 data
// (the inputs hold bfloat16 values and the outputs come back rounded to
// bfloat16), 4 for float32.  The port itself never loads this build.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -I ../../csrc \
//       -o libssm_gate_host.so host_step_test.cpp
#include <vector>

#include "ssm_gate_step.h"

namespace {

template <int E>
int run(const float* y, const float* x, const float* z, const float* d, const float* w,
        float* out, int64_t yb, int64_t ys, int64_t xb, int64_t xs, int64_t zb, int64_t zs,
        int64_t bsz, int64_t s_len, int d_inner, int p, bool round) {
  const int units = d_inner / E;
  const int k = ssm_gate_per_thread(units);
  if (d_inner <= 0 || p <= 0 || d_inner % p || p % E || k == 0) return 1;
  const int threads = ssm_gate_threads(units, k);
  std::vector<float> v(d_inner), part(threads);
  float lanes[32], next[32], o[E];
  for (int64_t b = 0; b < bsz; ++b)
    for (int64_t s = 0; s < s_len; ++s) {
      const float* yr = y + b * yb + s * ys;
      const float* xr = x + b * xb + s * xs;
      const float* zr = z + b * zb + s * zs;
      for (int t = 0; t < threads; ++t) {
        float acc = 0.0f;
        for (int j = 0; j < k; ++j) {
          const int u = t + j * threads;
          if (u < units)
            acc = ssm_gate_unit<E>(yr + u * E, xr + u * E, d[ssm_gate_head(u, E, p)],
                                   zr + u * E, &v[u * E], acc);
        }
        part[t] = acc;
      }
      float total = 0.0f;
      for (int w0 = 0; w0 < threads; w0 += 32) {
        for (int l = 0; l < 32; ++l) lanes[l] = part[w0 + l];
        for (int off = 16; off > 0; off >>= 1) {
          for (int l = 0; l < 32; ++l) next[l] = sg_add(lanes[l], lanes[l ^ off]);
          for (int l = 0; l < 32; ++l) lanes[l] = next[l];
        }
        total = sg_add(total, lanes[0]);
      }
      const float r = ssm_gate_scale(total, d_inner);
      float* orow = out + (b * s_len + s) * d_inner;
      for (int u = 0; u < units; ++u) {
        ssm_gate_out<E>(&v[u * E], r, w + u * E, o);
        for (int e = 0; e < E; ++e) orow[u * E + e] = round ? tc_round_bf16(o[e]) : o[e];
      }
    }
  return 0;
}

}  // namespace

extern "C" int host_ssm_gate(const float* y, const float* x, const float* z, const float* d,
                             const float* w, float* out, int64_t yb, int64_t ys, int64_t xb,
                             int64_t xs, int64_t zb, int64_t zs, int64_t bsz, int64_t s_len,
                             int d_inner, int p, int e) {
  if (e == 8)
    return run<8>(y, x, z, d, w, out, yb, ys, xb, xs, zb, zs, bsz, s_len, d_inner, p, true);
  if (e == 4)
    return run<4>(y, x, z, d, w, out, yb, ys, xb, xs, zb, zs, bsz, s_len, d_inner, p, false);
  return 1;
}
