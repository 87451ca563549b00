// Host harness of ssd_step.h, for the CPU tests only.
//
// Walks the same (batch, head) x chunk order as ssd_scan.cu, with the same
// zero padding past S, and runs the header's serial chunk step, so a g++
// build of this file checks the scan's formulas (the masked-before-exponent
// decay, the state weights, the carried state) against the plain PyTorch
// versions and the JAX package.  Inputs and outputs are float32 in the
// model layout: x and y (B, S, H, P), dt (B, S, H), a (H), b and c
// (B, S, N), state (B, H, P, N) holding the initial state on entry and the
// final state on return.  The port itself never loads this build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libssd_host.so host_step_test.cpp
#include <vector>

#include "ssd_step.h"

extern "C" int host_ssd_scan(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* state, int64_t bsz, int64_t s_len, int h,
                             int p, int n, int chunk) {
  if (chunk <= 0) return 1;
  std::vector<float> xc(chunk * p), dtc(chunk), bc(chunk * n), cc(chunk * n),
      yc(chunk * p), cum(chunk);
  for (int64_t bi = 0; bi < bsz; ++bi)
    for (int hi = 0; hi < h; ++hi) {
      float* st = state + (bi * h + hi) * p * n;
      for (int64_t c0 = 0; c0 < s_len; c0 += chunk) {
        for (int t = 0; t < chunk; ++t) {
          const int64_t pos = c0 + t;
          const bool in = pos < s_len;
          dtc[t] = in ? dt[(bi * s_len + pos) * h + hi] : 0.0f;
          for (int pi = 0; pi < p; ++pi)
            xc[t * p + pi] = in ? x[((bi * s_len + pos) * h + hi) * p + pi] : 0.0f;
          for (int ni = 0; ni < n; ++ni) {
            bc[t * n + ni] = in ? b[(bi * s_len + pos) * n + ni] : 0.0f;
            cc[t * n + ni] = in ? c[(bi * s_len + pos) * n + ni] : 0.0f;
          }
        }
        ssd_chunk_serial(xc.data(), p, dtc.data(), a[hi], bc.data(), cc.data(),
                         chunk, p, n, st, yc.data(), p, cum.data());
        for (int t = 0; t < chunk && c0 + t < s_len; ++t)
          for (int pi = 0; pi < p; ++pi)
            y[((bi * s_len + c0 + t) * h + hi) * p + pi] = yc[t * p + pi];
      }
    }
  return 0;
}
