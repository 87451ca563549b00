// Step of the K6 SSD chunk scan (ssd_scan.cu), shared by the CUDA kernel
// and by the CPU tests, which compile this header with g++ through
// host_step_test.cpp.
//
// Within one chunk of length L of one (batch, head), with cum the running
// sum of dt * a over the chunk:
//
//   y[t]  = sum_{s<=t} (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] x[s]   (intra)
//         + exp(cum[t]) C[t].S                                        (state)
//   S'    = S exp(cum[L-1]) + sum_s x[s] (exp(cum[L-1] - cum[s]) dt[s]) B[s]
//
// as in repro/models/ssm.py::ssd_chunked, except that the intra-chunk
// decay is masked BEFORE the exponent: exp(cum[t] - cum[s]) is computed
// only where s <= t and is 0 elsewhere.  ssd_chunked takes the exponent of
// every (t, s) and masks afterwards; for s > t the exponent is positive,
// overflows to inf at long chunks (zamba2's 256) and inf * 0 gives NaN.
// Wherever the reference is finite the two agree.
#pragma once
#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SSD_HD __host__ __device__ __forceinline__
#else
#define SSD_HD inline
#endif

// cum[t] = sum_{u<=t} dt[u] * a, added in order.
SSD_HD void ssd_cumsum(const float* dt, float a, int len, float* cum) {
  float c = 0.0f;
  for (int t = 0; t < len; ++t) {
    c += dt[t] * a;
    cum[t] = c;
  }
}

// exp(cum[t] - cum[s]) for s <= t, else 0 (the exponent is never taken).
SSD_HD float ssd_intra_decay(float cum_t, float cum_s, int t, int s) {
  return s <= t ? expf(cum_t - cum_s) : 0.0f;
}

// The weight of position s in the chunk's state update.
SSD_HD float ssd_state_weight(float cum_last, float cum_s, float dt_s) {
  return expf(cum_last - cum_s) * dt_s;
}

// One (chunk, head) done serially, for the host tests.  x (L x P, row
// stride x_stride), dt (L), b and c (L x N, row stride n), the state
// (P x N) updated in place, y (L x P, row stride y_stride); cum is scratch
// of L floats.
SSD_HD void ssd_chunk_serial(const float* x, int64_t x_stride, const float* dt,
                             float a, const float* b, const float* c, int len,
                             int p, int n, float* state, float* y,
                             int64_t y_stride, float* cum) {
  ssd_cumsum(dt, a, len, cum);
  for (int t = 0; t < len; ++t)
    for (int pi = 0; pi < p; ++pi) {
      float y_state = 0.0f;
      for (int ni = 0; ni < n; ++ni) y_state += c[t * n + ni] * state[pi * n + ni];
      y_state *= expf(cum[t]);
      float y_intra = 0.0f;
      for (int s = 0; s <= t; ++s) {
        float cb = 0.0f;
        for (int ni = 0; ni < n; ++ni) cb += c[t * n + ni] * b[s * n + ni];
        y_intra += cb * ssd_intra_decay(cum[t], cum[s], t, s) * (x[s * x_stride + pi] * dt[s]);
      }
      y[t * y_stride + pi] = y_intra + y_state;
    }
  const float last = cum[len - 1];
  const float seg = expf(last);
  for (int pi = 0; pi < p; ++pi)
    for (int ni = 0; ni < n; ++ni) {
      float upd = 0.0f;
      for (int s = 0; s < len; ++s)
        upd += x[s * x_stride + pi] * ssd_state_weight(last, cum[s], dt[s]) * b[s * n + ni];
      state[pi * n + ni] = state[pi * n + ni] * seg + upd;
    }
}
