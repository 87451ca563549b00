// The serial form of K6's chunk step (the formulas of
// src/repro_torch/kernels/ssd_scan/csrc/ssd_step.h): one (chunk, head) at a
// time, the running sum of dt * a added in order.  The block-per-head
// kernel ssd_scan_block_per_head.cu (the design the chunk-parallel passes
// replaced) runs these pieces on the card, and the CPU tests run
// ssd_chunk_serial through host_step_test.cpp's host_ssd_scan.
#pragma once
#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SSD_SERIAL_HD __host__ __device__ __forceinline__
#else
#define SSD_SERIAL_HD inline
#endif

// cum[t] = sum_{u<=t} dt[u] * a, added in order.
SSD_SERIAL_HD void ssd_cumsum(const float* dt, float a, int len, float* cum) {
  float c = 0.0f;
  for (int t = 0; t < len; ++t) {
    c += dt[t] * a;
    cum[t] = c;
  }
}

// exp(cum[t] - cum[s]) for s <= t, else 0 (the exponent is never taken).
SSD_SERIAL_HD float ssd_intra_decay(float cum_t, float cum_s, int t, int s) {
  return s <= t ? expf(cum_t - cum_s) : 0.0f;
}

// The weight of position s in the chunk's state update.
SSD_SERIAL_HD float ssd_state_weight(float cum_last, float cum_s, float dt_s) {
  return expf(cum_last - cum_s) * dt_s;
}

// One (chunk, head) done serially, for the host tests.  x (L x P, row
// stride x_stride), dt (L), b and c (L x N, row stride n), the state
// (P x N) updated in place, y (L x P, row stride y_stride); cum is scratch
// of L floats.
SSD_SERIAL_HD void ssd_chunk_serial(const float* x, int64_t x_stride, const float* dt,
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
