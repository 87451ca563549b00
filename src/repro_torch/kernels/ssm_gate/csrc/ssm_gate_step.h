// Steps of the Mamba2 block's gate (ssm_gate.cu), shared by the CUDA kernel
// and by the CPU tests, which compile this header with g++ through
// host_step_test.cpp.
//
// For one row (one position) of d_inner = H * P channels, with the scan's
// output y, the block's input projection x (the same channels) and z (the
// gate), the D skip d (H,) and the norm's weight w (d_inner,):
//
//   v[c] = (y[c] + x[c] * d[c / P]) * silu(z[c]),  silu(z) = z / (1 + exp(-z))
//   r    = 1 / sqrt(sum_c v[c]^2 / d_inner + eps)
//   o[c] = rnd((v[c] * r) * w[c])
//
// in float32, in the order of the plain PyTorch chain
// (kernels/ssm_gate/ssm_gate.py::ssm_gate_plain): each product and sum
// rounded on its own (no fused multiply-add: the plain ops round each), rnd
// the one rounding to the output's dtype.  Only the order of the sum of
// squares is the kernel's: a row is split into units of 16 bytes of its
// dtype (E elements: 8 bfloat16, 4 float32), thread t of a block of T owns
// units t, t + T, ... (at most SSM_GATE_MAX_K of them) and sums their
// squares in that order; each warp adds its 32 sums by the xor butterfly
// (at distance 16, 8, 4, 2, 1, each lane its own sum first), then every
// thread adds the warps' sums in order.
#pragma once
#include <math.h>
#include <stdint.h>

#include "tc_frag.h"

#if defined(__CUDACC__)
#define SG_HD __host__ __device__ __forceinline__
#define SG_UNROLL _Pragma("unroll")
#else
#define SG_HD inline
#define SG_UNROLL
#endif

#define SSM_GATE_EPS 1e-6f
#define SSM_GATE_THREADS 256  // most threads a block (a row)
#define SSM_GATE_MAX_K 4      // most units a thread

// a * b and a + b rounded on their own: never contracted into an FMA.
SG_HD float sg_mul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

SG_HD float sg_add(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// torch.nn.functional.silu's formula (its CPU and CUDA kernels both).
SG_HD float sg_silu(float z) { return z / (1.0f + expf(-z)); }

// Units a thread: the least power of two K with K * SSM_GATE_THREADS >=
// units; 0 where a row has more units than SSM_GATE_MAX_K a thread.
SG_HD int ssm_gate_per_thread(int units) {
  int k = 1;
  while (k * SSM_GATE_THREADS < units) k *= 2;
  return k > SSM_GATE_MAX_K ? 0 : k;
}

// Threads a block: enough warps for `units` at `k` units a thread.
SG_HD int ssm_gate_threads(int units, int k) { return ((units + k - 1) / k + 31) / 32 * 32; }

// The head of unit u (E elements a unit, P a multiple of E channels a head).
SG_HD int ssm_gate_head(int u, int e, int p) { return u * e / p; }

// One unit's gated values v and its squares added, in order, to acc.
template <int E>
SG_HD float ssm_gate_unit(const float* y, const float* x, float d, const float* z, float* v,
                          float acc) {
  SG_UNROLL
  for (int e = 0; e < E; ++e) {
    v[e] = sg_mul(sg_add(y[e], sg_mul(x[e], d)), sg_silu(z[e]));
    acc = sg_add(acc, sg_mul(v[e], v[e]));
  }
  return acc;
}

// The row's scale r from its sum of squares over n channels.
SG_HD float ssm_gate_scale(float sumsq, int n) {
  return 1.0f / sqrtf(sg_add(sumsq / (float)n, SSM_GATE_EPS));
}

// One unit's outputs before the rounding to the output's dtype.
template <int E>
SG_HD void ssm_gate_out(const float* v, float r, const float* w, float* o) {
  SG_UNROLL
  for (int e = 0; e < E; ++e) o[e] = sg_mul(sg_mul(v[e], r), w[e]);
}
