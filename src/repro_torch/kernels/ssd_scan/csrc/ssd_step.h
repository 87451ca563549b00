// Steps of the K6 SSD chunk scan (ssd_scan.cu), shared by the CUDA kernels
// and by the CPU tests, which compile this header with g++ through
// host_step_test.cpp.  The serial form of the chunk step below (one
// (chunk, head) at a time, the design these passes replaced) is
// tools/kernel_variants_csrc/ssd_serial_step.h.
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

#include "tc_frag.h"

#if defined(__CUDACC__)
#define SSD_HD __host__ __device__ __forceinline__
#else
#define SSD_HD inline
struct float4 {
  float x, y, z, w;
};
#endif

// ------------------------------------------------------------------------
// The chunk-parallel tensor-core kernels (ssd_scan.cu) split the chunk
// step into three passes:
//
//   A (ssd_state_kernel):   per (batch, chunk, head) the running sum cum of
//                           dt * a, cum[L-1], and the chunk's own state
//                           dS = sum_s x[s] w[s] B[s]^T, w[s] =
//                           exp(cum[L-1] - cum[s]) dt[s], held as dS^T
//                           (N x P);
//   B (ssd_carry_kernel):   per (batch, head) S_c = exp(cum_c[L-1]) S_{c-1}
//                           + dS_c over the chunks: each chunk's starting
//                           state S_{c-1}^T in place of its dS^T, and the
//                           final state;
//   C (ssd_output_kernel):  per (batch, chunk, query tile, group of heads)
//                           C.B^T once, then for each head
//                           y[t] = exp(cum[t]) C[t].S_{c-1}
//                                + sum_{s<=t} G[t][s] x[s],
//                           G[t][s] = (C[t].B[s]) exp(cum[t] - cum[s]) dt[s].
//
// The products run on mma.sync.m16n8k16 (tc_frag.h), whose operands are
// bfloat16.  A float32 operand goes in as a sum of bf16 parts
// (tc_split_parts): G, w B and S always, in 2 parts on the bfloat16 route
// (whose x, B and C are exact) and in SSD_F32_PARTS on the float32 route,
// where x, B and C are split too.  A product of an a-part operand and a
// b-part one takes the pairs of parts (i, j) with i + j < max(a, b)
// (ssd_pair_used): 2 on the bfloat16 route, 6 with 3 parts a side.  Two
// parts a side (hi hi + hi lo + lo hi) hold a product to about 2^-16,
// which at N = 128 misses float32's rtol 2e-4 (the CPU tests show it);
// three hold it to about 2^-24.

#ifndef SSD_F32_PARTS
#define SSD_F32_PARTS 3
#endif

// Threads of a block of the three passes.
#define SSD_THREADS 128
#define SSD_WARPS (SSD_THREADS / 32)

// exp(x) through the card's ex2.approx (exp2f on the host).
SSD_HD float ssd_exp(float x) { return tc_exp2(x * TC_LOG2E); }

// bf16 parts of a split operand (G, w B, S): 2 on the bfloat16 route, whose
// inputs are one part, and SSD_F32_PARTS on the float32 route.
SSD_HD int ssd_op_parts(int is_bf16) { return is_bf16 ? 2 : SSD_F32_PARTS; }

// Whether a product of an a-part and a b-part operand takes parts (i, j).
SSD_HD bool ssd_pair_used(int i, int j, int a_parts, int b_parts) {
  return i + j < (a_parts > b_parts ? a_parts : b_parts);
}

// Padded chunk length: a chunk of at most 64 rounds up to whole 16-row mma
// tiles; longer chunks are multiples of 64 already.
SSD_HD int ssd_lpad(int chunk) { return chunk <= 64 ? (chunk + 15) / 16 * 16 : chunk; }

// Rows of a ring stage (s-tile): 64 for bfloat16 inputs, 32 for float32
// (whose tiles hold SSD_F32_PARTS planes), or the padded chunk if shorter;
// always a divisor of the padded chunk.
SSD_HD int ssd_stile(int lpad, int parts) {
  const int cap = parts == 1 ? 64 : 32;
  return lpad <= cap ? lpad : lpad % cap == 0 ? cap : 16;
}

// Rows of pass C's query tile, a divisor of the padded chunk: at most 64
// (bfloat16) or 32 (float32), and fewer for long chunks, so that the
// tile's C.B^T (rows x lpad float32) stays within 64 KB of shared memory.
SSD_HD int ssd_qrows(int lpad, int parts) {
  if (parts == 1) return lpad <= 64 ? lpad : lpad <= 256 ? 64 : lpad <= 512 ? 32 : 16;
  return lpad <= 32 ? lpad : (lpad % 32 == 0 && lpad <= 256) ? 32 : 16;
}

// Positions of the block-wide running sum that each of SSD_THREADS
// threads adds up in order.
SSD_HD int ssd_scan_per_thread(int lpad) { return (lpad + SSD_THREADS - 1) / SSD_THREADS; }

// One round of a warp's inclusive scan (Hillis-Steele): `other` is the
// value of lane lane - offset (__shfl_up_sync), taken where that lane
// exists.  The running sum of dt * a is added in double (as PyTorch's
// float32 cumsum on the CPU accumulates): with cum near -200 at the end of
// a long chunk, one float32 ulp of cum is already 1.5e-5 of every decay
// taken from it.
SSD_HD double ssd_scan_round(double mine, double other, int lane, int offset) {
  return lane >= offset ? other + mine : mine;
}

// Pass A writes, and pass C reads, per chunk position s a float4
// (hi, lo, dt, 0): the running sum times log2(e) as a float pair,
// hi = float(c), lo = float(c - hi) (from the double sum), and dt.  2^(c_t - c_s) takes
// (hi_t - hi_s) + (lo_t - lo_s): where the two sums are close (the decays
// that matter), hi_t - hi_s is exact, so the difference carries no
// rounding of cum's magnitude; where they are far apart, the decay is
// small.
SSD_HD float ssd_decay2(float hi_t, float lo_t, float hi_s, float lo_s) {
  return tc_exp2((hi_t - hi_s) + (lo_t - lo_s));
}

// The A fragment of k-step [s0, s0 + 16) of G for the 16-row strip whose
// first row is local row `r0` of the query tile (chunk position t0 + r0):
// G[t][s] = cb[t][s] exp(cum[t] - cum[s]) dt[s] for s <= t, else 0 (the
// exponent is never taken), in K bf16 parts.  `cb` holds the tile's C.B^T
// rows (row stride cb_stride, column = chunk position s); `pos` the
// per-position float4 (hi, lo, dt) described at ssd_decay2.
//
// A lane holds rows g and g + 8 (g = lane / 4) at four columns s.  Below
// the diagonal (every s <= every t of the strip) no element is masked and
// the two rows share each column's factor: row g's decay times dt[s] is
// one exp2 per column, and row g + 8's is that times 2^(c_{g+8} - c_g)
// (at most 1, one exp2 per k-step), so a k-step takes 5 exp2 instead of 8.
// On the diagonal's k-step each element is masked and taken on its own.
template <int K>
SSD_HD void ssd_g_fragment(int lane, const float* cb, int cb_stride, int r0, int t0, int s0,
                           const float4* pos, uint32_t a[K][4]) {
  const int rg = r0 + lane / 4, tg = t0 + rg;
  const float4 pg = pos[tg], p8 = pos[tg + 8];
  float v[8];
  if (s0 + 15 <= t0 + r0) {
    const float r8 = ssd_decay2(p8.x, p8.y, pg.x, pg.y);
    TC_UNROLL for (int cb2 = 0; cb2 < 2; ++cb2)  // columns 2t, 2t + 1, then 2t + 8, 2t + 9
      TC_UNROLL for (int e = 0; e < 2; ++e) {
        const int s = s0 + 2 * (lane % 4) + 8 * cb2 + e;
        const float4 ps = pos[s];
        const float ed = ssd_decay2(pg.x, pg.y, ps.x, ps.y) * ps.z;
        v[4 * cb2 + e] = cb[rg * cb_stride + s] * ed;                 // row g
        v[4 * cb2 + 2 + e] = cb[(rg + 8) * cb_stride + s] * (ed * r8);  // row g + 8
      }
  } else {
    TC_UNROLL for (int i = 0; i < 8; ++i) {
      const int r = r0 + tc_a_row(lane, i), t = t0 + r, s = s0 + tc_a_col(lane, i);
      const float4 pt = pos[t], ps = pos[s];
      v[i] = s <= t ? cb[r * cb_stride + s] * ssd_decay2(pt.x, pt.y, ps.x, ps.y) * ps.z : 0.0f;
    }
  }
  TC_UNROLL for (int j = 0; j < 4; ++j) {
    uint32_t part[K];
    tc_split_parts<K>(v[2 * j], v[2 * j + 1], part);
    TC_UNROLL for (int k = 0; k < K; ++k) a[k][j] = part[k];
  }
}

// The A fragment of k-step [s0, s0 + 16) of (w B)^T (rows n, columns s),
// in K bf16 parts, from the ldmatrix.trans registers of the KB planes of
// the B tile (rows s, columns n): each element is the sum of its planes
// times w[s].
template <int KB, int K>
SSD_HD void ssd_wb_fragment(int lane, const uint32_t b[KB][4], int s0, const float* w,
                            uint32_t a[K][4]) {
  TC_UNROLL for (int j = 0; j < 4; ++j) {
    float v0 = 0.0f, v1 = 0.0f;
    TC_UNROLL for (int q = 0; q < KB; ++q) {
      v0 += tc_unpack_lo(b[q][j]);
      v1 += tc_unpack_hi(b[q][j]);
    }
    const int s = s0 + tc_a_col(lane, 2 * j);
    uint32_t part[K];
    tc_split_parts<K>(v0 * w[s], v1 * w[s + 1], part);
    TC_UNROLL for (int k = 0; k < K; ++k) a[k][j] = part[k];
  }
}

SSD_HD int ssd_round128(int64_t bytes) { return (int)((bytes + 127) / 128 * 128); }

// Byte offsets of pass A's shared memory: the ring of x and B tiles, the
// state weights w and the scan's warp sums.
struct SsdStateSmem {
  int ring_stage, x_tile, w, wsum, total;
  SSD_HD SsdStateSmem(int p, int n, int np, int lpad) {
    const int stile = ssd_stile(lpad, np);
    x_tile = np * stile * p * 2;
    ring_stage = ssd_round128(x_tile + np * stile * n * 2);
    w = 2 * ring_stage;
    wsum = w + ssd_round128(lpad * 4);
    total = wsum + SSD_WARPS * 8;
  }
};

// Byte offsets of pass C's shared memory: the tile's C.B^T rows (float32,
// row stride lpad + 4), its C rows, the ring (B tiles, then x tiles), the
// planes of S^T and two buffers of per-position float4s (ssd_decay2; this
// head's and the next one's).
struct SsdOutputSmem {
  int cb, cb_stride, cs, ring, ring_stage, ss, pos, pos_stage, total;
  SSD_HD SsdOutputSmem(int p, int n, int np, int sp, int lpad) {
    const int qr = ssd_qrows(lpad, np), stile = ssd_stile(lpad, np);
    cb_stride = lpad + 4;
    cb = 0;
    cs = ssd_round128((int64_t)qr * cb_stride * 4);
    ring = cs + ssd_round128(np * qr * n * 2);
    ring_stage = ssd_round128(np * stile * (p > n ? p : n) * 2);
    ss = ring + 2 * ring_stage;
    pos = ss + ssd_round128(sp * n * p * 2);
    pos_stage = ssd_round128(lpad * 16);
    total = pos + 2 * pos_stage;
  }
};

// Pass B's step on one element of the state: S' = S exp(cum[L-1]) + dS.
SSD_HD float ssd_carry(float s, float seg, float ds) { return s * seg + ds; }
