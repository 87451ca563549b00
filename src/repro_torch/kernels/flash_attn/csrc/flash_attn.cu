// K5: blocked causal / sliding-window attention with an online softmax,
// CUDA for sm_90a.
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attn/flash_attn.py) and, on the model path, the
// jnp scan blocked_attention (src/repro/models/attention.py), whose layout
// and query scaling it takes: q (B, Sq, H, hd), k and v (B, Skv, KV, hd),
// float32 or bfloat16, out (B, Sq, H, hd) in q's dtype.  GQA reads kv head
// h / (H / KV) directly; nothing is repeated in memory.  m, l and the
// accumulator are float32, masked scores are -1e30, and the output is
// acc / max(l, 1e-30), as in both JAX versions.  Query scaling follows
// blocked_attention: q * scale in the input dtype, then float32 (see
// fa_scale_q in flash_attn_step.h).  KV tiles wholly above the causal
// diagonal or before the window are skipped (fa_kv_tiles).
//
// What bounds it on an H100: operations.  At zamba2-1.2b's prefill (B 4,
// S 4096, 32 heads, hd 64, causal) the call does ~275 GFLOP against 268 MB
// of q, k, v and out, far above the card's ~295 operations per byte.  The
// route is chosen by dtype alone:
//
// bfloat16, on the tensor cores (flash_attn_tc_kernel).  One block of 4
// warps per (batch x head, query tile), tiles launched longest first
// (fa_tile_order); each warp owns two strips of 16 rows at hd <= 64, so
// that each K and V fragment serves two mma, and one at hd 128, where two
// would not fit the registers (FA_TC_STRIPS).  The block's Q tile and a
// two-stage ring of 64-key K and V tiles sit in dynamic shared memory as
// bf16, XOR-swizzled (tc_swizzle) so that ldmatrix is free of bank
// conflicts; cp.async brings tile t + 1 while tile t is multiplied.  Q is
// scaled in bf16 and held in registers as mma A fragments.  S = Q K^T is
// mma.sync m16n8k16 bf16 -> float32 (bf16 products are exact in float32,
// so S differs from the plain version only in the order of its sums).  The
// softmax runs on the S fragments (row max and sum over the 4 lanes that
// share a row), and the mask only on tiles that cross the diagonal, the
// window edge or the ragged end (fa_tile_needs_mask).  P V reuses the S
// registers as A fragments, with P split into two bf16 parts, hi =
// bf16(p) and lo = bf16(p - hi), in two mma into one float32 accumulator:
// one bf16 rounding of P would cost up to 2^-9 of each term, which on rows
// whose values cancel reaches the 1e-3 tolerance against the plain
// version; hi + lo holds P to about 2^-17, for one more mma per k-step.
// l sums the float32 p.  The output is staged through shared memory and
// written with 16-byte stores.  mma.sync and cp.async rather than wgmma
// and TMA: at 1-2 ms a call the kernel is a few percent of the prefill,
// worth less than the risk of a warpgroup pipeline that cannot be compiled
// where the tests run.
//
// float32, on the tensor cores too (flash_attn_f32tc_kernel).  Bound by
// operations as well: at the float32 cross-check's (4, 512, 32, 64), causal,
// 4.3 GFLOP, 0.064 ms at the CUDA cores' float32 peak, and 25.8 GFLOP of
// bf16 products in the split below, 0.026 ms at the tensor cores' peak.  One
// bf16 product would hold float32 to 2^-9 and TF32 to 2^-11, far outside
// float32's rtol 1e-4; so every float32 operand goes in as three bf16 parts,
// x = x1 + x2 + x3 (tc_split_parts: each part the bf16 rounding of what the
// parts before left, the differences exact in float32), and each product as
// six mma of the pairs of parts whose index sum is below three (q1k1, q1k2,
// q2k1, q1k3, q2k2, q3k1), into float32 accumulators: the terms left out are
// ~2^-24 of the product, float32's own precision.  Both products are split
// so: S = Q K^T, with Q scaled in float32 as blocked_attention scales it
// (fa_scale_q) before the split, and P V with P (float32, in the S
// registers) and V.  An mma cuts its terms toward zero 25 bits below the
// largest (tools/mma_accumulation.py fits this to the card), so S's five
// smaller pairs go into accumulators of their own (mma_parts_apart),
// added to the leading pair's once a tile's k-steps are done.  One block of 4 warps per (batch x head, 64 query rows),
// one 16-row strip a warp (two strips' Q parts, scores and accumulators
// would not fit the registers), tiles launched longest first.  The Q tile is
// loaded once, scaled, split, and kept as three swizzled bf16 planes in
// shared memory; a warp holds its parts in registers at hd <= 64 and reloads
// them by ldmatrix each k-step at hd 128 (FA_F32_QREG).  K and V arrive as
// float32 through a two-stage cp.async ring of float32 tiles (32 keys, 64 at
// hd 32, FA_F32_BK); when a tile has landed, the block splits it once into
// three swizzled bf16 planes of K and of V, which the warps read by ldmatrix
// (.trans for V), as the bfloat16 route reads its tiles.  The other way,
// each warp splitting the K and V values of its own fragments as it reads
// them from the float32 tile, splits every value four times over instead of
// once; tools/kernel_variants.py k5f32 times both, and the planes with
// 64-key tiles: the planes with 32-key tiles ran fastest.  The six pair mma
// of a product go into the same two accumulators one after another.  The
// softmax, masks and tile skipping are the bfloat16 route's; p is exp2 of
// float32 scores.  The output is written as float32 pairs straight from
// the accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn_step.h"

namespace {

// ----------------------------------------------------------------- bfloat16

constexpr int TC_BK = 64;  // keys per K / V tile
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_NT = TC_BK / 8;  // key n-tiles of a strip's S

// Copy `rows` rows of hd bf16 values, starting at sequence position pos0,
// into a swizzled tile; rows at or past `limit` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int64_t row_stride, int64_t pos0, int64_t limit,
                                          int rows) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CPR; idx += TC_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool valid = pos0 + r < limit;
    const __nv_bfloat16* src = base + (valid ? (pos0 + r) * row_stride : 0) + c * 8;
    cp_async_16(smem_u32(tile + tc_smem_off(r, c * 8, HD)), src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int64_t sq, int64_t skv, int h, int kvh, float scale, int causal,
                     int64_t window, int64_t q_offset) {
  constexpr int MS = FA_TC_STRIPS(HD);  // 16-row strips a warp
  constexpr int BQ = 16 * MS * TC_WARPS;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DT = HD / 8;   // dimension n-tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + BQ * HD;  // stage s: K at 2 s, V at 2 s + 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / h, head = bh % h;
  const int64_t kv_head = head / (h / kvh);
  const int64_t q0 = fa_tile_order(blockIdx.x, gridDim.x) * BQ;
  const int64_t q_stride = (int64_t)h * HD, kv_stride = (int64_t)kvh * HD;
  const __nv_bfloat16* qbase = q + (b * sq * h + head) * HD;
  const __nv_bfloat16* kbase = k + (b * skv * kvh + kv_head) * HD;
  const __nv_bfloat16* vbase = v + (b * skv * kvh + kv_head) * HD;

  int64_t t_lo, t_hi;
  fa_kv_tiles(q0, BQ, q_offset, skv, causal, window, TC_BK, &t_lo, &t_hi);
  load_tile<HD>(qs, qbase, q_stride, q0, sq, BQ);
  if (t_lo < t_hi) {
    load_tile<HD>(kvs, kbase, kv_stride, t_lo * TC_BK, skv, TC_BK);
    load_tile<HD>(kvs + TC_BK * HD, vbase, kv_stride, t_lo * TC_BK, skv, TC_BK);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Q's A fragments, scaled in bf16 as blocked_attention scales them.
  const int row0 = warp * 16 * MS;  // this warp's first row in the tile
  uint32_t qf[MS][KS][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      int r, c;
      tc_ldm_a(lane, row0 + 16 * ms, kk, &r, &c);
      ldmatrix_x4(qf[ms][kk], smem_u32(qs + tc_smem_off(r, c, HD)));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[ms][kk][i] = tc_pack_bf16x2(fa_scale_q(tc_unpack_lo(qf[ms][kk][i]), scale, 1),
                                       fa_scale_q(tc_unpack_hi(qf[ms][kk][i]), scale, 1));
    }

  float acc[MS][DT][4];
  float m[MS][2], lpart[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ms][d][i] = 0.0f;
    m[ms][0] = m[ms][1] = FA_NEG_INF;
    lpart[ms][0] = lpart[ms][1] = 0.0f;
  }
  const int64_t qpos_warp = q_offset + q0 + row0;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t > t_lo) {
      cp_async_wait_all();  // tile t has landed ...
      __syncthreads();      // ... for every thread, and tile t - 1 is no longer read
    }
    if (t + 1 < t_hi) {
      __nv_bfloat16* next = kvs + (stage ^ 1) * 2 * TC_BK * HD;
      load_tile<HD>(next, kbase, kv_stride, (t + 1) * TC_BK, skv, TC_BK);
      load_tile<HD>(next + TC_BK * HD, vbase, kv_stride, (t + 1) * TC_BK, skv, TC_BK);
    }
    cp_async_commit();
    const __nv_bfloat16* ks = kvs + stage * 2 * TC_BK * HD;
    const __nv_bfloat16* vs = ks + TC_BK * HD;

    // S = Q K^T for this warp's strips and the tile's 64 keys; each K
    // fragment serves every strip.
    float s[MS][TC_NT * 4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int i = 0; i < TC_NT * 4; ++i) s[ms][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < TC_NT / 2; ++np) {
        int r, c;
        uint32_t kb[4];
        tc_ldm_b(lane, np, kk, &r, &c);
        ldmatrix_x4(kb, smem_u32(ks + tc_smem_off(r, c, HD)));
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          mma_bf16(s[ms] + 8 * np, qf[ms][kk], kb[0], kb[1]);
          mma_bf16(s[ms] + 8 * np + 4, qf[ms][kk], kb[2], kb[3]);
        }
      }

    // Online softmax on the fragments: each row lives on 4 lanes.
    const int64_t kpos0 = t * TC_BK;
    uint32_t a_hi[MS][TC_NT / 2][4], a_lo[MS][TC_NT / 2][4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      const int64_t qpos_strip = qpos_warp + 16 * ms;
      if (fa_tile_needs_mask(qpos_strip, 16, kpos0, TC_BK, skv, causal, window))
        fa_frag_mask<TC_NT>(s[ms], lane, qpos_strip, kpos0, skv, causal, window);
      float mx[2], corr[2];
      fa_frag_rowmax<TC_NT>(s[ms], mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      fa_frag_update<TC_NT>(s[ms], m[ms], mx, lpart[ms], corr);
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ms][d][i] *= corr[i / 2];
      // P = hi + lo in bf16, straight from the S registers
#pragma unroll
      for (int j = 0; j < TC_NT / 2; ++j)
        fa_p_fragments(s[ms] + 8 * j, s[ms] + 8 * j + 4, a_hi[ms][j], a_lo[ms][j]);
    }

    // O += P V; each V fragment serves every strip.
#pragma unroll
    for (int j = 0; j < TC_NT / 2; ++j)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        int r, c;
        uint32_t vb[4];
        tc_ldm_bt(lane, j, dp, &r, &c);
        ldmatrix_x4_trans(vb, smem_u32(vs + tc_smem_off(r, c, HD)));
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          mma_bf16(acc[ms][2 * dp], a_hi[ms][j], vb[0], vb[1]);
          mma_bf16(acc[ms][2 * dp], a_lo[ms][j], vb[0], vb[1]);
          mma_bf16(acc[ms][2 * dp + 1], a_hi[ms][j], vb[2], vb[3]);
          mma_bf16(acc[ms][2 * dp + 1], a_lo[ms][j], vb[2], vb[3]);
        }
      }
  }

  // l of each row over its 4 lanes, then O / l staged through this warp's
  // own rows of the Q tile (read by this warp only, long before).
  __syncwarp();
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = lpart[ms][r];
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * ms + tc_c_row(lane, 2 * r);
        const int col = 8 * d + tc_c_col(lane, 0);
        const float x0 = tc_round_bf16(fa_finish(acc[ms][d][2 * r], l[r]));
        const float x1 = tc_round_bf16(fa_finish(acc[ms][d][2 * r + 1], l[r]));
        *reinterpret_cast<uint32_t*>(qs + tc_smem_off(row, col, HD)) = tc_pack_bf16x2(x0, x1);
      }
  }
  __syncwarp();
  constexpr int CPR = HD / 8;
  for (int idx = lane; idx < 16 * MS * CPR; idx += 32) {
    const int r = row0 + idx / CPR, c = idx % CPR;
    const int64_t qi = q0 + r;
    if (qi < sq)
      *reinterpret_cast<uint4*>(o + ((b * sq + qi) * h + head) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(qs + tc_smem_off(r, c * 8, HD));
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
              int64_t skv, int h, int kvh, float scale, int causal, int64_t window,
              int64_t q_offset, cudaStream_t stream) {
  // Q tile + two stages of K and V: 24 KB (hd 32), 48 KB (64), 80 KB (128).
  constexpr int BQ = 16 * FA_TC_STRIPS(HD) * TC_WARPS;
  constexpr int SMEM = (BQ + 4 * TC_BK) * HD * (int)sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (SMEM > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attn_tc_kernel<HD><<<grid, TC_THREADS, SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, sq, skv, h, kvh, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------ float32

constexpr int F32_PARTS = FA_F32_PARTS;
constexpr int F32_BQ = 16 * TC_WARPS;  // one 16-row strip a warp

// Rows [0, rows) of a (rows x HD) float32 tile of row stride ST, starting
// at sequence position pos0, by cp.async; rows at or past `limit` are
// zero-filled.
template <int HD, int ST>
__device__ __forceinline__ void load_f32_tile(float* tile, const float* base, int64_t row_stride,
                                              int64_t pos0, int64_t limit, int rows) {
  constexpr int CPR = HD / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CPR; idx += TC_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool valid = pos0 + r < limit;
    const float* src = base + (valid ? (pos0 + r) * row_stride : 0) + c * 4;
    cp_async_16(smem_u32(tile + r * ST + c * 4), src, valid);
  }
}

// 8 floats as F32_PARTS bf16 parts each, stored as one 16-byte chunk in
// each of the swizzled planes (plane q at planes + q * plane).
__device__ __forceinline__ void store_parts(__nv_bfloat16* planes, int plane, int off,
                                            const float v[8]) {
  uint32_t part[4][F32_PARTS];
#pragma unroll
  for (int j = 0; j < 4; ++j) tc_split_parts<F32_PARTS>(v[2 * j], v[2 * j + 1], part[j]);
#pragma unroll
  for (int q = 0; q < F32_PARTS; ++q)
    *reinterpret_cast<uint4*>(planes + q * plane + off) =
        make_uint4(part[0][q], part[1][q], part[2][q], part[3][q]);
}

// The block's Q rows [q0, q0 + F32_BQ), scaled as blocked_attention scales
// them (fa_scale_q), into F32_PARTS swizzled bf16 planes; rows at or past
// sq are zero.
template <int HD>
__device__ __forceinline__ void load_q_parts(__nv_bfloat16* qs, const float* qbase,
                                             int64_t q_stride, int64_t q0, int64_t sq,
                                             float scale) {
  constexpr int CPR = HD / 8;
  for (int idx = threadIdx.x; idx < F32_BQ * CPR; idx += TC_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    float v[8];
    if (q0 + r < sq) {
      const float4* src = reinterpret_cast<const float4*>(qbase + (q0 + r) * q_stride + c * 8);
      const float4 u0 = src[0], u1 = src[1];
      v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
      v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fa_scale_q(v[i], scale, 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    }
    store_parts(qs, F32_BQ * HD, tc_smem_off(r, c * 8, HD), v);
  }
}

// A float32 tile of `rows` rows (row stride ST) split once into F32_PARTS
// swizzled bf16 planes of (rows x HD), read by ldmatrix as the bfloat16
// route reads its tiles.
template <int HD, int ST>
__device__ __forceinline__ void split_tile(__nv_bfloat16* planes, const float* tile, int rows) {
  constexpr int CPR = HD / 8;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += TC_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const float4* src = reinterpret_cast<const float4*>(tile + r * ST + c * 8);
    const float4 u0 = src[0], u1 = src[1];
    const float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    store_parts(planes, rows * HD, tc_smem_off(r, c * 8, HD), v);
  }
}

// The block's K and V tiles, each split once into F32_PARTS planes, for
// every thread.
template <int HD, int KST, int VST, int BK>
__device__ __forceinline__ void split_tiles(__nv_bfloat16* kp, __nv_bfloat16* vp, const float* ks,
                                            const float* vs) {
  split_tile<HD, KST>(kp, ks, BK);
  split_tile<HD, VST>(vp, vs, BK);
  __syncthreads();
}

// The parts of the K B fragments of key n-tiles 2 np, 2 np + 1 at k-step
// kk, by ldmatrix from the K planes.
template <int HD, int BK>
__device__ __forceinline__ void k_plane_parts(const __nv_bfloat16* kp, int lane, int kk, int np,
                                              uint32_t kb[F32_PARTS][4]) {
  int r, c;
  tc_ldm_b(lane, np, kk, &r, &c);
#pragma unroll
  for (int p = 0; p < F32_PARTS; ++p)
    ldmatrix_x4(kb[p], smem_u32(kp + p * BK * HD + tc_smem_off(r, c, HD)));
}

// The parts of P V's V B fragments of dimension n-tiles 2 dp, 2 dp + 1 at
// key k-step j, by ldmatrix.trans from the V planes.
template <int HD, int BK>
__device__ __forceinline__ void v_plane_parts(const __nv_bfloat16* vp, int lane, int j, int dp,
                                              uint32_t vb[F32_PARTS][4]) {
  int r, c;
  tc_ldm_bt(lane, j, dp, &r, &c);
#pragma unroll
  for (int p = 0; p < F32_PARTS; ++p)
    ldmatrix_x4_trans(vb[p], smem_u32(vp + p * BK * HD + tc_smem_off(r, c, HD)));
}

// c0 and c1 += a times the two n-tiles of b (registers 0-1 and 2-3), over
// the pairs of parts fa_pair_used takes.  (P V; S takes mma_parts_apart.)
__device__ __forceinline__ void mma_parts(float c0[4], float c1[4],
                                          const uint32_t a[F32_PARTS][4],
                                          const uint32_t b[F32_PARTS][4]) {
#pragma unroll
  for (int i = 0; i < F32_PARTS; ++i)
#pragma unroll
    for (int j = 0; j < F32_PARTS; ++j)
      if (fa_pair_used(i, j)) {
        mma_bf16(c0, a[i], b[j][0], b[j][1]);
        mma_bf16(c1, a[i], b[j][2], b[j][3]);
      }
}

// mma_parts with the pair of leading parts (0, 0) into c0 / c1 and the
// five smaller pairs into l0 / l1.  The tensor cores cut every term of an
// mma, its addend included, toward zero at 25 bits below the largest
// term's exponent (tools/mma_accumulation.py, tce_mma_fused): summed onto
// the scores, each small pair's products and the scores themselves would be
// cut at the scores' scale five more times a k-step; apart, the small
// pairs are cut at their own scale, 2^-8 of it.
__device__ __forceinline__ void mma_parts_apart(float c0[4], float c1[4], float l0[4],
                                                float l1[4], const uint32_t a[F32_PARTS][4],
                                                const uint32_t b[F32_PARTS][4]) {
#pragma unroll
  for (int i = 0; i < F32_PARTS; ++i)
#pragma unroll
    for (int j = 0; j < F32_PARTS; ++j)
      if (i + j == 0) {
        mma_bf16(c0, a[i], b[j][0], b[j][1]);
        mma_bf16(c1, a[i], b[j][2], b[j][3]);
      } else if (fa_pair_used(i, j)) {
        mma_bf16(l0, a[i], b[j][0], b[j][1]);
        mma_bf16(l1, a[i], b[j][2], b[j][3]);
      }
}

template <int HD>
struct F32Smem {
  // keys a tile, and the row strides of the float32 K and V tiles, which
  // only the split pass reads, a row at a time
  static constexpr int BK = FA_F32_BK(HD), KST = HD, VST = HD;
  static constexpr int Q = F32_PARTS * F32_BQ * HD * 2;  // bytes of the Q planes
  static constexpr int STAGE = BK * (KST + VST);        // floats of a K + V stage
  static constexpr int PLANES = 2 * F32_PARTS * BK * HD * 2;  // bytes of the K, V planes
  static constexpr int BYTES = Q + 2 * STAGE * 4 + PLANES;
};

// At most 232 registers a thread, in place of __launch_bounds__(TC_THREADS):
// under the bound, ptxas held the hd-64 kernel to 168 registers and
// spilled; 2 blocks of 128 threads at 232 still share an SM's 65,536.
template <int HD>
__global__ void __maxnreg__(232)
flash_attn_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int64_t sq,
                        int64_t skv, int h, int kvh, float scale, int causal, int64_t window,
                        int64_t q_offset) {
  using L = F32Smem<HD>;
  constexpr int BK = L::BK, KST = L::KST, VST = L::VST, P = F32_PARTS;
  constexpr int NT = BK / 8;  // key n-tiles of S
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DT = HD / 8;   // dimension n-tiles of O
  constexpr bool QREG = FA_F32_QREG(HD);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + L::Q);  // stage s: K, then V
  __nv_bfloat16* kp = reinterpret_cast<__nv_bfloat16*>(ring + 2 * L::STAGE);  // K planes
  __nv_bfloat16* vp = kp + P * BK * HD;                                         // V planes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / h, head = bh % h;
  const int64_t kv_head = head / (h / kvh);
  const int64_t q0 = fa_tile_order(blockIdx.x, gridDim.x) * F32_BQ;
  const int64_t q_stride = (int64_t)h * HD, kv_stride = (int64_t)kvh * HD;
  const float* qbase = q + (b * sq * h + head) * HD;
  const float* kbase = k + (b * skv * kvh + kv_head) * HD;
  const float* vbase = v + (b * skv * kvh + kv_head) * HD;

  int64_t t_lo, t_hi;
  fa_kv_tiles(q0, F32_BQ, q_offset, skv, causal, window, BK, &t_lo, &t_hi);
  if (t_lo < t_hi) {
    load_f32_tile<HD, KST>(ring, kbase, kv_stride, t_lo * BK, skv, BK);
    load_f32_tile<HD, VST>(ring + BK * KST, vbase, kv_stride, t_lo * BK, skv, BK);
  }
  cp_async_commit();
  load_q_parts<HD>(qs, qbase, q_stride, q0, sq, scale);  // while the first tile flies
  cp_async_wait_all();
  __syncthreads();

  const int row0 = warp * 16;
  uint32_t qf[QREG ? P : 1][QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        int r, c;
        tc_ldm_a(lane, row0, kk, &r, &c);
        ldmatrix_x4(qf[p][kk], smem_u32(qs + p * F32_BQ * HD + tc_smem_off(r, c, HD)));
      }
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.0f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, lpart[2] = {0.0f, 0.0f};
  const int64_t qpos_strip = q_offset + q0 + row0;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t > t_lo) {
      cp_async_wait_all();  // tile t has landed ...
      __syncthreads();      // ... for every thread, and tile t - 1 is no longer read
    }
    if (t + 1 < t_hi) {
      float* next = ring + (stage ^ 1) * L::STAGE;
      load_f32_tile<HD, KST>(next, kbase, kv_stride, (t + 1) * BK, skv, BK);
      load_f32_tile<HD, VST>(next + BK * KST, vbase, kv_stride, (t + 1) * BK, skv, BK);
    }
    cp_async_commit();
    const float* ks = ring + stage * L::STAGE;
    const float* vs = ks + BK * KST;
    split_tiles<HD, KST, VST, BK>(kp, vp, ks, vs);

    // S = Q K^T for this warp's strip and the tile's keys, in P x P parts,
    // two key n-tiles at a time: the leading pair into s, the others into
    // lo, added once the k-steps are done.
    float s[NT * 4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      float lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[8 * np + i] = lo[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[P][4], kb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[p][i] = qf[p][kk][i];
          } else {
            int r, c;
            tc_ldm_a(lane, row0, kk, &r, &c);
            ldmatrix_x4(qa[p], smem_u32(qs + p * F32_BQ * HD + tc_smem_off(r, c, HD)));
          }
        }
        k_plane_parts<HD, BK>(kp, lane, kk, np, kb);
        mma_parts_apart(s + 8 * np, s + 8 * np + 4, lo, lo + 4, qa, kb);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[8 * np + i] += lo[i];
    }

    // Online softmax on the fragments: each row lives on 4 lanes.
    const int64_t kpos0 = t * BK;
    if (fa_tile_needs_mask(qpos_strip, 16, kpos0, BK, skv, causal, window))
      fa_frag_mask<NT>(s, lane, qpos_strip, kpos0, skv, causal, window);
    float mx[2], corr[2];
    fa_frag_rowmax<NT>(s, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    fa_frag_update<NT>(s, m, mx, lpart, corr);
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d][i] *= corr[i / 2];

    // O += P V in P x P parts, P split from the S registers.
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t pa[P][4];
      fa_p_parts(s + 8 * j, s + 8 * j + 4, pa);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[P][4];
        v_plane_parts<HD, BK>(vp, lane, j, dp, vb);
        mma_parts(acc[2 * dp], acc[2 * dp + 1], pa, vb);
      }
    }
  }

  // l of each row over its 4 lanes, then O / l as float32 pairs.
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = lpart[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qi = q0 + row0 + tc_c_row(lane, 2 * r);
    if (qi >= sq) continue;
    float* orow = o + ((b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(orow + 8 * d + tc_c_col(lane, 0)) =
          make_float2(fa_finish(acc[d][2 * r], l[r]), fa_finish(acc[d][2 * r + 1], l[r]));
  }
}

template <int HD>
int launch_f32tc(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
                 int64_t skv, int h, int kvh, float scale, int causal, int64_t window,
                 int64_t q_offset, cudaStream_t stream) {
  // Q planes, two stages of float32 K and V and the K and V planes: 68 KB
  // (hd 32), 80 KB (64), 160 KB (128).
  constexpr int SMEM = F32Smem<HD>::BYTES;
  static bool attr_set = false;
  if (SMEM > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_f32tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)((sq + F32_BQ - 1) / F32_BQ), (unsigned)(b * h));
  flash_attn_f32tc_kernel<HD><<<grid, TC_THREADS, SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv, h, kvh, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// scale is the softmax scale already rounded to the input dtype.  bfloat16
// inputs take flash_attn_tc_kernel, float32 inputs flash_attn_f32tc_kernel;
// every pointer must be 16-byte aligned.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int64_t b, int64_t sq, int64_t skv,
                                 int h, int kvh, int hd, int is_bf16,
                                 float scale, int causal, int64_t window,
                                 int64_t q_offset, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b * h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (is_bf16) {
    switch (hd) {
      case 32: return launch_tc<32>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      case 64: return launch_tc<64>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      case 128: return launch_tc<128>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32tc<32>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    case 64: return launch_f32tc<64>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    case 128: return launch_f32tc<128>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
