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
// float32, on the CUDA cores (flash_attn_f32_kernel).  On the tensor cores
// float32 would mean TF32, which cannot hold float32's rtol 1e-4, so this
// route stays scalar: one block of 256 threads per (batch x head, 64 query
// rows); four neighbouring threads share a query row, each owning every
// fourth dimension of its scaled query and its float32 accumulator in
// registers; K and V tiles are staged through shared memory as float32,
// the partial dot products are summed with two shuffles, and the
// online-softmax step is the header's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn_step.h"

namespace {

// ------------------------------------------------------------------ float32

constexpr int BQ = 64;    // query rows per block
constexpr int TPR = 4;    // threads per query row
constexpr int THREADS = BQ * TPR;

template <int HD, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int64_t sq,
                      int64_t skv, int h, int kvh, float scale, int causal,
                      int64_t window, int64_t q_offset) {
  constexpr int ND = HD / TPR;
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HD];
  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / h, head = bh % h;
  const int64_t kv_head = head / (h / kvh);
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t qi = q0 + row;

  float qp[ND], acc[ND];
  const float* qrow = q + ((b * sq + qi) * h + head) * HD;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    qp[i] = qi < sq ? fa_scale_q(qrow[part + i * TPR], scale, 0) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = FA_NEG_INF, l = 0.0f;

  int64_t t_lo, t_hi;
  fa_kv_tiles(q0, BQ, q_offset, skv, causal, window, BK, &t_lo, &t_hi);
  const int64_t qpos = q_offset + qi;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int64_t kpos = t * BK + j;
      float kx = 0.0f, vx = 0.0f;
      if (kpos < skv) {
        const int64_t off = ((b * skv + kpos) * kvh + kv_head) * HD + d;
        kx = k[off];
        vx = v[off];
      }
      ks[idx] = kx;
      vs[idx] = vx;
    }
    __syncthreads();
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = fa_partial_dot(qp, ks + j * HD, part, TPR, ND);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s[j] = fa_allowed(qpos, t * BK + j, skv, causal, window) ? p : FA_NEG_INF;
    }
    fa_online_update(s, BK, vs, HD, part, TPR, ND, &m, &l, acc);
  }
  if (qi < sq) {
    float* orow = o + ((b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) orow[part + i * TPR] = fa_finish(acc[i], l);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int64_t b,
               int64_t sq, int64_t skv, int h, int kvh, float scale, int causal,
               int64_t window, int64_t q_offset, cudaStream_t stream) {
  // BK * HD floats of K and V each: 32 KB of static shared memory in all
  // for every supported hd.
  constexpr int BK = HD > 64 ? 32 : 64;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attn_f32_kernel<HD, BK><<<grid, THREADS, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv, h, kvh, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

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

}  // namespace

// scale is the softmax scale already rounded to the input dtype.  bfloat16
// inputs take the tensor-core route, float32 inputs the scalar one; every
// bfloat16 pointer must be 16-byte aligned.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int64_t b, int64_t sq, int64_t skv,
                                 int h, int kvh, int hd, int is_bf16,
                                 float scale, int causal, int64_t window,
                                 int64_t q_offset, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b * h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
      return (int)cudaErrorMisalignedAddress;
    switch (hd) {
      case 32: return launch_tc<32>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      case 64: return launch_tc<64>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      case 128: return launch_tc<128>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    case 64: return launch_f32<64>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    case 128: return launch_f32<128>(q, k, v, o, b, sq, skv, h, kvh, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
