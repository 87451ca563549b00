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
// fa_scale_q in flash_attn_step.h).
//
// What bounds it on an H100: operations.  At zamba2-1.2b's prefill (B 4,
// S 4096, 32 heads, hd 64, causal) the call does ~275 GFLOP against 268 MB
// of q, k, v and out, far above the card's ~295 operations per byte.  This
// first version is simple and exact rather than fast: one block of 256
// threads per (batch x head, 64 query rows); four neighbouring threads
// share a query row, each owning every fourth dimension of its scaled
// query and its float32 accumulator in registers; K and V tiles of BK rows
// are staged through shared memory as float32, the partial dot products
// are summed with two shuffles, and the online-softmax step is the
// header's.  KV tiles wholly above the causal diagonal or before the
// window are skipped.  The arithmetic runs on the CUDA cores in float32;
// moving QK^T and PV onto the tensor cores (mma / wgmma on bf16 tiles,
// TMA-fed) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn_step.h"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int TPR = 4;    // threads per query row
constexpr int THREADS = BQ * TPR;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int64_t sq,
                  int64_t skv, int h, int kvh, float scale, int is_bf16,
                  int causal, int64_t window, int64_t q_offset) {
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
  const T* qrow = q + ((b * sq + qi) * h + head) * HD;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    qp[i] = qi < sq ? fa_scale_q(to_f32(qrow[part + i * TPR]), scale, is_bf16) : 0.0f;
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
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
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
    T* orow = o + ((b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) store(orow + part + i * TPR, fa_finish(acc[i], l));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t sq, int64_t skv, int h, int kvh, float scale, int is_bf16,
           int causal, int64_t window, int64_t q_offset, cudaStream_t stream) {
  // BK * HD floats of K and V each: 32 KB of static shared memory in all
  // for every supported hd.
  constexpr int BK = HD > 64 ? 32 : 64;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attn_kernel<T, HD, BK><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, h, kvh, scale,
      is_bf16, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int64_t b, int64_t sq, int64_t skv, int h, int kvh, float scale,
                int is_bf16, int causal, int64_t window, int64_t q_offset,
                cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, h, kvh, scale, is_bf16, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, h, kvh, scale, is_bf16, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, h, kvh, scale, is_bf16, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// scale is the softmax scale already rounded to the input dtype.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int64_t b, int64_t sq, int64_t skv,
                                 int h, int kvh, int hd, int is_bf16,
                                 float scale, int causal, int64_t window,
                                 int64_t q_offset, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b * h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b, sq, skv, h, kvh, scale, 1, causal, window, q_offset, s);
  return dispatch_hd<float>(hd, q, k, v, o, b, sq, skv, h, kvh, scale, 0, causal, window, q_offset, s);
}
