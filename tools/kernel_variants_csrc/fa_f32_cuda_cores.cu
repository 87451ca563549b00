// K5's float32 route on the CUDA cores, two designs that
// tools/kernel_variants.py k5f32 times beside the tensor-core kernel of
// src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu (same arguments as
// its flash_attn_launch, float32 only):
//
// fa_f32_scalar_launch: the design the tensor-core route replaced (the
//   port's float32 kernel until then).  One block of 256 threads per
//   (batch x head, 64 query rows); four neighbouring threads share a
//   query row, each owning every fourth dimension of its scaled query and
//   its float32 accumulator in registers; K and V tiles are loaded into
//   shared memory, synchronously, then read for every FMA; the partial dot
//   products are summed with two shuffles, and each row's online-softmax
//   step is fa_online_update below.
//
// fa_f32_blocked_launch: register-blocked.  One block of 256 threads (16 x
//   16) per (batch x head, 64 query rows); thread (ty, tx) computes the 4 x
//   4 scores of rows 4 ty .. 4 ty + 3 and keys tx + 16 j from float4 loads
//   of Q and K (16 FMAs for two 16-byte loads), the row maxima and sums
//   over the 16 threads of a half-warp by shuffles, P stored transposed to
//   shared memory, and then its rows' outputs at dimensions tx + 16 u from
//   a float4 of P and a float of V per key.  K and V come through a
//   two-stage cp.async ring of 64-key tiles, tile t + 1 landing while tile
//   t is computed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn_step.h"

namespace {

// ------------------------------------------------------------------ scalar

// This thread's part of the dot product of a scaled query row with one
// key row: sum over d = d0 + i * dstep, i < nd.
__device__ __forceinline__ float fa_partial_dot(const float* q_part, const float* k_row,
                                                int d0, int dstep, int nd) {
  float s = 0.0f;
  for (int i = 0; i < nd; ++i) s += q_part[i] * k_row[d0 + i * dstep];
  return s;
}

// One row's online-softmax update over a tile of `n` scores `s` (already
// masked to FA_NEG_INF) and the tile's value rows (`v_tile`, row stride
// `v_stride`): m, l and this thread's accumulator part are updated in
// place.  `s` is overwritten with the probabilities.
__device__ __forceinline__ void fa_online_update(float* s, int n, const float* v_tile,
                                                 int v_stride, int d0, int dstep, int nd,
                                                 float* m, float* l, float* acc_part) {
  float m_new = *m;
  for (int j = 0; j < n; ++j) m_new = s[j] > m_new ? s[j] : m_new;
  const float corr = expf(*m - m_new);
  float psum = 0.0f;
  for (int j = 0; j < n; ++j) {
    s[j] = expf(s[j] - m_new);
    psum += s[j];
  }
  *l = *l * corr + psum;
  for (int i = 0; i < nd; ++i) {
    float a = acc_part[i] * corr;
    const int d = d0 + i * dstep;
    for (int j = 0; j < n; ++j) a += s[j] * v_tile[j * v_stride + d];
    acc_part[i] = a;
  }
  *m = m_new;
}

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
int launch_scalar(const float* q, const float* k, const float* v, float* o, int64_t b,
                  int64_t sq, int64_t skv, int h, int kvh, float scale, int causal,
                  int64_t window, int64_t q_offset, cudaStream_t stream) {
  // BK * HD floats of K and V each: 32 KB of static shared memory in all.
  constexpr int BK = HD > 64 ? 32 : 64;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attn_f32_kernel<HD, BK><<<grid, THREADS, 0, stream>>>(q, k, v, o, sq, skv, h, kvh,
                                                              scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- register-blocked

constexpr int RB_BK = 64;  // keys a tile
constexpr int RB_THREADS = 256;

template <int HD>
struct RbSmem {
  static constexpr int ST = HD + 4;  // row stride of Q, K, V (floats)
  static constexpr int PST = BQ + 4;  // row stride of P^T
  static constexpr int STAGE = 2 * RB_BK * ST;  // K, then V
  static constexpr int BYTES = (BQ * ST + 2 * STAGE + RB_BK * PST) * 4;
};

template <int HD>
__device__ __forceinline__ void rb_load_tile(float* tile, const float* base, int64_t row_stride,
                                             int64_t pos0, int64_t limit) {
  constexpr int CPR = HD / 4, ST = RbSmem<HD>::ST;
  for (int idx = threadIdx.x; idx < RB_BK * CPR; idx += RB_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool valid = pos0 + r < limit;
    cp_async_16(smem_u32(tile + r * ST + c * 4),
                base + (valid ? (pos0 + r) * row_stride : 0) + c * 4, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(RB_THREADS)
flash_attn_f32_blocked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o, int64_t sq,
                              int64_t skv, int h, int kvh, float scale, int causal,
                              int64_t window, int64_t q_offset) {
  using L = RbSmem<HD>;
  constexpr int ST = L::ST, PST = L::PST, ND = HD / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ring = qs + BQ * ST;
  float* pt = ring + 2 * L::STAGE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / h, head = bh % h;
  const int64_t kv_head = head / (h / kvh);
  const int64_t q0 = fa_tile_order(blockIdx.x, gridDim.x) * BQ;
  const int64_t kv_stride = (int64_t)kvh * HD;
  const float* kbase = k + (b * skv * kvh + kv_head) * HD;
  const float* vbase = v + (b * skv * kvh + kv_head) * HD;

  int64_t t_lo, t_hi;
  fa_kv_tiles(q0, BQ, q_offset, skv, causal, window, RB_BK, &t_lo, &t_hi);
  if (t_lo < t_hi) {
    rb_load_tile<HD>(ring, kbase, kv_stride, t_lo * RB_BK, skv);
    rb_load_tile<HD>(ring + RB_BK * ST, vbase, kv_stride, t_lo * RB_BK, skv);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BQ * HD; idx += RB_THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int64_t qi = q0 + r;
    qs[r * ST + d] = qi < sq ? fa_scale_q(q[((b * sq + qi) * h + head) * HD + d], scale, 0) : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[4][ND], m[4], lpart[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    lpart[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < ND; ++u) acc[i][u] = 0.0f;
  }
  const int64_t qpos0 = q_offset + q0;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t > t_lo) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (t + 1 < t_hi) {
      float* next = ring + (stage ^ 1) * L::STAGE;
      rb_load_tile<HD>(next, kbase, kv_stride, (t + 1) * RB_BK, skv);
      rb_load_tile<HD>(next + RB_BK * ST, vbase, kv_stride, (t + 1) * RB_BK, skv);
    }
    cp_async_commit();
    const float* ks = ring + stage * L::STAGE;
    const float* vs = ks + RB_BK * ST;

    float s[4][4] = {};
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ST + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ST + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
    const int64_t kpos0 = t * RB_BK;
    if (fa_tile_needs_mask(qpos0, BQ, kpos0, RB_BK, skv, causal, window))
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!fa_allowed(qpos0 + 4 * ty + i, kpos0 + tx + 16 * j, skv, causal, window))
            s[i][j] = FA_NEG_INF;
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int x = 1; x < 16; x *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      lpart[i] = lpart[i] * corr[i] + ps;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * PST + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < ND; ++u) acc[i][u] *= corr[i];
    for (int key = 0; key < RB_BK; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pt + key * PST + 4 * ty);
#pragma unroll
      for (int u = 0; u < ND; ++u) {
        const float x = vs[key * ST + tx + 16 * u];
        acc[0][u] += p.x * x;
        acc[1][u] += p.y * x;
        acc[2][u] += p.z * x;
        acc[3][u] += p.w * x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lpart[i];
#pragma unroll
    for (int x = 1; x < 16; x *= 2) l += __shfl_xor_sync(0xffffffffu, l, x);
    const int64_t qi = q0 + 4 * ty + i;
    if (qi < sq)
#pragma unroll
      for (int u = 0; u < ND; ++u)
        o[((b * sq + qi) * h + head) * HD + tx + 16 * u] = fa_finish(acc[i][u], l);
  }
}

template <int HD>
int launch_blocked(const float* q, const float* k, const float* v, float* o, int64_t b,
                   int64_t sq, int64_t skv, int h, int kvh, float scale, int causal,
                   int64_t window, int64_t q_offset, cudaStream_t stream) {
  constexpr int SMEM = RbSmem<HD>::BYTES;
  static bool attr_set = false;
  if (SMEM > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_f32_blocked_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attn_f32_blocked_kernel<HD><<<grid, RB_THREADS, SMEM, stream>>>(
      q, k, v, o, sq, skv, h, kvh, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

#define FA_F32_ENTRY(name, launch)                                                              \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, int64_t b,          \
                      int64_t sq, int64_t skv, int h, int kvh, int hd, int is_bf16,           \
                      float scale, int causal, int64_t window, int64_t q_offset,               \
                      void* stream) {                                                          \
    if (b <= 0 || sq <= 0 || h <= 0) return 0;                                                 \
    if (is_bf16 || kvh <= 0 || h % kvh != 0 || b * h > 65535) return (int)cudaErrorInvalidValue; \
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)                      \
      return (int)cudaErrorMisalignedAddress;                                                  \
    const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;           \
    float* fo = (float*)o;                                                                     \
    cudaStream_t s = (cudaStream_t)stream;                                                     \
    switch (hd) {                                                                              \
      case 32: return launch<32>(fq, fk, fv, fo, b, sq, skv, h, kvh, scale, causal, window, q_offset, s); \
      case 64: return launch<64>(fq, fk, fv, fo, b, sq, skv, h, kvh, scale, causal, window, q_offset, s); \
      case 128: return launch<128>(fq, fk, fv, fo, b, sq, skv, h, kvh, scale, causal, window, q_offset, s); \
      default: return (int)cudaErrorInvalidValue;                                              \
    }                                                                                          \
  }

FA_F32_ENTRY(fa_f32_scalar_launch, launch_scalar)
FA_F32_ENTRY(fa_f32_blocked_launch, launch_blocked)
