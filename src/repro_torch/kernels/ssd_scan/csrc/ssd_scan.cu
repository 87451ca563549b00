// K6: Mamba2 SSD chunk scan with a carried (P, N) float32 state, CUDA for
// sm_90a.
//
// Replaces the Pallas kernel ssd_scan (src/repro/kernels/ssd_scan/
// ssd_scan.py) and, on the model path, the jnp ssd_chunked
// (src/repro/models/ssm.py), in the model's layout: x (B, S, H, P) and
// B, C (B, S, N) shared by all heads, in float32 or bfloat16; dt (B, S, H)
// and a (H,) float32; an optional float32 init_state (B, H, P, N).  It
// writes y (B, S, H, P) in x's dtype and the float32 final state
// (B, H, P, N), which the Pallas kernel does not produce and the prefill
// cache needs.  The intra-chunk decay is masked before the exponent (see
// ssd_step.h); positions past S are read as dt = 0, x = B = C = 0, so they
// change neither y nor the state, as ssd_chunked's padding does.
//
// What bounds it on an H100: bytes.  At zamba2-1.2b's prefill (B 4,
// S 4096, H 64, P 64, N 64, chunk 256) one call moves ~281 MB (x and y in
// bf16, dt, B, C, the final state) and needs ~35 GFLOP (C.B^T once per
// batch and chunk, the causal half of the intra-chunk products, the state
// terms); as written here it does ~60 GFLOP.  This first version is simple:
// one block of 256 threads per (batch, head) walks its chunks in order
// with the state in shared memory.  Per chunk, thread 0 forms the running
// sum of dt * a; then for each tile of up to 64 rows t the block forms
// exp(cum_t) C_t.S, and for each tile of positions s at or below it the
// masked weights G = (C_t.B_s) exp(cum_t - cum_s) in shared memory and
// G (dt x)_s; finally the state update.  Each thread computes a 4 x 4 (or
// 4 x P/16) register block of every product from shared-memory rows padded
// against bank conflicts, on the CUDA cores in float32.  C.B^T is
// recomputed by every head although B and C are shared; a grid over
// (batch, chunk) with heads inside, tensor-core tiles and a separate pass
// for the inter-chunk recurrence are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_step.h"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // rows of a tile (the chunk when it is shorter)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared-memory floats the kernel needs.
__host__ __device__ constexpr int64_t smem_floats(int p, int n, int chunk) {
  return 2 * TILE * (n + 1)      // C_t, B_s rows
         + TILE * p              // (dt x)_s or the state-weighted x_s
         + TILE * (TILE + 1)     // G
         + p * (n + 1)           // the state
         + 2 * (int64_t)chunk;   // dt, cum
}

// Rows [r0, r0 + rows) of a (B, S, N) matrix of batch b into smem rows of
// stride n + 1, zero past S.
template <typename T, int N>
__device__ __forceinline__ void load_bc(float* dst, const T* __restrict__ src,
                                        int64_t b, int64_t s_len, int64_t r0,
                                        int rows) {
  for (int idx = threadIdx.x; idx < rows * N; idx += THREADS) {
    const int r = idx / N, ni = idx % N;
    const int64_t t = r0 + r;
    dst[r * (N + 1) + ni] = t < s_len ? to_f32(src[(b * s_len + t) * N + ni]) : 0.0f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state,
                int64_t s_len, int h, int chunk) {
  extern __shared__ float smem[];
  float* cs = smem;                        // TILE x (N + 1)
  float* bs = cs + TILE * (N + 1);         // TILE x (N + 1)
  float* xs = bs + TILE * (N + 1);         // TILE x P
  float* gs = xs + TILE * P;               // TILE x (TILE + 1)
  float* st = gs + TILE * (TILE + 1);      // P x (N + 1)
  float* dts = st + P * (N + 1);           // chunk
  float* cum = dts + chunk;                // chunk

  constexpr int PJ = P / 16;               // p columns per thread
  constexpr int SE = (P * N + THREADS - 1) / THREADS;  // state entries per thread
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bi = blockIdx.x / h, head = blockIdx.x % h;
  const float av = a[head];
  const int tile = chunk < TILE ? chunk : TILE;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int64_t xrow = (int64_t)h * P;     // stride of t in x and y
  const T* xh = x + (bi * s_len * h + head) * P;
  T* yh = y + (bi * s_len * h + head) * P;

  for (int e = tid; e < P * N; e += THREADS)
    st[(e / N) * (N + 1) + e % N] = init ? init[(bi * h + head) * P * N + e] : 0.0f;

  for (int64_t c = 0; c < nc; ++c) {
    const int64_t c0 = c * chunk;
    __syncthreads();  // the previous chunk's state update is done
    for (int t = tid; t < chunk; t += THREADS)
      dts[t] = c0 + t < s_len ? dt[(bi * s_len + c0 + t) * h + head] : 0.0f;
    __syncthreads();
    if (tid == 0) ssd_cumsum(dts, av, chunk, cum);
    __syncthreads();

    for (int tt = 0; tt < chunk / tile; ++tt) {
      const int64_t t0 = c0 + (int64_t)tt * tile;
      __syncthreads();
      load_bc<T, N>(cs, cm, bi, s_len, t0, tile);
      __syncthreads();
      float acc_s[4][PJ], acc_i[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc_s[i][j] = acc_i[i][j] = 0.0f;
      // exp(cum_t) C_t . S
      for (int ni = 0; ni < N; ++ni) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + ni];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = st[(tx + 16 * j) * (N + 1) + ni];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc_s[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float e = r < tile ? expf(cum[tt * tile + r]) : 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc_s[i][j] *= e;
      }
      for (int sti = 0; sti <= tt; ++sti) {
        const int64_t s0 = c0 + (int64_t)sti * tile;
        __syncthreads();  // bs, xs and gs of the previous s tile are read
        load_bc<T, N>(bs, bm, bi, s_len, s0, tile);
        for (int idx = tid; idx < tile * P; idx += THREADS) {
          const int r = idx / P, pi = idx % P;
          const int64_t s = s0 + r;
          xs[idx] = s < s_len ? to_f32(xh[s * xrow + pi]) * dts[sti * tile + r] : 0.0f;
        }
        __syncthreads();
        // G[t][s] = (C_t . B_s) exp(cum_t - cum_s), masked before the exponent
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
        for (int ni = 0; ni < N; ++ni) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + ni];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * (N + 1) + ni];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty + 16 * i, q = tx + 16 * j;
            if (r < tile && q < tile) {
              const int t_idx = tt * tile + r, s_idx = sti * tile + q;
              gs[r * (TILE + 1) + q] =
                  g[i][j] * ssd_intra_decay(cum[t_idx], cum[s_idx], t_idx, s_idx);
            }
          }
        __syncthreads();
        // acc_i += G (dt x)_s
        for (int q = 0; q < tile; ++q) {
          float gv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = gs[(ty + 16 * i) * (TILE + 1) + q];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[q * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc_i[i][j] += gv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int64_t t = t0 + r;
        if (r < tile && t < s_len) {
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            store(yh + t * xrow + tx + 16 * j, acc_i[i][j] + acc_s[i][j]);
        }
      }
    }

    // S' = S exp(cum_last) + sum_s x_s (exp(cum_last - cum_s) dt_s) B_s
    const float last = cum[chunk - 1];
    float upd[SE];
#pragma unroll
    for (int k = 0; k < SE; ++k) upd[k] = 0.0f;
    for (int sti = 0; sti < chunk / tile; ++sti) {
      const int64_t s0 = c0 + (int64_t)sti * tile;
      __syncthreads();
      load_bc<T, N>(bs, bm, bi, s_len, s0, tile);
      for (int idx = tid; idx < tile * P; idx += THREADS) {
        const int r = idx / P, pi = idx % P;
        const int64_t s = s0 + r;
        const int si = sti * tile + r;
        xs[idx] = s < s_len
                      ? to_f32(xh[s * xrow + pi]) * ssd_state_weight(last, cum[si], dts[si])
                      : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SE; ++k) {
        const int e = tid + k * THREADS;
        if (e < P * N) {
          const int pi = e / N, ni = e % N;
          float u = upd[k];
          for (int q = 0; q < tile; ++q) u += xs[q * P + pi] * bs[q * (N + 1) + ni];
          upd[k] = u;
        }
      }
    }
    const float seg = expf(last);
#pragma unroll
    for (int k = 0; k < SE; ++k) {
      const int e = tid + k * THREADS;
      if (e < P * N) {
        float* sp = st + (e / N) * (N + 1) + e % N;
        *sp = *sp * seg + upd[k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS)
    final_state[(bi * h + head) * P * N + e] = st[(e / N) * (N + 1) + e % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* init, void* y, void* fin, int64_t bsz,
           int64_t s_len, int h, int chunk, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(P, N, chunk) * sizeof(float);
  auto kern = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(bsz * h), THREADS, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (const float*)init, (T*)y, (float*)fin, s_len, h, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int p, int n, const void* x, const void* dt, const void* a,
             const void* b, const void* c, const void* init, void* y, void* fin,
             int64_t bsz, int64_t s_len, int h, int chunk, cudaStream_t s) {
#define SSD_CASE(PP, NN) \
  if (p == PP && n == NN) return launch<T, PP, NN>(x, dt, a, b, c, init, y, fin, bsz, s_len, h, chunk, s);
  SSD_CASE(32, 16) SSD_CASE(32, 64) SSD_CASE(32, 128)
  SSD_CASE(64, 16) SSD_CASE(64, 64) SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Supported: p in {32, 64}, n in {16, 64, 128}, chunk <= 64 or a multiple
// of 64 (then at most 1024); init may be null (a zero state).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* init,
                               void* y, void* fin, int64_t bsz, int64_t s_len,
                               int h, int p, int n, int chunk, int is_bf16,
                               void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk > 1024 || (chunk > TILE && chunk % TILE != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(p, n, x, dt, a, b, c, init, y, fin, bsz, s_len, h, chunk, s);
  return dispatch<float>(p, n, x, dt, a, b, c, init, y, fin, bsz, s_len, h, chunk, s);
}
