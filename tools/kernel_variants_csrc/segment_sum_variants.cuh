// Designs of the ordered segment sum that tools/kernel_variants.py segsum
// times beside the committed kernel: this text is appended to
// src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu, whose kernel and
// steps (segment_sum_step.h) it reuses.  Each entry point takes the
// committed segment_sum_launch's arguments (two_pass also a scratch of E
// floats) and gives the same bits.
//
// segment_sum_two_launches: the kernel's two roles as two launches on one
//   stream, the heavy warps first, in place of two block roles in one grid.
// segment_sum_two_pass: values[perm] gathered into edge-sorted order by one
//   thread an edge, then each segment's chain over contiguous memory (the
//   same roles and buffers, lanes and threads loading sorted[j] directly).
// segment_sum_shuffle_launch: the kernel's roles with each chunk's values
//   passed by 32 shuffles, each just before its add, and each value's
//   perm load just before its values load (the first warp design).
// segment_sum_thread_launch: one thread a segment walking its edges, a load
//   of perm[j] and then of values[perm[j]] before each add (the design the
//   kernel replaced).

namespace {

__global__ void __launch_bounds__(THREADS)
gather_sorted_kernel(const float* __restrict__ values, const int32_t* __restrict__ perm,
                     int64_t e, float* __restrict__ sorted) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j < e) sorted[j] = values[perm[j]];
}

__global__ void __launch_bounds__(THREADS)
chain_contiguous_kernel(const float* __restrict__ sorted, const int64_t* __restrict__ offsets,
                        int n, const int32_t* __restrict__ heavy, int nheavy, int heavy_blocks,
                        float* __restrict__ out) {
  __shared__ __align__(16) float stage[WARPS][STAGES][SS_CHUNK];
  if ((int)blockIdx.x < heavy_blocks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int w = blockIdx.x * WARPS + warp;
    if (w >= nheavy) return;
    const int d = heavy[w];
    const int64_t lo = offsets[d], hi = offsets[d + 1], nc = ss_chunks(hi - lo);
    auto load = [&](int64_t c) {
      const int64_t j = lo + c * SS_CHUNK + lane;
      return j < hi ? sorted[j] : 0.0f;
    };
    float* buf = &stage[warp][0][0];
    float ring[SS_RING];
#pragma unroll
    for (int s = 0; s < SS_RING; ++s) ring[s] = load(s);
    buf[lane] = ring[0];
    __syncwarp();
    float cur[HALF], nxt[HALF];
    read_half(cur, buf);
    float acc = 0.0f;
    for (int64_t c0 = 0; c0 < nc; c0 += SS_RING) {
#pragma unroll
      for (int s = 0; s < SS_RING; ++s) {
        const int64_t c = c0 + s;
        if (c >= nc) break;
        const float* now = buf + (c & (STAGES - 1)) * SS_CHUNK;
        float* next = buf + ((c + 1) & (STAGES - 1)) * SS_CHUNK;
        next[lane] = ring[(s + 1) % SS_RING];
        ring[s] = load(c + SS_RING);
        __syncwarp();
        const int len = ss_chunk_len(lo, hi, c);
        read_half(nxt, now + HALF);
        acc = ss_chain(acc, len, cur, HALF);
        read_half(cur, next);
        acc = ss_chain(acc, len - HALF, nxt, HALF);
      }
    }
    if (lane == 0) out[d] = acc;
    return;
  }
  const int64_t d = (int64_t)(blockIdx.x - heavy_blocks) * THREADS + threadIdx.x;
  if (d >= n) return;
  const int64_t lo = offsets[d], hi = offsets[d + 1];
  if (ss_is_heavy(hi - lo)) return;
  float acc = 0.0f;
  for (int64_t j0 = lo; j0 < hi; j0 += SS_HOIST) {
    float v[SS_HOIST];
#pragma unroll
    for (int i = 0; i < SS_HOIST; ++i) v[i] = j0 + i < hi ? sorted[j0 + i] : 0.0f;
    acc = ss_chain(acc, (int)(hi - j0), v, SS_HOIST);
  }
  out[d] = acc;
}

__global__ void __launch_bounds__(THREADS)
segment_sum_shuffle_kernel(const float* __restrict__ values, const int32_t* __restrict__ perm,
                           const int64_t* __restrict__ offsets, int n,
                           const int32_t* __restrict__ heavy, int nheavy, int heavy_blocks,
                           float* __restrict__ out) {
  if ((int)blockIdx.x < heavy_blocks) {
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (w >= nheavy) return;
    const int d = heavy[w];
    const int64_t lo = offsets[d], hi = offsets[d + 1], nc = ss_chunks(hi - lo);
    float ring[SS_RING];
#pragma unroll
    for (int s = 0; s < SS_RING; ++s)
      ring[s] = ss_lane_value(values, ss_lane_perm(perm, lo, hi, s, lane));
    float acc = 0.0f;
    for (int64_t c0 = 0; c0 < nc; c0 += SS_RING) {
#pragma unroll
      for (int s = 0; s < SS_RING; ++s) {
        const float mine = ring[s];
        ring[s] = ss_lane_value(values, ss_lane_perm(perm, lo, hi, c0 + s + SS_RING, lane));
        const int len = ss_chunk_len(lo, hi, c0 + s);
#pragma unroll
        for (int i = 0; i < SS_CHUNK; ++i) {
          const float x = __shfl_sync(0xffffffffu, mine, i);
          if (i < len) acc += x;
        }
      }
    }
    if (lane == 0) out[d] = acc;
    return;
  }
  const int64_t d = (int64_t)(blockIdx.x - heavy_blocks) * THREADS + threadIdx.x;
  if (d >= n) return;
  const int64_t lo = offsets[d], hi = offsets[d + 1];
  if (ss_is_heavy(hi - lo)) return;
  out[d] = ss_light(values, perm, lo, hi);
}

__global__ void segment_sum_thread_kernel(const float* __restrict__ values,
                                          const int32_t* __restrict__ perm,
                                          const int64_t* __restrict__ offsets, int n,
                                          float* __restrict__ out) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  float acc = 0.0f;
  for (int64_t j = offsets[d]; j < offsets[d + 1]; ++j) acc += values[perm[j]];
  out[d] = acc;
}

}  // namespace

extern "C" int segment_sum_two_launches(const void* values, const void* perm,
                                        const void* offsets, int n, const void* heavy,
                                        int nheavy, void* out, void* stream) {
  if (n <= 0) return 0;
  const int heavy_blocks = (nheavy + WARPS - 1) / WARPS;
  const cudaStream_t s = (cudaStream_t)stream;
  if (heavy_blocks)
    segment_sum_kernel<<<heavy_blocks, THREADS, 0, s>>>(
        (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n,
        (const int32_t*)heavy, nheavy, heavy_blocks, (float*)out);
  segment_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n,
      (const int32_t*)heavy, nheavy, 0, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_two_pass(const void* values, const void* perm, const void* offsets,
                                    int n, const void* heavy, int nheavy, void* out,
                                    void* sorted, int64_t e, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (e > 0)
    gather_sorted_kernel<<<(unsigned)((e + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        (const float*)values, (const int32_t*)perm, e, (float*)sorted);
  const int heavy_blocks = (nheavy + WARPS - 1) / WARPS;
  chain_contiguous_kernel<<<heavy_blocks + (n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)sorted, (const int64_t*)offsets, n, (const int32_t*)heavy, nheavy,
      heavy_blocks, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_shuffle_launch(const void* values, const void* perm,
                                          const void* offsets, int n, const void* heavy,
                                          int nheavy, void* out, void* stream) {
  if (n <= 0) return 0;
  const int heavy_blocks = (nheavy + WARPS - 1) / WARPS;
  segment_sum_shuffle_kernel<<<heavy_blocks + (n + THREADS - 1) / THREADS, THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n,
      (const int32_t*)heavy, nheavy, heavy_blocks, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_thread_launch(const void* values, const void* perm,
                                         const void* offsets, int n, const void* heavy,
                                         int nheavy, void* out, void* stream) {
  if (n <= 0) return 0;
  segment_sum_thread_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n, (float*)out);
  return (int)cudaGetLastError();
}
