// Ordered float32 segment sum, one thread per segment.
//
// Not a port of a TPU kernel: it stands in for jax.ops.segment_sum in
// PageRankDelta's EDGEMAP (repro/apps/pagerank_delta.py:59).  The JAX
// package adds each destination's contributions sequentially in edge order
// (XLA-CPU's scatter-add), and the rank delta it yields feeds a threshold
// test that decides frontier membership, so the port must produce the same
// float sequence.  torch's index_add_ on CUDA uses atomics in an order
// that changes from run to run; this kernel instead walks each segment's
// edges in their original order, through a stable destination sort of the
// edge ids computed once per graph on the host (`perm`, `offsets`), and
// adds from 0.0f.
//
// What bounds it on an H100: bytes.  Each edge's value is read once through
// one gather (4 B value + 4 B edge id), each output written once; the
// per-thread loop is short except at high in-degree vertices.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int32_t* __restrict__ perm,
                                   const int64_t* __restrict__ offsets, int n,
                                   float* __restrict__ out) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  float acc = 0.0f;
  for (int64_t j = offsets[d]; j < offsets[d + 1]; ++j) acc += values[perm[j]];
  out[d] = acc;
}

extern "C" int segment_sum_launch(const void* values, const void* perm,
                                  const void* offsets, int n, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  segment_sum_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)values, (const int32_t*)perm, (const int64_t*)offsets, n,
      (float*)out);
  return (int)cudaGetLastError();
}
