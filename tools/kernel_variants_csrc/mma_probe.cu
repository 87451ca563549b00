// One mma.sync.m16n8k16 (bf16 x bf16 + float32) a warp, on tiles given in
// global memory, for tools/mma_accumulation.py: case w's A (16 x 16,
// row-major), B (16 x 8, k x n) and C (16 x 8) are float32 arrays holding
// bfloat16 values (A, B) and any float32 values (C); D = C + A B is
// written in C's layout.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_frag.h"

namespace {

__global__ void mma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 const float* __restrict__ c, float* __restrict__ d, int n) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, l = threadIdx.x & 31;
  if (w >= n) return;
  const float* A = a + (int64_t)w * 256;
  const float* B = b + (int64_t)w * 128;
  const float* C = c + (int64_t)w * 128;
  uint32_t ra[4], rb[2];
  float rc[4];
  for (int r = 0; r < 4; ++r)
    ra[r] = tc_pack_bf16x2(A[tc_a_row(l, 2 * r) * 16 + tc_a_col(l, 2 * r)],
                           A[tc_a_row(l, 2 * r + 1) * 16 + tc_a_col(l, 2 * r + 1)]);
  for (int r = 0; r < 2; ++r)
    rb[r] = tc_pack_bf16x2(B[tc_b_k(l, 2 * r) * 8 + tc_b_n(l, 2 * r)],
                           B[tc_b_k(l, 2 * r + 1) * 8 + tc_b_n(l, 2 * r + 1)]);
  for (int i = 0; i < 4; ++i) rc[i] = C[tc_c_row(l, i) * 8 + tc_c_col(l, i)];
  mma_bf16(rc, ra, rb[0], rb[1]);
  for (int i = 0; i < 4; ++i) d[(int64_t)w * 128 + tc_c_row(l, i) * 8 + tc_c_col(l, i)] = rc[i];
}

}  // namespace

extern "C" int mma_probe_launch(const void* a, const void* b, const void* c, void* d, int n,
                                void* stream) {
  if (n <= 0) return 0;
  mma_probe_kernel<<<(n + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)c, (float*)d, n);
  return (int)cudaGetLastError();
}
