// K3a / K3b: BaseDelta compression of AMC entry tiles, CUDA for sm_90a.
//
// Replaces the Pallas kernels basedelta_compress_tiles and
// basedelta_decompress_tiles (src/repro/kernels/basedelta/basedelta.py).
// An entry row of W int32 block ids has its base in column 0; K3a writes
// delta = x - base on the row's valid columns (< count) and 0 on pad
// columns, and the row's mode (0/1/2 for a largest |delta| <= 127,
// <= 32767, wider).  K3b adds each row's base back onto its deltas.  The
// arithmetic, in basedelta_step.h, wraps in int32 as JAX's does.
//
// What bounds it on an H100: bytes.  Each tile element is read once and
// written once (8 B), plus 8 B per row; there is one compare-and-max per
// element.  The Pallas kernel walks (8, W) VMEM tiles in grid order; here
// K3a gives each row one warp, lane = column (W <= 32 in one pass; wider
// rows loop), so a row's loads and stores are coalesced, and a warp
// shuffle max-reduce gives the mode with no shared memory.  K3b is one
// thread per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "basedelta_step.h"

__global__ void basedelta_compress_kernel(const int32_t* __restrict__ blocks,
                                          const int32_t* __restrict__ counts,
                                          int64_t e, int w,
                                          int32_t* __restrict__ deltas,
                                          int32_t* __restrict__ mode) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < e; r += warps) {
    int32_t absmax = bd_compress_cols(blocks + r * w, counts[r], w, lane, 32,
                                      deltas + r * w);
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t o = __shfl_xor_sync(0xffffffffu, absmax, off);
      absmax = o > absmax ? o : absmax;
    }
    if (lane == 0) mode[r] = bd_mode(absmax);
  }
}

__global__ void basedelta_decompress_kernel(const int32_t* __restrict__ base,
                                            const int32_t* __restrict__ deltas,
                                            int64_t e, int w,
                                            int32_t* __restrict__ out) {
  const int64_t n = e * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = bd_wrap_add(base[i / w], deltas[i]);
}

static int grid_for(int64_t threads_needed, int block) {
  const int64_t g = (threads_needed + block - 1) / block;
  return (int)(g < 65535 * 32 ? g : 65535 * 32);
}

extern "C" int basedelta_compress_launch(const void* blocks, const void* counts,
                                         int64_t e, int w, void* deltas,
                                         void* mode, void* stream) {
  if (e <= 0 || w <= 0) return 0;
  const int block = 256;  // 8 warps, one entry row each
  basedelta_compress_kernel<<<grid_for(e * 32, block), block, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)blocks, (const int32_t*)counts, e, w, (int32_t*)deltas,
      (int32_t*)mode);
  return (int)cudaGetLastError();
}

extern "C" int basedelta_decompress_launch(const void* base, const void* deltas,
                                           int64_t e, int w, void* out,
                                           void* stream) {
  if (e <= 0 || w <= 0) return 0;
  const int block = 256;
  basedelta_decompress_kernel<<<grid_for(e * w, block), block, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)base, (const int32_t*)deltas, e, w, (int32_t*)out);
  return (int)cudaGetLastError();
}
