// K4a / K4b: AMC recorded-stream gather, CUDA for sm_90a.
//
// Replaces the Pallas kernels amc_gather and amc_gather_segment_sum
// (src/repro/kernels/amc_gather/amc_gather.py).  K4a computes
// out[i] = table[idx[i]]; on the TPU the recorded index stream is a
// scalar-prefetch operand that drives each row's DMA one grid step ahead.
// K4b computes out[s] = sum of table[idx[i]] over segments[i] == s, in
// float32 in index order, cast to the table's dtype (the push-mode EDGEMAP
// consumer of the same stream).
//
// What bounds them on an H100: bytes.  K4a moves each gathered row once in
// and once out (2 N D sizeof(T) + 4 N); K4b reads the rows once and writes
// one row per segment.  K4a gives each output row one warp and copies it
// with 16-byte vector loads when a row is a multiple of 16 bytes (a
// D = 128 float32 row is one load per lane), element by element otherwise.
// It is a pure bit copy, so it is exact for any dtype.  The Pallas
// pipeline's point, fetching the next recorded row ahead of use, is left
// to the hardware here: each warp's loads are independent and many warps
// are in flight; a cp.async / TMA row prefetch is later work.
//
// K4b gives each segment one warp, lanes over D, and finds the segment's
// [start, end) in the sorted segment ids by binary search (lane 0), so
// empty segments are written as 0 and no second pass is needed.  Each
// lane adds its column in index order from 0.0f, the float sequence of
// the plain version (index_add_ on the CPU).  A segment of high degree is
// one serial chain per column, the same limit as the ordered segment sum
// (kernels/segment_sum/csrc/segment_sum.cu).
//
// Indices outside the table give a zero row (K4a) or add nothing (K4b),
// so no input makes a kernel read outside its arrays.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

static int grid_for_warps(int64_t warps, int block) {
  const int64_t g = (warps * 32 + block - 1) / block;
  return (int)(g < 65535 * 32 ? g : 65535 * 32);
}

// T is the copy unit: uint4 (16 bytes), uint32_t or uint16_t; `cols` is a
// row's length in units of T.
template <typename T>
__global__ void amc_gather_kernel(const T* __restrict__ table, int64_t v,
                                  int64_t cols, const int32_t* __restrict__ idx,
                                  int64_t n, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < n; r += warps) {
    const int64_t s = idx[r];
    T* dst = out + r * cols;
    if (s < 0 || s >= v) {
      for (int64_t c = lane; c < cols; c += 32) dst[c] = T{};
      continue;
    }
    const T* src = table + s * cols;
    for (int64_t c = lane; c < cols; c += 32) dst[c] = src[c];
  }
}

template <typename T>
static void launch_gather(const void* table, int64_t v, int64_t cols,
                          const void* idx, int64_t n, void* out,
                          cudaStream_t stream) {
  const int block = 256;  // 8 warps, one output row each
  amc_gather_kernel<T><<<grid_for_warps(n, block), block, 0, stream>>>(
      (const T*)table, v, cols, (const int32_t*)idx, n, (T*)out);
}

extern "C" int amc_gather_launch(const void* table, int64_t v, int64_t d,
                                 int elt, const void* idx, int64_t n, void* out,
                                 void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (elt != 4 && elt != 2) return (int)cudaErrorInvalidValue;
  const int64_t row_bytes = d * elt;
  const bool aligned16 = ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned16)
    launch_gather<uint4>(table, v, row_bytes / 16, idx, n, out, s);
  else if (row_bytes % 4 == 0 && (uintptr_t)table % 4 == 0 && (uintptr_t)out % 4 == 0)
    launch_gather<uint32_t>(table, v, row_bytes / 4, idx, n, out, s);
  else
    launch_gather<uint16_t>(table, v, row_bytes / 2, idx, n, out, s);
  return (int)cudaGetLastError();
}

// First position in the sorted seg[0, n) whose value is >= key.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ seg,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if ((int64_t)seg[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void amc_gather_segment_sum_kernel(
    const T* __restrict__ table, int64_t v, int64_t d,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ seg,
    int64_t n, int64_t num_segments, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < num_segments; s += warps) {
    int64_t lo = 0, hi = 0;
    if (lane == 0) {
      lo = lower_bound(seg, n, s);
      hi = lower_bound(seg, n, s + 1);
    }
    lo = __shfl_sync(0xffffffffu, lo, 0);
    hi = __shfl_sync(0xffffffffu, hi, 0);
    for (int64_t c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int64_t j = lo; j < hi; ++j) {
        const int64_t r = idx[j];
        if (r >= 0 && r < v) acc += load_f32(table + r * d + c);
      }
      store_f32(out + s * d + c, acc);
    }
  }
}

extern "C" int amc_gather_segment_sum_launch(const void* table, int64_t v,
                                             int64_t d, int is_bf16,
                                             const void* idx, const void* seg,
                                             int64_t n, int64_t num_segments,
                                             void* out, void* stream) {
  if (num_segments <= 0 || d <= 0) return 0;
  const int block = 256;  // 8 warps, one segment each
  const int grid = grid_for_warps(num_segments, block);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    amc_gather_segment_sum_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)table, v, d, (const int32_t*)idx,
        (const int32_t*)seg, n, num_segments, (__nv_bfloat16*)out);
  else
    amc_gather_segment_sum_kernel<float><<<grid, block, 0, s>>>(
        (const float*)table, v, d, (const int32_t*)idx, (const int32_t*)seg, n,
        num_segments, (float*)out);
  return (int)cudaGetLastError();
}
