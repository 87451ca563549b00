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
// K4b sums each column in index order from 0.0f, the float sequence of
// the plain version (index_add_ on the CPU), so the output is bit-equal to
// it; empty segments are written as 0.  What bounds it is latency: path
// E's largest segment holds 1,771 of 442,876 rows, one serial chain of
// adds, and a search for each segment's rows is a chain of dependent
// loads.  So a warp takes 32 consecutive segments, finds their rows with
// two warp-wide searches of 32 probes a round (warp_lower_bound: 4
// dependent loads for n = 442,876, not 19), and walks those rows as one
// stream, writing a segment's sum when the stream passes its end.  Each
// lane owns 16-byte vectors of the row (4 float32 or 8 bf16 columns;
// several where a row has more than 32), the warp loads 32 indices and
// segment ids at a time with one coalesced load each and broadcasts them
// with __shfl_sync (the next 32 are loaded while these are added), and it
// issues the loads of 8 rows before adding any of them.  Rows that are not
// a multiple of 16 bytes, or a table that is not 16-byte aligned, take the
// element-wise kernel: one warp per segment, one lane per column, rows
// innermost.
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

// lower_bound by the whole warp: each round probes 32 evenly spaced
// positions of [lo, hi) with one load per lane and keeps the gap where the
// ballot of `seg[p] < key` turns, so n = 442,876 takes 4 dependent loads
// instead of 19.  Every lane returns the same position.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* __restrict__ seg,
                                                    int64_t n, int64_t key, int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const bool below = p < hi && (int64_t)seg[p] < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) return lo;
    const int64_t next_hi = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = next_hi < hi ? next_hi : hi;
  }
  const bool below = lo + lane < hi && (int64_t)seg[lo + lane] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// Accumulate one 16-byte vector of 4 float32 or 8 bf16 values.
__device__ __forceinline__ void add_vec(float* acc, uint4 x, float) {
  acc[0] += __uint_as_float(x.x);
  acc[1] += __uint_as_float(x.y);
  acc[2] += __uint_as_float(x.z);
  acc[3] += __uint_as_float(x.w);
}
__device__ __forceinline__ void add_vec(float* acc, uint4 x, __nv_bfloat16) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack_vec(const float* acc, float) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}
__device__ __forceinline__ uint4 pack_vec(const float* acc, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Write the sums of segments [cur, until) (after the first, empty ones),
// zeroing the accumulator after each; cur ends at until.
template <typename T, int VPL, int E>
__device__ __forceinline__ void write_segments(uint4* __restrict__ out, float (&acc)[VPL][E],
                                               int64_t& cur, int64_t until, int vecs,
                                               int lane) {
  for (; cur < until; ++cur) {
#pragma unroll
    for (int w = 0; w < VPL; ++w) {
      const int c = lane + 32 * w;
      if (c < vecs) out[cur * vecs + c] = pack_vec(acc[w], T{});
#pragma unroll
      for (int e = 0; e < E; ++e) acc[w][e] = 0.0f;
    }
  }
}

// Rows of `vecs` 16-byte vectors; lane l owns vectors l, l + 32, ... (VPL
// of them).  A warp takes SPW consecutive segments and walks their rows as
// one stream in index order, U rows in flight before their adds, writing
// each segment's sum when the stream passes its end (empty segments get
// 0).  A row outside the table loads as zeros: adding +0.0f leaves a sum
// that started at +0.0f unchanged, bit for bit.
template <typename T, int VPL, int U, int SPW>
__global__ void __launch_bounds__(256) amc_gather_segment_sum_vec_kernel(
    const uint4* __restrict__ table, int64_t v, int vecs,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ seg, int64_t n,
    int64_t num_segments, uint4* __restrict__ out) {
  constexpr int E = 16 / sizeof(T);  // values per vector
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t s0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * SPW;
       s0 < num_segments; s0 += warps * SPW) {
    const int64_t s1 = s0 + SPW < num_segments ? s0 + SPW : num_segments;
    const int64_t lo = warp_lower_bound(seg, n, s0, lane);
    const int64_t hi = warp_lower_bound(seg, n, s1, lane);
    float acc[VPL][E];
#pragma unroll
    for (int w = 0; w < VPL; ++w)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[w][e] = 0.0f;
    int64_t cur = s0;  // the segment being summed
    int32_t next_i = lo + lane < hi ? idx[lo + lane] : -1;
    int32_t next_s = lo + lane < hi ? seg[lo + lane] : 0;
    for (int64_t base = lo; base < hi; base += 32) {
      const int32_t my_i = next_i, my_s = next_s;  // rows base .. base + 31, one a lane
      const bool more = base + 32 + lane < hi;
      next_i = more ? idx[base + 32 + lane] : -1;
      next_s = more ? seg[base + 32 + lane] : 0;
      const int cnt = (int)(hi - base < 32 ? hi - base : 32);
      for (int j0 = 0; j0 < cnt; j0 += U) {
        uint4 x[U][VPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t r = __shfl_sync(0xffffffffu, my_i, (j0 + u) & 31);
          const bool ok = j0 + u < cnt && r >= 0 && r < v;
#pragma unroll
          for (int w = 0; w < VPL; ++w) {
            const int c = lane + 32 * w;
            x[u][w] = ok && c < vecs ? __ldg(table + r * vecs + c) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t sj = __shfl_sync(0xffffffffu, my_s, (j0 + u) & 31);
          if (j0 + u < cnt) {
            write_segments<T>(out, acc, cur, sj < s1 ? sj : s1, vecs, lane);
#pragma unroll
            for (int w = 0; w < VPL; ++w) add_vec(acc[w], x[u][w], T{});
          }
        }
      }
    }
    write_segments<T>(out, acc, cur, s1, vecs, lane);
  }
}

template <typename T>
static void launch_segment_sum_scalar(const void* table, int64_t v, int64_t d,
                                      const void* idx, const void* seg, int64_t n,
                                      int64_t num_segments, void* out, cudaStream_t s) {
  const int block = 256;  // 8 warps, one segment each
  amc_gather_segment_sum_kernel<T><<<grid_for_warps(num_segments, block), block, 0, s>>>(
      (const T*)table, v, d, (const int32_t*)idx, (const int32_t*)seg, n, num_segments,
      (T*)out);
}

template <typename T, int VPL, int U>
static void launch_segment_sum_vec(const void* table, int64_t v, int vecs, const void* idx,
                                   const void* seg, int64_t n, int64_t num_segments,
                                   void* out, cudaStream_t s) {
  constexpr int SPW = 32;  // segments a warp
  const int block = 256;  // 8 warps
  amc_gather_segment_sum_vec_kernel<T, VPL, U, SPW>
      <<<grid_for_warps((num_segments + SPW - 1) / SPW, block), block, 0, s>>>(
          (const uint4*)table, v, vecs, (const int32_t*)idx, (const int32_t*)seg, n,
          num_segments, (uint4*)out);
}

template <typename T>
static void launch_segment_sum(const void* table, int64_t v, int64_t d, const void* idx,
                               const void* seg, int64_t n, int64_t num_segments, void* out,
                               cudaStream_t s) {
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  const bool aligned16 = ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t vecs = row_bytes / 16;
  if (row_bytes % 16 != 0 || !aligned16 || vecs > 4 * 32) {
    launch_segment_sum_scalar<T>(table, v, d, idx, seg, n, num_segments, out, s);
    return;
  }
  // 8 rows in flight: more would cost the registers of warps in flight
  if (vecs <= 32)
    launch_segment_sum_vec<T, 1, 8>(table, v, (int)vecs, idx, seg, n, num_segments, out, s);
  else if (vecs <= 64)
    launch_segment_sum_vec<T, 2, 8>(table, v, (int)vecs, idx, seg, n, num_segments, out, s);
  else
    launch_segment_sum_vec<T, 4, 8>(table, v, (int)vecs, idx, seg, n, num_segments, out, s);
}

extern "C" int amc_gather_segment_sum_launch(const void* table, int64_t v,
                                             int64_t d, int is_bf16,
                                             const void* idx, const void* seg,
                                             int64_t n, int64_t num_segments,
                                             void* out, void* stream) {
  if (num_segments <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch_segment_sum<__nv_bfloat16>(table, v, d, idx, seg, n, num_segments, out, s);
  else
    launch_segment_sum<float>(table, v, d, idx, seg, n, num_segments, out, s);
  return (int)cudaGetLastError();
}
