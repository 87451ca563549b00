// The Mamba2 block's gate: the D skip, the silu(z) gate, the gated RMSNorm
// over d_inner and the cast to the activation dtype, in one pass, CUDA for
// sm_90a.
//
// Replaces no Pallas kernel.  The JAX package writes this chain in jnp
// after the scan (repro/models/ssm.py::ssm_block), where XLA fuses it; the
// port ran it as eleven float32 PyTorch ops, each writing a float32 tensor
// of every position's d_inner channels that the next one read back
// (kernels/ssm_gate/ssm_gate.py::ssm_gate_plain).  It reads the
// scan's y (B, S, H, P) and the input projection's x and z, which stay
// strided views of one (B, S, 2 d_inner + 2 N + H) tensor (their position
// stride is that width), the D skip d (H,) and the norm's weight w
// (d_inner,), and writes the output (B, S, d_inner) in y's dtype, dense.
// The arithmetic is the plain chain's, in float32 (ssm_gate_step.h).
//
// What bounds it on an H100: bytes.  At zamba2-1.2b's prefill batch (32,768
// positions of d_inner 4,096 in bf16) one call reads y, x and z once
// (805 MB) and writes the output once (268 MB): 1.07 GB, 0.32 ms at
// 3.35 TB/s; its ~20 float32 operations and one exp a channel are far
// below the CUDA cores' rate.  So every byte moves once, 16 bytes a load
// or store: one block a position (the row's mean of squares is a block
// reduction: warp butterflies, then the warps' sums through shared
// memory), each thread holding its units' gated values in registers
// between the reduction and the output, every load of the row issued
// before the first is used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_gate_step.h"

namespace {

struct Strides {
  int64_t yb, ys, xb, xs, zb, zs;  // batch and position strides, in elements
};

// A 16-byte unit of the row's dtype: its E elements, loaded raw and
// converted to float32, or rounded from float32 and stored.
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int E = 4;
  typedef float4 Raw;
  __device__ __forceinline__ static void to_float(const Raw& q, float* f) {
    f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Unit<__nv_bfloat16> {
  static constexpr int E = 8;
  typedef uint4 Raw;
  __device__ __forceinline__ static void to_float(const Raw& q, float* f) {
    const uint32_t r[4] = {q.x, q.y, q.z, q.w};
    SG_UNROLL
    for (int i = 0; i < 4; ++i) f[2 * i] = tc_unpack_lo(r[i]), f[2 * i + 1] = tc_unpack_hi(r[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = make_uint4(tc_pack_round(f[0], f[1]), tc_pack_round(f[2], f[3]),
                                              tc_pack_round(f[4], f[5]), tc_pack_round(f[6], f[7]));
  }
};

__device__ __forceinline__ float param(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float param(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// Grid (S, B): one block a position, threads ssm_gate_threads(units, K),
// thread t owning units t + j * blockDim.x, j < K.
template <typename T, typename W, int K>
__global__ void __launch_bounds__(SSM_GATE_THREADS)
    ssm_gate_kernel(const T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ z,
                    const W* __restrict__ d, const W* __restrict__ w, T* __restrict__ out,
                    Strides sd, int units, int p) {
  constexpr int E = Unit<T>::E;
  typedef typename Unit<T>::Raw Raw;
  const int64_t s = blockIdx.x, b = blockIdx.y;
  const T* yr = y + b * sd.yb + s * sd.ys;
  const T* xr = x + b * sd.xb + s * sd.xs;
  const T* zr = z + b * sd.zb + s * sd.zs;
  T* orow = out + (b * gridDim.x + s) * (int64_t)units * E;

  Raw qy[K], qx[K], qz[K];
  SG_UNROLL
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + j * blockDim.x;
    if (u < units) {
      qy[j] = *reinterpret_cast<const Raw*>(yr + u * E);
      qx[j] = *reinterpret_cast<const Raw*>(xr + u * E);
      qz[j] = *reinterpret_cast<const Raw*>(zr + u * E);
    }
  }
  float v[K][E];
  float acc = 0.0f;
  SG_UNROLL
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + j * blockDim.x;
    if (u < units) {
      float fy[E], fx[E], fz[E];
      Unit<T>::to_float(qy[j], fy);
      Unit<T>::to_float(qx[j], fx);
      Unit<T>::to_float(qz[j], fz);
      acc = ssm_gate_unit<E>(fy, fx, param(d, ssm_gate_head(u, E, p)), fz, v[j], acc);
    }
  }
  SG_UNROLL
  for (int off = 16; off > 0; off >>= 1)
    acc = sg_add(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  __shared__ float warp_sums[SSM_GATE_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total = sg_add(total, warp_sums[i]);
  const float r = ssm_gate_scale(total, units * E);
  SG_UNROLL
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + j * blockDim.x;
    if (u < units) {
      float fw[E], o[E];
      SG_UNROLL
      for (int e = 0; e < E; ++e) fw[e] = param(w, u * E + e);
      ssm_gate_out<E>(v[j], r, fw, o);
      Unit<T>::store(orow + u * E, o);
    }
  }
}

template <typename T, typename W>
int launch(const void* y, const void* x, const void* z, const void* d, const void* w, void* out,
           const Strides& sd, int64_t bsz, int64_t s_len, int d_inner, int p,
           cudaStream_t stream) {
  const int units = d_inner / Unit<T>::E;
  const int k = ssm_gate_per_thread(units);
  const dim3 grid((unsigned)s_len, (unsigned)bsz);
  const int threads = ssm_gate_threads(units, k);
#define SG_CASE(KK)                                                                         \
  case KK:                                                                                  \
    ssm_gate_kernel<T, W, KK><<<grid, threads, 0, stream>>>(                                \
        (const T*)y, (const T*)x, (const T*)z, (const W*)d, (const W*)w, (T*)out, sd, units, \
        p);                                                                                 \
    break;
  switch (k) {
    SG_CASE(1) SG_CASE(2) SG_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SG_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// y, x, z and out in one dtype (is_bf16: bfloat16, else float32), d and w
// in one dtype (w_bf16 likewise).  Row (b, s) of y / x / z starts at
// b * yb + s * ys (xb, xs; zb, zs) elements and holds d_inner dense
// channels; out is dense (B, S, d_inner).  Supported: p a multiple of the
// 16-byte unit (8 bfloat16, 4 float32 elements) dividing d_inner, at most
// SSM_GATE_THREADS * SSM_GATE_MAX_K units a row, B <= 65,535, S < 2^31;
// y, x, z and out 16-byte aligned, every stride a multiple of the unit.
extern "C" int ssm_gate_launch(const void* y, const void* x, const void* z, const void* d,
                               const void* w, void* out, int64_t yb, int64_t ys, int64_t xb,
                               int64_t xs, int64_t zb, int64_t zs, int64_t bsz, int64_t s_len,
                               int d_inner, int p, int is_bf16, int w_bf16, void* stream) {
  if (bsz <= 0 || s_len <= 0) return 0;
  const int unit = is_bf16 ? 8 : 4;
  if (d_inner <= 0 || p <= 0 || d_inner % p || p % unit || bsz > 65535 || s_len > 0x7fffffff ||
      ssm_gate_per_thread(d_inner / unit) == 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)y | (uintptr_t)x | (uintptr_t)z | (uintptr_t)out) % 16 ||
      (yb | ys | xb | xs | zb | zs) % unit)
    return (int)cudaErrorMisalignedAddress;
  const Strides sd{yb, ys, xb, xs, zb, zs};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(y, x, z, d, w, out, sd, bsz, s_len,
                                                         d_inner, p, s)
                  : launch<__nv_bfloat16, float>(y, x, z, d, w, out, sd, bsz, s_len, d_inner, p, s);
  return w_bf16 ? launch<float, __nv_bfloat16>(y, x, z, d, w, out, sd, bsz, s_len, d_inner, p, s)
                : launch<float, float>(y, x, z, d, w, out, sd, bsz, s_len, d_inner, p, s);
}
