// K6 with the state term in a pass of its own (a design step of
// tools/kernel_variants.py k6).  kernel_variants.py splices this text into
// ssd_scan.cu's namespace, makes pass C leave out the state term and write
// its intra-chunk y as float32 into `yf` below, and launches
// ssd_state_term_kernel after it:
//
//   D  grid (batch, chunk, head, query tile): the tile's C rows and the
//      head's S_{c-1} planes (from pass B) by cp.async, then per 16-row
//      strip exp(cum[t]) C[t].S_{c-1} on mma.sync (the same fragments as
//      pass C's state term), added to the intra-chunk y and written once
//      in y's dtype.
//
// y goes through float32 between the passes so that it is rounded once,
// as in the fused kernel; the scratch is allocated at the first call and
// kept.
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_state_term_kernel(const T* __restrict__ cm, const __nv_bfloat16* __restrict__ planes,
                      const float4* __restrict__ pos_g, const float* __restrict__ yf,
                      T* __restrict__ y, Strides sd, int64_t s_len, int h, int chunk) {
  constexpr int NP = Parts<T>::NP, SP = Parts<T>::SP;
  constexpr int NT = P / 8, KN = N / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = ssd_lpad(chunk), qr = ssd_qrows(lpad, NP), nq = lpad / qr;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ss = cs + NP * qr * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  int64_t idx = blockIdx.x;
  const int qi = (int)(idx % nq);
  idx /= nq;
  const int head = (int)(idx % h);
  idx /= h;
  const int64_t c = idx % nc, bi = idx / nc, c0 = c * chunk;
  const int t0 = qi * qr;
  const int64_t slot = (bi * nc + c) * h + head;
  load_rows<N, NP>(cs, cm + bi * sd.cb + (c0 + t0) * sd.cs, sd.cs, qr,
                   valid_rows(t0, qr, chunk, c0, s_len));
  const __nv_bfloat16* src = planes + slot * (int64_t)(SP * N * P);
#pragma unroll
  for (int q = 0; q < SP; ++q) load_rows<P, 1>(ss + q * N * P, src + q * N * P, P, N, N);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int r0 = 16 * warp; r0 < qr; r0 += 16 * WARPS) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      int r, col;
      uint32_t ca[NP][4];
      tc_ldm_a(lane, r0, kk, &r, &col);
      ldm_planes<NP, false>(ca, cs, qr * N, tc_smem_off(r, col, N));
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t sb[SP][4];
        tc_ldm_bt(lane, kk, dp, &r, &col);
        ldm_planes<SP, true>(sb, ss, N * P, tc_smem_off(r, col, P));
        mma_pair<NP, SP>(acc + 2 * dp, ca, sb);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = t0 + r0 + tc_c_row(lane, 2 * hf);
      if (t >= chunk || c0 + t >= s_len) continue;
      const float4 pt = pos_g[slot * lpad + t];
      const float e = tc_exp2(pt.x + pt.y);
      const int64_t row = ((bi * s_len + c0 + t) * h + head) * P;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = 8 * j + tc_c_col(lane, 0);
        const float2 v = *reinterpret_cast<const float2*>(yf + row + p);
        const float y0 = v.x + acc[j][2 * hf] * e, y1 = v.y + acc[j][2 * hf + 1] * e;
        if constexpr (NP == 1)
          *reinterpret_cast<uint32_t*>(y + row + p) = tc_pack_round(y0, y1);
        else
          *reinterpret_cast<float2*>(y + row + p) = make_float2(y0, y1);
      }
    }
  }
}

// The float32 scratch for the intra-chunk y, grown as needed and kept.
float* intra_scratch(int64_t elems) {
  static float* buf = nullptr;
  static int64_t have = 0;
  if (elems > have) {
    cudaFree(buf);
    buf = nullptr;
    if (cudaMalloc(&buf, elems * sizeof(float)) != cudaSuccess) return nullptr;
    have = elems;
  }
  return buf;
}

template <typename T, int P, int N>
int launch_state_term(const void* c, const void* planes, const void* pos, const float* yf,
                      void* y, const Strides& sd, int64_t bsz, int64_t s_len, int h, int chunk,
                      cudaStream_t stream) {
  constexpr int NP = Parts<T>::NP, SP = Parts<T>::SP;
  const int lpad = ssd_lpad(chunk), qr = ssd_qrows(lpad, NP);
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int bytes = NP * qr * N * 2 + SP * N * P * 2;
  auto kern = ssd_state_term_kernel<T, P, N>;
  cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((lpad / qr) * bsz * nc * h), THREADS, bytes, stream>>>(
      (const T*)c, (const __nv_bfloat16*)planes, (const float4*)pos, yf, (T*)y, sd, s_len, h,
      chunk);
  return (int)cudaGetLastError();
}
