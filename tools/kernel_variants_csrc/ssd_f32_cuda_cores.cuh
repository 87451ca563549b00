// K6's float32 route with float32 products on the CUDA cores, inside the
// chunk-parallel grid of ssd_scan.cu (a design step of
// tools/kernel_variants.py k6, against the committed route, whose float32
// operands go into mma.sync as three bf16 parts a side).
// kernel_variants.py splices this text into ssd_scan.cu's namespace and
// sends float32 calls to dispatch_cc.  The passes keep the committed
// grids, running sum (block_cumsum, in double), carry (ssd_carry_kernel,
// whose three bf16 planes of S_{c-1} are summed back to float32 here) and
// scratch; only the products move from the tensor cores to FMAs:
//
//   A' grid (batch, chunk, group of 4 heads): per head the running sum,
//      then dS^T[n][p] = sum_s w[s] B[s][n] x[s][p] over 32-row tiles of x
//      and w B in shared memory, each thread a block of N / TN rows n by
//      4 columns p;
//   C' grid (batch, chunk, group of 8 heads, query tile of 32 or 16 rows):
//      C.B^T for the tile's rows once (float32, in shared memory), then per
//      head exp(cum[t]) C[t].S_{c-1} and, over 32-row tiles of positions s
//      up to the tile's last row, G[t][s] = (C.B^T)[t][s] exp(cum[t] -
//      cum[s]) dt[s] (masked before the exponent) times the x tile; each
//      thread a block of rows t by 4 columns p.
//
// Shared-memory rows read as a thread's own row (C, G) are padded by one
// float against bank conflicts; rows read four columns at a time (x, w B,
// B^T, S^T) are float4s.

// Rows of an s-tile of the CUDA-core passes: 32, or the padded chunk (16,
// 32) or 16 where 32 does not divide it.
__host__ __device__ __forceinline__ int cc_stile(int lpad) {
  return lpad <= 32 ? lpad : lpad % 32 == 0 ? 32 : 16;
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_state_cc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    float* __restrict__ ds, float* __restrict__ last, float4* __restrict__ pos,
                    Strides sd, int64_t s_len, int h, int chunk) {
  constexpr int TP = P / 4, TN = THREADS / TP, RN = N / TN;
  static_assert(RN >= 1, "a thread owns at least one row n");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = ssd_lpad(chunk), stile = cc_stile(lpad), ns = lpad / stile;
  const int per = ssd_scan_per_thread(lpad);
  double* wsum = reinterpret_cast<double*>(smem);
  float* w = reinterpret_cast<float*>(smem + 128);
  float* xt = w + (lpad + 3) / 4 * 4;  // stile x P
  float* wb = xt + stile * P;          // stile x N: w[s] B[s][n]
  const int tp = threadIdx.x % TP, tn = threadIdx.x / TP;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int groups = (h + HG_STATE - 1) / HG_STATE;
  const int g = blockIdx.x % groups;
  const int64_t bc = blockIdx.x / groups, bi = bc / nc, c = bc % nc, c0 = c * chunk;
  const int h_end = (g + 1) * HG_STATE < h ? (g + 1) * HG_STATE : h;

  float v[SCAN_MAX];
  load_dt(v, dt, bi, s_len, h, g * HG_STATE, c0, chunk, per);
  for (int head = g * HG_STATE; head < h_end; ++head) {
    const int64_t slot = (bi * nc + c) * h + head;
    const double total = block_cumsum(v, a[head], per, lpad, pos + slot * lpad, w, wsum);
    if (head + 1 < h_end) load_dt(v, dt, bi, s_len, h, head + 1, c0, chunk, per);
    __syncthreads();  // w visible
    float acc[RN][4];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int st = 0; st < ns; ++st) {
      const int r0 = st * stile, valid = valid_rows(r0, stile, chunk, c0, s_len);
      for (int idx = threadIdx.x; idx < stile * (P / 4); idx += THREADS) {
        const int r = idx / (P / 4), q = idx % (P / 4);
        reinterpret_cast<float4*>(xt)[idx] =
            r < valid ? *reinterpret_cast<const float4*>(x + bi * sd.xb + (c0 + r0 + r) * sd.xs +
                                                         head * P + 4 * q)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int idx = threadIdx.x; idx < stile * (N / 4); idx += THREADS) {
        const int r = idx / (N / 4), q = idx % (N / 4);
        float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < valid) {
          u = *reinterpret_cast<const float4*>(bm + bi * sd.bb + (c0 + r0 + r) * sd.bs + 4 * q);
          const float ws = w[r0 + r];
          u.x *= ws, u.y *= ws, u.z *= ws, u.w *= ws;
        }
        reinterpret_cast<float4*>(wb)[idx] = u;
      }
      __syncthreads();
      for (int r = 0; r < stile; ++r) {
        const float4 xv = reinterpret_cast<const float4*>(xt + r * P)[tp];
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          const float bv = wb[r * N + tn + TN * i];
          acc[i][0] += bv * xv.x, acc[i][1] += bv * xv.y;
          acc[i][2] += bv * xv.z, acc[i][3] += bv * xv.w;
        }
      }
      __syncthreads();
    }
    float* out = ds + slot * (int64_t)(N * P);
#pragma unroll
    for (int i = 0; i < RN; ++i)
      *reinterpret_cast<float4*>(out + (tn + TN * i) * P + 4 * tp) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (threadIdx.x == 0) last[slot] = (float)total;
  }
}

// Byte offsets of pass C''s shared memory.
struct CcOutputSmem {
  int cb, cb_stride, cs, cs_stride, st, xt, gt, gt_stride, pos, total;
  __host__ __device__ CcOutputSmem(int p, int n, int lpad, int qr, int stile) {
    cb_stride = lpad + 4;
    cs_stride = n + 1;
    gt_stride = stile + 1;
    cb = 0;
    cs = ssd_round128((int64_t)qr * cb_stride * 4);
    st = cs + ssd_round128((int64_t)qr * cs_stride * 4);  // S^T (N x P), first B^T tiles
    xt = st + ssd_round128((int64_t)n * p * 4);
    gt = xt + ssd_round128((int64_t)stile * p * 4);
    pos = gt + ssd_round128((int64_t)qr * gt_stride * 4);
    total = pos + lpad * 16;
  }
};

template <int P, int N, int SP>
__global__ void __launch_bounds__(THREADS)
ssd_output_cc_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm, const __nv_bfloat16* __restrict__ planes,
                     const float4* __restrict__ pos_g, float* __restrict__ y, Strides sd,
                     int64_t s_len, int h, int chunk) {
  constexpr int TP = P / 4, TR = THREADS / TP, RM_MAX = 32 / TR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = ssd_lpad(chunk), qr = ssd_qrows(lpad, SSD_F32_PARTS), nq = lpad / qr;
  const int stile = cc_stile(lpad), rm = qr / TR;
  const CcOutputSmem L(P, N, lpad, qr, stile);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* sT = reinterpret_cast<float*>(smem + L.st);
  float* bT = sT;  // B^T tiles (N x stile) while C.B^T is formed
  float* xt = reinterpret_cast<float*>(smem + L.xt);
  float* gt = reinterpret_cast<float*>(smem + L.gt);
  float4* ps = reinterpret_cast<float4*>(smem + L.pos);
  const int tp = threadIdx.x % TP, tr = threadIdx.x / TP;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int groups = (h + HG_OUTPUT - 1) / HG_OUTPUT;
  int64_t idx0 = blockIdx.x;
  const int qi = nq - 1 - (int)(idx0 % nq);
  idx0 /= nq;
  const int g = (int)(idx0 % groups);
  idx0 /= groups;
  const int64_t c = idx0 % nc, bi = idx0 / nc, c0 = c * chunk;
  const int t0 = qi * qr, s_end = t0 + qr, nsq = (s_end + stile - 1) / stile;
  const int h0 = g * HG_OUTPUT, h_end = h0 + HG_OUTPUT < h ? h0 + HG_OUTPUT : h;

  // The tile's C rows, then C.B^T an s-tile at a time.
  const int cvalid = valid_rows(t0, qr, chunk, c0, s_len);
  for (int idx = threadIdx.x; idx < qr * (N / 4); idx += THREADS) {
    const int r = idx / (N / 4), q = idx % (N / 4);
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < cvalid)
      u = *reinterpret_cast<const float4*>(cm + bi * sd.cb + (c0 + t0 + r) * sd.cs + 4 * q);
    float* d = cs + r * L.cs_stride + 4 * q;
    d[0] = u.x, d[1] = u.y, d[2] = u.z, d[3] = u.w;
  }
  for (int st = 0; st < nsq; ++st) {
    const int r0 = st * stile, valid = valid_rows(r0, stile, chunk, c0, s_len);
    __syncthreads();  // the last tile's B^T no longer read
    for (int idx = threadIdx.x; idx < stile * (N / 4); idx += THREADS) {
      const int r = idx % stile, q = idx / stile;
      float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < valid)
        u = *reinterpret_cast<const float4*>(bm + bi * sd.bb + (c0 + r0 + r) * sd.bs + 4 * q);
      bT[(4 * q) * stile + r] = u.x, bT[(4 * q + 1) * stile + r] = u.y;
      bT[(4 * q + 2) * stile + r] = u.z, bT[(4 * q + 3) * stile + r] = u.w;
    }
    __syncthreads();
    const int ts = stile / 4, tt = THREADS / ts;
    const int col = threadIdx.x % ts;
    for (int r = threadIdx.x / ts; r < qr; r += tt) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float cv = cs[r * L.cs_stride + n];
        const float4 bv = reinterpret_cast<const float4*>(bT + n * stile)[col];
        acc.x += cv * bv.x, acc.y += cv * bv.y, acc.z += cv * bv.z, acc.w += cv * bv.w;
      }
      *reinterpret_cast<float4*>(cb + r * L.cb_stride + r0 + 4 * col) = acc;
    }
  }

  for (int head = h0; head < h_end; ++head) {
    const int64_t slot = (bi * nc + c) * h + head;
    __syncthreads();  // C.B^T done, or the last head's G x done: S^T, pos free
    const __nv_bfloat16* src = planes + slot * (int64_t)(SP * N * P);
    for (int idx = threadIdx.x; idx < N * P / 2; idx += THREADS) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < SP; ++q) {
        const uint32_t u = reinterpret_cast<const uint32_t*>(src + q * N * P)[idx];
        s0 += tc_unpack_lo(u), s1 += tc_unpack_hi(u);
      }
      reinterpret_cast<float2*>(sT)[idx] = make_float2(s0, s1);
    }
    for (int idx = threadIdx.x; idx < lpad; idx += THREADS) ps[idx] = pos_g[slot * lpad + idx];
    __syncthreads();

    // exp(cum[t]) C[t] . S_{c-1}
    float acc[RM_MAX][4];
#pragma unroll
    for (int i = 0; i < RM_MAX; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 sv = reinterpret_cast<const float4*>(sT + n * P)[tp];
#pragma unroll
      for (int i = 0; i < RM_MAX; ++i) {
        if (i >= rm) break;
        const float cv = cs[(tr + TR * i) * L.cs_stride + n];
        acc[i][0] += cv * sv.x, acc[i][1] += cv * sv.y;
        acc[i][2] += cv * sv.z, acc[i][3] += cv * sv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < RM_MAX; ++i) {
      if (i >= rm) break;
      const float4 pt = ps[t0 + tr + TR * i];
      const float e = tc_exp2(pt.x + pt.y);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }

    // + G x over the s-tiles up to the tile's last row
    for (int st = 0; st < nsq; ++st) {
      const int r0 = st * stile, valid = valid_rows(r0, stile, chunk, c0, s_len);
      if (st > 0) __syncthreads();  // the last x and G tiles no longer read
      for (int idx = threadIdx.x; idx < stile * (P / 4); idx += THREADS) {
        const int r = idx / (P / 4), q = idx % (P / 4);
        reinterpret_cast<float4*>(xt)[idx] =
            r < valid ? *reinterpret_cast<const float4*>(x + bi * sd.xb + (c0 + r0 + r) * sd.xs +
                                                         head * P + 4 * q)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int idx = threadIdx.x; idx < qr * stile; idx += THREADS) {
        const int r = idx / stile, s = idx % stile, t = t0 + r, sa = r0 + s;
        const float4 pt = ps[t], pa = ps[sa];
        gt[r * L.gt_stride + s] =
            sa <= t ? cb[r * L.cb_stride + sa] * ssd_decay2(pt.x, pt.y, pa.x, pa.y) * pa.z : 0.0f;
      }
      __syncthreads();
      for (int k = 0; k < stile; ++k) {
        const float4 xv = reinterpret_cast<const float4*>(xt + k * P)[tp];
#pragma unroll
        for (int i = 0; i < RM_MAX; ++i) {
          if (i >= rm) break;
          const float gv = gt[(tr + TR * i) * L.gt_stride + k];
          acc[i][0] += gv * xv.x, acc[i][1] += gv * xv.y;
          acc[i][2] += gv * xv.z, acc[i][3] += gv * xv.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM_MAX; ++i) {
      if (i >= rm) break;
      const int t = t0 + tr + TR * i;
      if (t >= chunk || c0 + t >= s_len) continue;
      *reinterpret_cast<float4*>(y + ((bi * s_len + c0 + t) * h + head) * P + 4 * tp) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int P, int N>
int launch_cc(const void* x, const void* dt, const void* a, const void* b, const void* c,
              const void* init, void* y, void* fin, void* ds, void* last, void* planes,
              void* pos, const Strides& sd, int64_t bsz, int64_t s_len, int h, int chunk,
              cudaStream_t stream) {
  constexpr int SP = SSD_F32_PARTS;
  const int lpad = ssd_lpad(chunk), stile = cc_stile(lpad), qr = ssd_qrows(lpad, SP);
  const int64_t nc = (s_len + chunk - 1) / chunk;
  cudaError_t e;
  if (nc > 0) {
    const int bytes = 128 + (lpad + 3) / 4 * 16 + stile * (P + N) * 4;
    auto kern = ssd_state_cc_kernel<P, N>;
    if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
    kern<<<(unsigned)(bsz * nc * ((h + HG_STATE - 1) / HG_STATE)), THREADS, bytes, stream>>>(
        (const float*)x, (const float*)dt, (const float*)a, (const float*)b, (float*)ds,
        (float*)last, (float4*)pos, sd, s_len, h, chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int64_t quads = bsz * h * (N * P / 4);
  ssd_carry_kernel<P, N, SP><<<(unsigned)((quads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      (const float*)ds, (const float*)last, (const float*)init, (float*)fin,
      (__nv_bfloat16*)planes, bsz * h, nc, h);
  if ((e = cudaGetLastError()) != cudaSuccess || nc == 0) return (int)e;
  const int bytes = CcOutputSmem(P, N, lpad, qr, stile).total;
  auto kern = ssd_output_cc_kernel<P, N, SP>;
  if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
  kern<<<(unsigned)((lpad / qr) * bsz * nc * ((h + HG_OUTPUT - 1) / HG_OUTPUT)), THREADS, bytes,
         stream>>>((const float*)x, (const float*)b, (const float*)c,
                   (const __nv_bfloat16*)planes, (const float4*)pos, (float*)y, sd, s_len, h,
                   chunk);
  return (int)cudaGetLastError();
}

int dispatch_cc(int p, int n, const void* x, const void* dt, const void* a, const void* b,
                const void* c, const void* init, void* y, void* fin, void* ds, void* last,
                void* planes, void* pos, const Strides& sd, int64_t bsz, int64_t s_len, int h,
                int chunk, cudaStream_t s) {
#define CC_CASE(PP, NN)                                                                   \
  if (p == PP && n == NN)                                                                 \
    return launch_cc<PP, NN>(x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd, bsz, \
                             s_len, h, chunk, s);
  CC_CASE(32, 16) CC_CASE(32, 64) CC_CASE(32, 128)
  CC_CASE(64, 16) CC_CASE(64, 64) CC_CASE(64, 128)
#undef CC_CASE
  return (int)cudaErrorInvalidValue;
}
