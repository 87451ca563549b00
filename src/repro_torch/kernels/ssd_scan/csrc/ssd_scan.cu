// K6: Mamba2 SSD chunk scan with a carried (P, N) float32 state, CUDA for
// sm_90a, chunk-parallel on the tensor cores.
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
// bf16, dt, B, C, the final state) and needs ~35 GFLOP, 0.084 ms at the
// memory's rate.  A grid over (batch, head) that walks the chunks in order
// leaves the card to 256 blocks and scalar float32 products; here every
// chunk is independent work, in three passes (ssd_step.h):
//
//   A  ssd_state_kernel, grid (batch, chunk, group of 4 heads): the running
//      sum of dt * a as a block-wide scan, then the chunk's own state
//      dS^T = (w B)^T x on the tensor cores, with w B split into bf16
//      parts (the A operand, from ldmatrix.trans of the B tile); dS^T and
//      cum[L-1] go to a float32 scratch.  The running sum is added in
//      double (ssd_step.h): cum reaches -200 in a chunk of 256 at the
//      model's dt, where one float32 ulp is 1.5e-5 of every decay.
//   B  ssd_carry_kernel, one thread per 4 elements of a (batch, head)'s
//      state: S_c = exp(cum_c[L-1]) S_{c-1} + dS_c over the chunks, the next
//      chunk's dS loaded ahead, writing each chunk's starting state as bf16
//      planes (a scratch pass C copies with cp.async) and the final state.
//   C  ssd_output_kernel, grid (batch, chunk, group of 8 heads, query
//      tile), the query tiles of one chunk side by side (they read the
//      same x and S tiles, so those come from L2) and the heaviest first:
//      C.B^T for the tile's rows once (kept in shared memory as float32,
//      for every head of the group), then per head the state term
//      exp(cum[t]) C[t].S_{c-1} and the intra-chunk term G x with G =
//      (C.B^T) exp(cum[t] - cum[s]) dt[s] masked before the exponent, on
//      the diagonal's lower side only.  x tiles come through a two-stage
//      cp.async ring that runs on across heads, and the next head's S
//      planes are copied while this head's intra-chunk term runs; each
//      warp owns a 16-row strip.
//
// The state term is fused into pass C, so y is written once, in its
// dtype, from one float32 accumulator (a pass of its own, which needs y
// in float32 between the passes, is slower: tools/kernel_variants.py k6).
// Every product is mma.sync m16n8k16 bf16 -> float32 with the fragment
// maps, swizzle and ldmatrix addresses of tc_frag.h (shared with K5).  One
// bf16 rounding of a float32 operand (G, w B, S) costs up to 2^-9 of each
// term, so these go in as bf16 parts (ssd_step.h): hi + lo on the
// bfloat16 route, whose x, B and C are exact, holding them to about
// 2^-17; on the float32 route x, B and C are split too, in SSD_F32_PARTS
// parts a side (three: six products a pair, to about 2^-24; float32 FMAs
// on the CUDA cores in the same grid are slower, kernel_variants.py k6).
// The float32 route's tiles are 32 rows (query tiles of 32), to fit the
// extra planes.  Chunks longer than 256 take query tiles of 32 or 16 rows,
// so that a tile's C.B^T stays within 64 KB of shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_step.h"

namespace {

constexpr int THREADS = SSD_THREADS;
constexpr int WARPS = SSD_WARPS;
constexpr int HG_STATE = 4;   // heads a block of pass A
constexpr int HG_OUTPUT = 8;  // heads a block of pass C (each reuses the tile's C.B^T)
constexpr int SCAN_MAX = 8;   // positions a thread of the scan: lpad <= 1024
constexpr uint32_t FULL = 0xffffffffu;

// bf16 parts of the inputs x, B, C (NP) and of the split operands G, w B,
// S (SP), by input type.
template <typename T>
struct Parts;
template <>
struct Parts<__nv_bfloat16> {
  static constexpr int NP = 1, SP = 2;
};
template <>
struct Parts<float> {
  static constexpr int NP = SSD_F32_PARTS, SP = SSD_F32_PARTS;
};

// Rows [0, rows) of W values each, row r at base + r * stride, into the
// swizzled tile planes at `tile` (plane q at tile + q * rows * W); rows at
// or past `valid` are zero-filled.  bf16 (one plane): cp.async, 16 bytes a
// request.  float32: loaded, split into K planes (tc_split_parts), stored.
template <int W, int K>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int64_t stride, int rows, int valid) {
  static_assert(K == 1, "bf16 rows are one plane");
  constexpr int CPR = W / 8;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < valid;
    cp_async_16(smem_u32(tile + tc_smem_off(r, c * 8, W)), base + (ok ? r * stride : 0) + c * 8,
                ok);
  }
}

template <int W, int K>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const float* base, int64_t stride,
                                          int rows, int valid) {
  constexpr int CPR = W / 8;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    float v[8];
    if (r < valid) {
      const float4* src = reinterpret_cast<const float4*>(base + r * stride + c * 8);
      const float4 u0 = src[0], u1 = src[1];
      v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
      v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    uint32_t part[4][K];
#pragma unroll
    for (int j = 0; j < 4; ++j) tc_split_parts<K>(v[2 * j], v[2 * j + 1], part[j]);
    const int off = tc_smem_off(r, c * 8, W);
#pragma unroll
    for (int k = 0; k < K; ++k)
      *reinterpret_cast<uint4*>(tile + k * rows * W + off) =
          make_uint4(part[0][k], part[1][k], part[2][k], part[3][k]);
  }
}

// Rows that hold data among `rows` rows starting at chunk row r0: before
// the chunk's end and before S.
__device__ __forceinline__ int valid_rows(int r0, int rows, int chunk, int64_t c0,
                                          int64_t s_len) {
  int64_t v = chunk - r0;
  if (s_len - c0 - r0 < v) v = s_len - c0 - r0;
  return v < 0 ? 0 : (v > rows ? rows : (int)v);
}

// ldmatrix (.trans with TRANS) of the same fragment from each of K planes
// (plane q at tile + q * plane).
template <int K, bool TRANS>
__device__ __forceinline__ void ldm_planes(uint32_t r[K][4], const __nv_bfloat16* tile,
                                           int plane, int off) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (TRANS)
      ldmatrix_x4_trans(r[q], smem_u32(tile + q * plane + off));
    else
      ldmatrix_x4(r[q], smem_u32(tile + q * plane + off));
  }
}

// acc[0] and acc[1] += a times the two n-tiles of b (registers 0-1 and
// 2-3), over the pairs of parts ssd_pair_used takes.
template <int KA, int KB>
__device__ __forceinline__ void mma_pair(float (*acc)[4], const uint32_t a[KA][4],
                                         const uint32_t b[KB][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < KA; ++i)
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (ssd_pair_used(i, j, KA, KB))
          mma_bf16(acc[half], a[i], b[j][2 * half], b[j][2 * half + 1]);
}

// This thread's dt values of the block-wide scan (positions
// threadIdx.x * per + k), 0 past the chunk or S.
__device__ __forceinline__ void load_dt(float v[SCAN_MAX], const float* __restrict__ dt,
                                        int64_t bi, int64_t s_len, int h, int head, int64_t c0,
                                        int chunk, int per) {
#pragma unroll
  for (int k = 0; k < SCAN_MAX; ++k) {
    const int s = threadIdx.x * per + k;
    v[k] = (k < per && s < chunk && c0 + s < s_len) ? dt[(bi * s_len + c0 + s) * h + head] : 0.0f;
  }
}

// The running sum of dt * a over the padded chunk, added in double: each
// thread adds its `per` positions in order, the warps scan the threads'
// sums (ssd_scan_round), and the warps' sums meet in shared memory.
// Writes, per position, where asked: pass C's float4 (hi, lo, dt) of the
// sum times log2(e) (ssd_decay2), and pass A's state weights w[s] =
// exp(total - cum[s]) dt[s].  Returns the chunk's sum, cum[L-1].  Contains
// a __syncthreads; the caller syncs again before anyone reads what it
// wrote.
__device__ __forceinline__ double block_cumsum(const float v[SCAN_MAX], float av, int per,
                                               int lpad, float4* pos, float* w, double* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double c[SCAN_MAX];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < SCAN_MAX; ++k) {
    if (k < per) run += (double)(v[k] * av);
    c[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    incl = ssd_scan_round(incl, __shfl_up_sync(FULL, incl, off), lane, off);
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  double pre = 0.0, total = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pre += wsum[w];
    total += wsum[w];
  }
  pre += excl;
#pragma unroll
  for (int k = 0; k < SCAN_MAX; ++k) {
    const int s = threadIdx.x * per + k;
    if (k < per && s < lpad) {
      const double cs = pre + c[k];
      if (pos) {
        const double c2 = cs * (double)TC_LOG2E;
        const float hi = (float)c2;
        pos[s] = make_float4(hi, (float)(c2 - (double)hi), v[k], 0.0f);
      }
      if (w) w[s] = ssd_exp((float)(total - cs)) * v[k];
    }
  }
  return total;
}

// ------------------------------------------------------------------ pass A

// Strides (elements) of the inputs that need not be contiguous: x's batch
// and position (its head stride is P, its last dimension dense), and B's
// and C's batch and position (their last dimension dense).
struct Strides {
  int64_t xb, xs, bb, bs, cb, cs;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm, float* __restrict__ ds,
                 float* __restrict__ last, float4* __restrict__ pos, Strides sd, int64_t s_len,
                 int h, int chunk) {
  constexpr int NP = Parts<T>::NP, SP = Parts<T>::SP;
  constexpr int MT = N / 16;                     // 16-row m-tiles of dS^T (rows n)
  constexpr int MPW = (MT + WARPS - 1) / WARPS;  // m-tiles a warp
  constexpr int NT = P / 8;                      // n-tiles (columns p)
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = ssd_lpad(chunk), stile = ssd_stile(lpad, NP), ns = lpad / stile;
  const int per = ssd_scan_per_thread(lpad);
  const SsdStateSmem L(P, N, NP, lpad);
  float* w = reinterpret_cast<float*>(smem + L.w);
  double* wsum = reinterpret_cast<double*>(smem + L.wsum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int groups = (h + HG_STATE - 1) / HG_STATE;
  const int g = blockIdx.x % groups;
  const int64_t bc = blockIdx.x / groups, bi = bc / nc, c = bc % nc, c0 = c * chunk;
  const int h_end = (g + 1) * HG_STATE < h ? (g + 1) * HG_STATE : h;

  auto xtile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + (st & 1) * L.ring_stage);
  };
  auto btile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + (st & 1) * L.ring_stage + L.x_tile);
  };
  auto load_stage = [&](int head, int st) {
    const int r0 = st * stile, valid = valid_rows(r0, stile, chunk, c0, s_len);
    load_rows<P, NP>(xtile(st), x + bi * sd.xb + (c0 + r0) * sd.xs + head * P, sd.xs, stile,
                     valid);
    load_rows<N, NP>(btile(st), bm + bi * sd.bb + (c0 + r0) * sd.bs, sd.bs, stile, valid);
  };

  float v[SCAN_MAX];
  load_dt(v, dt, bi, s_len, h, g * HG_STATE, c0, chunk, per);
  for (int head = g * HG_STATE; head < h_end; ++head) {
    const int64_t slot = (bi * nc + c) * h + head;
    const double total = block_cumsum(v, a[head], per, lpad, pos + slot * lpad, w, wsum);
    load_stage(head, 0);
    cp_async_commit();
    if (head + 1 < h_end) load_dt(v, dt, bi, s_len, h, head + 1, c0, chunk, per);
    float acc[MPW][NT][4];
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

    for (int st = 0; st < ns; ++st) {
      cp_async_wait_all();
      __syncthreads();  // tile st (and w) visible; stage st + 1 no longer read
      if (st + 1 < ns) load_stage(head, st + 1);
      cp_async_commit();
      const __nv_bfloat16* xs = xtile(st);
      const __nv_bfloat16* bs = btile(st);
      for (int kk = 0; kk < stile / 16; ++kk) {
        const int s0 = st * stile + 16 * kk;
#pragma unroll
        for (int m = 0; m < MPW; ++m) {
          const int mt = warp + WARPS * m;
          if (mt >= MT) continue;
          int r, col;
          uint32_t bp[NP][4], wb[SP][4];
          tc_ldm_at(lane, 16 * mt, kk, &r, &col);
          ldm_planes<NP, true>(bp, bs, stile * N, tc_smem_off(r, col, N));
          ssd_wb_fragment<NP, SP>(lane, bp, s0, w, wb);
#pragma unroll
          for (int dp = 0; dp < NT / 2; ++dp) {
            uint32_t xb[NP][4];
            tc_ldm_bt(lane, kk, dp, &r, &col);
            ldm_planes<NP, true>(xb, xs, stile * P, tc_smem_off(r, col, P));
            mma_pair<SP, NP>(acc[m] + 2 * dp, wb, xb);
          }
        }
      }
    }
    float* out = ds + slot * (int64_t)(N * P);
#pragma unroll
    for (int m = 0; m < MPW; ++m) {
      const int mt = warp + WARPS * m;
      if (mt >= MT) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = 16 * mt + tc_c_row(lane, 2 * hf), p = 8 * j + tc_c_col(lane, 0);
          *reinterpret_cast<float2*>(out + n * P + p) =
              make_float2(acc[m][j][2 * hf], acc[m][j][2 * hf + 1]);
        }
    }
    if (threadIdx.x == 0) last[slot] = (float)total;
  }
}

// ------------------------------------------------------------------ pass B

// One thread per 4 neighbouring elements (n, p .. p + 3) of one (batch,
// head)'s state, walking the chunks with the next chunk's dS loaded ahead:
// it writes each chunk's starting state S_{c-1}^T as SP bf16 planes (8
// bytes a plane) and the final state.
template <int P, int N, int SP>
__global__ void __launch_bounds__(THREADS)
ssd_carry_kernel(const float* __restrict__ ds, const float* __restrict__ last,
                 const float* __restrict__ init, float* __restrict__ fin,
                 __nv_bfloat16* __restrict__ planes, int64_t bh_count, int64_t nc, int h) {
  constexpr int Q = N * P / 4;  // quads of a state
  const int64_t gid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (gid >= bh_count * Q) return;
  const int64_t bh = gid / Q, bi = bh / h, head = bh % h;
  const int e0 = 4 * (int)(gid % Q), n = e0 / P, p0 = e0 % P;
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = init ? init[(bh * P + p0 + j) * N + n] : 0.0f;
  auto dsq = [&](int64_t c) {
    return *reinterpret_cast<const float4*>(ds + ((bi * nc + c) * h + head) * (int64_t)(N * P) + e0);
  };
  float4 d = nc > 0 ? dsq(0) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t c = 0; c < nc; ++c) {
    const float4 dn = c + 1 < nc ? dsq(c + 1) : d;
    uint32_t lo2[SP], hi2[SP];
    tc_split_parts<SP>(s[0], s[1], lo2);
    tc_split_parts<SP>(s[2], s[3], hi2);
    __nv_bfloat16* out = planes + ((bi * nc + c) * h + head) * (int64_t)(SP * N * P) + e0;
#pragma unroll
    for (int q = 0; q < SP; ++q)
      *reinterpret_cast<uint2*>(out + q * N * P) = make_uint2(lo2[q], hi2[q]);
    const float seg = expf(last[(bi * nc + c) * h + head]);
    s[0] = ssd_carry(s[0], seg, d.x);
    s[1] = ssd_carry(s[1], seg, d.y);
    s[2] = ssd_carry(s[2], seg, d.z);
    s[3] = ssd_carry(s[3], seg, d.w);
    d = dn;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) fin[(bh * P + p0 + j) * N + n] = s[j];
}

// ------------------------------------------------------------------ pass C

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                  const __nv_bfloat16* __restrict__ planes, const float4* __restrict__ pos_g,
                  T* __restrict__ y, Strides sd, int64_t s_len, int h, int chunk) {
  constexpr int NP = Parts<T>::NP, SP = Parts<T>::SP;
  constexpr int NT = P / 8;
  constexpr int KN = N / 16;  // k-steps over the state dimension
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = ssd_lpad(chunk), stile = ssd_stile(lpad, NP), qr = ssd_qrows(lpad, NP);
  const int nq = lpad / qr;
  const SsdOutputSmem L(P, N, NP, SP, lpad);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cs);
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(smem + L.ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nc = (s_len + chunk - 1) / chunk;
  const int groups = (h + HG_OUTPUT - 1) / HG_OUTPUT;
  // query tiles fastest, the heaviest (it reaches the most s) first
  int64_t idx = blockIdx.x;
  const int qi = nq - 1 - (int)(idx % nq);
  idx /= nq;
  const int g = (int)(idx % groups);
  idx /= groups;
  const int64_t c = idx % nc, bi = idx / nc, c0 = c * chunk;
  const int t0 = qi * qr, r0 = 16 * warp;
  const bool active = r0 < qr;      // warps beyond the tile's strips only load
  const int t_last = t0 + r0 + 15;  // the strip's last row
  const int s_end = t0 + qr < lpad ? t0 + qr : lpad;
  const int nsq = (s_end + stile - 1) / stile;
  const int h0 = g * HG_OUTPUT, h_end = h0 + HG_OUTPUT < h ? h0 + HG_OUTPUT : h;
  auto stage = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.ring + (st & 1) * L.ring_stage);
  };
  auto pos = [&](int head) {
    return reinterpret_cast<float4*>(smem + L.pos + ((head - h0) & 1) * L.pos_stage);
  };

  // The tile's C rows and B s-tile 0, then C.B^T tile by tile.
  load_rows<N, NP>(cs, cm + bi * sd.cb + (c0 + t0) * sd.cs, sd.cs, qr,
                   valid_rows(t0, qr, chunk, c0, s_len));
  load_rows<N, NP>(stage(0), bm + bi * sd.bb + c0 * sd.bs, sd.bs, stile,
                   valid_rows(0, stile, chunk, c0, s_len));
  cp_async_commit();
  for (int st = 0; st < nsq; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsq)
      load_rows<N, NP>(stage(st + 1), bm + bi * sd.bb + (c0 + (st + 1) * stile) * sd.bs, sd.bs,
                       stile, valid_rows((st + 1) * stile, stile, chunk, c0, s_len));
    cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* bs = stage(st);
    for (int np = 0; np < stile / 16; ++np) {
      const int s_first = st * stile + 16 * np;
      if (s_first > t_last) break;  // wholly above the strip's diagonal
      float acc2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        int r, col;
        uint32_t ca[NP][4], bb[NP][4];
        tc_ldm_a(lane, r0, kk, &r, &col);
        ldm_planes<NP, false>(ca, cs, qr * N, tc_smem_off(r, col, N));
        tc_ldm_b(lane, np, kk, &r, &col);
        ldm_planes<NP, false>(bb, bs, stile * N, tc_smem_off(r, col, N));
        mma_pair<NP, NP>(acc2, ca, bb);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + tc_c_row(lane, 2 * hf);
          const int s = s_first + 8 * half + tc_c_col(lane, 0);
          *reinterpret_cast<float2*>(cb + row * L.cb_stride + s) =
              make_float2(acc2[half][2 * hf], acc2[half][2 * hf + 1]);
        }
    }
  }

  // The heads, their s-tiles flattened into one ring: each step issues the
  // next step's x tile, across head boundaries.  A head's per-position
  // float4s (written by pass A) go into its own half of `pos`, copied
  // while the head before runs.  Its S planes go into `ss` once every warp
  // is past the state term of the head before: at that head's second
  // step, or, where it has one step only, after a barrier at this head's
  // start.
  auto x_tile = [&](int head, int st) {
    load_rows<P, NP>(stage(nsq * (head - h0) + st),
                     x + bi * sd.xb + (c0 + st * stile) * sd.xs + head * P, sd.xs, stile,
                     valid_rows(st * stile, stile, chunk, c0, s_len));
  };
  auto s_planes = [&](int head) {
    const __nv_bfloat16* src = planes + ((bi * nc + c) * h + head) * (int64_t)(SP * N * P);
#pragma unroll
    for (int q = 0; q < SP; ++q) load_rows<P, 1>(ss + q * N * P, src + q * N * P, P, N, N);
  };
  auto pos_rows = [&](int head) {  // lpad float4s as 16-byte rows of one chunk
    load_rows<8, 1>(reinterpret_cast<__nv_bfloat16*>(pos(head)),
                    reinterpret_cast<const __nv_bfloat16*>(pos_g + ((bi * nc + c) * h + head) * lpad),
                    8, lpad, lpad);
  };
  __syncthreads();  // every warp is past C.B^T: the ring is free
  x_tile(h0, 0);
  s_planes(h0);
  pos_rows(h0);
  cp_async_commit();
  bool s_issued = true;
  for (int head = h0; head < h_end; ++head) {
    if (!s_issued) {
      __syncthreads();  // every warp is past the last head's state term
      s_planes(head);
      cp_async_commit();
    }
    s_issued = false;
    const float4* ph = pos(head);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

    for (int st = 0; st < nsq; ++st) {
      cp_async_wait_all();
      __syncthreads();  // this step's x tile, S and pos visible; the other stages free
      if (st + 1 < nsq)
        x_tile(head, st + 1);
      else if (head + 1 < h_end)
        x_tile(head + 1, 0);
      if (st == 0 && head + 1 < h_end) pos_rows(head + 1);
      if (st == 1 && head + 1 < h_end) {
        s_planes(head + 1);  // every warp is past this head's state term
        s_issued = true;
      }
      cp_async_commit();
      if (!active) continue;
      if (st == 0) {
        // exp(cum[t]) C[t] . S_{c-1}
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
        float e[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float4 pt = ph[t0 + r0 + tc_c_row(lane, 2 * hf)];
          e[hf] = tc_exp2(pt.x + pt.y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] *= e[i / 2];
      }
      // + G x over this s-tile, up to the strip's diagonal
      const __nv_bfloat16* xs = stage(nsq * (head - h0) + st);
      for (int kk = 0; kk < stile / 16; ++kk) {
        const int s0 = st * stile + 16 * kk;
        if (s0 > t_last) break;
        uint32_t gf[SP][4];
        ssd_g_fragment<SP>(lane, cb, L.cb_stride, r0, t0, s0, ph, gf);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          int r, col;
          uint32_t xb[NP][4];
          tc_ldm_bt(lane, kk, dp, &r, &col);
          ldm_planes<NP, true>(xb, xs, stile * P, tc_smem_off(r, col, P));
          mma_pair<SP, NP>(acc + 2 * dp, gf, xb);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + r0 + tc_c_row(lane, 2 * hf);
        if (t >= chunk || c0 + t >= s_len) continue;
        T* yrow = y + ((bi * s_len + c0 + t) * h + head) * P;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int p = 8 * j + tc_c_col(lane, 0);
          if constexpr (NP == 1)
            *reinterpret_cast<uint32_t*>(yrow + p) = tc_pack_round(acc[j][2 * hf], acc[j][2 * hf + 1]);
          else
            *reinterpret_cast<float2*>(yrow + p) = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* init, void* y, void* fin, void* ds, void* last, void* planes, void* pos,
           const Strides& sd, int64_t bsz, int64_t s_len, int h, int chunk, cudaStream_t stream) {
  constexpr int NP = Parts<T>::NP, SP = Parts<T>::SP;
  const int lpad = ssd_lpad(chunk);
  const int64_t nc = (s_len + chunk - 1) / chunk;
  cudaError_t e;
  if (nc > 0) {
    const int bytes = SsdStateSmem(P, N, NP, lpad).total;
    auto kern = ssd_state_kernel<T, P, N>;
    if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
    const int64_t grid = bsz * nc * ((h + HG_STATE - 1) / HG_STATE);
    kern<<<(unsigned)grid, THREADS, bytes, stream>>>((const T*)x, (const float*)dt,
                                                     (const float*)a, (const T*)b, (float*)ds,
                                                     (float*)last, (float4*)pos, sd, s_len, h,
                                                     chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int64_t quads = bsz * h * (N * P / 4);
  ssd_carry_kernel<P, N, SP><<<(unsigned)((quads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      (const float*)ds, (const float*)last, (const float*)init, (float*)fin,
      (__nv_bfloat16*)planes, bsz * h, nc, h);
  if ((e = cudaGetLastError()) != cudaSuccess || nc == 0) return (int)e;
  const int bytes = SsdOutputSmem(P, N, NP, SP, lpad).total;
  auto kern = ssd_output_kernel<T, P, N>;
  if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
  const int64_t grid = (lpad / ssd_qrows(lpad, NP)) * bsz * nc * ((h + HG_OUTPUT - 1) / HG_OUTPUT);
  kern<<<(unsigned)grid, THREADS, bytes, stream>>>((const T*)x, (const T*)b, (const T*)c,
                                                   (const __nv_bfloat16*)planes,
                                                   (const float4*)pos, (T*)y, sd, s_len, h, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int p, int n, const void* x, const void* dt, const void* a, const void* b,
             const void* c, const void* init, void* y, void* fin, void* ds, void* last,
             void* planes, void* pos, const Strides& sd, int64_t bsz, int64_t s_len, int h,
             int chunk, cudaStream_t s) {
#define SSD_CASE(PP, NN)                                                                    \
  if (p == PP && n == NN)                                                                   \
    return launch<T, PP, NN>(x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd, bsz,  \
                             s_len, h, chunk, s);
  SSD_CASE(32, 16) SSD_CASE(32, 64) SSD_CASE(32, 128)
  SSD_CASE(64, 16) SSD_CASE(64, 64) SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 planes of each chunk's starting state in the `planes` scratch.
extern "C" int ssd_scan_state_parts(int is_bf16) { return ssd_op_parts(is_bf16); }

// Supported: p in {32, 64}, n in {16, 64, 128}, chunk <= 64 or a multiple
// of 64 (then at most 1024); init may be null (a zero state).  x may have
// any batch and position strides (xb, xs; its head stride is p and its
// last dimension dense), b and c any batch and position strides (their
// last dimension dense), all multiples of 16 bytes.  Scratch: ds float32
// (B, ceil(S / chunk), H, N, P), last float32 (B, ceil(S / chunk), H),
// planes bf16 (B, ceil(S / chunk), H, ssd_scan_state_parts, N, P), pos
// float32 (B, ceil(S / chunk), H, ssd_lpad(chunk), 4); x, b, c, y, ds,
// planes and pos 16-byte aligned.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* init, void* y, void* fin, void* ds,
                               void* last, void* planes, void* pos, int64_t xb, int64_t xs,
                               int64_t bb, int64_t bs, int64_t cb, int64_t cs, int64_t bsz,
                               int64_t s_len, int h, int p, int n, int chunk, int is_bf16,
                               void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk > 1024 || (chunk > 64 && chunk % 64 != 0))
    return (int)cudaErrorInvalidValue;
  const int64_t unit = is_bf16 ? 8 : 4;  // elements a 16-byte unit
  if (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)y | (uintptr_t)ds |
       (uintptr_t)planes | (uintptr_t)pos) % 16 ||
      (xb | xs | bb | bs | cb | cs) % unit)
    return (int)cudaErrorMisalignedAddress;
  const Strides sd{xb, xs, bb, bs, cb, cs};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(p, n, x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd,
                                   bsz, s_len, h, chunk, s);
  return dispatch<float>(p, n, x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd, bsz,
                         s_len, h, chunk, s);
}
