// Host harness of ssd_step.h, for the CPU tests only.
//
// host_ssd_scan: walks the (batch, head) x chunk order of the serial chunk
// step (tools/kernel_variants_csrc/ssd_serial_step.h, the block-per-head
// design's), with the zero padding past S, so a g++ build checks the scan's
// formulas (the masked-before-exponent decay, the state
// weights, the carried state) against the plain PyTorch versions and the
// JAX package.
//
// host_ssd_scan_tc: the three passes of ssd_scan.cu, each warp's 32 lanes
// emulated on the host: the block-wide running sum (threads' sums, warp
// scans by ssd_scan_round, warp sums), the tiles as shared-memory images
// with tc_smem_off's swizzle (float32 inputs as bf16 hi and lo planes),
// ldmatrix from the lanes' row addresses (tc_ldm_*), each mma.sync as a
// loop over the PTX fragment layout (tc_emulate.h), and the header's
// fragment builders (ssd_g_fragment, ssd_wb_fragment), the carry and the
// hi / lo split of the state.  With split = 0, the lo parts of G, w B and
// S are dropped (one bf16 rounding), for the tests that show what the
// split is for.
//
// Inputs and outputs are float32 in the model layout: x and y (B, S, H, P),
// dt (B, S, H), a (H), b and c (B, S, N), the states (B, H, P, N); with
// parts = 1 (bfloat16 inputs) x, b and c hold bfloat16 values and y comes
// back rounded to bfloat16.  The port itself never loads this build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I ../../csrc \
//       -I ../../../../../tools/kernel_variants_csrc -o libssd_host.so host_step_test.cpp
#include <vector>

#include "ssd_serial_step.h"
#include "ssd_step.h"
#include "tc_emulate.h"

extern "C" int host_ssd_scan(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* state, int64_t bsz, int64_t s_len, int h,
                             int p, int n, int chunk) {
  if (chunk <= 0) return 1;
  std::vector<float> xc(chunk * p), dtc(chunk), bc(chunk * n), cc(chunk * n),
      yc(chunk * p), cum(chunk);
  for (int64_t bi = 0; bi < bsz; ++bi)
    for (int hi = 0; hi < h; ++hi) {
      float* st = state + (bi * h + hi) * p * n;
      for (int64_t c0 = 0; c0 < s_len; c0 += chunk) {
        for (int t = 0; t < chunk; ++t) {
          const int64_t pos = c0 + t;
          const bool in = pos < s_len;
          dtc[t] = in ? dt[(bi * s_len + pos) * h + hi] : 0.0f;
          for (int pi = 0; pi < p; ++pi)
            xc[t * p + pi] = in ? x[((bi * s_len + pos) * h + hi) * p + pi] : 0.0f;
          for (int ni = 0; ni < n; ++ni) {
            bc[t * n + ni] = in ? b[(bi * s_len + pos) * n + ni] : 0.0f;
            cc[t * n + ni] = in ? c[(bi * s_len + pos) * n + ni] : 0.0f;
          }
        }
        ssd_chunk_serial(xc.data(), p, dtc.data(), a[hi], bc.data(), cc.data(),
                         chunk, p, n, st, yc.data(), p, cum.data());
        for (int t = 0; t < chunk && c0 + t < s_len; ++t)
          for (int pi = 0; pi < p; ++pi)
            y[((bi * s_len + c0 + t) * h + hi) * p + pi] = yc[t * p + pi];
      }
    }
  return 0;
}

namespace {

typedef float Frag[32][4][2];  // a warp's x4 fragment: [lane][register][half]
typedef float Acc[32][4];      // a warp's m16n8 accumulator
constexpr int kMaxParts = 3;

struct Geometry {
  int64_t bsz, s_len, nc;
  int h, p, n, chunk, lpad, stile, qr, per, np, sp, split;
};

int valid_rows(int r0, int rows, int chunk, int64_t c0, int64_t s_len) {
  int64_t v = chunk - r0;
  if (s_len - c0 - r0 < v) v = s_len - c0 - r0;
  return v < 0 ? 0 : (v > rows ? rows : (int)v);
}

// x as k bf16 parts (tc_split_parts's rule), into part[0 .. k-1].
void split_parts(float x, int k, float* part) {
  for (int q = 0; q < k; ++q) {
    part[q] = tc_round_bf16(x);
    x -= part[q];
  }
}

// ssd_scan.cu's load_rows: `rows` rows of `width` values into the tile's
// `parts` planes (plane q at q * rows * width), swizzled.
std::vector<float> tile_image(const float* base, int64_t stride, int rows, int valid, int width,
                              int parts) {
  std::vector<float> img(parts * rows * width, 0.0f);
  for (int r = 0; r < valid; ++r)
    for (int col = 0; col < width; ++col) {
      float part[kMaxParts];
      split_parts(base[r * stride + col], parts, part);
      for (int q = 0; q < parts; ++q) img[q * rows * width + tc_smem_off(r, col, width)] = part[q];
    }
  return img;
}

// ssd_scan.cu's load_dt and block_cumsum for the block's SSD_THREADS
// threads: where asked, pass C's per-position float4s (ssd_decay2) and
// pass A's state weights w; returns the sum.
double block_cumsum(const Geometry& g, const float* dt, int64_t bi, int head, int64_t c0,
                    float av, std::vector<float4>* pos, std::vector<float>* w) {
  double run[SSD_THREADS], c[SSD_THREADS][8];
  float v[SSD_THREADS][8];
  for (int th = 0; th < SSD_THREADS; ++th) {
    run[th] = 0.0;
    for (int k = 0; k < g.per; ++k) {
      const int s = th * g.per + k;
      v[th][k] = (s < g.chunk && c0 + s < g.s_len) ? dt[(bi * g.s_len + c0 + s) * g.h + head] : 0.0f;
      run[th] += (double)(v[th][k] * av);
      c[th][k] = run[th];
    }
  }
  double incl[SSD_THREADS], wsum[SSD_WARPS];
  for (int th = 0; th < SSD_THREADS; ++th) incl[th] = run[th];
  for (int off = 1; off < 32; off <<= 1) {  // __shfl_up_sync rounds
    double prev[SSD_THREADS];
    for (int th = 0; th < SSD_THREADS; ++th) prev[th] = incl[th];
    for (int th = 0; th < SSD_THREADS; ++th) {
      const int lane = th % 32;
      incl[th] = ssd_scan_round(prev[th], lane >= off ? prev[th - off] : prev[th], lane, off);
    }
  }
  for (int wp = 0; wp < SSD_WARPS; ++wp) wsum[wp] = incl[32 * wp + 31];
  double total = 0.0;
  for (int wp = 0; wp < SSD_WARPS; ++wp) total += wsum[wp];
  for (int th = 0; th < SSD_THREADS; ++th) {
    const int lane = th % 32, warp = th / 32;
    double pre = 0.0;
    for (int wp = 0; wp < warp; ++wp) pre += wsum[wp];
    pre += lane == 0 ? 0.0 : incl[th - 1];
    for (int k = 0; k < g.per; ++k) {
      const int s = th * g.per + k;
      if (s < g.lpad) {
        const double cs = pre + c[th][k];
        if (pos) {
          const double c2 = cs * (double)TC_LOG2E;
          const float hi = (float)c2;
          (*pos)[s] = float4{hi, (float)(c2 - (double)hi), v[th][k], 0.0f};
        }
        if (w) (*w)[s] = ssd_exp((float)(total - cs)) * v[th][k];
      }
    }
  }
  return total;
}

// Fragments of k parts: the same ldmatrix from each of a tile's planes.
template <typename Addr>
void ldm_planes(const std::vector<float>& img, int plane, int k, int width, bool trans, Addr addr,
                Frag* out) {
  for (int q = 0; q < k; ++q) tce_ldmatrix_x4(img.data() + q * plane, width, trans, addr, out[q]);
}

// acc[0] and acc[1] += a times the two n-tiles of b, over the pairs of
// parts ssd_pair_used takes (ssd_scan.cu's mma_pair); `keep_a` / `keep_b`
// parts of the split operand a or b (the others dropped, for split = 0).
void mma_pair(Acc* acc, const Frag* a, int ka, const Frag* b, int kb, int keep_a, int keep_b) {
  for (int half = 0; half < 2; ++half)
    for (int i = 0; i < ka; ++i)
      for (int j = 0; j < kb; ++j) {
        if (!ssd_pair_used(i, j, ka, kb) || i >= keep_a || j >= keep_b) continue;
        float bh[32][2][2];
        tce_b_half(b[j], half, bh);
        tce_mma(acc[half], a[i], bh);
      }
}

void zero(std::vector<Acc>& acc) {
  for (auto& t : acc)
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) t[l][i] = 0.0f;
}

// Pass A for one (batch, chunk, head): dS^T (N x P), the per-position
// float4s (into pos) and cum[L-1].
float pass_state(const Geometry& g, const float* x, const float* dt, const float* a,
                 const float* bm, int64_t bi, int64_t ci, int head, float* ds,
                 std::vector<float4>& pos) {
  const int64_t c0 = ci * g.chunk;
  std::vector<float> w(g.lpad);
  const double total = block_cumsum(g, dt, bi, head, c0, a[head], &pos, &w);
  const int mt_n = g.n / 16, nt = g.p / 8, keep = g.split ? g.sp : 1;
  std::vector<Acc> acc(mt_n * nt);
  zero(acc);
  for (int st = 0; st < g.lpad / g.stile; ++st) {
    const int r0 = st * g.stile, valid = valid_rows(r0, g.stile, g.chunk, c0, g.s_len);
    const std::vector<float> xs = tile_image(x + ((bi * g.s_len + c0 + r0) * g.h + head) * g.p,
                                             (int64_t)g.h * g.p, g.stile, valid, g.p, g.np);
    const std::vector<float> bs = tile_image(bm + (bi * g.s_len + c0 + r0) * g.n, g.n, g.stile,
                                             valid, g.n, g.np);
    for (int kk = 0; kk < g.stile / 16; ++kk) {
      const int s0 = r0 + 16 * kk;
      for (int mt = 0; mt < mt_n; ++mt) {
        Frag bp[kMaxParts], wb[kMaxParts];
        ldm_planes(bs, g.stile * g.n, g.np, g.n, true,
                   [&](int l, int* r, int* col) { tc_ldm_at(l, 16 * mt, kk, r, col); }, bp);
        uint32_t regs[32][kMaxParts][4], out[32][kMaxParts][4];
        for (int l = 0; l < 32; ++l)
          for (int q = 0; q < g.np; ++q)
            for (int i = 0; i < 4; ++i) regs[l][q][i] = tc_pack_bf16x2(bp[q][l][i][0], bp[q][l][i][1]);
        for (int l = 0; l < 32; ++l) {
          if (g.np == 1 && g.sp == 2) ssd_wb_fragment<1, 2>(l, regs[l], s0, w.data(), out[l]);
          else if (g.np == 2) ssd_wb_fragment<2, 2>(l, regs[l], s0, w.data(), out[l]);
          else ssd_wb_fragment<3, 3>(l, regs[l], s0, w.data(), out[l]);
        }
        for (int q = 0; q < g.sp; ++q)
          for (int l = 0; l < 32; ++l) tce_unpack(out[l][q], wb[q][l]);
        for (int dp = 0; dp < nt / 2; ++dp) {
          Frag xb[kMaxParts];
          ldm_planes(xs, g.stile * g.p, g.np, g.p, true,
                     [&](int l, int* r, int* col) { tc_ldm_bt(l, kk, dp, r, col); }, xb);
          mma_pair(&acc[mt * nt + 2 * dp], wb, g.sp, xb, g.np, keep, kMaxParts);
        }
      }
    }
  }
  for (int mt = 0; mt < mt_n; ++mt)
    for (int j = 0; j < nt; ++j)
      for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i)
          ds[(16 * mt + tc_c_row(l, i)) * g.p + 8 * j + tc_c_col(l, i)] = acc[mt * nt + j][l][i];
  return (float)total;
}

// Pass C for one (batch, chunk, query tile) and its heads: y.  `sprev`
// holds each (batch, chunk, head)'s starting state S^T (N x P), `pos` its
// per-position float4s from pass A.
void pass_output(const Geometry& g, const float* x, const float* bm, const float* cm,
                 const std::vector<float>& sprev, const std::vector<std::vector<float4>>& pos,
                 float* y, int64_t bi, int64_t ci, int qi) {
  const int64_t c0 = ci * g.chunk;
  const int t0 = qi * g.qr, strips = g.qr / 16, nt = g.p / 8, kn = g.n / 16;
  const int s_end = t0 + g.qr < g.lpad ? t0 + g.qr : g.lpad;
  const int nsq = (s_end + g.stile - 1) / g.stile;
  const int stride = g.lpad + 4, keep = g.split ? g.sp : 1;
  const std::vector<float> cs =
      tile_image(cm + (bi * g.s_len + c0 + t0) * g.n, g.n, g.qr,
                 valid_rows(t0, g.qr, g.chunk, c0, g.s_len), g.n, g.np);
  std::vector<float> cb(g.qr * stride, 0.0f);
  for (int st = 0; st < nsq; ++st) {
    const std::vector<float> bs =
        tile_image(bm + (bi * g.s_len + c0 + st * g.stile) * g.n, g.n, g.stile,
                   valid_rows(st * g.stile, g.stile, g.chunk, c0, g.s_len), g.n, g.np);
    for (int w = 0; w < strips; ++w) {
      const int r0 = 16 * w, t_last = t0 + r0 + 15;
      for (int np = 0; np < g.stile / 16; ++np) {
        const int s_first = st * g.stile + 16 * np;
        if (s_first > t_last) break;
        std::vector<Acc> acc2(2);
        zero(acc2);
        for (int kk = 0; kk < kn; ++kk) {
          Frag ca[kMaxParts], bb[kMaxParts];
          ldm_planes(cs, g.qr * g.n, g.np, g.n, false,
                     [&](int l, int* r, int* col) { tc_ldm_a(l, r0, kk, r, col); }, ca);
          ldm_planes(bs, g.stile * g.n, g.np, g.n, false,
                     [&](int l, int* r, int* col) { tc_ldm_b(l, np, kk, r, col); }, bb);
          mma_pair(acc2.data(), ca, g.np, bb, g.np, kMaxParts, kMaxParts);
        }
        for (int half = 0; half < 2; ++half)
          for (int l = 0; l < 32; ++l)
            for (int i = 0; i < 4; ++i)
              cb[(r0 + tc_c_row(l, i)) * stride + s_first + 8 * half + tc_c_col(l, i)] =
                  acc2[half][l][i];
      }
    }
  }
  for (int head = 0; head < g.h; ++head) {
    const std::vector<float4>& ph = pos[(bi * g.nc + ci) * g.h + head];
    const float* slot = sprev.data() + ((bi * g.nc + ci) * g.h + head) * g.n * g.p;
    const std::vector<float> ss = tile_image(slot, g.p, g.n, g.n, g.p, g.sp);
    for (int w = 0; w < strips; ++w) {
      const int r0 = 16 * w, t_last = t0 + r0 + 15;
      std::vector<Acc> acc(nt);
      zero(acc);
      for (int kk = 0; kk < kn; ++kk) {
        Frag ca[kMaxParts];
        ldm_planes(cs, g.qr * g.n, g.np, g.n, false,
                   [&](int l, int* r, int* col) { tc_ldm_a(l, r0, kk, r, col); }, ca);
        for (int dp = 0; dp < nt / 2; ++dp) {
          Frag sb[kMaxParts];
          ldm_planes(ss, g.n * g.p, g.sp, g.p, true,
                     [&](int l, int* r, int* col) { tc_ldm_bt(l, kk, dp, r, col); }, sb);
          mma_pair(&acc[2 * dp], ca, g.np, sb, g.sp, kMaxParts, keep);
        }
      }
      for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
          const float4 pt = ph[t0 + r0 + tc_c_row(l, i)];
          const float e = tc_exp2(pt.x + pt.y);
          for (int j = 0; j < nt; ++j) acc[j][l][i] *= e;
        }
      for (int st = 0; st < nsq; ++st) {
        const int rs = st * g.stile;
        const std::vector<float> xs =
            tile_image(x + ((bi * g.s_len + c0 + rs) * g.h + head) * g.p, (int64_t)g.h * g.p,
                       g.stile, valid_rows(rs, g.stile, g.chunk, c0, g.s_len), g.p, g.np);
        for (int kk = 0; kk < g.stile / 16; ++kk) {
          const int s0 = rs + 16 * kk;
          if (s0 > t_last) break;
          uint32_t gr[32][kMaxParts][4];
          for (int l = 0; l < 32; ++l) {
            if (g.sp == 2)
              ssd_g_fragment<2>(l, cb.data(), stride, r0, t0, s0, ph.data(), gr[l]);
            else
              ssd_g_fragment<3>(l, cb.data(), stride, r0, t0, s0, ph.data(), gr[l]);
          }
          Frag gf[kMaxParts];
          for (int q = 0; q < g.sp; ++q)
            for (int l = 0; l < 32; ++l) tce_unpack(gr[l][q], gf[q][l]);
          for (int dp = 0; dp < nt / 2; ++dp) {
            Frag xb[kMaxParts];
            ldm_planes(xs, g.stile * g.p, g.np, g.p, true,
                       [&](int l, int* r, int* col) { tc_ldm_bt(l, kk, dp, r, col); }, xb);
            mma_pair(&acc[2 * dp], gf, g.sp, xb, g.np, keep, kMaxParts);
          }
        }
      }
      for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + r0 + tc_c_row(l, i);
          if (t >= g.chunk || c0 + t >= g.s_len) continue;
          for (int j = 0; j < nt; ++j) {
            const float v = acc[j][l][i];
            y[((bi * g.s_len + c0 + t) * g.h + head) * g.p + 8 * j + tc_c_col(l, i)] =
                g.np == 1 ? tc_round_bf16(v) : v;
          }
        }
    }
  }
}

}  // namespace

// The three passes of ssd_scan.cu, emulated.  init may be null; parts is
// the bf16 parts of a float32 input and of a split operand on the float32
// route (SSD_F32_PARTS on the card; 2 or 3 here), 1 for bfloat16 inputs.
// Returns 0, or 1 on an unsupported argument.
extern "C" int host_ssd_scan_tc(const float* x, const float* dt, const float* a, const float* b,
                                const float* c, const float* init, float* y, float* fin,
                                int64_t bsz, int64_t s_len, int h, int p, int n, int chunk,
                                int parts, int split) {
  if (chunk <= 0 || chunk > 1024 || (chunk > 64 && chunk % 64) || p % 16 || n % 16 ||
      parts < 1 || parts > kMaxParts)
    return 1;
  Geometry g;
  g.bsz = bsz, g.s_len = s_len, g.h = h, g.p = p, g.n = n, g.chunk = chunk;
  g.nc = (s_len + chunk - 1) / chunk;
  g.np = parts, g.sp = parts == 1 ? 2 : parts, g.split = split;
  g.lpad = ssd_lpad(chunk), g.stile = ssd_stile(g.lpad, g.np), g.qr = ssd_qrows(g.lpad, g.np);
  g.per = ssd_scan_per_thread(g.lpad);
  // pass A: dS^T, the per-position float4s and cum[L-1] per (batch, chunk,
  // head)
  std::vector<float> ds(bsz * g.nc * h * n * p), last(bsz * g.nc * h);
  std::vector<std::vector<float4>> pos(bsz * g.nc * h, std::vector<float4>(g.lpad));
  for (int64_t bi = 0; bi < bsz; ++bi)
    for (int64_t ci = 0; ci < g.nc; ++ci)
      for (int head = 0; head < h; ++head) {
        const int64_t slot = (bi * g.nc + ci) * h + head;
        last[slot] = pass_state(g, x, dt, a, b, bi, ci, head, &ds[slot * n * p], pos[slot]);
      }
  // pass B: each chunk's starting state over its dS^T, and the final state
  for (int64_t bi = 0; bi < bsz; ++bi)
    for (int head = 0; head < h; ++head)
      for (int e = 0; e < n * p; ++e) {
        const int nn = e / p, pp = e % p;
        float s = init ? init[((bi * h + head) * p + pp) * n + nn] : 0.0f;
        for (int64_t ci = 0; ci < g.nc; ++ci) {
          const int64_t slot = (bi * g.nc + ci) * h + head;
          const float d = ds[slot * n * p + e];
          ds[slot * n * p + e] = s;
          s = ssd_carry(s, expf(last[slot]), d);
        }
        fin[((bi * h + head) * p + pp) * n + nn] = s;
      }
  // pass C: y per (batch, chunk, query tile)
  for (int64_t bi = 0; bi < bsz; ++bi)
    for (int64_t ci = 0; ci < g.nc; ++ci)
      for (int qi = 0; qi < g.lpad / g.qr; ++qi)
        pass_output(g, x, b, c, ds, pos, y, bi, ci, qi);
  return 0;
}

// The tiling of a chunk for inputs of `parts` bf16 parts (1: bfloat16):
// lpad, s-tile rows, query-tile rows, positions a scan thread, and the
// shared memory of passes A and C at (p, n), into out[0..5].
extern "C" void host_ssd_tiling(int chunk, int parts, int p, int n, int* out) {
  const int lpad = ssd_lpad(chunk), sp = parts == 1 ? 2 : parts;
  out[0] = lpad;
  out[1] = ssd_stile(lpad, parts);
  out[2] = ssd_qrows(lpad, parts);
  out[3] = ssd_scan_per_thread(lpad);
  out[4] = SsdStateSmem(p, n, parts, lpad).total;
  out[5] = SsdOutputSmem(p, n, parts, sp, lpad).total;
}
