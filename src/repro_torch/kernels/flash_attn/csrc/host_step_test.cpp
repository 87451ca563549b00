// Host harness of flash_attn_step.h, for the CPU tests only.
//
// host_flash_attn_tc: the bfloat16 tensor-core route, one 16-row strip at a
// time with a warp's 32 lanes emulated on the host, in the kernel's query
// blocks (FA_TC_STRIPS) and tile order.  Tiles are laid out in shared-memory images with
// the kernel's swizzle, ldmatrix is emulated from the lanes' row
// addresses (tc_ldm_a / _k / _v), each mma.sync is a plain loop over the
// PTX fragment layout (tc_a_*, tc_b_*, tc_c_*), and the shuffles are
// butterflies over the emulated lanes; masks, softmax step, P's hi / lo
// split and the output staging are the header's.  With split = 0, lo is
// dropped (one bf16 rounding of P), for the tests that show what the split
// is for.
//
// host_flash_attn_f32tc: the float32 tensor-core route the same way, one
// 16-row strip at a time in the kernel's 64-row blocks, tile order and KV
// tiles (FA_F32_BK): the Q tile scaled in float32 and the K and V tiles
// split into three bf16 parts as images of the kernel's swizzled planes,
// ldmatrix emulated from them, P split by fa_p_parts, and each product as
// the mma of the pairs of parts the kernel takes (S's leading pair and its
// other pairs into two accumulators, as mma_parts_apart), each summed as the
// card's tensor cores sum (tce_mma_fused).  With parts = 2 only the pairs
// (i, j) with i + j < 2 are taken (hi hi, hi lo, lo hi), for the tests that
// show what the third part is for.  The port itself never
// loads this build.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I ../../csrc -o libflash_attn_host.so host_step_test.cpp
#include <set>
#include <vector>

#include "flash_attn_step.h"
#include "tc_emulate.h"

namespace {

constexpr int kBK = 64, kWarps = 4, kNT = kBK / 8;

template <typename Addr>
void ldmatrix_x4(const std::vector<float>& tile, int hd, bool trans, Addr addr,
                 float frag[32][4][2]) {
  tce_ldmatrix_x4(tile.data(), hd, trans, addr, frag);
}

}  // namespace

// q, k, v hold bfloat16 values as float32; o receives the bf16 output as
// float32.  Returns 0, or 1 on a bad argument, 2 if the tile order is not a
// permutation of the query tiles.
extern "C" int host_flash_attn_tc(const float* q, const float* k, const float* v, float* o,
                                  int64_t b, int64_t sq, int64_t skv, int h, int kvh, int hd,
                                  float scale, int causal, int64_t window, int64_t q_offset,
                                  int split) {
  if (kvh <= 0 || h % kvh != 0 || (hd != 32 && hd != 64 && hd != 128)) return 1;
  const int KS = hd / 16, DT = hd / 8, MS = FA_TC_STRIPS(hd), kBQ = 16 * MS * kWarps;
  const int64_t ntiles = (sq + kBQ - 1) / kBQ;
  std::vector<float> qs(kBQ * hd), ks(kBK * hd), vs(kBK * hd);
  auto fill = [&](std::vector<float>& tile, const float* base, int64_t stride, int64_t pos0,
                  int64_t limit, int rows) {
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < hd; ++c)
        tile[tc_smem_off(r, c, hd)] = pos0 + r < limit ? base[(pos0 + r) * stride + c] : 0.0f;
  };
  for (int64_t bi = 0; bi < b; ++bi)
    for (int head = 0; head < h; ++head) {
      const int kv_head = head / (h / kvh);
      const float* qbase = q + (bi * sq * h + head) * hd;
      const float* kbase = k + (bi * skv * kvh + kv_head) * hd;
      const float* vbase = v + (bi * skv * kvh + kv_head) * hd;
      std::set<int64_t> seen;
      for (int64_t blk = 0; blk < ntiles; ++blk) {
        const int64_t qt = fa_tile_order(blk, ntiles);
        if (qt < 0 || qt >= ntiles || !seen.insert(qt).second) return 2;
        const int64_t q0 = qt * kBQ;
        fill(qs, qbase, (int64_t)h * hd, q0, sq, kBQ);
        int64_t t_lo, t_hi;
        fa_kv_tiles(q0, kBQ, q_offset, skv, causal, window, kBK, &t_lo, &t_hi);
        // each 16-row strip on its own: the kernel runs a warp's strips
        // side by side, with the same arithmetic for each
        for (int strip = 0; strip < kWarps * MS; ++strip) {
          const int row0 = 16 * strip;
          std::vector<float> qf(32 * KS * 8), acc(32 * DT * 4, 0.0f);
          for (int kk = 0; kk < KS; ++kk) {
            float f[32][4][2];
            ldmatrix_x4(qs, hd, false,
                        [&](int l, int* r, int* c) { tc_ldm_a(l, row0, kk, r, c); }, f);
            for (int l = 0; l < 32; ++l)
              for (int i = 0; i < 8; ++i)
                qf[(l * KS + kk) * 8 + i] = fa_scale_q(f[l][i / 2][i % 2], scale, 1);
          }
          float m[32][2], lpart[32][2];
          for (int l = 0; l < 32; ++l) {
            m[l][0] = m[l][1] = FA_NEG_INF;
            lpart[l][0] = lpart[l][1] = 0.0f;
          }
          const int64_t qpos_strip = q_offset + q0 + row0;
          for (int64_t t = t_lo; t < t_hi; ++t) {
            fill(ks, kbase, (int64_t)kvh * hd, t * kBK, skv, kBK);
            fill(vs, vbase, (int64_t)kvh * hd, t * kBK, skv, kBK);
            float s[32][kNT * 4] = {};
            for (int kk = 0; kk < KS; ++kk)
              for (int np = 0; np < kNT / 2; ++np) {
                float kb[32][4][2], a[32][4][2], b0[32][2][2], b1[32][2][2];
                ldmatrix_x4(ks, hd, false,
                            [&](int l, int* r, int* c) { tc_ldm_b(l, np, kk, r, c); }, kb);
                float c0[32][4], c1[32][4];
                for (int l = 0; l < 32; ++l) {
                  for (int i = 0; i < 8; ++i) a[l][i / 2][i % 2] = qf[(l * KS + kk) * 8 + i];
                  for (int e = 0; e < 2; ++e)
                    for (int r = 0; r < 2; ++r) {
                      b0[l][r][e] = kb[l][r][e];
                      b1[l][r][e] = kb[l][2 + r][e];
                    }
                  for (int i = 0; i < 4; ++i) {
                    c0[l][i] = s[l][8 * np + i];
                    c1[l][i] = s[l][8 * np + 4 + i];
                  }
                }
                tce_mma(c0, a, b0);
                tce_mma(c1, a, b1);
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) {
                    s[l][8 * np + i] = c0[l][i];
                    s[l][8 * np + 4 + i] = c1[l][i];
                  }
              }
            const int64_t kpos0 = t * kBK;
            if (fa_tile_needs_mask(qpos_strip, 16, kpos0, kBK, skv, causal, window))
              for (int l = 0; l < 32; ++l)
                fa_frag_mask<kNT>(s[l], l, qpos_strip, kpos0, skv, causal, window);
            float mx[32][2], corr[32][2];
            for (int l = 0; l < 32; ++l) fa_frag_rowmax<kNT>(s[l], mx[l]);
            for (int x = 1; x <= 2; x *= 2) {  // __shfl_xor_sync butterflies
              float prev[32][2];
              memcpy(prev, mx, sizeof(prev));
              for (int l = 0; l < 32; ++l)
                for (int r = 0; r < 2; ++r)
                  mx[l][r] = prev[l][r] > prev[l ^ x][r] ? prev[l][r] : prev[l ^ x][r];
            }
            for (int l = 0; l < 32; ++l) {
              fa_frag_update<kNT>(s[l], m[l], mx[l], lpart[l], corr[l]);
              for (int d = 0; d < DT; ++d)
                for (int i = 0; i < 4; ++i) acc[(l * DT + d) * 4 + i] *= corr[l][i / 2];
            }
            for (int j = 0; j < kNT / 2; ++j) {
              float ahi[32][4][2], alo[32][4][2];
              for (int l = 0; l < 32; ++l) {
                uint32_t rh[4], rl[4];
                fa_p_fragments(&s[l][8 * j], &s[l][8 * j + 4], rh, rl);
                tce_unpack(rh, ahi[l]);
                tce_unpack(rl, alo[l]);
                if (!split)
                  for (int r = 0; r < 4; ++r) alo[l][r][0] = alo[l][r][1] = 0.0f;
              }
              for (int dp = 0; dp < DT / 2; ++dp) {
                float vb[32][4][2];
                ldmatrix_x4(vs, hd, true,
                            [&](int l, int* r, int* c) { tc_ldm_bt(l, j, dp, r, c); }, vb);
                for (int half = 0; half < 2; ++half) {
                  float bb[32][2][2], c[32][4];
                  const int d = 2 * dp + half;
                  for (int l = 0; l < 32; ++l) {
                    for (int r = 0; r < 2; ++r)
                      for (int e = 0; e < 2; ++e) bb[l][r][e] = vb[l][2 * half + r][e];
                    for (int i = 0; i < 4; ++i) c[l][i] = acc[(l * DT + d) * 4 + i];
                  }
                  tce_mma(c, ahi, bb);
                  tce_mma(c, alo, bb);
                  for (int l = 0; l < 32; ++l)
                    for (int i = 0; i < 4; ++i) acc[(l * DT + d) * 4 + i] = c[l][i];
                }
              }
            }
          }
          // l over the 4 lanes of a row, then the output staged in the Q
          // tile image as the kernel stages it, and copied out.
          float l4[32][2];
          memcpy(l4, lpart, sizeof(l4));
          for (int x = 1; x <= 2; x *= 2) {
            float prev[32][2];
            memcpy(prev, l4, sizeof(prev));
            for (int l = 0; l < 32; ++l)
              for (int r = 0; r < 2; ++r) l4[l][r] = prev[l][r] + prev[l ^ x][r];
          }
          for (int l = 0; l < 32; ++l)
            for (int d = 0; d < DT; ++d)
              for (int i = 0; i < 4; ++i) {
                const int row = row0 + tc_c_row(l, i), col = 8 * d + tc_c_col(l, i);
                qs[tc_smem_off(row, col, hd)] =
                    tc_round_bf16(fa_finish(acc[(l * DT + d) * 4 + i], l4[l][i / 2]));
              }
          for (int r = row0; r < row0 + 16; ++r)
            if (q0 + r < sq)
              for (int c = 0; c < hd; ++c)
                o[((bi * sq + q0 + r) * h + head) * hd + c] = qs[tc_smem_off(r, c, hd)];
        }
      }
      if ((int64_t)seen.size() != ntiles) return 2;
    }
  return 0;
}

// q, k, v float32; o receives the float32 output.  Returns 0, 1 on a bad
// argument, 2 if the tile order is not a permutation of the query tiles.
extern "C" int host_flash_attn_f32tc(const float* q, const float* k, const float* v, float* o,
                                     int64_t b, int64_t sq, int64_t skv, int h, int kvh, int hd,
                                     float scale, int causal, int64_t window, int64_t q_offset,
                                     int parts) {
  if (kvh <= 0 || h % kvh != 0 || (hd != 32 && hd != 64 && hd != 128)) return 1;
  if (parts < 1 || parts > FA_F32_PARTS) return 1;
  constexpr int P = FA_F32_PARTS, BQ = 16 * kWarps;
  const int BK = FA_F32_BK(hd), NT = BK / 8, KS = hd / 16, DT = hd / 8;
  const int64_t ntiles = (sq + BQ - 1) / BQ;
  auto used = [&](int i, int j) { return parts == P ? fa_pair_used(i, j) : i + j < parts; };
  // rows [pos0, pos0 + rows) of a (., hd) float32 array of row stride
  // `stride` (scaled by `mul`), split into P swizzled bf16 plane images as
  // the kernel stores them; rows at or past `limit` are zero
  auto planes = [&](std::vector<float>& img, const float* base, int64_t stride, int64_t pos0,
                    int64_t limit, int rows, float mul, bool scaled) {
    img.assign((size_t)P * rows * hd, 0.0f);
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < hd; c += 2) {
        float x0 = 0.0f, x1 = 0.0f;
        if (pos0 + r < limit) {
          x0 = base[(pos0 + r) * stride + c], x1 = base[(pos0 + r) * stride + c + 1];
          if (scaled) x0 = fa_scale_q(x0, mul, 0), x1 = fa_scale_q(x1, mul, 0);
        }
        uint32_t part[P];
        tc_split_parts<P>(x0, x1, part);
        for (int p = 0; p < P; ++p) {
          img[(size_t)p * rows * hd + tc_smem_off(r, c, hd)] = tc_unpack_lo(part[p]);
          img[(size_t)p * rows * hd + tc_smem_off(r, c + 1, hd)] = tc_unpack_hi(part[p]);
        }
      }
  };
  std::vector<float> qimg, kimg, vimg;
  for (int64_t bi = 0; bi < b; ++bi)
    for (int head = 0; head < h; ++head) {
      const int kv_head = head / (h / kvh);
      const float* qbase = q + (bi * sq * h + head) * hd;
      const float* kbase = k + (bi * skv * kvh + kv_head) * hd;
      const float* vbase = v + (bi * skv * kvh + kv_head) * hd;
      std::set<int64_t> seen;
      for (int64_t blk = 0; blk < ntiles; ++blk) {
        const int64_t qt = fa_tile_order(blk, ntiles);
        if (qt < 0 || qt >= ntiles || !seen.insert(qt).second) return 2;
        const int64_t q0 = qt * BQ;
        planes(qimg, qbase, (int64_t)h * hd, q0, sq, BQ, scale, true);
        int64_t t_lo, t_hi;
        fa_kv_tiles(q0, BQ, q_offset, skv, causal, window, BK, &t_lo, &t_hi);
        for (int warp = 0; warp < kWarps; ++warp) {
          const int row0 = 16 * warp;
          std::vector<float> acc(32 * DT * 4, 0.0f);
          float m[32][2], lpart[32][2];
          for (int l = 0; l < 32; ++l) {
            m[l][0] = m[l][1] = FA_NEG_INF;
            lpart[l][0] = lpart[l][1] = 0.0f;
          }
          const int64_t qpos_strip = q_offset + q0 + row0;
          for (int64_t t = t_lo; t < t_hi; ++t) {
            planes(kimg, kbase, (int64_t)kvh * hd, t * BK, skv, BK, 1.0f, false);
            planes(vimg, vbase, (int64_t)kvh * hd, t * BK, skv, BK, 1.0f, false);
            std::vector<std::vector<float>> s(32, std::vector<float>(NT * 4, 0.0f));
            std::vector<std::vector<float>> s_lo(32, std::vector<float>(NT * 4, 0.0f));
            for (int kk = 0; kk < KS; ++kk) {
              static float qa[P][32][4][2];
              for (int p = 0; p < P; ++p)
                tce_ldmatrix_x4(&qimg[(size_t)p * BQ * hd], hd, false,
                                [&](int l, int* r, int* c) { tc_ldm_a(l, row0, kk, r, c); },
                                qa[p]);
              for (int nt = 0; nt < NT; ++nt) {
                static float bp[P][32][2][2];
                for (int p = 0; p < P; ++p) {
                  float x4[32][4][2];
                  tce_ldmatrix_x4(&kimg[(size_t)p * BK * hd], hd, false,
                                  [&](int l, int* r, int* c) { tc_ldm_b(l, nt / 2, kk, r, c); },
                                  x4);
                  tce_b_half(x4, nt % 2, bp[p]);
                }
                float c[32][4], c_lo[32][4];  // mma_parts_apart's two accumulators
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) c[l][i] = s[l][4 * nt + i], c_lo[l][i] = s_lo[l][4 * nt + i];
                for (int i = 0; i < P; ++i)
                  for (int j = 0; j < P; ++j)
                    if (used(i, j)) tce_mma_fused(i + j == 0 ? c : c_lo, qa[i], bp[j]);
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) s[l][4 * nt + i] = c[l][i], s_lo[l][4 * nt + i] = c_lo[l][i];
              }
            }
            for (int l = 0; l < 32; ++l)
              for (int i = 0; i < NT * 4; ++i) s[l][i] += s_lo[l][i];
            const int64_t kpos0 = t * BK;
            float mx[32][2], corr[32][2];
            for (int l = 0; l < 32; ++l) {
              if (fa_tile_needs_mask(qpos_strip, 16, kpos0, BK, skv, causal, window)) {
                if (NT == 8) fa_frag_mask<8>(s[l].data(), l, qpos_strip, kpos0, skv, causal, window);
                else fa_frag_mask<4>(s[l].data(), l, qpos_strip, kpos0, skv, causal, window);
              }
              if (NT == 8) fa_frag_rowmax<8>(s[l].data(), mx[l]);
              else fa_frag_rowmax<4>(s[l].data(), mx[l]);
            }
            for (int x = 1; x <= 2; x *= 2) {  // __shfl_xor_sync butterflies
              float prev[32][2];
              memcpy(prev, mx, sizeof(prev));
              for (int l = 0; l < 32; ++l)
                for (int r = 0; r < 2; ++r)
                  mx[l][r] = prev[l][r] > prev[l ^ x][r] ? prev[l][r] : prev[l ^ x][r];
            }
            for (int l = 0; l < 32; ++l) {
              if (NT == 8) fa_frag_update<8>(s[l].data(), m[l], mx[l], lpart[l], corr[l]);
              else fa_frag_update<4>(s[l].data(), m[l], mx[l], lpart[l], corr[l]);
              for (int d = 0; d < DT; ++d)
                for (int i = 0; i < 4; ++i) acc[(l * DT + d) * 4 + i] *= corr[l][i / 2];
            }
            for (int jj = 0; jj < NT / 2; ++jj) {
              static float pa[P][32][4][2];
              for (int l = 0; l < 32; ++l) {
                uint32_t r[P][4];
                fa_p_parts(&s[l][8 * jj], &s[l][8 * jj + 4], r);
                for (int p = 0; p < P; ++p) tce_unpack(r[p], pa[p][l]);
              }
              for (int d = 0; d < DT; ++d) {
                static float vp[P][32][2][2];
                for (int p = 0; p < P; ++p) {
                  float x4[32][4][2];
                  tce_ldmatrix_x4(&vimg[(size_t)p * BK * hd], hd, true,
                                  [&](int l, int* r, int* c) { tc_ldm_bt(l, jj, d / 2, r, c); },
                                  x4);
                  tce_b_half(x4, d % 2, vp[p]);
                }
                float c[32][4];
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) c[l][i] = acc[(l * DT + d) * 4 + i];
                for (int i = 0; i < P; ++i)
                  for (int j = 0; j < P; ++j)
                    if (used(i, j)) tce_mma_fused(c, pa[i], vp[j]);
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) acc[(l * DT + d) * 4 + i] = c[l][i];
              }
            }
          }
          float l4[32][2];
          memcpy(l4, lpart, sizeof(l4));
          for (int x = 1; x <= 2; x *= 2) {
            float prev[32][2];
            memcpy(prev, l4, sizeof(prev));
            for (int l = 0; l < 32; ++l)
              for (int r = 0; r < 2; ++r) l4[l][r] = prev[l][r] + prev[l ^ x][r];
          }
          for (int l = 0; l < 32; ++l)
            for (int d = 0; d < DT; ++d)
              for (int i = 0; i < 4; ++i) {
                const int64_t row = q0 + row0 + tc_c_row(l, i);
                if (row < sq)
                  o[((bi * sq + row) * h + head) * hd + 8 * d + tc_c_col(l, i)] =
                      fa_finish(acc[(l * DT + d) * 4 + i], l4[l][i / 2]);
              }
        }
      }
      if ((int64_t)seen.size() != ntiles) return 2;
    }
  return 0;
}

// Byte offsets, in the float32 route's bf16 plane images at hd, of the 32
// row segments each ldmatrix.x4 of a warp addresses: Q (kk, strip; a 64-row
// tile), then K (np, kk) and V (j, dp) (FA_F32_BK-row tiles), 32 per
// instruction.  Returns how many were written; *n_q and *n_k receive the Q
// and K shares.
extern "C" int host_f32_ldmatrix_offsets(int hd, int* out, int* n_q, int* n_k) {
  const int BK = FA_F32_BK(hd);
  int n = 0, r, c;
  for (int kk = 0; kk < hd / 16; ++kk)
    for (int strip = 0; strip < kWarps; ++strip)
      for (int l = 0; l < 32; ++l) tc_ldm_a(l, 16 * strip, kk, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  *n_q = n;
  for (int np = 0; np < BK / 16; ++np)
    for (int kk = 0; kk < hd / 16; ++kk)
      for (int l = 0; l < 32; ++l) tc_ldm_b(l, np, kk, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  *n_k = n - *n_q;
  for (int j = 0; j < BK / 16; ++j)
    for (int dp = 0; dp < hd / 16; ++dp)
      for (int l = 0; l < 32; ++l) tc_ldm_bt(l, j, dp, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  return n;
}

// c (16 x 8, row-major) += a (16 x 16) b (16 x 8, k x n) by one emulated
// mma (tce_mma_fused), through the fragment layout; a and b hold bfloat16
// values.
extern "C" void host_mma(const float* a, const float* b, float* c) {
  float fa[32][4][2], fb[32][2][2], fc[32][4];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 8; ++i) fa[l][i / 2][i % 2] = a[tc_a_row(l, i) * 16 + tc_a_col(l, i)];
    for (int i = 0; i < 4; ++i) fb[l][i / 2][i % 2] = b[tc_b_k(l, i) * 8 + tc_b_n(l, i)];
    for (int i = 0; i < 4; ++i) fc[l][i] = c[tc_c_row(l, i) * 8 + tc_c_col(l, i)];
  }
  tce_mma_fused(fc, fa, fb);
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) c[tc_c_row(l, i) * 8 + tc_c_col(l, i)] = fc[l][i];
}

extern "C" void host_split_parts(const float* x, float* parts, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t r[FA_F32_PARTS];
    tc_split_parts<FA_F32_PARTS>(x[i], 0.0f, r);
    for (int p = 0; p < FA_F32_PARTS; ++p) parts[i * FA_F32_PARTS + p] = tc_unpack_lo(r[p]);
  }
}

// The header's small functions, one by one, for the tests of their
// contracts.
extern "C" void host_split_bf16(const float* p, float* hi, float* lo, int64_t n) {
  for (int64_t i = 0; i < n; ++i) tc_split_bf16(p[i], &hi[i], &lo[i]);
}

extern "C" int64_t host_tile_order(int64_t i, int64_t n) { return fa_tile_order(i, n); }

extern "C" int host_tile_needs_mask(int64_t qpos0, int64_t nq, int64_t kpos0, int64_t nk,
                                    int64_t skv, int causal, int64_t window) {
  return fa_tile_needs_mask(qpos0, nq, kpos0, nk, skv, causal, window);
}

extern "C" int host_allowed(int64_t qpos, int64_t kpos, int64_t skv, int causal,
                            int64_t window) {
  return fa_allowed(qpos, kpos, skv, causal, window);
}

// Fragment maps, (row, col) per lane and element: A (32 x 8), B (32 x 4),
// C (32 x 4), written in that order into rc (2 ints each).
extern "C" void host_fragment_maps(int* rc) {
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 8; ++i, rc += 2) rc[0] = tc_a_row(l, i), rc[1] = tc_a_col(l, i);
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i, rc += 2) rc[0] = tc_b_k(l, i), rc[1] = tc_b_n(l, i);
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i, rc += 2) rc[0] = tc_c_row(l, i), rc[1] = tc_c_col(l, i);
}

// Byte offsets in a tile of hd bf16 columns of the 32 row segments that
// each ldmatrix.x4 of the kernel addresses, in the order Q (kk), K (np,
// kk), V (j, dp), 32 per instruction; returns how many were written.
extern "C" int host_ldmatrix_offsets(int hd, int* out) {
  int n = 0, r, c;
  for (int kk = 0; kk < hd / 16; ++kk)
    for (int strip = 0; strip < kWarps * FA_TC_STRIPS(hd); ++strip)
      for (int l = 0; l < 32; ++l) tc_ldm_a(l, 16 * strip, kk, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  for (int np = 0; np < kNT / 2; ++np)
    for (int kk = 0; kk < hd / 16; ++kk)
      for (int l = 0; l < 32; ++l) tc_ldm_b(l, np, kk, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  for (int j = 0; j < kNT / 2; ++j)
    for (int dp = 0; dp < hd / 16; ++dp)
      for (int l = 0; l < 32; ++l) tc_ldm_bt(l, j, dp, &r, &c), out[n++] = 2 * tc_smem_off(r, c, hd);
  return n;
}

extern "C" int host_smem_off(int row, int col, int hd) { return tc_smem_off(row, col, hd); }
