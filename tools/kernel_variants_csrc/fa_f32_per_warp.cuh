// K5's float32 route with each warp splitting the K and V values of its own
// fragments from the float32 tiles, in place of the block splitting each
// tile once into bf16 planes: the design that lost to the kernel's
// (tools/kernel_variants.py k5f32 splices this text into
// src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu and drops the split
// pass and the planes).  The float32 tiles' rows are padded: a K fragment
// is read as float2 (row 8 n + g, columns 2 t, 2 t + 1), so rows HD + 8
// floats apart put a half-warp's 16 lanes on 32 different banks; a V
// fragment as single floats (rows 2 t, column g), so rows HD + 4 apart put
// the warp's 32 lanes on 32 banks.

// Offset, in a float32 K tile of row stride kst, of element e (0, 1) of B
// register reg (0: b0, 1: b1) of lane `lane`'s fragment of key n-tile nt at
// k-step kk: key 8 nt + g, dimension 16 kk + 2 t + e + 8 reg.
FA_HD int fa_kb_off(int lane, int kk, int nt, int reg, int e, int kst) {
  return (8 * nt + tc_b_n(lane, 0)) * kst + 16 * kk + tc_b_k(lane, 2 * reg + e);
}

// The same in a float32 V tile of row stride vst, for P V's B fragment of
// dimension n-tile d at key k-step j: key 16 j + 2 t + e + 8 reg,
// dimension 8 d + g.
FA_HD int fa_vb_off(int lane, int j, int d, int reg, int e, int vst) {
  return (16 * j + tc_b_k(lane, 2 * reg + e)) * vst + 8 * d + tc_b_n(lane, 0);
}

// The parts of the K B fragments of key n-tiles 2 np, 2 np + 1 at k-step
// kk (registers as tc_ldm_b's ldmatrix gives them), from the float32 tile.
template <int KST>
__device__ __forceinline__ void k_parts(const float* ks, int lane, int kk, int np,
                                        uint32_t kb[F32_PARTS][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) {
      const float2 x =
          *reinterpret_cast<const float2*>(ks + fa_kb_off(lane, kk, 2 * np + half, reg, 0, KST));
      uint32_t part[F32_PARTS];
      tc_split_parts<F32_PARTS>(x.x, x.y, part);
#pragma unroll
      for (int q = 0; q < F32_PARTS; ++q) kb[q][2 * half + reg] = part[q];
    }
}

// The parts of the V B fragments of dimension n-tiles 2 dp, 2 dp + 1 at
// key k-step j (registers as tc_ldm_bt's ldmatrix.trans gives them), from
// the float32 tile.
template <int VST>
__device__ __forceinline__ void v_parts(const float* vs, int lane, int j, int dp,
                                        uint32_t vb[F32_PARTS][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) {
      const float x0 = vs[fa_vb_off(lane, j, 2 * dp + half, reg, 0, VST)];
      const float x1 = vs[fa_vb_off(lane, j, 2 * dp + half, reg, 1, VST)];
      uint32_t part[F32_PARTS];
      tc_split_parts<F32_PARTS>(x0, x1, part);
#pragma unroll
      for (int q = 0; q < F32_PARTS; ++q) vb[q][2 * half + reg] = part[q];
    }
}
