#!/usr/bin/env python3
"""Times the design choices of the port's redesigned kernels on a CUDA
card, at the shapes of the main paths, by building variants of the
committed sources.

    python3 tools/kernel_variants.py [k5] [k4b] [k2] [k3b] [k6] [k1] [k5f32] [segsum]
                                                                     (default: all)

Each variant is the committed ``.cu`` file with one constant replaced (or,
for the designs a kernel replaced, the earlier kernel rebuilt from the
committed step header), written to ``src/repro_torch/kernels/_build/variants/``
and built by the port's ``build`` module; its C entry point is called
directly.

- K5 (``flash_attn.cu``) at path F's attention, q, k, v (4, 4096, 32, 64)
  bf16 causal, with 16-row strips per warp 2 (the kernel's choice at hd 64)
  and 1; beside ``scaled_dot_product_attention``.
- K4b (``amc_gather.cu``, the vector kernel) along run 2 of the bfs/google
  pair (path E: a (110,000 x 128) float32 table, 442,876 rows into 110,000
  segments) with U rows in flight in {4, 8, 16} and SPW segments a warp in
  {1, 8, 32}, on the whole path, on the path with its largest segment
  (1,771 rows) cut to 4 rows, and on that segment alone (as it is, its
  rows sorted, and its rows moved into the table's first 4,096); beside
  ``embedding_bag``.
- K2 (``fused_levels.cu``) on main path B's demand stream (pgd/google under
  ``PAPER``): one warp a row with the levels looked up all at once (the
  kernel) or one level after another (``FW_PACK_LEVELS`` 0), each with the
  row's state in shared or in global memory; and one thread a row
  (``fused_row`` of ``cache_sim_step.h``, the design before).
- K3b (``basedelta.cu``) on path D's AMC entry tiles (77,995 x 32): the
  vector route, the scalar route, and one thread an element with a 64-bit
  division (the design before); beside ``base[:, None] + deltas``.

- K6 (``ssd_scan.cu``) at path F's shape, x (4, 4096, 64, 64) bf16, B/C
  (4, 4096, 64), chunk 256, dt = softplus(N(0, 1)): the committed passes
  (each pass's device time from ``torch.profiler``) with pass C's head
  groups of 8 (the kernel's choice), 4 and 16; one block per (batch, head)
  with scalar float32 products (the design before,
  ``tools/kernel_variants_csrc/ssd_scan_block_per_head.cu``); the plain
  version; the state term in a pass of its own after pass C (pass C writes
  its intra-chunk y as float32, ``kernel_variants_csrc/ssd_state_pass.cuh``)
  against the kernel, where it is fused into pass C.  The float32 route at
  the cross-check's shape (4, 512, 64, 64) with N 64 and 128: its inputs
  in 3 bf16 parts a side (the kernel) or 2 (``SSD_F32_PARTS``), float32
  FMAs on the CUDA cores in the same chunk-parallel grid
  (``kernel_variants_csrc/ssd_f32_cuda_cores.cuh``), and the state term in
  its own pass, each with its error against the plain version; the two new
  designs are held within ``SSD_TOL`` on two ragged shapes first.
- K1 (``lru_hits.cu``) on main path B's four launches: one lane group a
  row with the ways across lanes (the kernel, design (a)), one thread a
  row with the accesses staged in shared memory (design (b)), and one
  thread a row that loads each access and stores each hit byte itself
  (the design before, ``lru_row``).

- K5's float32 route (``k5f32``) at the cross-check's shape (4, 512, 32,
  64) and at (4, 2048, 32, 64), float32 causal: the tensor-core kernel,
  which splits each float32 K / V tile once into bf16 planes read by
  ldmatrix, with 32-key tiles (the kernel's choice) and 64 (``FA_F32_BK``),
  against each warp splitting the K and V values of its own fragments from
  padded float32 tiles (``kernel_variants_csrc/fa_f32_per_warp.cuh``), and
  with S's six pair products in one accumulator (its error reported, not
  held: on the cancelling pairs of ``tests/test_torch_flash_attn_f32tc.py``
  the card's cut of each term puts it at the tolerance's edge); a
  register-blocked design on the CUDA cores and the scalar kernel it
  replaced (``kernel_variants_csrc/fa_f32_cuda_cores.cu``); beside the plain
  version and SDPA in float32.
- The ordered segment sum (``segsum``) on google's push and pull orders:
  the kernel (one launch, heavy and light block roles, 8 chunks in flight
  a warp, each chunk passed through shared memory) against 2, 4 and 16
  chunks in flight (``SS_RING``), the roles as two launches, each chunk
  passed by shuffles (the first warp design), two passes (a gather into
  edge-sorted order, then chains over contiguous memory) and one thread a
  segment, the design before
  (``kernel_variants_csrc/segment_sum_variants.cuh``).

Every variant's output is held against the committed kernel's plain
version first (K2, K3b, K4b and the segment sum bit for bit, K5 within
``chip_smoke.ATTN_TOL``).  Prints the card's name and power limit, then one
line per reading, and as the last line a JSON object of all readings.
Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANT_CSRC = ROOT / "tools" / "kernel_variants_csrc"  # sources and headers of variants
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def variant(source: Path, name: str, old: str, new: str) -> Path:
    """``source`` with ``old`` replaced by ``new``."""
    text = source.read_text()
    if old not in text:
        raise SystemExit(f"{source.name}: {old!r} not found")
    return rebuilt(source, name, text.replace(old, new))


def rebuilt(source: Path, name: str, text: str) -> Path:
    """``text`` written in place of ``source`` beside its headers' copies
    (the build hashes the headers next to a source)."""
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "variants" / f"{source.stem}-{name}"
    out.mkdir(parents=True, exist_ok=True)
    for h in [*source.parent.glob("*.h"), *VARIANT_CSRC.glob("*.h")]:
        (out / h.name).write_text(h.read_text())
    path = out / source.name
    path.write_text(text)
    return path


def k5_variants(dev, readings):
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

    header = fa.SOURCE.parent / "flash_attn_step.h"
    macro = "#define FA_TC_STRIPS(hd) ((hd) <= 64 ? 2 : 1)"
    if macro not in header.read_text():
        raise SystemExit("flash_attn_step.h: FA_TC_STRIPS changed")
    paths = {}
    for strips in (2, 1):
        p = variant(fa.SOURCE, f"strips{strips}", '#include "flash_attn_step.h"',
                    f'#include "flash_attn_step.h"\n#undef FA_TC_STRIPS\n'
                    f"#define FA_TC_STRIPS(hd) {strips}")
        paths[strips] = p
    build.build(list(paths.values()))
    b, s, h, hd = 4, 4096, 32, 64
    q, k, v = cs.k5_inputs(np.random.default_rng(0), b, s, s, h, h, hd, torch.bfloat16, dev)
    ref = blocked_attention_plain(q, k, v, True)
    scale = float(torch.tensor(hd**-0.5, dtype=torch.bfloat16))
    flop = 4 * hd * b * h * (s * (s + 1) // 2)
    for strips, p in paths.items():
        fn = build.load(p).flash_attn_launch
        i64, ci = ctypes.c_int64, ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [i64, i64, i64, ci, ci, ci, ci, ctypes.c_float,
                                               ci, i64, i64, ctypes.c_void_p]
        out = torch.empty_like(q)

        def run():
            rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), b, s, s, h, h, hd, 1, scale, 1, 0, 0,
                    stream_ptr(dev))
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        run()
        cs.close(out, ref, what=f"K5 with {strips} strips a warp", **cs.ATTN_TOL["bfloat16"])
        ms = cs.cuda_ms(run, dev, reps=10)
        readings[f"K5 strips {strips}"] = ms
        cs.log(f"K5, {strips} strips of 16 rows a warp: {ms:.4f} ms "
               f"({flop / ms * 1e-9:.1f} TFLOP/s)")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), dev, reps=10)
    readings["SDPA"] = lib
    cs.log(f"scaled_dot_product_attention: {lib:.4f} ms")


def k4b_variants(dev, readings):
    import torch

    from repro_torch.graphs import make_dataset, make_evolving_pair
    from repro_torch.kernels import build
    from repro_torch.kernels.amc_gather import amc_gather as ga
    from repro_torch.kernels.build import ptr, stream_ptr

    paths = {}
    for u in (4, 8, 16):
        for spw in (1, 8, 32):
            p = variant(ga.SOURCE, f"u{u}-spw{spw}", "launch_segment_sum_vec<T, 1, 8>",
                        f"launch_segment_sum_vec<T, 1, {u}>")
            text = p.read_text()
            if "constexpr int SPW = 32;" not in text:
                raise SystemExit("amc_gather.cu: SPW changed")
            p.write_text(text.replace("constexpr int SPW = 32;", f"constexpr int SPW = {spw};"))
            paths[(u, spw)] = p
    build.build(list(paths.values()))
    run2 = make_evolving_pair(make_dataset("google"), seed=0).run2
    table = cs.vertex_table(run2.num_vertices, dev)
    idx = torch.from_numpy(run2.neighbors).to(dev)
    seg = torch.from_numpy(run2.edge_sources()).to(dev)
    ns = run2.num_vertices
    deg = torch.bincount(seg.long(), minlength=ns)
    big = int(deg.argmax())
    first = int((seg < big).sum())
    keep = (seg != big) | (torch.arange(seg.numel(), device=dev) < first + 4)
    only = seg == big
    zeros = torch.zeros(int(only.sum()), dtype=torch.int32, device=dev)
    cases = {
        "path E": (idx, seg, ns),
        f"largest segment ({int(deg[big])} rows) cut to 4": (
            idx[keep].contiguous(), seg[keep].contiguous(), ns),
        "largest segment alone": (idx[only].contiguous(), zeros, 1),
        # the same rows in table order, and rows from a 2 MB window instead:
        # whether the chain's cost follows where its rows lie
        "largest segment alone, rows sorted": (idx[only].sort().values.contiguous(), zeros, 1),
        "largest segment alone, rows in the first 4,096": (
            (idx[only] % 4096).contiguous(), zeros, 1),
    }
    refs = {name: ga.amc_gather_segment_sum_plain(table.cpu(), ix.cpu(), sg.cpu(), n)
            for name, (ix, sg, n) in cases.items()}
    for (u, spw), p in paths.items():
        fn = build.load(p).amc_gather_segment_sum_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        for name, (ix, sg, n) in cases.items():
            out = torch.empty((n, table.shape[1]), device=dev)

            def run():
                rc = fn(ptr(table), table.shape[0], table.shape[1], 0, ptr(ix), ptr(sg),
                        ix.numel(), n, ptr(out), stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")

            run()
            cs.check(torch.equal(out.cpu(), refs[name]), f"K4b U {u} SPW {spw} {name}: != plain")
            ms = cs.cuda_ms(run, dev, reps=20)
            readings[f"K4b U {u} SPW {spw}: {name}"] = ms
            cs.log(f"K4b, U {u}, SPW {spw}, {name}: {ms:.4f} ms")
    starts = torch.searchsorted(seg, torch.arange(ns, device=dev, dtype=torch.int32),
                                out_int32=True)
    lib = cs.cuda_ms(lambda: torch.nn.functional.embedding_bag(idx, table, starts, mode="sum"),
                     dev, reps=20)
    readings["embedding_bag"] = lib
    cs.log(f"embedding_bag: {lib:.4f} ms")


# K2 before the warp kernel: one thread a (stream, group) row, the row's
# state walked in place in global memory, the levels one after another.
K2_THREAD_PER_ROW = r"""
#include <cuda_runtime.h>
#include "cache_sim_step.h"

__global__ void fused_levels_thread_kernel(const int32_t* __restrict__ blocks,
                                           const int64_t* __restrict__ offsets,
                                           int rows, FusedLevels lv,
                                           int8_t* __restrict__ lvl) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  fused_row(lv, row, blocks, offsets[row], offsets[row + 1], lvl);
}

extern "C" int fused_levels_launch(const void* blocks, const void* offsets,
                                   int rows, int k, int lg, const int* rmask,
                                   const int* ways, const int* lanes,
                                   void* const* tags, void* const* age,
                                   void* lvl, void* stream) {
  FusedLevels lv;
  lv.k = k;
  lv.lg = lg;
  for (int i = 0; i < CS_MAX_LEVELS; ++i) {
    const bool on = i < k;
    lv.rmask[i] = on ? rmask[i] : 0;
    lv.ways[i] = on ? ways[i] : 1;
    lv.lanes[i] = on ? lanes[i] : 0;
    lv.tags[i] = on ? (int32_t*)tags[i] : nullptr;
    lv.age[i] = on ? (int32_t*)age[i] : nullptr;
  }
  fused_levels_thread_kernel<<<(rows + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)blocks, (const int64_t*)offsets, rows, lv, (int8_t*)lvl);
  return (int)cudaGetLastError();
}
"""


def k2_variants(dev, readings):
    import torch

    from repro_torch import memsim
    from repro_torch.core import build_workload
    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.cache_sim import fused_sim as fs
    from repro_torch.memsim.hierarchy import _demand_levels

    warp = {"at once": fs.SOURCE,
            "in turn": variant(fs.SOURCE, "in-turn", '#include "fused_warp_step.h"',
                               '#define FW_PACK_LEVELS 0\n#include "fused_warp_step.h"')}
    thread = rebuilt(fs.SOURCE, "thread-per-row", K2_THREAD_PER_ROW)
    build.build(list(warp.values()) + [thread])
    wl = build_workload("pgd", "google", hierarchy=memsim.PAPER, device=dev)
    levels = _demand_levels(wl.profile.cfg)
    blocks, offsets, tags, age = cs.k2_inputs([wl.block], levels, dev)
    del wl
    rows, k = offsets.numel() - 1, len(levels)
    lens = offsets[1:] - offsets[:-1]
    longest = int(lens.max())
    order = torch.argsort(lens, descending=True, stable=True).to(torch.int32)
    lg, rmask, ways, lanes = fs._geometry(levels)
    ints, ptrs = ctypes.c_int * k, ctypes.c_void_p * k
    geom = (k, lg, ints(*rmask), ints(*ways), ints(*lanes))
    cs.log(f"K2 at path B: {blocks.numel()} kept accesses in {rows} rows, the longest "
           f"{longest}, levels {list(levels)}")
    t0 = time.perf_counter()
    ref = fs.fused_levels_plain(blocks, offsets, levels, tags, age)
    cs.log(f"  plain version: {time.perf_counter() - t0:.1f} s")

    def timed(name, run, out):
        run()
        cs.check(cs.max_err(out(), ref) == 0, f"K2 {name}: != plain")
        ms = cs.cuda_ms(run, dev, reps=3)
        readings[f"K2 {name}"] = ms
        cs.log(f"K2, {name}: {ms:.3f} ms, {ms * 1e6 / longest:.1f} ns a step of the longest row")

    for how, src in warp.items():
        fn = build.load(src).fused_levels_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        for place, shared in (("shared", 1), ("global", 0)):
            lvl = torch.empty_like(blocks, dtype=torch.int8)
            t_out = [torch.empty_like(t) for t in tags]
            a_out = [torch.empty_like(a) for a in age]

            def run(fn=fn, shared=shared, lvl=lvl, t_out=t_out, a_out=a_out):
                rc = fn(ptr(blocks), ptr(offsets), ptr(order), rows, *geom,
                        ptrs(*(t.data_ptr() for t in tags)), ptrs(*(a.data_ptr() for a in age)),
                        ptrs(*(t.data_ptr() for t in t_out)), ptrs(*(a.data_ptr() for a in a_out)),
                        shared, ptr(lvl), stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")

            timed(f"one warp a row, levels {how}, state in {place} memory", run,
                  lambda lvl=lvl, t_out=t_out, a_out=a_out: (lvl, t_out, a_out))
    fn = build.load(thread).fused_levels_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
    lvl = torch.empty_like(blocks, dtype=torch.int8)
    state = {}

    def run_thread():
        # it walks the state in place: every call starts from the carry
        state["t"] = [t.clone() for t in tags]
        state["a"] = [a.clone() for a in age]
        rc = fn(ptr(blocks), ptr(offsets), rows, *geom,
                ptrs(*(t.data_ptr() for t in state["t"])),
                ptrs(*(a.data_ptr() for a in state["a"])), ptr(lvl), stream_ptr(dev))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    timed("one thread a row (the design before)", run_thread,
          lambda: (lvl, state["t"], state["a"]))


# K3b before: one thread an element, the row found by a 64-bit division.
K3B_THREAD_PER_ELEMENT = r"""
#include <cuda_runtime.h>
#include "basedelta_step.h"

__global__ void decompress_elementwise(const int32_t* __restrict__ base,
                                       const int32_t* __restrict__ deltas,
                                       int64_t e, int w, int32_t* __restrict__ out) {
  const int64_t n = e * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = bd_wrap_add(base[i / w], deltas[i]);
}

extern "C" int basedelta_decompress_launch(const void* base, const void* deltas,
                                           int64_t e, int w, int vec, void* out,
                                           void* stream) {
  const int64_t g = (e * w + 255) / 256;
  decompress_elementwise<<<(int)(g < 65535 * 32 ? g : 65535 * 32), 256, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)base, (const int32_t*)deltas, e, w, (int32_t*)out);
  return (int)cudaGetLastError();
}
"""


def k3b_variants(dev, readings):
    import numpy as np
    import torch

    from repro_torch import memsim
    from repro_torch.core import build_workload
    from repro_torch.kernels import build
    from repro_torch.kernels.basedelta import basedelta as bd
    from repro_torch.kernels.basedelta.ops import pack_ragged
    from repro_torch.kernels.build import ptr, stream_ptr

    before = rebuilt(bd.SOURCE, "element-wise", K3B_THREAD_PER_ELEMENT)
    build.build([bd.SOURCE, before])
    wl = build_workload("bfs", "google", hierarchy=memsim.PAPER, device=dev)
    packed = [pack_ragged(t.miss_blocks, t.miss_offsets) for t in cs.amc_entry_tables(wl)]
    del wl
    tiles = torch.from_numpy(np.concatenate([p[0] for p in packed])).to(dev)
    counts = torch.from_numpy(np.concatenate([p[1] for p in packed])).to(dev)
    deltas, _ = bd.basedelta_compress_tiles(tiles, counts)
    base = tiles[:, 0].contiguous()
    e, w = deltas.shape
    ref = bd.basedelta_decompress_plain(base, deltas)
    cs.log(f"K3b at path D's entry tiles ({e}, {w})")
    out = torch.empty_like(deltas)
    for name, src, vec in (("vector route", bd.SOURCE, 1), ("scalar route", bd.SOURCE, 0),
                           ("one thread an element (the design before)", before, 0)):
        fn = build.load(src).basedelta_decompress_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 2)

        def run(fn=fn, vec=vec):
            rc = fn(ptr(base), ptr(deltas), e, w, vec, ptr(out), stream_ptr(dev))
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        out.fill_(0x5A5A5A5A)
        run()
        cs.check(torch.equal(out, ref), f"K3b {name}: != plain")
        ms = cs.cuda_ms(run, dev, reps=50)
        readings[f"K3b {name}"] = ms
        cs.log(f"K3b, {name}: {ms:.4f} ms")
    lib = cs.cuda_ms(lambda: base[:, None] + deltas, dev, reps=50)
    readings["base[:, None] + deltas"] = lib
    cs.log(f"base[:, None] + deltas: {lib:.4f} ms")


def pass_ms(fn, dev, names, reps=5):
    """Device milliseconds a call of ``fn`` spends in each kernel whose name
    holds one of ``names``, from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    out = {n: 0.0 for n in names}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                out[n] += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
    return {n: us / 1e3 / reps for n, us in out.items()}


# K6 with the state term in a pass of its own (ssd_state_pass.cuh): pass C
# leaves it out and writes its float32 intra-chunk y to a scratch.
K6_STATE_PASS_EDITS = [
    ("const float4* __restrict__ pos_g,\n                  T* __restrict__ y,",
     "const float4* __restrict__ pos_g,\n                  float* __restrict__ y,"),
    ("      if (st == 0) {\n        // exp(cum[t]) C[t] . S_{c-1}",
     "      if (false) {  // the state term runs in its own pass\n        // exp(cum[t]) C[t] . S_{c-1}"),
    ("    for (int q = 0; q < SP; ++q) load_rows<P, 1>(ss + q * N * P, src + q * N * P, P, N, N);",
     "    for (int q = 0; q < 0; ++q) load_rows<P, 1>(ss + q * N * P, src + q * N * P, P, N, N);"),
    ("        T* yrow = y + ", "        float* yrow = y + "),
    ("          if constexpr (NP == 1)\n            *reinterpret_cast<uint32_t*>(yrow + p)",
     "          if constexpr (false)\n            *reinterpret_cast<uint32_t*>(yrow + p)"),
    ("  const int bytes = SsdOutputSmem(P, N, NP, SP, lpad).total;\n",
     "  float* yf = intra_scratch(bsz * s_len * h * P);\n"
     "  if (!yf) return (int)cudaErrorMemoryAllocation;\n"
     "  const int bytes = SsdOutputSmem(P, N, NP, SP, lpad).total;\n"),
    ("(const float4*)pos, (T*)y, sd, s_len, h, chunk);\n  return (int)cudaGetLastError();\n}",
     "(const float4*)pos, yf, sd, s_len, h, chunk);\n"
     "  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n"
     "  return launch_state_term<T, P, N>(c, planes, pos, yf, y, sd, bsz, s_len, h, chunk, stream);\n}"),
]
# K6's float32 route on the CUDA cores (ssd_f32_cuda_cores.cuh)
K6_CUDA_CORE_EDITS = [
    ("  return dispatch<float>(p, n, x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd, bsz,\n"
     "                         s_len, h, chunk, s);",
     "  return dispatch_cc(p, n, x, dt, a, b, c, init, y, fin, ds, last, planes, pos, sd, bsz,\n"
     "                     s_len, h, chunk, s);"),
]


def spliced(source: Path, name: str, cuh: str, edits) -> Path:
    """``source`` with each (old, new) of ``edits`` made once and the text
    of ``VARIANT_CSRC / cuh`` put before its ``launch`` template."""
    anchor = "template <typename T, int P, int N>\nint launch("
    return edited(source, name,
                  [*edits, (anchor, (VARIANT_CSRC / cuh).read_text() + "\n" + anchor)])


def k6_variants(dev, readings):
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain, ssd_naive

    src = ssd.SOURCE
    state_pass = spliced(src, "state-pass", "ssd_state_pass.cuh", K6_STATE_PASS_EDITS)
    tc = {"head groups of 8 (the kernel)": src}
    for hg in (4, 16):
        tc[f"head groups of {hg}"] = variant(src, f"hg{hg}", "constexpr int HG_OUTPUT = 8;",
                                             f"constexpr int HG_OUTPUT = {hg};")
    tc["state term in a pass of its own"] = state_pass
    f32 = {f"{parts} bf16 parts a side" + (" (the kernel)" if parts == 3 else ""):
           variant(src, f"f32parts{parts}", '#include "ssd_step.h"',
                   f'#define SSD_F32_PARTS {parts}\n#include "ssd_step.h"')
           for parts in (3, 2)}
    f32["float32 FMAs on the CUDA cores"] = spliced(src, "f32-cuda-cores",
                                                    "ssd_f32_cuda_cores.cuh", K6_CUDA_CORE_EDITS)
    f32["state term in a pass of its own"] = state_pass
    before = rebuilt(src, "block-per-head", (VARIANT_CSRC
                                             / "ssd_scan_block_per_head.cu").read_text())
    build.build(list(dict.fromkeys([*tc.values(), *f32.values(), before])))  # each once
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    names = ["ssd_state_kernel", "ssd_carry_kernel", "ssd_output_kernel", "ssd_state_term_kernel"]

    def tc_runner(path, x, dt, a, b, c, chunk=256):
        lib = build.load(path)
        fn = lib.ssd_scan_launch
        fn.argtypes = [vp] * 12 + [i64] * 8 + [ci, ci, ci, ci, ci, vp]
        bsz, s, h, p = x.shape
        n, nc = b.shape[-1], -(-s // chunk)
        lpad = chunk if chunk > 64 else -(-chunk // 16) * 16
        is_bf16 = int(x.dtype == torch.bfloat16)
        y = torch.empty_like(x)
        fin = torch.empty((bsz, h, p, n), device=dev)
        states = torch.empty((bsz, nc, h, n, p), device=dev)
        last = torch.empty((bsz, nc, h), device=dev)
        planes = torch.empty((bsz, nc, h, lib.ssd_scan_state_parts(is_bf16), n, p),
                             dtype=torch.bfloat16, device=dev)
        pos = torch.empty((bsz, nc, h, lpad, 4), device=dev)

        def run():
            rc = fn(ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c), None, ptr(y), ptr(fin), ptr(states),
                    ptr(last), ptr(planes), ptr(pos), s * h * p, h * p, s * n, n, s * n, n, bsz,
                    s, h, p, n, chunk, is_bf16, stream_ptr(dev))
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
            return y, fin
        return run

    def outside(got, ref, tol):
        return int(((got.double() - ref.double()).abs()
                    > tol["atol"] + tol["rtol"] * ref.double().abs()).sum())

    # the new float32 designs first, held as chip_smoke.py holds the kernel
    # (beside it): against the plain version on two of its ragged families
    # (chunks 48 and 512, P 32 / N 16 and P 64 / N 128), and against the
    # recurrence ssd_naive at chunk 256 with dt = softplus(N(0, 1))
    rng = np.random.default_rng(1)
    for (bsz, s, h, p, n, chunk, sp) in ((2, 300, 3, 32, 16, 48, False),
                                         (1, 1100, 9, 64, 128, 512, False),
                                         (1, 512, 4, 64, 64, 256, True)):
        x, dt, a, b, c, _ = cs.k6_inputs(rng, bsz, s, h, p, n, torch.float32, dev,
                                         softplus_dt=sp)
        ref = ssd_naive(x, dt, a, b, c) if sp else ssd_chunked_plain(x, dt, a, b, c, chunk)
        for name in ("3 bf16 parts a side (the kernel)", "float32 FMAs on the CUDA cores",
                     "state term in a pass of its own"):
            y, fin = tc_runner(f32[name], x, dt, a, b, c, chunk)()
            e = max(cs.close(y, ref[0], what=f"K6 {name}: y", **cs.SSD_TOL["float32"]),
                    cs.close(fin, ref[1], what=f"K6 {name}: state", **cs.SSD_TOL["float32"]))
            cs.log(f"K6 float32 {name} == {'ssd_naive' if sp else 'plain'} at ({bsz}, {s}, {h}, "
                   f"{p}), N {n}, chunk {chunk}: max abs err {e:.3g}")

    # path F's shape: x (4, 4096, 64, 64) bf16, B/C (4, 4096, 64), chunk 256,
    # dt = softplus(N(0, 1)), a = -1 (the model's init)
    rng = np.random.default_rng(0)
    x, dt, a, b, c, _ = cs.k6_inputs(rng, 4, 4096, 64, 64, 64, torch.bfloat16, dev,
                                     softplus_dt=True)
    ref = ssd_chunked_plain(x, dt, a, b, c, 256)
    cs.log("K6 at path F's shape, x (4, 4096, 64, 64) bf16, chunk 256")
    for name, path in tc.items():
        run = tc_runner(path, x, dt, a, b, c)
        y, fin = run()
        e = max(cs.close(y, ref[0], what=f"K6 {name}: y", **cs.SSD_TOL["bfloat16"]),
                cs.close(fin, ref[1], what=f"K6 {name}: state", **cs.SSD_TOL["float32"]))
        ms = cs.cuda_ms(run, dev, reps=20)
        parts = pass_ms(run, dev, names)
        readings[f"K6 tensor cores, {name}"] = ms
        readings[f"K6 tensor cores, {name}: passes"] = parts
        cs.log(f"K6 tensor cores, {name}: {ms:.4f} ms; passes A {parts['ssd_state_kernel']:.4f}, "
               f"B {parts['ssd_carry_kernel']:.4f}, C {parts['ssd_output_kernel']:.4f}, "
               f"D (state term) {parts['ssd_state_term_kernel']:.4f} ms (torch.profiler); "
               f"max abs err {e:.3g}")
    fn = build.load(before).ssd_scan_launch
    fn.argtypes = [vp] * 8 + [i64, i64, ci, ci, ci, ci, ci, vp]
    y, fin = torch.empty_like(x), torch.empty((4, 64, 64, 64), device=dev)

    def run_before():
        rc = fn(ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c), None, ptr(y), ptr(fin), 4, 4096, 64, 64,
                64, 256, 1, stream_ptr(dev))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    run_before()
    cs.close(y, ref[0], what="K6 block per head: y", **cs.SSD_TOL["bfloat16"])
    ms = cs.cuda_ms(run_before, dev, reps=5)
    readings["K6 one block per (batch, head), scalar float32 (the design before)"] = ms
    cs.log(f"K6 one block per (batch, head), scalar float32 (the design before): {ms:.4f} ms")
    ms = cs.cuda_ms(lambda: ssd_chunked_plain(x, dt, a, b, c, 256), dev, reps=2)
    readings["K6 plain version"] = ms
    cs.log(f"K6 plain version: {ms:.3f} ms")

    # the float32 route at the cross-check's shape, (4, 512, 64, 64), N 64,
    # and at N 128 (where two parts miss float32's tolerance)
    for n in (64, 128):
        x, dt, a, b, c, _ = cs.k6_inputs(rng, 4, 512, 64, 64, n, torch.float32, dev,
                                         softplus_dt=True)
        ref = ssd_chunked_plain(x, dt, a, b, c, 256)
        for name, path in f32.items():
            run = tc_runner(path, x, dt, a, b, c)
            y, fin = run()
            err = float((y - ref[0]).abs().max())
            over = outside(y, ref[0], cs.SSD_TOL["float32"]) + outside(fin, ref[1],
                                                                      cs.SSD_TOL["float32"])
            ms = cs.cuda_ms(run, dev, reps=20)
            parts = pass_ms(run, dev, names + ["ssd_state_cc_kernel", "ssd_output_cc_kernel"])
            readings[f"K6 float32, {name}, N {n}"] = dict(ms=ms, max_abs_err=err,
                                                          outside_tol=over, passes=parts)
            cs.log(f"K6 float32 (4, 512, 64, 64), N {n}, {name}: {ms:.4f} ms, max abs err "
                   f"{err:.3g}, {over} elements outside rtol=atol=2e-4; passes (torch.profiler) "
                   + ", ".join(f"{k} {v:.4f}" for k, v in parts.items() if v))


# K1 before: one thread a row, each step loading its access from global
# memory and storing its hit byte (lru_row of cache_sim_step.h).
K1_THREAD_PER_STEP = r"""
#include <cuda_runtime.h>
#include "cache_sim_step.h"

template <int CAP>
__global__ void lru_hits_step_kernel(const int32_t* __restrict__ blocks,
                                     const int64_t* __restrict__ offsets, int rows, int ways,
                                     const int32_t* __restrict__ tags_in,
                                     const int32_t* __restrict__ age_in,
                                     int32_t* __restrict__ tags_out,
                                     int32_t* __restrict__ age_out, uint8_t* __restrict__ hits) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t s = row * ways;
  lru_row<CAP>(blocks, offsets[row], offsets[row + 1], ways, tags_in + s, age_in + s,
               tags_out + s, age_out + s, hits);
}

extern "C" int lru_hits_launch(const void* blocks, const void* offsets, int rows, int ways,
                               const void* tags_in, const void* age_in, void* tags_out,
                               void* age_out, void* hits, void* stream) {
#define STEP(CAP) lru_hits_step_kernel<CAP><<<(rows + 31) / 32, 32, 0, (cudaStream_t)stream>>>( \
    (const int32_t*)blocks, (const int64_t*)offsets, rows, ways, (const int32_t*)tags_in, \
    (const int32_t*)age_in, (int32_t*)tags_out, (int32_t*)age_out, (uint8_t*)hits)
  if (ways <= 8) STEP(8); else STEP(16);
  return (int)cudaGetLastError();
}
"""

# K1 design (b): one thread a row, the warp staging its 32 rows' next 64
# accesses in shared memory with cp.async (two stages, 16-byte chunks), a
# thread reading 4 accesses a 16-byte shared load, the touched way found by
# a pairwise tree over the ways, hit bytes stored 4 at a time.
K1_STAGED = r"""
#include <cuda_runtime.h>
#include "cache_sim_step.h"
// lru_step with the touched way found by a pairwise tree instead of a
// chain over the ways: log2(CAP) levels of compare-and-select, the lower
// ways winning ties at each node, so the winner is the same first minimum
// and the outputs are lru_step's bit for bit.  Ways beyond `ways` take
// part with key INT32_MAX and never win over a real way.  The tree is an
// implicit binary heap (way w's leaf at CAP + w, node i over 2i and
// 2i + 1) walked by one loop of CAP - 1 nodes, so that it unrolls with
// constant indices and its arrays stay in registers.
template <int CAP>
CS_HD bool lru_step_tree(int32_t* tags, int32_t* age, int ways, int32_t b, int32_t t,
                         bool update) {
  int32_t key[2 * CAP];
  int idx[2 * CAP];
  bool hit = false;
CS_UNROLL
  for (int w = 0; w < CAP; ++w) {
    const bool h = w < ways && tags[w] == b;
    key[CAP + w] = w >= ways ? CS_INT32_MAX : h ? CS_INT32_MIN : age[w];
    idx[CAP + w] = w;
    hit = hit || h;
  }
CS_UNROLL
  for (int i = CAP - 1; i >= 1; --i) {
    const bool right = key[2 * i + 1] < key[2 * i];
    key[i] = right ? key[2 * i + 1] : key[2 * i];
    idx[i] = right ? idx[2 * i + 1] : idx[2 * i];
  }
  const int way = idx[1];  // the root (for CAP 1, way 0's leaf)
  if (update) {
CS_UNROLL
    for (int w = 0; w < CAP; ++w) {
      if (w == way) {
        tags[w] = b;
        age[w] = t;
      }
    }
  }
  return hit;
}

// K1's staged walk (lru_hits.cu): one thread per (stream, set) row, 32 rows
// a warp.  The warp copies each row's next LRU_WINDOW accesses into shared
// memory ahead of the walk (cp.async, two stages), in 16-byte chunks from
// a window base aligned down to 4 accesses; a thread takes its row's
// accesses 4 at a time (one 16-byte shared load) and stores their 4 hit
// bytes as one word where all 4 lie in its row, byte by byte at the row's
// two ends.  The loop body is one group of 4 steps, so that the walk's
// code stays small for every CAP.
#define LRU_WINDOW 64
// Words between two rows of a stage: rows stay 16-byte aligned, and the 8
// lanes of one phase of a 16-byte shared load hit 8 distinct bank groups.
#define LRU_STRIDE (LRU_WINDOW + 4)

CS_HD int64_t lru_window_base(int64_t lo) { return lo & ~(int64_t)3; }

// Windows a row [lo, hi) walks.
CS_HD int lru_windows(int64_t lo, int64_t hi) {
  return hi > lo ? (int)((hi - lru_window_base(lo) + LRU_WINDOW - 1) / LRU_WINDOW) : 0;
}

// Bytes of the 16-byte chunk at access index a that the copy reads: those
// before the row's end (the rest is zero-filled), so nothing past the
// stream is read.
CS_HD int lru_chunk_bytes(int64_t a, int64_t hi) {
  const int64_t v = (hi - a) * 4;
  return v <= 0 ? 0 : v >= 16 ? 16 : (int)v;
}

// One thread's walk over accesses [base, base + 4) of its row [lo, hi)
// (base a multiple of 4), whose staged values are `staged` (16-byte
// aligned): the steps of the accesses in the row, then their hit bytes,
// packed in one word, stored whole where all 4 lie in [lo, hi) and one by
// one where some do.
template <int CAP>
CS_HD void lru_block4(const int32_t* staged, int64_t base, int64_t lo, int64_t hi, int ways,
                      int32_t* tg, int32_t* ag, uint8_t* hits) {
  int32_t bb[4];
#if defined(__CUDA_ARCH__)
  const int4 v = *reinterpret_cast<const int4*>(staged);
  bb[0] = v.x, bb[1] = v.y, bb[2] = v.z, bb[3] = v.w;
#else
  for (int e = 0; e < 4; ++e) bb[e] = staged[e];
#endif
  uint32_t w = 0u;
CS_UNROLL
  for (int e = 0; e < 4; ++e) {
    const int64_t i = base + e;
    if (i >= lo && i < hi) {
      const bool hit = lru_step_tree<CAP>(tg, ag, ways, bb[e], (int32_t)(i - lo + 1), bb[e] >= 0);
      w |= (uint32_t)hit << (8 * e);
    }
  }
  if (base >= lo && base + 4 <= hi) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint32_t*>(hits + base) = w;
#else
    for (int e = 0; e < 4; ++e) hits[base + e] = (uint8_t)(w >> (8 * e));
#endif
  } else {
CS_UNROLL
    for (int e = 0; e < 4; ++e)
      if (base + e >= lo && base + e < hi) hits[base + e] = (uint8_t)(w >> (8 * e));
  }
}


template <int CAP>
__global__ void __launch_bounds__(32)
lru_hits_staged_kernel(const int32_t* __restrict__ blocks, const int64_t* __restrict__ offsets,
                       int rows, int ways, const int32_t* __restrict__ tags_in,
                       const int32_t* __restrict__ age_in, int32_t* __restrict__ tags_out,
                       int32_t* __restrict__ age_out, uint8_t* __restrict__ hits) {
  constexpr int CHUNKS = LRU_WINDOW / 4;
  __shared__ __align__(16) int32_t stage[2][32][LRU_STRIDE];
  __shared__ int64_t base_s[32], hi_s[32];
  const int lane = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * 32 + lane;
  const bool has = row < rows;
  const int64_t lo = has ? offsets[row] : 0, hi = has ? offsets[row + 1] : 0;
  const int64_t base = lru_window_base(lo);
  base_s[lane] = base;
  hi_s[lane] = hi;
  const int windows = (int)__reduce_max_sync(0xffffffffu, (unsigned)lru_windows(lo, hi));
  int32_t tg[CAP], ag[CAP];
#pragma unroll
  for (int w = 0; w < CAP; ++w) {
    tg[w] = has && w < ways ? tags_in[row * ways + w] : -2;
    ag[w] = has && w < ways ? age_in[row * ways + w] : CS_INT32_MAX;
  }
  __syncwarp();
  auto issue = [&](int k) {
    for (int idx = lane; idx < 32 * CHUNKS; idx += 32) {
      const int r = idx / CHUNKS, ch = idx % CHUNKS;
      const int64_t a = base_s[r] + (int64_t)k * LRU_WINDOW + 4 * ch;
      const int bytes = lru_chunk_bytes(a, hi_s[r]);
      const unsigned d = (unsigned)__cvta_generic_to_shared(&stage[k & 1][r][4 * ch]);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(blocks + (bytes ? a : 0)), "r"(bytes));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (windows > 0) issue(0);
  for (int k = 0; k < windows; ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    if (k + 1 < windows) issue(k + 1);
    const int32_t* st = stage[k & 1][lane];
#pragma unroll 1
    for (int q = 0; q < LRU_WINDOW / 4; ++q)
      lru_block4<CAP>(st + 4 * q, base + (int64_t)k * LRU_WINDOW + 4 * q, lo, hi, ways, tg, ag,
                      hits);
  }
  if (has) {
#pragma unroll
    for (int w = 0; w < CAP; ++w)
      if (w < ways) {
        tags_out[row * ways + w] = tg[w];
        age_out[row * ways + w] = ag[w];
      }
  }
}

extern "C" int lru_hits_launch(const void* blocks, const void* offsets, int rows, int ways,
                               const void* tags_in, const void* age_in, void* tags_out,
                               void* age_out, void* hits, void* stream) {
#define STAGED(CAP) lru_hits_staged_kernel<CAP><<<(rows + 31) / 32, 32, 0, (cudaStream_t)stream>>>( \
    (const int32_t*)blocks, (const int64_t*)offsets, rows, ways, (const int32_t*)tags_in, \
    (const int32_t*)age_in, (int32_t*)tags_out, (int32_t*)age_out, (uint8_t*)hits)
  if (ways <= 8) STAGED(8); else STAGED(16);
  return (int)cudaGetLastError();
}
"""


def k1_variants(dev, readings):
    """K1 on path B's four launches (pgd/google under PAPER), each design
    held bit for bit against the plain version of the first launch and
    against the committed kernel on every launch, then timed."""
    import torch

    from repro_torch import memsim
    from repro_torch.core import build_workload, resolve_prefetchers, score_prefetchers_batched
    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.cache_sim import cache_sim as k1
    from repro_torch.memsim import engine

    designs = {
        "one lane group a row, ways across lanes (the kernel, design a)": k1.SOURCE,
        "one thread a row, accesses staged in shared memory (design b)":
            rebuilt(k1.SOURCE, "staged", K1_STAGED),
        "one thread a row, a global load and store a step (the design before)":
            rebuilt(k1.SOURCE, "thread-per-step", K1_THREAD_PER_STEP),
    }
    build.build(list(designs.values()))
    calls = []

    def recorded(*args):
        calls.append(args)
        return k1.lru_hits(*args)

    engine.lru_hits = recorded
    try:
        wl = build_workload("pgd", "google", hierarchy=memsim.PAPER, device=dev)
        score_prefetchers_batched(wl, resolve_prefetchers(["amc", "vldp"]))
    finally:
        engine.lru_hits = k1.lru_hits
    del wl
    for li, args in enumerate(calls):
        lens = args[1][1:] - args[1][:-1]
        longest = int(lens.max())
        ref = k1.lru_hits(*args)
        if li == 0:
            cs.check(cs.max_err(ref, k1.lru_hits_plain(*args)) == 0, "K1 launch 1: kernel != plain")
        cs.log(f"K1 launch {li + 1}: {args[0].numel()} accesses, {args[2].shape[0]} rows x "
               f"{args[2].shape[1]} ways, longest row {longest}")
        for name, path in designs.items():
            fn = build.load(path).lru_hits_launch
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
            hits = torch.empty_like(ref[0])
            to, ao = torch.empty_like(ref[1]), torch.empty_like(ref[2])

            def run(fn=fn, hits=hits, to=to, ao=ao):
                rc = fn(ptr(args[0]), ptr(args[1]), args[2].shape[0], args[2].shape[1],
                        ptr(args[2]), ptr(args[3]), ptr(to), ptr(ao), ptr(hits), stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")

            run()
            cs.check(cs.max_err([hits, to, ao], list(ref)) == 0, f"K1 {name}, launch {li + 1}: "
                     "!= the kernel")
            ms = cs.cuda_ms(run, dev, reps=3)
            readings[f"K1 launch {li + 1}, {name}"] = dict(ms=ms, ns_per_step=ms * 1e6 / longest)
            cs.log(f"  {name}: {ms:.3f} ms, {ms * 1e6 / longest:.1f} ns a step of the longest row")


# K5's float32 route with each warp splitting its own fragments' K and V
# from padded float32 tiles (kernel_variants_csrc/fa_f32_per_warp.cuh), no
# split pass and no planes.
K5_F32_PER_WARP_EDITS = [
    ("static constexpr int BK = FA_F32_BK(HD), KST = HD, VST = HD;",
     "static constexpr int BK = FA_F32_BK(HD), KST = HD + 8, VST = HD + 4;"),
    ("static constexpr int PLANES = 2 * F32_PARTS * BK * HD * 2;",
     "static constexpr int PLANES = 0;"),
    ("    split_tiles<HD, KST, VST, BK>(kp, vp, ks, vs);\n", ""),
    ("k_plane_parts<HD, BK>(kp, lane, kk, np, kb);", "k_parts<KST>(ks, lane, kk, np, kb);"),
    ("v_plane_parts<HD, BK>(vp, lane, j, dp, vb);", "v_parts<VST>(vs, lane, j, dp, vb);"),
    ("template <int HD>\nstruct F32Smem",
     (VARIANT_CSRC / "fa_f32_per_warp.cuh").read_text() + "\ntemplate <int HD>\nstruct F32Smem"),
]


# K5's float32 route with S's six pair products summed into one pair of
# accumulators, where the kernel keeps the five smaller pairs apart.
ONE_ACC = "tensor cores, S's six pair products into one accumulator"
K5_F32_ONE_ACC_EDITS = [
    ("mma_parts_apart(s + 8 * np, s + 8 * np + 4, lo, lo + 4, qa, kb);",
     "mma_parts(s + 8 * np, s + 8 * np + 4, qa, kb);"),
]


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with each (old, new) of ``edits`` made once."""
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{source.name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return rebuilt(source, name, text)


def k5f32_variants(dev, readings):
    """K5's float32 route: the tensor-core kernel (each float32 K / V tile
    split once into bf16 planes, 32-key tiles) against 64-key tiles and
    against each warp splitting its own fragments from the float32 tiles,
    and two designs on the CUDA cores (register-blocked; scalar, the design
    before), each held within ``chip_smoke.ATTN_TOL["float32"]`` on five
    families first, then timed at the cross-check's shape (4, 512, 32, 64)
    and at (4, 2048, 32, 64), causal; beside the plain version and SDPA in
    float32.  The kernel with S's six pair products in one accumulator (the
    summation order before) is timed too, its error against the tolerance
    reported rather than held, on the families and on the CPU test's
    cancelling family that the card's way of summing puts it outside."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

    src, inc = fa.SOURCE, '#include "flash_attn_step.h"'
    bk64 = (inc, "#define FA_F32_BK(hd) ((hd) <= 64 ? 64 : 32)\n" + inc)  # 64-key tiles
    cc = rebuilt(src, "cuda-cores", (VARIANT_CSRC / "fa_f32_cuda_cores.cu").read_text())
    designs = {
        "tensor cores, each tile split once into bf16 planes, 32-key tiles (the kernel)":
            (src, "flash_attn_launch"),
        "tensor cores, each tile split once into bf16 planes, 64-key tiles":
            (edited(src, "f32-bk64", [bk64]), "flash_attn_launch"),
        "tensor cores, each warp splits its fragments, 32-key tiles":
            (edited(src, "f32-per-warp", K5_F32_PER_WARP_EDITS), "flash_attn_launch"),
        ONE_ACC: (edited(src, "f32-one-acc", K5_F32_ONE_ACC_EDITS), "flash_attn_launch"),
        "CUDA cores, register-blocked 4 x 4": (cc, "fa_f32_blocked_launch"),
        "CUDA cores, scalar (the design before)": (cc, "fa_f32_scalar_launch"),
    }
    paths = list(dict.fromkeys(p for p, _ in designs.values()))
    build.build(paths)
    for p in paths:
        for line in build.ptxas_report(p):
            if "f32" in line or "spill" in line or "registers" in line:
                cs.log(f"  [{p.parent.name}] {line}")
    i64, ci = ctypes.c_int64, ctypes.c_int

    def runner(path, entry, q, k, v, causal=True, win=0, qoff=0):
        fn = getattr(build.load(path), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [i64, i64, i64, ci, ci, ci, ci, ctypes.c_float,
                                               ci, i64, i64, ctypes.c_void_p]
        b, sq, h, hd = q.shape
        out = torch.empty_like(q)

        def run():
            rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), b, sq, k.shape[1], h, k.shape[2], hd, 0,
                    hd**-0.5, int(causal), win, qoff, stream_ptr(dev))
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
            return out
        return run

    rng = np.random.default_rng(3)
    families = [  # (name, b, sq, skv, h, kv, hd, causal, window, q_offset, cancelling)
        ("causal GQA hd 64", 2, 256, 256, 4, 2, 64, True, 0, 0, False),
        ("window 128 hd 128", 1, 300, 300, 2, 2, 128, True, 128, 0, False),
        ("hd 32 GQA 4, non-causal", 2, 100, 100, 8, 2, 32, False, 0, 0, False),
        ("GQA 4, q_offset 300 into 700 keys", 2, 400, 700, 8, 2, 64, True, 0, 300, False),
        ("cancelling pairs, hd 128", 1, 300, 300, 2, 2, 128, True, 128, 0, True),
    ]
    tol = cs.ATTN_TOL["float32"]

    def over_tolerance(got, ref):
        """The largest |got - ref| / (atol + rtol |ref|): above 1 is outside."""
        g, r = got.double(), ref.double()
        return float(((g - r).abs() / (tol["atol"] + tol["rtol"] * r.abs())).max())

    for name, b, sq, skv, h, kv, hd, causal, win, qoff, canc in families:
        q, k, v = cs.k5_inputs(rng, b, sq, skv, h, kv, hd, torch.float32, dev, canc)
        ref = blocked_attention_plain(q, k, v, causal, win, qoff)
        for dname, (path, entry) in designs.items():
            got = runner(path, entry, q, k, v, causal, win, qoff)()
            if dname == ONE_ACC:  # reported, not held
                readings[f"K5 float32 {dname}, {name}: error over tolerance"] = over_tolerance(
                    got, ref)
                continue
            cs.close(got, ref, what=f"K5 float32 {dname}, {name}", **tol)
    # tests/test_torch_flash_attn_f32tc.py's cancelling family (1, 300, 300,
    # 4, 4, 64) causal, window 10, the same inputs (seed 12), where its CPU
    # emulation of the tensor cores' sum puts S's six pairs in one
    # accumulator just outside the tolerance
    q, k, v = cs.k5_inputs(np.random.default_rng(12), 1, 300, 300, 4, 4, 64, torch.float32, dev,
                           True)
    ref = blocked_attention_plain(q, k, v, True, 10, 0)
    for dname, (path, entry) in designs.items():
        ratio = over_tolerance(runner(path, entry, q, k, v, True, 10, 0)(), ref)
        readings[f"K5 float32 {dname}, the CPU test's cancelling window-10 family: error over "
                 "tolerance"] = ratio
        cs.log(f"  {dname}, the CPU test's cancelling window-10 family: error "
               f"{ratio:.4f} of the tolerance")
        cs.check(dname == ONE_ACC or ratio <= 1.0, f"K5 float32 {dname}: outside the tolerance")
    cs.log(f"K5 float32: {len(designs)} designs within rtol 1e-4 atol 1e-5 on "
           f"{len(families)} families")
    for s in (512, 2048):
        b, h, hd = 4, 32, 64
        q, k, v = cs.k5_inputs(rng, b, s, s, h, h, hd, torch.float32, dev)
        flop = 4 * hd * b * h * (s * (s + 1) // 2)
        ref = blocked_attention_plain(q, k, v, True)
        cs.log(f"K5 float32 at ({b}, {s}, {h}, {hd}), causal, {flop / 1e9:.2f} GFLOP")
        for dname, (path, entry) in designs.items():
            run = runner(path, entry, q, k, v)
            if dname == ONE_ACC:
                err = float((run().double() - ref.double()).abs().max())
            else:
                err = cs.close(run(), ref, what=f"K5 float32 {dname}", **tol)
            ms = cs.cuda_ms(run, dev, reps=10)
            readings[f"K5 float32 S {s}, {dname}"] = dict(ms=ms, max_abs_err=err)
            cs.log(f"  {dname}: {ms:.4f} ms ({flop / ms * 1e-9:.1f} TFLOP/s), "
                   f"max abs err {err:.3g}")
        plain = cs.cuda_ms(lambda: blocked_attention_plain(q, k, v, True), dev, reps=3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), dev, reps=10)
        readings[f"K5 float32 S {s}, plain"] = plain
        readings[f"K5 float32 S {s}, SDPA"] = lib
        cs.log(f"  plain version: {plain:.4f} ms; SDPA in float32: {lib:.4f} ms")


def segsum_variants(dev, readings):
    """The ordered segment sum on google's push and pull edge orders (path
    B's graph): the kernel (one launch, two block roles, 8 chunks in flight
    a heavy warp, chunks passed through shared memory) against rings of 2,
    4 and 16 chunks, the two roles as two launches, chunks passed by
    shuffles (the first warp design), two passes (gather into edge-sorted
    order, then chains over contiguous memory) and one thread a segment
    (the design before), each held bit for bit against index_add_ on the
    CPU first."""
    import numpy as np
    import torch

    from repro_torch.graphs import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr
    from repro_torch.kernels.segment_sum import segment_sum as seg

    src, inc = seg.SOURCE, '#include "segment_sum_step.h"'
    both = rebuilt(src, "variants", src.read_text()
                   + (VARIANT_CSRC / "segment_sum_variants.cuh").read_text())
    designs = {"one launch, two block roles, 8 chunks in flight (the kernel)":
               (src, "segment_sum_launch")}
    for r in (2, 4, 16):
        designs[f"{r} chunks in flight"] = (
            variant(src, f"ring{r}", inc, f"#define SS_RING {r}\n" + inc), "segment_sum_launch")
    designs["the two roles as two launches"] = (both, "segment_sum_two_launches")
    designs["chunks passed by shuffles, each perm load just before its values load"] = (
        both, "segment_sum_shuffle_launch")
    designs["two passes: gather, then chains over contiguous memory"] = (
        both, "segment_sum_two_pass")
    designs["one thread a segment (the design before)"] = (both, "segment_sum_thread_launch")
    paths = list(dict.fromkeys(p for p, _ in designs.values()))
    build.build(paths)
    for p in paths:
        for line in build.ptxas_report(p):
            cs.log(f"  [{p.parent.name}] {line}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    g = make_dataset("google")
    for order, dst in (("push", g.neighbors), ("pull", g.transpose().edge_sources())):
        plan = seg.segment_plan(dst, g.num_vertices, dev)
        e, n = len(dst), g.num_vertices
        vals = torch.rand(e, generator=torch.Generator().manual_seed(3)).to(dev)
        ref = seg.segment_sum_plain(vals.cpu(), plan.ids.cpu(), n)
        longest = int((plan.offsets[1:] - plan.offsets[:-1]).max())
        cs.log(f"segment sum, google {order}: {e} edges into {n} segments, "
               f"{plan.heavy.numel()} of more than 32 edges, the longest {longest}")
        out = torch.empty(n, device=dev)
        scratch = torch.empty(e, device=dev)
        for name, (path, entry) in designs.items():
            fn = getattr(build.load(path), entry)
            two_pass = entry == "segment_sum_two_pass"
            scratch_args = [vp, ctypes.c_int64] if two_pass else []
            fn.argtypes = [vp] * 3 + [ci, vp, ci, vp] + scratch_args + [vp]

            def run(fn=fn, two_pass=two_pass):
                extra = (ptr(scratch), e) if two_pass else ()
                rc = fn(ptr(vals), ptr(plan.perm), ptr(plan.offsets), n, ptr(plan.heavy),
                        plan.heavy.numel(), ptr(out), *extra, stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")

            out.fill_(float("nan"))
            run()
            cs.check(cs.same_bits(out.cpu(), ref), f"segment sum {name}, {order}: != index_add_")
            ms = cs.cuda_ms(run, dev, reps=50)
            readings[f"segment sum {order}, {name}"] = ms
            cs.log(f"  {name}: {ms:.4f} ms")


VARIANTS = {"k5": k5_variants, "k4b": k4b_variants, "k2": k2_variants, "k3b": k3b_variants,
            "k6": k6_variants, "k1": k1_variants, "k5f32": k5f32_variants,
            "segsum": segsum_variants}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"kernel_variants: unknown {unknown}; choose from {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.log(cs.gpu_line())
    readings = {}
    for n in names:
        VARIANTS[n](dev, readings)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
