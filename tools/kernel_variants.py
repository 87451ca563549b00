#!/usr/bin/env python3
"""Times the design choices of the port's redesigned kernels on a CUDA
card, at the shapes of the main paths, by building variants of the
committed sources.

    python3 tools/kernel_variants.py [k5] [k4b] [k2] [k3b]   (default: all)

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

Every variant's output is held against the committed kernel's plain
version first (K2, K3b and K4b bit for bit, K5 within
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
    for h in source.parent.glob("*.h"):
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


VARIANTS = {"k5": k5_variants, "k4b": k4b_variants, "k2": k2_variants, "k3b": k3b_variants}


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
