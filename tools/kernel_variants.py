#!/usr/bin/env python3
"""Times the design choices of K5's bfloat16 kernel and of K4b on a CUDA
card, at the shapes of the main paths, by building variants of the
committed sources.

    python3 tools/kernel_variants.py

Each variant is the committed ``.cu`` file with one constant replaced,
written to ``src/repro_torch/kernels/_build/variants/`` and built by the
port's ``build`` module; its C entry point is called directly.

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

Every variant's output is held against the committed kernel's plain
version first (K4b bit for bit, K5 within ``chip_smoke.ATTN_TOL``).  Prints
the card's name and power limit, then one line per reading, and as the
last line a JSON object of all readings.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def variant(source: Path, name: str, old: str, new: str) -> Path:
    """``source`` with ``old`` replaced by ``new``, beside its headers'
    copies (the build hashes the headers next to a source)."""
    from repro_torch.kernels import build

    text = source.read_text()
    if old not in text:
        raise SystemExit(f"{source.name}: {old!r} not found")
    out = build.BUILD_DIR / "variants" / f"{source.stem}-{name}"
    out.mkdir(parents=True, exist_ok=True)
    for h in source.parent.glob("*.h"):
        (out / h.name).write_text(h.read_text())
    path = out / source.name
    path.write_text(text.replace(old, new))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.log(cs.gpu_line())
    readings = {}
    k5_variants(dev, readings)
    k4b_variants(dev, readings)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
