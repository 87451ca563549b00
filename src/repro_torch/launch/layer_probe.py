"""Two-point layer probe: a cell's costs as a linear function of depth (the
port of ``repro/launch/layer_probe.py``).

The JAX probe corrects ``cost_analysis``, which counts a scan-over-layers
body once: it lowers each (arch x shape) at two small depths L1 < L2 and
fits ``cost(L) = fixed + L * per_layer``.  The port's dry run runs eagerly
and counts every layer, so here the fit corrects nothing: it saves time,
tracing two shallow models instead of, say, llama3-405b's 126 layers.  It
holds for any program linear in L, as an eager step with one module a
layer is (the optimizer's per-tensor updates and the gradient all-reduces
are linear in L too).

Hybrid (zamba2) varies the count of groups (``hybrid_attn_every`` Mamba
layers and the shared attention block) with the tail fixed; enc-dec varies
encoder and decoder depth together (whisper has Le == Ld).

    python -m repro_torch.launch.layer_probe --arch smollm_360m --shape train_4k

Writes ``results/layerprobe_torch/<arch>__<shape>__<mesh>.json`` with the
fitted flops / op bytes / collective bytes (host-only, like the dry run).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import fake_process_group, production_shape

OUT_DIR = "results/layerprobe_torch"


def probe_depths(cfg):
    """(L1, L2, unit_count_full, make_cfg(L)) for the two-point fit."""
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        tail = cfg.num_layers - (cfg.num_layers // every) * every
        full_groups = cfg.num_layers // every

        def mk(groups):
            return dataclasses.replace(cfg, num_layers=groups * every + tail, scan_layers=False)

        return 1, 2, full_groups, mk
    if cfg.family == "encdec":

        def mk(layers):
            return dataclasses.replace(cfg, num_layers=layers, encoder_layers=layers,
                                       scan_layers=False)

        return 1, 2, cfg.num_layers, mk

    def mk(layers):
        return dataclasses.replace(cfg, num_layers=layers, scan_layers=False)

    return 2, 4, cfg.num_layers, mk


def measure(cfg, shape, mesh) -> dict:
    """One rank's flops, op bytes and collective bytes of the cell."""
    rec = trace_cell(cfg, shape, mesh)
    return dict(flops=rec["flops"], bytes=rec["bytes_accessed"],
                coll_bytes=float(rec["collectives"]["total_bytes"]), coll=rec["collectives"])


def fit(m1: dict, m2: dict, l1: int, l2: int, units: int) -> dict:
    """``fixed + units * per_layer`` of each cost, from its values at depths
    ``l1`` and ``l2``."""
    out = {}
    for key in ("flops", "bytes", "coll_bytes"):
        per_unit = (m2[key] - m1[key]) / (l2 - l1)
        fixed = m1[key] - l1 * per_unit
        out[key] = fixed + units * per_unit
        out[key + "_per_layer"] = per_unit
        out[key + "_fixed"] = fixed
    return out


def run_probe(arch: str, shape_name: str, out_dir: str = OUT_DIR, multi_pod: bool = False):
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        print(f"[skip] {tag}")
        return None
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, _ = cell_supported(cfg, shape)
    if not ok:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    dims, axes = production_shape(multi_pod)
    try:
        t0 = time.time()
        l1, l2, full_units, mk = probe_depths(cfg)
        n = 1
        for d in dims:
            n *= d
        with fake_process_group(n):
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
            m1 = measure(mk(l1), shape, mesh)
            m2 = measure(mk(l2), shape, mesh)
        out = {"arch": arch, "shape": shape_name, "mesh": "x".join(map(str, dims)),
               "probe_l1": l1, "probe_l2": l2, "full_units": full_units,
               **fit(m1, m2, l1, l2, full_units)}
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[ok] {tag} ({time.time() - t0:.0f}s): flops={out['flops']:.3g} "
              f"coll={out['coll_bytes']:.3g}B")
        return out
    except Exception as e:  # noqa: BLE001 -- a failed cell is reported, the rest go on
        traceback.print_exc()
        print(f"[ERROR] {tag}: {e}")
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            run_probe(a, s, args.out, multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
