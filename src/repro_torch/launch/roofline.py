"""Roofline analysis of the dry run's records (the port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds per step:

  compute    = FLOPs_per_device / peak_flops
  memory     = analytic_bytes_per_device / hbm_bw
  collective = link_bytes_per_device / link_bw

The dry run's counts are per rank (one rank's program, ``launch/dryrun.py``),
so no division by the device count is needed.  Collective link-bytes
convention: all-reduce counts 2x its payload (ring reduce + broadcast
phases), all-gather / reduce-scatter / all-to-all / collective-permute 1x
their result bytes.

The peaks are a :class:`Peaks` value.  The default, :data:`H100_SXM`, is
the NVIDIA H100 SXM5 80GB: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, NVLink 4 at 450 GB/s each way (NVIDIA's H100 Tensor
Core GPU datasheet).  A 256-card mesh
spans hosts, and past one host's eight cards the links are the network's,
not NVLink: the NVLink figure is an optimistic stand-in for the TPU's
per-link ICI bandwidth that the JAX package's terms use.

The "roofline fraction" figure of merit is compute_term / max(all terms):
1.0 means the step is compute-bound at peak.  MODEL_FLOPS (6·N·D_tokens,
active params for MoE) over global FLOPs catches remat/redundancy waste.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Peaks:
    flops: float  # dense bf16 FLOP/s of one device
    hbm_bw: float  # B/s
    link_bw: float  # B/s of one link, one way


H100_SXM = Peaks(flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

LINK_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

SHAPE_TOKENS = {  # global tokens processed per step
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,
    "long_500k": 1,
}

# MODEL_FLOPS conventions: 6·N·T for training (fwd 2NT + bwd 4NT),
# 2·N·T for inference.
FLOPS_PER_PARAM_TOKEN = {"train": 6.0, "prefill": 2.0, "decode": 2.0}

DRYRUN_DIR = "results/dryrun_torch"
PROBE_DIR = "results/layerprobe_torch"


def load_cells(dryrun_dir: str = DRYRUN_DIR) -> List[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _cfg_info(arch: str, shape: str) -> dict:
    """Analytic model facts for the memory bound (no allocation)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs

    cfg = get_config(arch)
    info = dict(d_model=cfg.d_model, layers=cfg.num_layers)
    if SHAPES[shape].mode == "decode":
        cspec = specs.cache_spec(cfg, SHAPES[shape])
        info["cache_bytes"] = float(sum(t.numel() * t.element_size() for t in cspec.values()))
    return info


def _analytic_memory_bytes(rec: dict) -> float:
    """Fused-execution HBM-traffic lower bound per device per step.

    The dry run's op bytes are unfused-op accounting (every intermediate
    counted); this analytic bound is what the memory term uses.
    Conventions: train touches params 4x in fp32 (p, g, m, v read+write
    amortized) + one activation save + read per layer; inference reads
    bf16 active params once + the KV/state cache."""
    devices = rec.get("devices", 256)
    n = rec.get("param_count") or 0
    n_active = rec.get("active_param_count") or n
    tokens = SHAPE_TOKENS[rec["shape"]]
    info = _cfg_info(rec["arch"], rec["shape"])
    d_model, layers = info["d_model"], info["layers"]
    if rec["mode"] == "train":
        param_traffic = n * 4.0 * 4  # fp32 p/g/m/v r+w amortized
        act = 2.0 * layers * tokens * d_model * 2  # save+read per layer, bf16
        total = param_traffic + act
    elif rec["mode"] == "prefill":
        total = n_active * 2.0 + 2.0 * layers * tokens * d_model * 2
    else:  # decode: params replicate over the data axis (weights are
        # TP-sharded only), so each device streams its model-axis shard; the
        # cache is batch/seq sharded over all devices.
        model_shards = 16
        return n_active * 2.0 / model_shards + info.get("cache_bytes", 0.0) / devices
    return total / devices


def analyze_cell(rec: dict, probe: Optional[dict] = None,
                 peaks: Peaks = H100_SXM) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    flops = probe["flops"] if probe else rec["flops"]
    colls = rec.get("collectives", {})
    raw_total = sum(v["bytes"] for v in colls.values() if isinstance(v, dict))
    weighted = sum(LINK_FACTOR[k] * v["bytes"] for k, v in colls.items()
                   if isinstance(v, dict) and k in LINK_FACTOR)
    if probe:
        # the probe gives depth-fitted totals; apply the raw mix's average
        # link factor (1.3 when the raw program had none).
        factor = weighted / raw_total if raw_total > 0 else 1.3
        link_bytes = probe["coll_bytes"] * factor
    else:
        link_bytes = weighted
    membytes = _analytic_memory_bytes(rec)
    t_comp = flops / peaks.flops
    t_mem = membytes / peaks.hbm_bw
    t_coll = link_bytes / peaks.link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = t_comp / bound if bound > 0 else 0.0

    tokens = SHAPE_TOKENS[rec["shape"]]
    n_active = rec.get("active_param_count") or rec.get("param_count") or 0
    model_flops = FLOPS_PER_PARAM_TOKEN[rec["mode"]] * n_active * tokens
    global_flops = flops * rec.get("devices", 1)
    useful = model_flops / global_flops if global_flops > 0 else 0.0

    hint = {
        "compute": "compute-bound: raise per-device utilization (larger "
        "per-device tiles, fused kernels)",
        "memory": "HBM-bound: reduce activation traffic (fusion, lighter "
        "remat policy, wider batching per device)",
        "collective": "link-bound: reshard to cut collective payload or "
        "overlap collectives with compute",
    }[dominant]
    return dict(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        mode=rec["mode"],
        compute_s=t_comp,
        memory_s=t_mem,
        collective_s=t_coll,
        dominant=dominant,
        roofline_fraction=frac,
        model_flops=model_flops,
        hlo_flops_global=global_flops,
        useful_flop_ratio=useful,
        hint=hint,
    )


def load_probes(probe_dir: str = PROBE_DIR) -> Dict[tuple, dict]:
    out = {}
    for f in glob.glob(os.path.join(probe_dir, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def table(cells=None, mesh: str = "16x16", probes=None, peaks: Peaks = H100_SXM) -> List[dict]:
    cells = cells if cells is not None else load_cells()
    probes = probes if probes is not None else load_probes()
    rows = []
    for rec in cells:
        if rec.get("mesh") != mesh:
            continue
        probe = probes.get((rec.get("arch"), rec.get("shape"), rec.get("mesh")))
        r = analyze_cell(rec, probe, peaks)
        if r:
            r["depth_corrected"] = probe is not None
            rows.append(r)
    return rows


def markdown(rows: List[dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "roofline frac | useful FLOP ratio |\n|---|---|---|---|---|---|---|---|"
    )
    lines = [hdr]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['roofline_fraction']:.2f} | {r['useful_flop_ratio']:.2f} |"
        )
    return "\n".join(lines)


def cells_markdown(cells: List[dict], probes=None, peaks: Peaks = H100_SXM) -> str:
    """One row an arch, one column a shape, each cell ``16x16 / 2x16x16``:
    the status and, where it traced, the trace seconds, the per-rank
    argument and temp GB and the dominant roofline term."""
    probes = probes if probes is not None else {}
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in cells}
    shapes = [s for s in SHAPE_TOKENS if any(k[1] == s for k in by)]
    meshes = ("16x16", "2x16x16")

    def cell(r, key):
        if r is None or r["status"] != "ok":
            return "missing" if r is None else r["status"]
        a = analyze_cell(r, probes.get(key), peaks)
        mem = r["memory"]
        return (f"{r['trace_s']:.1f} s, {mem['argument_size_in_bytes'] / 1e9:.3g} + "
                f"{mem['temp_size_in_bytes'] / 1e9:.3g} GB, {a['dominant']}")

    lines = ["| arch | " + " | ".join(f"{s} ({' / '.join(meshes)})" for s in shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch in sorted({a for a, _, _ in by}):
        cols = []
        for shape in shapes:
            got = [cell(by.get((arch, shape, m)), (arch, shape, m)) for m in meshes]
            cols.append(got[0] if got[0] == got[1] == "skipped" else " / ".join(got))
        lines.append(f"| {arch} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main():
    rows = table()
    print(markdown(rows))
    print(cells_markdown(load_cells(), load_probes()))
    with open("results/roofline_torch.json", "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
