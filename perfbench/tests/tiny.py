"""A copy of the benchmark with small cells beside the real ones, for the
CPU tests: the same files and code, the configurations cut to CPU sizes and
the check drawing its batches from every cycle of the smaller pool.

A configuration's CPU cut is a file of its own, ``tiny_cuts/<config>.json``:
the keys it overrides, keeping the layer pattern and depth of the real
configuration and narrowing its widths.  The fault and reference tests take
every configuration that has one, and every cell of such a configuration."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
CUTS = Path(__file__).resolve().parent / "tiny_cuts"

TINY = {p.stem: json.loads(p.read_text()) for p in sorted(CUTS.glob("*.json"))}
TRAFFIC = {"lengths": [64, 128, 256], "batch_tokens": 512, "pool_cycles": 4}


def tiny_cells() -> list:
    """The cells of ``BENCHMARK.json`` whose configuration has a cut, in the
    manifest's order."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in manifest["workloads"] if w["config"] in TINY]


def tiny_root(dst: Path) -> Path:
    """A checkout at ``dst``: ``BENCHMARK.json``, a copy of the benchmark's
    folder and a link to the program's ``src``, every configuration cut to ``TINY`` and every
    traffic mix to ``TRAFFIC``'s lengths."""
    dst = Path(dst)
    shutil.copytree(HERE, dst / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "src").symlink_to(ROOT / "src", target_is_directory=True)
    for name, cut in TINY.items():
        path = dst / "perfbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    for path in (dst / "perfbench" / "traffic").glob("*.json"):
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **TRAFFIC)))
    for path in (dst / "perfbench" / "workloads").glob("*.json"):  # as many batches to draw
        spec = json.loads(path.read_text())
        spec["check"]["within_cycles"] = TRAFFIC["pool_cycles"]
        path.write_text(json.dumps(spec))
    return dst
