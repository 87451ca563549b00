"""A copy of the benchmark with small cells beside the real ones, for the
CPU tests: the same files and code, the configurations cut to CPU sizes and
the check drawing its batches from every cycle of the smaller pool."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

TINY = {
    # the layer pattern and depth of the real configurations, narrow
    "zamba2-1.2b": dict(d_model=128, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=256,
                        vocab_size=512, ssm_state=16, ssm_head_dim=32, ssm_chunk=16),
    "mixtral-8x22b": dict(d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=512),
}
TRAFFIC = {"lengths": [64, 128, 256], "batch_tokens": 512, "pool_cycles": 4}


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
