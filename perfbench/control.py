"""The readings that set the check's limits, at a cell's own sizes: the
program's, on the batches a run of each seed compares, and the control's,
the reference put in the program's place with its products from float8
operands (the precision below the configuration's bfloat16).

    python3 perfbench/control.py --workload CELL --program-seeds 1,2,... \\
        --control-seeds 7,8,9

prints one JSON line a seed (``{"side", "seed", "readings"}``) and a
summary: each reading's largest over the program's seeds and smallest over
the control's; the cell's kind (``kinds/<kind>.py``) takes the readings.
The benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + sys.path[1:]
    import torch

    from perfbench import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cell = bench.load_cell(args.workload, ROOT)
    seen = {"program": [], "control": []}
    for side, seeds in (("program", args.program_seeds), ("control", args.control_seeds)):
        for s in (int(x) for x in seeds.split(",") if x):
            t0 = time.perf_counter()
            r = cell.kind.readings(cell, s, side, device)
            seen[side].append(r)
            print(json.dumps({"side": side, "seed": s, "seconds": time.perf_counter() - t0,
                              "readings": r}), flush=True)
    names = sorted({k for rs in seen.values() for r in rs for k in r})
    summary = {n: {"program_max": max((r[n] for r in seen["program"]), default=None),
                   "control_min": min((r[n] for r in seen["control"]), default=None)}
               for n in names}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
