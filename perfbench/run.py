"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
check compared with its limit); the last lines of standard error repeat the
compared numbers.  Exits non-zero, printing no result, without a CUDA
device, or where JAX or the JAX package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # fixed cache directories inside the checkout; nothing at a fixed /tmp path
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

    import torch

    from perfbench import bench

    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("no CUDA device: this benchmark runs on the card only")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                         log=log)
    found = bench.forbidden_modules()
    if found:
        log(f"the process has loaded {found}: the benchmark may load neither JAX nor the JAX "
            f"package")
        return 3
    out["device"]["power_limit"] = bench.power_limit()
    out["compared"] = out.pop("compared")  # last key
    for name, c in out["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
