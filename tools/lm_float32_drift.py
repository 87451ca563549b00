#!/usr/bin/env python3
"""How far the port's float32 prefill and its token-by-token decode drift
apart in a deep hybrid model, beside the same prefill through the plain
versions of K5 and K6 and beside a one-ulp move of the embedding table
(``repro_torch.launch.drift``), at a narrower width than ``chip_smoke.py``
runs it.

    PYTHONPATH=src python tools/lm_float32_drift.py --device cpu

Builds zamba2-1.2b's config at a narrower width (38 layers, d 512, 8 heads
of 64, d_ff 1024, vocab 1024 by default) in float32 with ``init_params``,
runs ``prefill_decode_drift`` on one prompt and prints its readings as
JSON.  On the CPU the kernels' places are taken by their plain versions, so
the prefill and the witness are one computation there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.drift import prefill_decode_drift  # noqa: E402
from repro_torch.launch.serve import prompt_tokens  # noqa: E402
from repro_torch.models import init_params  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=38)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("zamba2_1p2b"), num_layers=args.layers, d_model=args.d_model,
        num_heads=args.d_model // 64, num_kv_heads=args.d_model // 64, d_ff=2 * args.d_model,
        vocab_size=1024, dtype="float32", param_dtype="float32")
    model = init_params(cfg, args.seed, device=dev)
    tokens = prompt_tokens(np.random.default_rng(args.seed), cfg.vocab_size, 1, args.prompt_len)
    t0 = time.perf_counter()
    out = dict(device=str(dev), layers=cfg.num_layers, d_model=cfg.d_model,
               prompt_len=args.prompt_len, **prefill_decode_drift(cfg, model, tokens, args.seed))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
