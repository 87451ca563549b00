#!/usr/bin/env python3
"""The port's serve loop, timed: ms a step of the prompt's ``decode_step``
and of the generated ``serve_step`` (host clock, synchronized), and the
aten ops and Python function calls (``cProfile``'s count) of one
``decode_step``, for the package under ``--src``.

    python tools/serve_loop_ms.py [--src SRC] [--device cpu] [--reduced]

Defaults: path F of ``chip_smoke.py`` (zamba2-1.2b at full width in bf16,
4 requests of 128 prompt tokens and 32 generated, seed 0) on the card.
``--src`` points at another checkout's ``src`` (the package it imports),
so that two commits are compared in one session, each in a process of its
own: run them alternately and compare within one machine.  Prints one
JSON line a repetition (the sha256 of the generated tokens included, which
two commits with the same arithmetic share) and one with the counts.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import hashlib
import json
import os
import pstats
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--arch", default="zamba2_1p2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import prompt_tokens, serve_loop
    from repro_torch.models import decode_step, init_cache, init_params

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    model = init_params(cfg, args.seed, device=dev)
    tokens = prompt_tokens(np.random.default_rng(args.seed), cfg.vocab_size, args.batch,
                           args.prompt + 1)
    serve_loop(cfg, model, tokens[:, :9], 4)  # warm-up
    src = os.path.abspath(args.src)
    out = []
    for rep in range(args.reps):
        res = serve_loop(cfg, model, tokens, args.gen)
        out.append(dict(src=src, rep=rep, decode_step_ms=res.prefill_s / args.prompt * 1e3,
                        serve_step_ms=res.decode_s / args.gen * 1e3,
                        tokens_sha256=hashlib.sha256(res.gen.tobytes()).hexdigest()))
        print(json.dumps(out[-1]), flush=True)
    cache = init_cache(cfg, args.batch, args.prompt + 1, device=dev)
    tok = torch.from_numpy(tokens[:, :1]).to(dev)
    with torch.no_grad(), OpCount() as count:
        decode_step(cfg, model, tok, cache)
    prof = cProfile.Profile()
    with torch.no_grad():
        prof.runcall(decode_step, cfg, model, tok, cache)
    out.append(dict(src=src, decode_step_aten_ops=sum(count.ops.values()),
                    decode_step_python_calls=pstats.Stats(prof).total_calls))
    print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
