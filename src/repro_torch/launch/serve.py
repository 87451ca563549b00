"""Serving launcher: batched decode with a KV / SSM cache (the port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \
        --batch 4 --prompt-len 512 --gen 32

As in the JAX launcher, the prompt is fed token by token through the decode
path and the tokens are drawn from ``numpy.random.default_rng(seed)`` in the
same order: one first token per sequence, then one per prompt position.
The parameters come from ``init_params`` with a ``torch.Generator`` seeded
with ``seed``, on the launcher's device.  :func:`serve_loop` is the loop
itself, for callers that bring their own parameters and tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import decode_step, init_cache, init_params


def prompt_tokens(rng: np.random.Generator, vocab: int, batch: int, prompt_len: int) -> np.ndarray:
    """``(batch, prompt_len + 1)`` int32 tokens in the JAX launcher's draw
    order: column 0 is the first token, column i + 1 the token drawn at
    prompt step i."""
    cols = [rng.integers(0, vocab, (batch, 1))]
    cols += [rng.integers(0, vocab, (batch, 1)) for _ in range(prompt_len)]
    return np.concatenate(cols, axis=1).astype(np.int32)


@dataclasses.dataclass
class ServeResult:
    gen: np.ndarray  # (B, gen) int32 generated tokens
    prompt_logits: torch.Tensor  # (B, V) logits of the last prompt step
    prompt_cache: Optional[dict]  # a copy of the cache after the prompt, if kept
    prefill_s: float  # host seconds of the prompt steps (synchronized)
    decode_s: float  # host seconds of the generation steps (synchronized)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_loop(cfg, params, tokens: np.ndarray, gen: int, keep_prompt_cache: bool = False) -> ServeResult:
    """Feed ``tokens[:, :P]`` one by one through ``decode_step`` (P =
    ``tokens.shape[1] - 1``), then generate ``gen`` tokens greedily with
    ``serve_step``, starting from ``tokens[:, P]``.  The cache holds
    ``P + gen + 1`` positions, as the JAX launcher's."""
    dev = params.embed.device
    batch, p1 = tokens.shape
    prompt_len = p1 - 1
    toks = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.int32)).to(dev)
    serve_step = make_serve_step(cfg)
    cache = init_cache(cfg, batch, prompt_len + gen + 1, device=dev)
    logits = None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt_len):
        logits, cache = decode_step(cfg, params, toks[:, i:i + 1], cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    kept = {k: v.clone() for k, v in cache.items()} if keep_prompt_cache else None
    tok = toks[:, prompt_len:]
    outs = []
    t0 = time.perf_counter()
    for _ in range(gen):
        tok, cache = serve_step(params, tok, cache)
        outs.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    out = torch.cat(outs, dim=1).cpu().numpy() if outs else np.zeros((batch, 0), np.int32)
    return ServeResult(out, None if logits is None else logits[:, -1], kept, prefill_s, decode_s)


def main(argv=None, device: DeviceLike = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError("--model-parallel > 1 needs the port's mesh (ROADMAP.md)")

    dev = resolve_device(args.device if device is None else device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    tokens = prompt_tokens(rng, cfg.vocab_size, args.batch, args.prompt_len)
    res = serve_loop(cfg, params, tokens, args.gen)
    tps = args.batch * args.gen / max(res.decode_s, 1e-9)
    print(f"prefill {args.prompt_len} toks: {res.prefill_s:.2f}s")
    print(f"decode  {args.gen} toks x {args.batch} seqs: {res.decode_s:.2f}s ({tps:.1f} tok/s)")
    print("sample:", res.gen[0, :16].tolist())
    assert np.isfinite(res.gen).all()
    return res.gen


if __name__ == "__main__":
    main()
