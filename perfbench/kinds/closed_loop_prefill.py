"""Traffic kind ``closed_loop_prefill``: prompts prefilled through
``repro_torch.launch.steps.make_prefill_step(cfg)``'s
``prefill_step(model, {"tokens"})``, one batch in flight.

A batch is issued, its greedy first tokens are copied to the host, and the
next batch follows.  A request's time to first token runs from its batch's
issue to its first token on the host.  The window ends with the first
cycle of the traffic (each length once) that completes ``seconds`` or more
after the first issue, and its length is that completion's time, so every
batch counted lies wholly inside it, and every seed's window holds the
same prompts in another order.

End-to-end: ``prefill_tokens_per_s`` (the prompt tokens of the window's
batches over the window) and ``ttft_p95_ms`` (the 95th percentile over
every request of the window).  The check holds the sampled batches' served
tokens, last-position logits and returned caches against the reference.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import check, weights
from perfbench.traffic import Traffic, sub_seed


def load_traffic(path) -> Traffic:
    return Traffic.load(path)


def sample_batches(cell, seed: int, order: List[int]) -> List[int]:
    """Pool indices of the batches the check compares, drawn from the seed
    among the batches of the first ``within_cycles`` cycles: one of the
    longest prompts and ``batches - 1`` of the other lengths."""
    rng = np.random.default_rng(sub_seed(seed, "check"))
    n, within = int(cell.spec["check"]["batches"]), int(cell.spec["check"]["within_cycles"])
    head = order[:within * len(cell.traffic.lengths)]
    longest = [i for i, x in enumerate(head) if x == max(head)]
    others = [i for i, x in enumerate(head) if x != max(head)]
    if n - 1 > len(others):
        raise ValueError(f"{cell.name}: {n} batches to check, {len(others) + 1} to draw from")
    picked = [longest[int(rng.integers(len(longest)))]]
    picked += [others[i] for i in rng.permutation(len(others))[:n - 1]]
    return sorted(picked)


def end_to_end(batches, window_s: float) -> Dict[str, float]:
    ttft = [1e3 * (b.t_done - b.t_issue) for b in batches for _ in range(b.rows)]
    return {"prefill_tokens_per_s": sum(b.rows * b.length for b in batches) / window_s,
            "ttft_p95_ms": float(np.quantile(ttft, 0.95))}


class Driver:
    """The cell's model, entry and token pool; set-up happens here."""

    def __init__(self, cell, seed: int, device, step_factory=None):
        from repro_torch.launch.steps import make_prefill_step

        from perfbench import bench

        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        self.vocab = cfg["vocab_size"]
        self.model = bench.build_model(cfg, sub_seed(seed, "weights"), device)
        self.step = (step_factory or make_prefill_step)(bench.model_config(cfg))
        self.order = cell.traffic.order(seed)
        self.pool = cell.traffic.pool(seed, self.vocab, device)
        self.sampled = set(sample_batches(cell, seed, self.order))
        self.kept: Dict[int, dict] = {}
        self.next = 0

    def one(self, i: int, record: list):
        from perfbench.bench import Batch

        toks = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        logits, cache = self.step(self.model, {"tokens": toks})
        t1 = time.perf_counter()
        first = logits[:, :self.vocab].argmax(dim=-1).cpu()
        t2 = time.perf_counter()
        record.append(Batch(i, toks.shape[0], toks.shape[1], t0, t1, t2))
        if i in self.sampled and i not in self.kept:
            self.kept[i] = dict(tokens=toks, logits=logits.clone(), cache=cache, first=first)

    def warm_up(self):
        """Each shape of the traffic once."""
        for length in self.cell.traffic.lengths:
            self.one(self.order.index(length), [])
        self.kept.clear()

    def window(self, seconds: float):
        batches: list = []
        t_first = time.perf_counter()
        cycle = len(self.cell.traffic.lengths)
        while True:
            self.one(self.next, batches)
            self.next += 1
            if batches[-1].t_done - t_first >= seconds and self.next % cycle == 0:
                break
        window_s = batches[-1].t_done - t_first
        while not self.sampled <= set(self.kept):  # a sampled batch past the window
            self.one(self.next, [])
            self.next += 1
        return batches, window_s

    def traced(self) -> list:
        """The traced sub-window: ``trace_cycles`` cycles of batches."""
        from torch.profiler import record_function

        out: list = []
        for _ in range(int(self.cell.spec.get("trace_cycles", 1)) * len(self.cell.traffic.lengths)):
            with record_function("perfbench.batch"):
                self.one(self.next, out)
            self.next += 1
        return out

    def describe(self, batches, window_s: float) -> str:
        e2e = end_to_end(batches, window_s)
        ttft = [1e3 * (b.t_done - b.t_issue) for b in batches for _ in range(b.rows)]
        return (f"window {window_s:.3f} s: {len(batches)} batches, "
                f"{sum(b.rows for b in batches)} requests, "
                f"{e2e['prefill_tokens_per_s']:.1f} tokens/s, ttft p50 "
                f"{statistics.median(ttft):.2f} ms p95 {e2e['ttft_p95_ms']:.2f} ms")

    def check(self, log=print):
        """Frees the program's model, then compares the kept batches:
        ``(readings, failed requests)``."""
        del self.model, self.pool
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        values = compare_kept(self.cell, self.seed, self.kept, self.device)
        failed = sum(int((~torch.isfinite(k["logits"].float())).any(dim=1).sum())
                     for k in self.kept.values())
        log(f"check of {len(self.kept)} batches "
            f"({sum(k['tokens'].shape[0] for k in self.kept.values())} requests) in "
            f"{time.perf_counter() - t0:.2f} s")
        return values, failed


def compare_kept(cell, seed: int, kept: Dict[int, dict], device) -> Dict[str, float]:
    """The readings of the kept batches against the reference."""
    tree = weights.draw_tree(cell.config, sub_seed(seed, "weights"), device)
    readings = check.Readings()
    for i in sorted(kept):
        k = kept.pop(i)
        parts = k.get("parts") or check.program_parts(cell.family, cell.config, k["cache"])
        with torch.no_grad():
            check.compare_batch(cell.config, cell.family, tree, k["tokens"], parts, k["logits"],
                                k["first"], readings)
        kept[i] = dict(tokens=k["tokens"], logits=k["logits"])
        del parts, k
    return readings.values()


def readings(cell, seed: int, side: str, device) -> Dict[str, float]:
    """The check's readings of one seed on the batches a run compares:
    ``side`` ``program`` (the timed path) or ``control`` (the reference in
    its place with float8 products)."""
    from perfbench import bench
    from perfbench.reference.common import Matmul

    cfg = cell.config
    order = cell.traffic.order(seed)
    pool = cell.traffic.pool(seed, cfg["vocab_size"], device)
    kept = {}
    if side == "program":
        from repro_torch.launch.steps import make_prefill_step

        model = bench.build_model(cfg, sub_seed(seed, "weights"), device)
        step = make_prefill_step(bench.model_config(cfg))
        for i in sample_batches(cell, seed, order):
            logits, cache = step(model, {"tokens": pool[i]})
            kept[i] = dict(tokens=pool[i], logits=logits.clone(), cache=cache,
                           first=logits[:, :cfg["vocab_size"]].argmax(-1).cpu())
        del model
    else:
        tree = weights.draw_tree(cfg, sub_seed(seed, "weights"), device)
        for i in sample_batches(cell, seed, order):
            with torch.no_grad():
                parts, logits = check.reference_parts(cell.family, cfg, tree, pool[i],
                                                      Matmul("fp8"))
            kept[i] = dict(tokens=pool[i], logits=logits, parts=parts,
                           first=logits.argmax(-1).cpu())
        del tree
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare_kept(cell, seed, kept, device)
