"""The traffic generator of the ``closed_loop_prefill`` kind: reads a
``traffic/<name>.json`` file of parameters and makes a cell's batches from
the seed (a kind's module, ``kinds/<kind>.py``, names its generator).

Prompts of each of ``lengths`` once a cycle, the
cycle's order a seeded permutation, each batch ``batch_tokens`` tokens
(``batch_tokens / length`` prompts of one length); token ids drawn from the
distribution ``token_ids`` names over the model's vocabulary (``zipf``:
id ``r - 1`` with probability proportional to ``r ** -s``, ``r`` = 1 ..
vocabulary; ``uniform``).  Every seed gets the same lengths in another
order, and the ids of ``pool_cycles`` cycles are drawn once, on the device,
at set-up; a window that runs past them takes them again from the start.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for one use (``tag``) of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass(frozen=True)
class Traffic:
    name: str
    lengths: Tuple[int, ...]
    batch_tokens: int
    token_ids: dict
    pool_cycles: int
    kind: str = "closed_loop_prefill"

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        spec = json.loads(Path(path).read_text())
        lengths = tuple(int(n) for n in spec["lengths"])
        tokens = int(spec["batch_tokens"])
        if any(tokens % n for n in lengths):
            raise ValueError(f"{path}: every length must divide batch_tokens {tokens}")
        return cls(Path(path).stem, lengths, tokens, dict(spec["token_ids"]),
                   int(spec["pool_cycles"]), spec["kind"])

    def rows(self, length: int) -> int:
        return self.batch_tokens // length

    def order(self, seed: int) -> List[int]:
        """The prompt length of each batch of the pool, cycle by cycle."""
        rng = np.random.default_rng(sub_seed(seed, "order"))
        out: List[int] = []
        for _ in range(self.pool_cycles):
            out.extend(int(self.lengths[i]) for i in rng.permutation(len(self.lengths)))
        return out

    def _cdf(self, vocab: int, device) -> torch.Tensor:
        dist = self.token_ids["dist"]
        r = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        if dist == "zipf":
            p = r ** -float(self.token_ids["s"])
        elif dist == "uniform":
            p = torch.ones_like(r)
        else:
            raise ValueError(f"unknown token id distribution {dist!r}")
        cdf = torch.cumsum(p / p.sum(), 0)
        cdf[-1] = 1.0
        return cdf

    def pool(self, seed: int, vocab: int, device) -> List[torch.Tensor]:
        """The pool's token batches, int32 ``(rows, length)`` on ``device``,
        in the order of :meth:`order`; one draw of uniforms on the device
        mapped through the distribution's CDF."""
        order = self.order(seed)
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens"))
        u = torch.rand(len(order) * self.batch_tokens, generator=g, device=device,
                       dtype=torch.float64)
        ids = torch.searchsorted(self._cdf(vocab, device), u).clamp_(max=vocab - 1)
        ids = ids.to(torch.int32).view(len(order), self.batch_tokens)
        return [ids[i].view(self.rows(n), n) for i, n in enumerate(order)]
