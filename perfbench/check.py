"""The comparison that decides ``correct``: what the timed path returned for
the sampled batches (each request's last-position logits, its greedy first
token and the returned cache) against the plain float32 reference on the
same weights (drawn again from the seed) and the same tokens.

Readings, each the worst over the sampled batches:

- ``token_miss`` (of ``token_miss_of``): the requests whose served token is
  not the reference's best, among those whose reference's two best logits
  lie ``TIE`` or more apart (an exact comparison: closer ties may fall
  either way under rounding);
- ``token_gap``: over the requests, how far below the reference's largest
  logit lies the reference's logit of the token the program served;
- ``logits_err``: over the requests, the relative L2 error of the
  last-position logits;
- ``kv_err`` / ``state_err``: over every cache part (each attention call's
  keys and values; each Mamba2 layer's final state) and request, the
  relative L2 error of that request's slice;
- ``kv_err_med`` / ``state_err_med``: the median over parts and requests of
  the same relative errors (the higher of the two middle values);
- ``unjudged`` (of ``unjudged_of``): the requests whose last position the
  reference could not follow through every routing a near tie admits
  (``moe``: more than ``MAX_BRANCHES``), left out of the three readings of
  the logits.  Where the reference gives such routings (``branches``), each
  request's logits are judged against the closest of them.

The workload file's ``limits`` name the readings compared and their limits.
A reading that judged nothing is missing, and a count of nothing (``_of``
0) fails: a check that compares nothing is not passed.

The workload file's ``limits`` name the readings compared and their limits.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import family_module
from perfbench.reference.common import Matmul

TIE = 0.25  # logits: the widest gap a sound bf16 run served was 0.090 (PERF.md)


def row_errors(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of each leading row of ``prog`` against ``ref``."""
    p = prog.float().reshape(prog.shape[0], -1)
    r = ref.float().reshape(ref.shape[0], -1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)


class Readings:
    """Accumulates the readings over the sampled batches."""

    def __init__(self):
        self.worst: Dict[str, float] = {}
        self.rows: Dict[str, List[torch.Tensor]] = {}

    def count(self, name: str, hits: int, of: int):
        """A count over the requests: ``hits`` of ``of``."""
        got = self.worst.get(name + "_of", 0)
        self.worst[name] = self.worst.get(name, 0) + hits
        self.worst[name + "_of"] = got + of

    def add(self, name: str, errs: torch.Tensor):
        errs = errs.detach().float().cpu()
        if errs.numel() == 0:  # judged nothing: the reading stays missing
            return
        if not torch.isfinite(errs).all():
            errs = torch.full_like(errs, float("inf"))
        self.worst[name] = max(self.worst.get(name, 0.0), float(errs.max()))
        self.rows.setdefault(name, []).append(errs)

    def values(self) -> Dict[str, float]:
        out = dict(self.worst)
        for name in ("kv_err", "state_err"):
            if name in self.rows:
                out[name + "_med"] = float(torch.quantile(torch.cat(self.rows[name]), 0.5,
                                                          interpolation="higher"))
        return out


def compare_batch(cfg: dict, family: str, tree: dict, tokens, prog_parts: dict, prog_logits,
                  prog_first, readings: Readings, mm: Matmul | None = None):
    """Hold one batch's outputs against the reference forward, part by part
    as the reference makes them (so its cache is never held whole)."""
    ref_mod = family_module("reference", family)
    v = cfg["vocab_size"]
    b = prog_logits.shape[0]
    branches = None
    for name, ref in ref_mod.run(cfg, tree, tokens, mm or Matmul("float32")):
        if name == "branches":
            branches = ref
        elif name == "logits":
            owner = torch.arange(b, device=ref.device)
            if branches is not None:
                owner, ref = branches
            errs_all = row_errors(prog_logits[owner, :v], ref).nan_to_num(nan=float("inf"))
            # each request judged against its closest reference
            best_err = torch.full((b,), float("inf"), device=ref.device)
            best_err.scatter_reduce_(0, owner, errs_all, "amin")
            pick = torch.full((b,), -1, dtype=torch.long, device=ref.device)
            n = torch.arange(owner.numel(), device=ref.device)
            pick.scatter_reduce_(0, owner, torch.where(errs_all == best_err[owner], n, -1),
                                 "amax")
            judged = pick >= 0
            readings.count("unjudged", int((~judged).sum()), b)
            ref, errs = ref[pick[judged]], best_err[judged]
            served = torch.as_tensor(prog_first, device=ref.device).long().view(-1)[judged]
            gap = ref.max(dim=1).values - ref.gather(1, served.clamp(0, v - 1)[:, None])[:, 0]
            gap = torch.where((served >= 0) & (served < v), gap, float("inf"))
            top2 = ref.topk(2, dim=1).values
            clear = top2[:, 0] - top2[:, 1] >= TIE
            readings.add("token_gap", gap)
            readings.add("logits_err", errs)
            readings.count("token_miss", int((clear & (served != ref.argmax(dim=1))).sum()),
                           int(clear.sum()))
        else:
            kind = "state_err" if name.startswith("state.") else "kv_err"
            readings.add(kind, row_errors(prog_parts[name], ref))


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])`` over the limited readings; a
    reading that is missing or not finite fails, and so does a count of
    nothing (``<name>_of`` 0)."""
    rows = []
    for name, limit in limits.items():
        value = values.get(name, float("inf"))
        if values.get(name + "_of", 1) == 0:
            value = float("inf")
        rows.append((name, value, float(limit)))
    ok = all(value == value and value <= limit for _, value, limit in rows)
    return ok, rows


def program_parts(family: str, cfg: dict, cache) -> dict:
    return family_module("reference", family).program_parts(cfg, cache)


def reference_parts(family: str, cfg: dict, tree: dict, tokens, mm: Matmul):
    """A reference forward's parts and logits, held whole (the control puts
    them in the program's place)."""
    parts, logits = {}, None
    ref_mod = family_module("reference", family)
    for name, t in ref_mod.run(cfg, tree, tokens, mm):
        if name == "logits":
            logits = t
        elif name != "branches":
            parts[name] = t
    return parts, logits
