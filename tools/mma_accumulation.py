#!/usr/bin/env python3
"""How a CUDA card's mma.sync.m16n8k16 (bfloat16 x bfloat16 + float32)
sums, found by fitting models of the sum to the card's own results.

    python3 tools/mma_accumulation.py [--cases N] [--save FILE.npz]
    python3 tools/mma_accumulation.py --load FILE.npz    (no card: refit)

Runs one mma a warp (``kernel_variants_csrc/mma_probe.cu``) on N random
cases whose products and addends spread over many binades, then computes
each candidate model of D = C + sum_k A[:, k] B[k, :] in float64 on the host
and counts the outputs it gets bit for bit.  The products of two bfloat16
values are exact; a model says how the 16 products and the addend are then
added (``model_mma``):

- ``group``: the products are added ``group`` at a time, each group with
  the running value, which is rounded to float32 after each group;
- ``frac``: every term of a group is cut to a multiple of 2^(E - frac),
  E the largest of the terms' exponents (None: kept exact);
- ``operands``: a product's exponent is the sum of its factors' exponents
  (its leading bit may lie one above it), else its own leading bit's;
- ``cut_c``: whether the running value is cut too, or only the products;
- ``floor``: the cut rounds down (two's complement) rather than toward 0;
- ``rz``: the group's sum is rounded to float32 toward 0, else to nearest.

Prints the card's name and power limit, the models that match every output,
the best few otherwise, and as the last line a JSON object of the fits.
Needs one CUDA card, unless ``--load`` gives the cases and results that an
earlier run saved.  The model that matches is the one the CPU emulation of
the tensor cores takes (``tce_mma_fused`` in
``src/repro_torch/kernels/csrc/tc_emulate.h``).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tools" / "kernel_variants_csrc" / "mma_probe.cu"


def bf16_values(rng, shape, lo, hi):
    """Random bfloat16 values (as float32) with binades in [lo, hi]."""
    mant = 1 + rng.integers(0, 128, shape) / 128
    sign = rng.choice([-1.0, 1.0], shape)
    return (sign * mant * np.exp2(rng.integers(lo, hi + 1, shape))).astype(np.float32)


def cases(n, seed=0):
    """A (n, 16, 16), B (n, 16, 8), C (n, 16, 8): a quarter of the cases
    each with the inputs' binades within +-2, +-8 and +-16, and a quarter
    with C close to minus the products' sum, so that the sum cancels; in
    every eighth case half of A is 0, and B's first two columns and C's
    first column, so that some outputs have no term that is not 0."""
    rng = np.random.default_rng(seed)
    a, b, c = (np.empty((n,) + s, np.float32) for s in ((16, 16), (16, 8), (16, 8)))
    for i in range(n):
        spread = (2, 8, 16, 4)[i % 4]
        a[i] = bf16_values(rng, (16, 16), -spread, spread)
        b[i] = bf16_values(rng, (16, 8), -spread, spread)
        if i % 4 == 3:
            s = a[i].astype(np.float64) @ b[i].astype(np.float64)
            c[i] = (-s * (1 + rng.normal(size=s.shape) * 2.0**-20)).astype(np.float32)
        else:
            c[i] = (rng.normal(size=(16, 8)) * np.exp2(rng.integers(-2 * spread, 2 * spread + 1,
                                                                    (16, 8)))).astype(np.float32)
        if i % 8 == 5:
            a[i][rng.random((16, 16)) < 0.5] = 0
            b[i][:, :2] = 0
            c[i][:, 0] = 0
    return a, b, c


def to_f32(x, rz):
    """float64 ``x`` rounded to float32, toward 0 if ``rz``, else to
    nearest."""
    f = x.astype(np.float32)
    if rz:
        over = np.abs(f.astype(np.float64)) > np.abs(x)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def exponent(x):
    """floor(log2 |x|), and a very small number where x is 0."""
    _, e = np.frexp(x)  # |x| = m 2^e, m in [0.5, 1)
    return np.where(x == 0, -10**6, e - 1)


def model_mma(a, b, c, group=16, frac=None, cut_c=True, floor=False, rz=False, operands=False):
    """D = C + A B under one model of the card's sum (module docstring)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    prods = a64[:, :, :, None] * b64[:, None, :, :]  # (n, m, k, n)
    if operands:
        pexp = exponent(a64)[:, :, :, None] + exponent(b64)[:, None, :, :]
        pexp = np.where(prods == 0, -10**6, pexp)
    else:
        pexp = exponent(prods)
    acc = c.astype(np.float64)
    for g0 in range(0, 16, group):
        terms = np.concatenate([acc[:, :, None, :], prods[:, :, g0:g0 + group, :]], axis=2)
        if frac is not None:
            expo = np.concatenate([exponent(acc)[:, :, None, :], pexp[:, :, g0:g0 + group, :]],
                                  axis=2)
            top = (expo if cut_c else expo[:, :, 1:]).max(axis=2, keepdims=True)
            step = np.exp2((np.maximum(top, -600) - frac).astype(np.float64))  # > 0 if all 0
            cut = (np.floor if floor else np.trunc)(terms / step) * step
            if not cut_c:
                cut[:, :, :1] = terms[:, :, :1]
            terms = cut
        acc = to_f32(terms.sum(axis=2), rz).astype(np.float64)
    return acc.astype(np.float32)


MODELS = [dict(group=g, frac=f, cut_c=cc, floor=fl, rz=rz, operands=op)
          for g, f, cc, fl, rz, op in itertools.product(
              (16, 8, 4), (None, *range(22, 29)), (True, False), (False, True), (False, True),
              (False, True))
          if f is not None or (cc and not fl and not op)]


def fits(a, b, c, d):
    """Each model's share of outputs equal to the card's ``d``."""
    out = []
    for m in MODELS:
        got = model_mma(a, b, c, **m)
        out.append(dict(m, share=float(np.mean(got == d))))
    return sorted(out, key=lambda r: -r["share"])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases", type=int, default=1024)
    p.add_argument("--save", type=Path, help="write the cases and the card's results here")
    p.add_argument("--load", type=Path, help="fit the cases and results an earlier run saved")
    args = p.parse_args()
    if args.load:
        z = np.load(args.load)
        return report(fits(z["a"], z["b"], z["c"], z["d"]), int(z["d"].size), print)

    import torch

    if not torch.cuda.is_available():
        print("mma_accumulation: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.build import ptr, stream_ptr

    dev = torch.device("cuda", 0)
    cs.log(cs.gpu_line())
    a, b, c = cases(args.cases)
    fn = build.load(SOURCE).mma_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    ta, tb, tc = (torch.from_numpy(x).to(dev) for x in (a, b, c))
    td = torch.empty_like(tc)
    rc = fn(ptr(ta), ptr(tb), ptr(tc), ptr(td), args.cases, stream_ptr(dev))
    if rc:
        raise RuntimeError(f"CUDA error {rc}")
    d = td.cpu().numpy()
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.save, a=a, b=b, c=c, d=d)
    return report(fits(a, b, c, d), int(d.size), cs.log)


def report(ranked, outputs, log) -> int:
    exact = [r for r in ranked if r["share"] == 1.0]
    for r in exact or ranked[:8]:
        log(("matches every output: " if exact else "best: ") + json.dumps(r))
    print(json.dumps({"outputs": outputs, "matching": exact, "best": ranked[:8]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
