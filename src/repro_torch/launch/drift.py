"""How far ``prefill_step`` and the token-by-token decode path drift apart
on the same prompt, for a ``hybrid`` model, beside two yardsticks of the
same shape:

- the witness: the same prefill with the plain PyTorch versions of K5 and
  K6 (``blocked_attention_plain``, ``ssd_chunked_plain``) in place of the
  kernels, on the same device;
- the one-ulp move: the prefill once more with every embedding entry
  moved by one float32 ulp (relative 2^-23, random sign).

The prefill and the decode differ only in the order of their float32 sums,
and a deep random model amplifies such differences with depth.  If K5 and
K6 are right, the prefill drifts from the decode about as far as the
witness does; a fault in a kernel (a wrong mask, decay or state) gives
errors of order 1.  ``chip_smoke.py`` holds zamba2-1.2b's float32 prefill
to this at full width on the card; ``tools/lm_float32_drift.py`` runs it
at a narrower width.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels.flash_attn.ref import blocked_attention_plain
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.steps import decode_cache_from_prefill, make_prefill_step
from repro_torch.models import attention, ssm


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.double(), ref.double()
    return float((g - r).norm() / max(float(r.norm()), 1e-30))


@contextlib.contextmanager
def plain_versions():
    """While open, the model's prefill runs the plain versions of K5 and K6
    on whatever device its tensors are on; their launch counts stay put."""
    saved = attention.flash_attention, ssm.ssd_scan
    attention.flash_attention, ssm.ssd_scan = blocked_attention_plain, ssd_chunked_plain
    try:
        yield
    finally:
        attention.flash_attention, ssm.ssd_scan = saved


def _layer_states(cache) -> List[torch.Tensor]:
    """Every Mamba layer's state, in layer order."""
    g = cache["g_state"]
    out = [g[i, j] for i in range(g.shape[0]) for j in range(g.shape[1])]
    return out + list(cache["t_state"]) if "t_state" in cache else out


def prefill_decode_drift(cfg, model, tokens: np.ndarray, seed: int = 0) -> Dict[str, object]:
    """``tokens`` ``(B, S + 1)`` as the serve loop takes them; the prefill
    runs on the first S.  Returns relative L2 differences, each a dict over
    ``g_state``, ``g_k``, ``g_v``, (``t_state``,) ``logits``:
    ``prefill_vs_decode``, ``plain_vs_decode`` (the witness),
    ``prefill_vs_plain`` and ``one_ulp_move``; per Mamba layer,
    ``layer_state`` and ``layer_state_plain`` (against the decode); and
    the serve loop's seconds as ``decode_s``.  ``model`` is left as it
    was."""
    if cfg.family != "hybrid":
        raise ValueError(f"prefill_decode_drift reads a hybrid cache, not {cfg.family!r}")
    dev = model.embed.device
    s = tokens.shape[1] - 1
    step = make_prefill_step(cfg)
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :s])).to(dev)}

    def prefill():
        last, cache = step(model, batch)
        out = decode_cache_from_prefill(cfg, cache, s, s + 1)
        del out["len"]
        out["logits"] = last
        return out

    pre = prefill()
    with plain_versions():
        plain = prefill()
    res = serve_loop(cfg, model, tokens, 0, keep_prompt_cache=True)
    dec = dict(res.prompt_cache, logits=res.prompt_logits)
    del dec["len"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    embed = model.embed.detach().clone()
    with torch.no_grad():
        sign = torch.randint(0, 2, embed.shape, generator=gen, device=dev) * 2 - 1
        model.embed.mul_(1 + sign * 2.0**-23)
        try:
            moved = prefill()
        finally:
            model.embed.copy_(embed)
    return dict(
        prefill_vs_decode={k: rel_l2(pre[k], dec[k]) for k in pre},
        plain_vs_decode={k: rel_l2(plain[k], dec[k]) for k in pre},
        prefill_vs_plain={k: rel_l2(pre[k], plain[k]) for k in pre},
        one_ulp_move={k: rel_l2(moved[k], pre[k]) for k in pre},
        layer_state=[rel_l2(a, b) for a, b in zip(_layer_states(pre), _layer_states(dec))],
        layer_state_plain=[rel_l2(a, b) for a, b in zip(_layer_states(plain), _layer_states(dec))],
        decode_s=res.prefill_s,
    )


__all__ = ["plain_versions", "prefill_decode_drift", "rel_l2"]
