"""How far ``prefill_step`` and the token-by-token decode path drift apart
on the same prompt of tokens, for a model of any family but ``encdec``
(whose prefill needs frames), beside two yardsticks of the same shape:

- the witness: the same prefill with the plain PyTorch versions of K5 and
  K6 (``blocked_attention_plain``, ``ssd_chunked_plain``) in place of the
  kernels, on the same device;
- the one-ulp move: the prefill once more with every embedding entry
  moved by one float32 ulp (relative 2^-23, random sign).

The prefill and the decode differ only in the order of their float32 sums,
and a deep random model amplifies such differences with depth.  If K5 and
K6 are right, the prefill drifts from the decode about as far as the
witness does; a fault in a kernel (a wrong mask, decay or state) gives
errors of order 1.  An MoE layer that drops slots in the prefill (its
capacity follows the tokens of the call) makes the two differ by order 1
as well; the caller reads the plans.  ``chip_smoke.py`` holds
zamba2-1.2b's float32 prefill to this at full width on the card, and
mixtral's and qwen2-vl's cut in depth; ``tools/lm_float32_drift.py`` runs
it at a narrower width.
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
    """Per layer, in layer order, what the prefill hands the decode: every
    Mamba layer's state (``hybrid``, ``ssm``), or every layer's keys (the
    attention families)."""
    if "state" in cache:
        return list(cache["state"])
    if "g_state" not in cache:
        return list(cache["k"])
    g = cache["g_state"]
    out = [g[i, j] for i in range(g.shape[0]) for j in range(g.shape[1])]
    return out + list(cache["t_state"]) if "t_state" in cache else out


def prefill_decode_drift(cfg, model, tokens: np.ndarray, seed: int = 0) -> Dict[str, object]:
    """``tokens`` ``(B, S + 1)`` as the serve loop takes them; the prefill
    runs on the first S.  Returns relative L2 differences, each a dict over
    the decode cache's components (``g_state``, ``g_k``, ``g_v``,
    (``t_state``) for ``hybrid``; ``k``, ``v`` for the attention families)
    and ``logits``: ``prefill_vs_decode``, ``plain_vs_decode`` (the
    witness), ``prefill_vs_plain`` and ``one_ulp_move``; per layer (see
    ``_layer_states``), ``layer_state`` and ``layer_state_plain`` (against
    the decode); and the serve loop's seconds as ``decode_s``.  ``model``
    is left as it was."""
    if cfg.family == "encdec":
        raise ValueError("prefill_decode_drift feeds tokens alone; an encdec prefill needs frames")
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
