"""Model FLOPs of a Mixtral prefill: the attention projections and the
router for every token, the experts' three products for each token's top
``k`` experts (not the capacity's empty slots, nor less for dropped ones),
the attention over its causal pairs, and the head for the last position
only (2 FLOPs per multiply-add)."""
from __future__ import annotations

from perfbench.counts import k5


def attention_calls(cfg: dict) -> int:
    """K5's calls a forward: one a layer."""
    return cfg["num_layers"]


def ssm_layers(cfg: dict) -> int:
    """K6's calls a forward: none."""
    return 0


def flops(cfg: dict, rows: int, length: int) -> int:
    d, f, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    h, kv, e, k = cfg["num_heads"], cfg["num_kv_heads"], cfg["moe_experts"], cfg["moe_top_k"]
    tokens = rows * length
    proj = 2 * tokens * (d * hd * (2 * h + 2 * kv) + d * e)
    experts = 2 * tokens * k * 3 * d * f
    attn = k5.launch(cfg, rows, length)[0]
    head = 2 * rows * d * cfg["vocab_size"]
    return cfg["num_layers"] * (proj + experts + attn) + head
