"""Model FLOPs of a Zamba2 prefill: every product of every layer for every
token (2 per multiply-add), the SSD scan's products as K6 counts them, the
shared block's attention over its causal pairs, and the head for the last
position only."""
from __future__ import annotations

from perfbench.counts import k5, k6


def attention_calls(cfg: dict) -> int:
    """K5's calls a forward: one a call of the shared block."""
    return cfg["num_layers"] // cfg["hybrid_attn_every"]


def ssm_layers(cfg: dict) -> int:
    """K6's calls a forward: one a Mamba2 layer."""
    return cfg["num_layers"]


def flops(cfg: dict, rows: int, length: int) -> int:
    d, f, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    h, kv = cfg["num_heads"], cfg["num_kv_heads"]
    d_in = cfg["ssm_expand"] * d
    nh = d_in // cfg["ssm_head_dim"]
    tokens = rows * length
    mamba = 2 * tokens * (d * (2 * d_in + 2 * cfg["ssm_state"] + nh) + d_in * d)
    scan = k6.launch(cfg, rows, length)[0]
    calls = attention_calls(cfg)
    block = 2 * tokens * (d * hd * (2 * h + 2 * kv) + 3 * d * f)
    attn = k5.launch(cfg, rows, length)[0]
    head = 2 * rows * d * cfg["vocab_size"]
    return ssm_layers(cfg) * (mamba + scan) + calls * (block + attn) + head
