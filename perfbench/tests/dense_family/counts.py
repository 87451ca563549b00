"""Model FLOPs of a dense prefill with a tied head (copied to
``counts/model_dense.py`` by the discovery test): the attention projections
and the SwiGLU MLP for every token, the attention over its causal pairs,
and the head for the last position only (2 FLOPs per multiply-add)."""
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
    h, kv = cfg["num_heads"], cfg["num_kv_heads"]
    tokens = rows * length
    layer = 2 * tokens * (d * hd * (2 * h + 2 * kv) + 3 * d * f) + k5.launch(cfg, rows, length)[0]
    return attention_calls(cfg) * layer + 2 * rows * d * cfg["vocab_size"]
