"""K5, the port's flash attention (``kernels/flash_attn``): the least work
of a causal launch.  Operations: the kept (query, key) pairs times 4 hd (a
multiply and an add in Q K^T and in P V) for every query head.  Bytes: q,
k, v and the output, each read or written once, in bf16."""
from __future__ import annotations

from perfbench import family_module

KERNELS = ("flash_attn_tc_kernel", "flash_attn_f32tc_kernel")


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def attention_layers(cfg: dict) -> int:
    """Attention calls of one forward, as the family's counts
    (``model_<family>.py``) give them."""
    return family_module("counts", f"model_{cfg['family']}").attention_calls(cfg)


def launch(cfg: dict, rows: int, length: int, elem_bytes: int = 2):
    hd, h, kv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    ops = 4 * hd * rows * h * causal_pairs(length)
    nbytes = rows * length * hd * (2 * h + 2 * kv) * elem_bytes
    return ops, nbytes


def launches(cfg: dict, rows: int, length: int):
    return [launch(cfg, rows, length)] * attention_layers(cfg)
