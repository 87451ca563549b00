"""K6, the port's SSD chunk scan (``kernels/ssd_scan``): the least work of
one launch.  Operations, per (batch row, chunk): C B^T on the chunk's lower
triangle once, then per head the masked product with x, and the state's
read by C and update (2 chunk N P each).  Bytes: x read and y written
(bf16), dt (float32), B and C (bf16) and the final float32 state, each
once."""
from __future__ import annotations

from perfbench import family_module

KERNELS = ("ssd_state_kernel", "ssd_carry_kernel", "ssd_output_kernel")


def launch(cfg: dict, rows: int, length: int, elem_bytes: int = 2):
    chunk, n, p = cfg["ssm_chunk"], cfg["ssm_state"], cfg["ssm_head_dim"]
    h = cfg["ssm_expand"] * cfg["d_model"] // p
    nc = -(-length // chunk)
    tri = chunk * (chunk + 1) // 2
    ops = 2 * rows * nc * (tri * n + h * (tri * p + 2 * chunk * n * p))
    tokens = rows * length
    nbytes = (2 * tokens * h * p * elem_bytes + tokens * h * 4 + 2 * tokens * n * elem_bytes
              + rows * h * p * n * 4 + h * 4)
    return ops, nbytes


def launches(cfg: dict, rows: int, length: int):
    """One launch for each Mamba2 layer the family's counts
    (``model_<family>.py``) give."""
    layers = family_module("counts", f"model_{cfg['family']}").ssm_layers(cfg)
    return [launch(cfg, rows, length)] * layers if layers else []
