"""LR schedules (the port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int = 200, total: int = 10_000, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak (scale factor),
    in float32, as a 0-d tensor on ``step``'s device (the CPU for a Python
    number).  Step 0 gives 0."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
