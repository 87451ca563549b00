"""Device resolution for the port's public entry points.

Every entry point that does device work takes ``device=``.  ``None`` means
the CUDA card; a run that finds no card raises instead of quietly running
on the CPU.  The CPU is used only when the caller asks for it, as the CPU
tests do, and then every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a card);
    an explicit ``"cpu"`` or ``"cuda[:i]"`` is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
