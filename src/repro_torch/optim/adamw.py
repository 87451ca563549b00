"""AdamW with a per-config optimizer-state dtype (bf16 m/v for
llama3-405b); the port of ``repro/optim/adamw.py``.

Functional over a dict of tensors (``dict(model.named_parameters())``):
the state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": 0-d
int32 tensor}``.  ``adamw_update`` keeps the JAX package's arithmetic, not
``torch.optim.AdamW``'s: the clip ``min(1, grad_clip / (|g| + 1e-9))`` over
the global float32 norm, float32 bias corrections, and the weight decay
inside the step, scaled by the learning rate (``torch.optim.AdamW`` first
multiplies the parameter by ``1 - lr * wd``, another result).  The math runs
in float32 and is cast back to each tensor's dtype; unlike the JAX function
it writes the new values into the given tensors in place and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def adamw_init(params: Tensors, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)

    def zeros():
        # zeros_like keeps a DTensor parameter's layout: the state follows its plan
        return {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()}

    device = next(iter(params.values())).device if params else None
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tensors) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Tensors, dict]:
    """One AdamW step; ``lr_scale`` multiplies ``cfg.lr`` (a number or a
    0-d float32 tensor, as ``cosine_schedule`` gives).  Returns
    ``(params, state)``, updated in place but for ``state["step"]``."""
    dt = getattr(torch, cfg.state_dtype)
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step32)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step32)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=step.device)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g32 = grads[k].float() * clip
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new.to(dt))
        v.copy_(v_new.to(dt))
    state["step"] = step
    return params, state
