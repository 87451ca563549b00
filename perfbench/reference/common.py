"""Plain PyTorch pieces of the reference forward: float32 throughout (the
harness turns TF32 off), written from the models' equations, not from the
program.  ``Matmul`` is every product with a weight: float32, or, for the
control, both operands rounded to float8 e4m3 with a per-tensor scale
(``fp8``) and multiplied in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at 448), back in float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Matmul:
    """``x @ w`` in float32 (``precision="float32"``) or from float8
    operands (``"fp8"``, the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return to_fp8(x) @ to_fp8(w)
        return x.float() @ w.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float, start: int = 0) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, H, hd) at positions start .. start +
    S - 1, the two halves of the head rotated as pairs; angles in float64."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(start, start + s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, elements: int = 1 << 28) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) over k, v (B, S, KV, hd), each
    query over the keys at and before it, in blocks of queries so that a
    block's scores hold at most ``elements`` numbers."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    out = torch.empty_like(q)
    qb = max(16, min(s, elements // max(h * s, 1)))
    for r in range(b):
        kr = k[r].repeat_interleave(groups, dim=1).transpose(0, 1)  # (H, S, hd)
        vr = v[r].repeat_interleave(groups, dim=1).transpose(0, 1)
        for lo in range(0, s, qb):
            hi = min(s, lo + qb)
            qr = q[r, lo:hi].transpose(0, 1) * hd ** -0.5  # (H, qb, hd)
            sc = qr @ kr[:, :hi].transpose(1, 2)  # (H, qb, hi)
            mask = torch.arange(hi, device=q.device)[None, :] > torch.arange(
                lo, hi, device=q.device)[:, None]
            sc.masked_fill_(mask, float("-inf"))
            out[r, lo:hi] = (torch.softmax(sc, dim=-1) @ vr[:, :hi]).transpose(0, 1)
    return out


def attention_block(p: dict, x, cfg: dict, mm: Matmul, eps: float):
    """Pre-norm attention with rope: ``(x + attention output, k, v)``; k
    after rope, as a decode cache holds it."""
    b, s, d = x.shape
    hd, h, kv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    hn = rms_norm(x, p["ln1"], eps)
    q = mm(hn, p["attn"]["wq"]).view(b, s, h, hd)
    k = mm(hn, p["attn"]["wk"]).view(b, s, kv, hd)
    v = mm(hn, p["attn"]["wv"]).view(b, s, kv, hd)
    theta = cfg.get("rope_theta", 1e4)
    q, k = rope(q, theta), rope(k, theta)
    o = causal_attention(q, k, v).reshape(b, s, h * hd)
    return x + mm(o, p["attn"]["wo"]), k, v


def last_attention_block(p: dict, xl, owner, k, v, cfg: dict, mm: Matmul, eps: float,
                         block: int = 256):
    """:func:`attention_block` for the last position alone, from other
    states of it: ``xl`` (n, D) are last-position states of the requests
    ``owner`` (n,), and ``k``, ``v`` (B, S, KV, hd) the block's keys and
    values of every request, of which the positions before the last are
    taken (causal attention: they do not depend on the last position).
    The states of one request attend over its keys together, ``block`` at
    a time, each query head over its own KV head's keys.  Returns ``xl``
    plus the attention output."""
    s = k.shape[1]
    hd, h, kv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    hn = rms_norm(xl, p["ln1"], eps)
    theta = cfg.get("rope_theta", 1e4)
    q = rope(mm(hn, p["attn"]["wq"]).view(-1, 1, h, hd), theta, s - 1)[:, 0]
    kl = rope(mm(hn, p["attn"]["wk"]).view(-1, 1, kv, hd), theta, s - 1)[:, 0]
    vl = mm(hn, p["attn"]["wv"]).view(-1, kv, hd)
    qg = (q * hd ** -0.5).view(-1, kv, h // kv, hd)  # head i reads KV head i // (h / kv)
    out = torch.empty_like(qg)
    for r in torch.unique(owner).tolist():
        mine = (owner == r).nonzero()[:, 0]
        kr, vr = k[r, :s - 1], v[r, :s - 1]  # (S - 1, KV, hd)
        for js in mine.split(block):
            sc = torch.cat([torch.einsum("nkgd,skd->nkgs", qg[js], kr),
                            torch.einsum("nkgd,nkd->nkg", qg[js], kl[js])[..., None]], dim=-1)
            w = torch.softmax(sc, dim=-1)
            out[js] = (torch.einsum("nkgs,skd->nkgd", w[..., :-1], vr)
                       + w[..., -1:] * vl[js][:, :, None, :])
    return xl + mm(out.reshape(-1, h * hd), p["attn"]["wo"])


def swiglu(x, wg, wu, wd, mm: Matmul):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def ssd(x, dt, a, bm, cm, chunk: int = 64):
    """The Mamba2 recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = h_t C_t``, from a zero state, in its chunked form: within a
    chunk the quadratic form with the decays masked before the exponent,
    across chunks the states carried one chunk at a time.

    x (B, S, H, P), dt (B, S, H), a (H,), B and C (B, S, N), float32.
    Returns ``(y (B, S, H, P), final state (B, H, P, N))``."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd reference: {s} positions are not chunks of {chunk}")
    nc = s // chunk
    xc = x.view(b, nc, chunk, h, p)
    dtc = dt.view(b, nc, chunk, h)
    bc, cc = bm.view(b, nc, chunk, n), cm.view(b, nc, chunk, n)
    cs = torch.cumsum(dtc * a, dim=2)  # (B, nc, L, H)
    seg = cs.permute(0, 1, 3, 2)[..., :, None] - cs.permute(0, 1, 3, 2)[..., None, :]
    upper = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).triu(1)
    decay = torch.exp(seg.masked_fill(upper, float("-inf")))  # (B, nc, H, L, L)
    g = cc @ bc.transpose(-1, -2)  # (B, nc, L, L): C_i . B_j
    m = decay * g[:, :, None] * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = (m @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (B, nc, L, H, P)
    to_end = torch.exp(cs[:, :, -1:, :] - cs) * dtc  # (B, nc, L, H)
    local = torch.einsum("bclh,bclhp,bcln->bchpn", to_end, xc, bc)
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = torch.exp(cs[:, c, -1])[:, :, None, None] * state + local[:, c]
    start = torch.stack(starts, dim=1)  # (B, nc, H, P, N)
    y = y + torch.einsum("bcln,bchpn->bclhp", cc, start) * torch.exp(cs)[..., None]
    return y.reshape(b, s, h, p), state


def mamba2(p: dict, i: int, x, cfg: dict, mm: Matmul, eps: float):
    """Mamba2 layer ``i`` of the stacked leaves ``p``: ``(x + block output,
    final SSM state)``.  The in-projection gives x, z, B, C and dt in that
    order; the skip ``D x``; the output gated by ``silu(z)`` and RMS-normed
    before the out-projection."""
    b, s, d = x.shape
    d_in = cfg["ssm_expand"] * d
    hp = cfg["ssm_head_dim"]
    h, n = d_in // hp, cfg["ssm_state"]
    proj = mm(rms_norm(x, p["ln1"][i], eps), p["ssm"]["w_in"][i])
    xi, z, bm, cm, dt = torch.split(proj, [d_in, d_in, n, n, h], dim=-1)
    dt = F.softplus(dt + p["ssm"]["dt_bias"][i].float())
    a = -torch.exp(p["ssm"]["a_log"][i].float())
    xh = xi.reshape(b, s, h, hp)
    y, state = ssd(xh.contiguous(), dt.contiguous(), a, bm.contiguous(), cm.contiguous())
    y = (y + xh * p["ssm"]["d_skip"][i].float()[:, None]).reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p["ssm"]["norm"][i], eps)
    return x + mm(y, p["ssm"]["w_out"][i]), state


def embed(tree: dict, tokens) -> torch.Tensor:
    return tree["embed"][tokens.long()].float()


def last_logits(tree: dict, x, cfg: dict, mm: Matmul, eps: float) -> torch.Tensor:
    """The last position's logits over the vocabulary (B, V), by the head, or
    by the embedding where the tree has no head (a tied model)."""
    h = rms_norm(x[:, -1], tree["final_norm"], eps)
    head = tree["lm_head"] if "lm_head" in tree else tree["embed"]
    return mm(h, head[: cfg["vocab_size"]].T)
