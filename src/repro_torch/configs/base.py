"""Model + run configuration system (the port's copy of
``repro/configs/base.py``, which imports JAX).

Every assigned architecture is a :class:`ModelConfig` in its own module
(``src/repro_torch/configs/<id>.py``), selectable via ``--arch <id>`` in
the launchers.  ``reduced()`` gives the CPU smoke-test variant (same
family, tiny dims).  The port runs the ``dense``, ``ssm`` and ``hybrid``
families; the others resolve but raise in ``models.model``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False  # M-RoPE 3-section rotary (qwen2-vl)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w (half-dims)
    sliding_window: int = 0  # 0 = full attention
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # Hybrid (Zamba2-style): shared attention block every N ssm layers
    hybrid_attn_every: int = 0
    # Encoder-decoder (Whisper backbone)
    encoder_layers: int = 0
    frontend: str = "none"  # none | audio | vision (stub embeddings)
    # Training
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Perf iteration 2 (EXPERIMENTS §5): bf16 compute weights halve the
    # FSDP weight-gather traffic; AdamW keeps fp32 math and m/v state.
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for llama3-405b (memory note)
    remat_policy: str = "dots"  # none | dots | full
    # scan-over-layers keeps compile time O(1) in depth; the layer-probe
    # unrolls (False) because XLA cost_analysis does not descend into
    # while-loop bodies (see launch/layer_probe.py).
    scan_layers: bool = True
    # Attention applicability notes
    supports_long_context: bool = False  # sub-quadratic path exists
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def q_groups(self) -> int:
        return max(self.num_heads // max(self.num_kv_heads, 1), 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        mlp = 3 * d * dff  # SwiGLU
        if self.moe_experts:
            mlp = self.moe_experts * 3 * d * dff + d * self.moe_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            ssm = d * (2 * d_in + 2 * self.ssm_state * nh // max(nh, 1) + nh) + d_in * d
            ssm += 2 * self.ssm_state * d_in  # B,C projections approx
        per_layer = {
            "dense": attn + mlp,
            "moe": attn + mlp,
            "vlm": attn + mlp,
            "encdec": attn + mlp,
            "ssm": ssm + 0,
            "hybrid": ssm,
        }[self.family]
        total = self.num_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + mlp  # one shared block
        if self.family == "encdec":
            total += self.encoder_layers * (2 * attn + mlp)  # self+cross approx
        total += v * d * (1 if self.tie_embeddings else 2)
        total += 2 * d * self.num_layers  # norms
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k)."""
        if not self.moe_experts:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        full_mlp = self.moe_experts * 3 * d * dff
        active_mlp = self.moe_top_k * 3 * d * dff
        return self.param_count() - self.num_layers * (full_mlp - active_mlp)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 + (2 if self.hybrid_attn_every else 0)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            moe_experts=min(self.moe_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            encoder_layers=min(self.encoder_layers, 2),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            mrope_sections=(4, 6, 6),
            dtype="float32",
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "mixtral_8x22b",
    "grok_1_314b",
    "zamba2_1p2b",
    "whisper_tiny",
    "qwen3_4b",
    "llama3_405b",
    "glm4_9b",
    "smollm_360m",
    "mamba2_780m",
    "qwen2_vl_7b",
]


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, with the DESIGN.md skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""
