"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 v=152064,
M-RoPE, dynamic resolution (patch frontend STUB) [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
    supports_long_context=False,
    notes="28 heads not divisible by model axis: attention replicated, MLP/vocab sharded; patch frontend stubbed.",
)
