"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 v=32768,
MoE 8e top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
    sliding_window=4096,
    moe_experts=8,
    moe_top_k=2,
    supports_long_context=True,  # SWA bounds the KV cache
    notes="AMC-technique applicable: recorded-dispatch MoE gathers.",
)
