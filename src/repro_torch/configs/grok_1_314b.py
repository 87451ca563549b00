"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) d_ff=32768 v=131072,
MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe_experts=8,
    moe_top_k=2,
    supports_long_context=False,  # full attention
    notes="AMC-technique applicable: recorded-dispatch MoE gathers.",
)
