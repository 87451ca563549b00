"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 v=32000,
ssm_state=64, Mamba2 + shared attn blocks [arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,  # shared transformer block after every 6 mamba blocks
    supports_long_context=True,  # SSM backbone; attn decodes vs sharded cache
    notes=(
        "Shared-block LoRA adapters of the HF release omitted (DESIGN.md); "
        "AMC technique applies to embedding gathers only."
    ),
)
