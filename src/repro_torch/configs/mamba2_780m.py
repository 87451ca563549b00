"""mamba2-780m [ssm]: 48L d=1536 (attn-free) v=50280, ssm_state=128, SSD
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,  # padded to 50288 for 16-way vocab sharding
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    supports_long_context=True,  # O(1)/token decode state
    notes="Attention-free: AMC technique inapplicable (DESIGN.md §4).",
)
