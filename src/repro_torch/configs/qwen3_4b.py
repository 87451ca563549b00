"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) d_ff=9728 v=151936, qk_norm
[hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    supports_long_context=False,
    notes="AMC technique inapplicable (dense); embedding gathers only.",
)
