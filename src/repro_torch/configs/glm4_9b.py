"""glm4-9b [dense]: 40L d=4096 32H (GQA kv=2) d_ff=13696 v=151552, RoPE
[hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    supports_long_context=False,
    notes="Extreme GQA (kv=2): KV replicated across model shards.",
)
