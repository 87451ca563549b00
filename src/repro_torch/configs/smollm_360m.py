"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) d_ff=2560 v=49152,
llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
    supports_long_context=False,
    notes="15 heads not divisible by model axis: attention replicated, MLP/vocab sharded.",
)
