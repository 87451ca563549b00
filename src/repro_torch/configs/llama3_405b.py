"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248 v=128256
[arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    opt_state_dtype="bfloat16",  # 405B fp32 m/v does not fit 256x16GB
    supports_long_context=False,
    notes="FSDP(data)+TP(model) sharding; bf16 optimizer state (EXPERIMENTS §3).",
)
