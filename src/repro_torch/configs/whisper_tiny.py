"""whisper-tiny [audio]: 4L d=384 6H d_ff=1536 v=51865, enc-dec, conv
frontend STUB (input_specs supplies precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,  # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,  # padded to 51872 for 16-way vocab sharding
    head_dim=64,
    frontend="audio",
    supports_long_context=False,
    notes="Conv frontend stubbed per assignment; AMC technique inapplicable (dense).",
)
