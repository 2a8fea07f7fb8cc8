"""whisper-medium [audio] — enc-dec, conv frontend stubbed (arXiv:2212.04356).

24 encoder + 24 decoder layers, d_model=1024 16H (MHA) d_ff=4096
vocab=51865; frontend stub provides (B, 1500, d_model) frame embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,
    remat="full",
)
