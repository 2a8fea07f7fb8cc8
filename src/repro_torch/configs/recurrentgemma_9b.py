"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2 (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000,
pattern (rec, rec, attn) with window 2048. Sub-quadratic: runs long_500k.
"""
from .base import GriffinConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    griffin=GriffinConfig(pattern=("rec", "rec", "attn"), lru_width=4096,
                          window=2048, conv_width=4),
    remat="full",
)
