"""internvl2-2b [vlm] — InternViT stub + InternLM2-1.8B backbone
(arXiv:2404.16821).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553; the vision frontend
is a STUB: input_specs() provides (B, 256, d_model) patch embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92553,
    n_vision_tokens=256,
    rope_theta=1e6,
    remat="full",
)
