"""granite-moe-3b-a800m [moe] — hf:ibm-granite (granite-3.0 MoE family).

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 40 experts top-8 (assignment's explicit "MoE 40e top-8" field).
SPLIM ELLPACK dispatch is the technique-representative path here.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,              # all-MoE FFN
    vocab=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  dispatch="sort"),   # SPLIM sort dispatch (§Perf cell A)
    remat="full",
)
