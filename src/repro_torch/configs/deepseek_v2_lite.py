"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 (arXiv:2405.04434).

27L d_model=2048 16H, MoE 64 routed experts top-6 + 2 shared, per-expert
d_ff=1408 (assignment's explicit "MoE 64e top-6" field), vocab=102400.
Layer 0 keeps a dense FFN (d_ff=10944), per the published architecture.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,       # MLA: all heads share the latent KV
    d_head=128,
    d_ff=10944,          # dense FFN of layer 0
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  first_dense_layers=1,
                  dispatch="sort"),  # SPLIM sort dispatch (§Perf cell B)
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    remat="full",
)
