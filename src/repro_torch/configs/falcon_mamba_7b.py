"""falcon-mamba-7b [ssm] — mamba-1, attention-free (arXiv:2410.05355).

64L d_model=4096 vocab=65024, ssm_state=16, expand=2 (d_inner=8192),
d_conv=4. Sub-quadratic: runs the long_500k cell.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    remat="full",
)
