"""Architecture configs of the port: copies of ``src/repro/configs``, brought
over as the port reaches each model (so far deepseek-v2-lite's, for the MoE
layer)."""
from . import base, deepseek_v2_lite
from .base import MoEConfig, ModelConfig

__all__ = ["MoEConfig", "ModelConfig", "base", "deepseek_v2_lite"]
