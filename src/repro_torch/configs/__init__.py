"""Architecture registry of the port: copies of ``src/repro/configs`` field
for field, and ``--arch <id>`` resolution for launchers and tests
(``get_config("<id>-smoke")`` is the arch's ``reduced()`` variant)."""
from . import base
from .base import (MLAConfig, ModelConfig, MoEConfig, SHAPES, ShapeCase,
                   applicable_shapes, get_shape)

from . import deepseek_v2_lite
from .deepseek_v2_lite import CONFIG as _deepseek
from .falcon_mamba_7b import CONFIG as _falcon_mamba
from .granite_moe_3b import CONFIG as _granite
from .internvl2_2b import CONFIG as _internvl
from .mistral_large_123b import CONFIG as _mistral
from .qwen15_110b import CONFIG as _qwen15
from .qwen2_05b import CONFIG as _qwen2
from .recurrentgemma_9b import CONFIG as _rgemma
from .whisper_medium import CONFIG as _whisper
from .yi_34b import CONFIG as _yi

ARCHS = {c.name: c for c in [
    _mistral, _qwen15, _qwen2, _yi, _falcon_mamba,
    _granite, _deepseek, _whisper, _rgemma, _internvl,
]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].reduced()
    return ARCHS[name]


__all__ = ["ARCHS", "MLAConfig", "MoEConfig", "ModelConfig", "SHAPES",
           "ShapeCase", "applicable_shapes", "base", "deepseek_v2_lite",
           "get_config", "get_shape"]
