"""The serving engine's SpGEMM lane (``engine.py``), mirroring
``repro.serve``."""
from .engine import (ServeConfig, ServingEngine, SparseGemmBatcher,
                     SparseGemmRequest)

__all__ = ["ServeConfig", "ServingEngine", "SparseGemmBatcher",
           "SparseGemmRequest"]
