"""Synthetic LM data of the port, mirroring ``repro.data``."""
from .pipeline import DataConfig, SyntheticLMDataset, make_host_loader

__all__ = ["DataConfig", "SyntheticLMDataset", "make_host_loader"]
