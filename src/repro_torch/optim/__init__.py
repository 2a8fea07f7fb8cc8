"""Optimizer of the port, mirroring ``repro.optim``: AdamW (``adamw``) and
the int8 gradient compression (``compress``)."""
from .adamw import (AdamWConfig, PartialUpdateError, adamw_init,
                    adamw_update, global_norm, opt_state_specs,
                    place_opt_state)
from .compress import compress_int8, compressed_psum_mean, decompress_int8

__all__ = ["AdamWConfig", "PartialUpdateError", "adamw_init", "adamw_update", "global_norm",
           "opt_state_specs", "place_opt_state", "compress_int8", "decompress_int8",
           "compressed_psum_mean"]
