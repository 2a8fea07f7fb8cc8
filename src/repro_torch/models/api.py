"""Model facade, mirroring ``src/repro/models/api.py``: one object per
architecture with uniform step functions.

  model.init(generator, device)             -> params (real tensors)
  model.abstract_params()                   -> tensors on the meta device
  model.loss(params, batch)                 -> scalar (differentiable; a
                                               Sharded one on placed weights)
  model.prefill(params, batch, s_max)       -> (last_logits, cache)
  model.decode_step(params, cache, tokens)  -> (logits, cache)
  model.input_specs(shape_case)             -> {name: (torch.Size, dtype)}
  model.cache_zeros(batch, s_max)           -> decode cache
  model.place(params[, opt_state])          -> params (and AdamW's state)
                                               laid out on the mesh

``batch`` is a dict: always "tokens" (B,S); plus "frames" (the audio
stub's (B, encoder_seq, d_model) embeddings, whisper) or "patches" (the
VLM stub). The audio family runs ``models/encdec.py``, every other one the
decoder of ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeCase
from . import encdec, transformer
from .params import (abstract_params, count_params, init_params,
                     place_params, torch_dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    # -- parameters ---------------------------------------------------------
    def specs(self):
        if self._audio:
            return encdec.encdec_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Any:
        """Weights drawn from ``generator`` (a seeded ``torch.Generator`` on
        ``device``) in ``param_dtype`` on ``device`` (default: the card)."""
        return init_params(self.specs(), generator,
                           torch_dtype(self.cfg.param_dtype), device)

    def abstract_params(self):
        return abstract_params(self.specs(), torch_dtype(self.cfg.param_dtype))

    def n_params(self) -> int:
        return count_params(self.specs())

    def place(self, params, opt_state=None):
        """``params`` laid out on the active mesh by the rules
        (``params.place_params``). With ``opt_state`` (AdamW's, whole), the
        pair ``(params, opt_state)``, the moments laid out by their ZeRO-1
        specs (``optim.place_opt_state``)."""
        placed = place_params(params, self.specs())
        if opt_state is None:
            return placed
        from ..optim import place_opt_state
        return placed, place_opt_state(opt_state, self.specs())

    # -- steps ---------------------------------------------------------------
    def _prefix(self, batch):
        return batch.get("patches") if self.cfg.family == "vlm" else None

    def loss(self, params, batch) -> torch.Tensor:
        if self._audio:
            return encdec.encdec_loss(params, batch["frames"],
                                      batch["tokens"], self.cfg)
        return transformer.decoder_loss(params, batch["tokens"], self.cfg,
                                        prefix_embed=self._prefix(batch))

    def prefill(self, params, batch, s_max: int):
        if self._audio:
            return encdec.encdec_prefill(params, batch["frames"],
                                         batch["tokens"], self.cfg, s_max)
        return transformer.decoder_prefill(params, batch["tokens"], self.cfg,
                                           s_max,
                                           prefix_embed=self._prefix(batch))

    def decode_step(self, params, cache, tokens):
        if self._audio:
            return encdec.encdec_decode_step(params, cache, tokens, self.cfg)
        return transformer.decoder_decode_step(params, cache, tokens,
                                               self.cfg)

    def cache_zeros(self, batch: int, s_max: int, device=None):
        from ..core.formats import resolve_device
        zeros = encdec.encdec_cache_zeros if self._audio \
            else transformer.decoder_cache_zeros
        return zeros(self.cfg, batch, s_max, resolve_device(device))

    # -- shape stand-ins ------------------------------------------------------
    def input_specs(self, case: ShapeCase) -> Dict[str, tuple]:
        """(torch.Size, dtype) stand-ins for one shape cell. For decode
        cells "tokens" is the one-step (B, 1) batch."""
        cfg = self.cfg
        b, s = case.global_batch, case.seq_len
        if case.kind == "decode":
            return {"tokens": (torch.Size((b, 1)), torch.int32)}
        specs = {"tokens": (torch.Size((b, s)), torch.int32)}
        dt = torch_dtype(cfg.compute_dtype)
        if cfg.family == "audio":
            specs["frames"] = (torch.Size((b, cfg.encoder_seq, cfg.d_model)),
                               dt)
        if cfg.family == "vlm" and cfg.n_vision_tokens:
            specs["patches"] = (torch.Size((b, cfg.n_vision_tokens,
                                            cfg.d_model)), dt)
            # text shrinks so the total positions equal the cell's seq_len
            specs["tokens"] = (torch.Size((b, s - cfg.n_vision_tokens)),
                               torch.int32)
        return specs


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
