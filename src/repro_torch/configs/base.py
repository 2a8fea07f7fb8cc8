"""Config system: one dataclass covering every assigned architecture family.

The port's own copy of ``src/repro/configs/base.py`` (framework-free, so the
two packages agree field for field). Each ``repro_torch/configs/<arch>.py``
exports ``CONFIG`` (the exact published configuration) built from this
dataclass. ``reduced()`` derives the tiny
same-family variant used by CPU smoke tests. ``SHAPES`` defines the assigned
input-shape set (LM-family: seq_len × global_batch, with decode/long shapes
lowering ``serve_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_dense_layers: int = 0       # deepseek: layer 0 keeps a dense FFN
    capacity_factor: float = 1.25
    dispatch: str = "ellpack"         # 'ellpack' (one-hot) | 'sort' | 'spmm'
    xe_shard: str = "both"            # sort-dispatch buffer sharding: both|batch|expert
    comm: str = "all_to_all"          # 'all_to_all' | 'ring' (SPLIM ring)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 = full-rank Q (v2-lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 -> ceil(d_model/16)
    chunk: int = 256                  # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")   # RG 1 attn : 2 rec
    lru_width: int = 0                # 0 -> d_model
    window: int = 2048                # local attention window
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_window: int = 0             # 0 = full causal attention
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    griffin: Optional[GriffinConfig] = None
    # enc-dec (whisper): encoder layer count; frontend provides embeddings
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30 s of audio -> 1500 frames
    # vlm: vision stub
    n_vision_tokens: int = 0
    # numerics / scan
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "none"              # none | full | dots  (activation ckpt)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / bounded-window hybrids)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs are decoders or enc-dec

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_moe = None
        if self.moe:
            small_moe = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=64,
                first_dense_layers=min(1, self.moe.first_dense_layers))
        small_mla = dataclasses.replace(
            self.mla, kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
            v_head_dim=16) if self.mla else None
        small_ssm = dataclasses.replace(
            self.ssm, d_state=4, chunk=16) if self.ssm else None
        small_griffin = dataclasses.replace(
            self.griffin, lru_width=64, window=8) if self.griffin else None
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, len(self.griffin.pattern) if self.griffin else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128,
            vocab=256,
            moe=small_moe, mla=small_mla, ssm=small_ssm, griffin=small_griffin,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=16 if self.n_encoder_layers else 1500,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            param_dtype="float32", compute_dtype="float32",
        )

    def n_params(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.ssm.expand * d
            dt = self.ssm.dt_rank or -(-d // 16)
            per = (d * di * 2            # in_proj
                   + di * self.ssm.d_conv
                   + di * (dt + 2 * self.ssm.d_state)
                   + dt * di + di * d + di * self.ssm.d_state + di)
            return emb + L * per
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mla:
            m = self.mla
            q_dim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            attn = d * q_dim + d * (m.kv_lora_rank + m.rope_head_dim) \
                + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim) \
                + self.n_heads * m.v_head_dim * d
        if self.moe:
            moe_ff = 3 * d * self.moe.d_ff_expert
            per = attn + moe_ff * (self.moe.n_experts + self.moe.n_shared) \
                + d * self.moe.n_experts
            dense_ff = 3 * d * self.d_ff if self.d_ff else 0
            return emb + L * per + self.moe.first_dense_layers * (dense_ff - moe_ff * (self.moe.n_experts + self.moe.n_shared))
        ff = 3 * d * self.d_ff
        n_enc = self.n_encoder_layers
        cross = d * (self.n_heads * hd) * 2 if n_enc else 0
        return emb + (L + n_enc) * (attn + ff) + L * cross

    def active_params(self) -> int:
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mla:
            m = self.mla
            q_dim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            attn = d * q_dim + d * (m.kv_lora_rank + m.rope_head_dim) \
                + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim) \
                + self.n_heads * m.v_head_dim * d
        moe_ff = 3 * d * self.moe.d_ff_expert
        per = attn + moe_ff * (self.moe.top_k + self.moe.n_shared)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * per


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = (
    ShapeCase("train_4k", 4_096, 256, "train"),
    ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    ShapeCase("decode_32k", 32_768, 128, "decode"),
    ShapeCase("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeCase:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig):
    """The assigned cells for this arch (DESIGN.md §4 skip rules)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue   # pure full-attention arch — documented skip
        out.append(s)
    return tuple(out)
