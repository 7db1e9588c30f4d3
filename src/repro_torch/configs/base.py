"""Configuration dataclasses (the port's own copy of ``repro.configs.base``).

Configs are pure data: the same frozen fields, derived properties and
capacity rule as the reference, so one config drives both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


def moe_capacity_rows(tokens: int, top_k: int, num_experts: int,
                      capacity_factor: float) -> int:
    """Per-expert capacity C = max(1, ceil(tokens*top_k/E*cf))."""
    return max(1, math.ceil(tokens * top_k / num_experts * capacity_factor))


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts FFN block configuration."""

    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    num_shared_experts: int = 0        # DeepSeek-style always-on experts
    capacity_factor: float = 1.25      # EP baseline dispatch capacity
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    micro_slices: int = 4              # FSE-DP micro-slices per device slice
    impl: str = "dense"                # default strategy name (registry key)

    def __post_init__(self):
        assert self.top_k <= self.num_experts

    def capacity_rows(self, tokens: int) -> int:
        return moe_capacity_rows(tokens, self.top_k, self.num_experts,
                                 self.capacity_factor)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                 # SSD head dim (P)
    n_groups: int = 1
    chunk_size: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    activation: str = "swiglu"         # swiglu | relu2 | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1
    encoder_layers: int = 0
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"
    source: str = ""
    verified: str = "unverified"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                kinds.append("attn" if (i % self.attn_every) == self.attn_every - 1
                             else "ssm")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def ffn_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.num_layers):
            if self.moe is not None and (i % self.moe_every) == self.moe_every - 1:
                kinds.append("moe")
            elif self.d_ff > 0:
                kinds.append("dense")
            else:
                kinds.append("none")
        return tuple(kinds)

    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        n_mats = 3 if self.activation == "swiglu" else 2
        moe_ffn = 0
        if self.moe is not None:
            per_e = n_mats * d * self.moe.d_expert
            moe_ffn = self.moe.num_experts * per_e + d * self.moe.num_experts \
                + self.moe.num_shared_experts * per_e
        ssm_p = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            gn = self.ssm.n_groups * self.ssm.d_state
            # in_proj (z, x, B, C, dt) + conv + out_proj + A, D
            ssm_p = d * (2 * di + 2 * gn + nh) + self.ssm.d_conv * (di + 2 * gn) \
                + di * d + 2 * nh
        total = embed
        for mix, ffn in zip(self.layer_kinds(), self.ffn_kinds()):
            total += (attn if mix == "attn" else ssm_p) + 2 * d
            total += moe_ffn if ffn == "moe" else (
                n_mats * d * self.d_ff if ffn == "dense" else 0)
        return int(total)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# ported architectures; the reference registers thirteen
_ARCH_MODULES = ["granite_moe_1b", "mamba2_370m", "jamba_v0_1_52b"]
_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)
