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
class FrontendConfig:
    """Modality frontend stub (audio frames / vision patches): the backbone
    takes precomputed embeddings, as in the reference."""

    kind: str                          # "audio" | "vision"
    num_prefix_tokens: int = 256       # vision: patch tokens prepended
    frame_dim: int = 0                 # audio: dim of precomputed frames (=d_model)


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
    encoder_layers: int = 0            # encoder-decoder (Whisper): encoder depth
    frontend: Optional[FrontendConfig] = None
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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_moe(self) -> bool:
        return self.moe is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: the SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Every family decodes (encoder-decoder with its decoder)."""
        return True

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
        dense_ffn = n_mats * d * self.d_ff
        total = embed
        for mix, ffn in zip(self.layer_kinds(), self.ffn_kinds()):
            total += (attn if mix == "attn" else ssm_p) + 2 * d
            total += moe_ffn if ffn == "moe" else (
                dense_ffn if ffn == "dense" else 0)
        if self.encoder_layers:
            # the encoder stack, and each decoder layer's cross-attention
            # and its norm
            total += self.encoder_layers * (attn + dense_ffn + 2 * d)
            total += self.num_layers * (attn + d)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token activates (top-k of the experts, not all)."""
        if self.moe is None:
            return self.param_count()
        per_e = (3 if self.activation == "swiglu" else 2) * self.d_model \
            * self.moe.d_expert
        n_moe = sum(1 for f in self.ffn_kinds() if f == "moe")
        return int(self.param_count()
                   - n_moe * (self.moe.num_experts - self.moe.top_k) * per_e)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


_ARCH_MODULES = [
    "nemotron_4_15b", "yi_6b", "stablelm_1_6b", "nemotron_4_340b",
    "jamba_v0_1_52b", "whisper_base", "granite_moe_1b", "phi3_5_moe",
    "internvl2_2b", "mamba2_370m",
    # the paper's Table I workload models
    "deepseek_moe_16b", "qwen3_30b_a3b", "yuan2_m32",
]
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
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)
