"""InternVL2-2B — InternViT (stub) + InternLM2-1.8B backbone.

Vision frontend is a stub: the caller supplies precomputed patch
embeddings (``prefix_embeds``), prepended as prefix tokens.
[arXiv:2404.16821; hf]
"""
from .base import ModelConfig, FrontendConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    frontend=FrontendConfig(kind="vision", num_prefix_tokens=256),
    source="arXiv:2404.16821",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-2b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        frontend=FrontendConfig(kind="vision", num_prefix_tokens=8))
