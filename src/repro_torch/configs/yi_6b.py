"""Yi-6B — llama-architecture dense GQA transformer. [arXiv:2403.04652; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=5000000.0,
    source="arXiv:2403.04652",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yi-6b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=160, vocab_size=128)
