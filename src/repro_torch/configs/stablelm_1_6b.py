"""StableLM-2 1.6B — dense transformer, kv=32 (MHA-equivalent GQA).

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    activation="swiglu",
    norm="layernorm",
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="stablelm-1.6b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=128)
