"""Nemotron-4 15B — dense GQA transformer with squared-ReLU FFN.

[arXiv:2402.16819; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    source="arXiv:2402.16819",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-4-15b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
