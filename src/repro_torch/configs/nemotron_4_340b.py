"""Nemotron-4 340B — dense GQA transformer, squared-ReLU FFN.

[arXiv:2402.16819; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    source="arXiv:2402.16819",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-4-340b-reduced", num_layers=3, d_model=96, num_heads=6,
        num_kv_heads=2, head_dim=16, d_ff=384, vocab_size=128)
