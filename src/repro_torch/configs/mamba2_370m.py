"""Mamba2-370M — attention-free SSD (state-space duality) LM.

[arXiv:2405.21060; unverified]
"""
from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    source="arXiv:2405.21060",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-370m-reduced", num_layers=2, d_model=64, vocab_size=128,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=32))
