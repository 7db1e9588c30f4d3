"""Whisper-base — encoder-decoder audio transformer (backbone only).

The conv frontend is a stub: the caller supplies precomputed frame
embeddings (``frames``) of shape (batch, frames, d_model).
[arXiv:2212.04356; unverified]
"""
from .base import ModelConfig, FrontendConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    frontend=FrontendConfig(kind="audio", frame_dim=512),
    source="arXiv:2212.04356",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-base-reduced", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=128, frontend=FrontendConfig(kind="audio", frame_dim=64))
