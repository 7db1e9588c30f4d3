"""Qwen3-30B-A3B — paper Table-I workload model (128 experts top-8).

[arXiv:2505.09388 / paper Table I; hf]
The full config's ``moe.impl`` is ``fse_dp`` (``core.fse_dp``): on one
device it runs ``capacity``; the engine serves under its own spec
(``capacity`` by default).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, impl="fse_dp"),
    moe_every=1,
    source="paper Table I / arXiv:2505.09388",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-30b-a3b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=4, d_expert=64, impl="dense"))
