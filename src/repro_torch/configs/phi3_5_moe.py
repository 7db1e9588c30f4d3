"""Phi-3.5-MoE 42B-A6.6B — 16 experts top-2. Also a paper Table-I model.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
The full config's ``moe.impl`` is ``fse_dp`` (``core.fse_dp``): on one
device it runs ``capacity``; the engine serves under its own spec
(``capacity`` by default).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    activation="swiglu",
    norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400, impl="fse_dp"),
    moe_every=1,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi3.5-moe-42b-a6.6b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, impl="dense"))
