"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8, d_expert=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512, impl="fse_dp"),
    moe_every=1,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-1b-a400m-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, impl="dense"))
