"""Yuan2.0-M32 — paper Table-I workload model (32 experts top-2).

[arXiv:2405.17976 / paper Table I; unverified]
The full config's ``moe.impl`` is ``fse_dp`` (``core.fse_dp``): on one
device it runs ``capacity``; the engine serves under its own spec
(``capacity`` by default).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="yuan2-m32",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4096,
    vocab_size=135040,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=32, top_k=2, d_expert=4096, impl="fse_dp"),
    moe_every=1,
    source="paper Table I / arXiv:2405.17976",
    verified="unverified",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yuan2-m32-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=128, impl="dense"))
