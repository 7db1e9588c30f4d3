"""DeepSeek-MoE 16B — paper Table-I workload model (64 experts, 6+2 shared).

[arXiv:2401.06066 / paper Table I; hf]
The full config's ``moe.impl`` is ``fse_dp`` (``core.fse_dp``): on one
device it runs ``capacity``; the engine serves under its own spec
(``capacity`` by default).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, impl="fse_dp"),
    moe_every=1,
    source="paper Table I / arXiv:2401.06066",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-moe-16b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64,
                      num_shared_experts=1, impl="dense"))
