"""Jamba-v0.1 52B — hybrid Mamba+attention (1:7 interleave) with MoE.

MoE 16 experts top-2 on every other layer. [arXiv:2403.19887; hf]
Mamba-1 blocks are realized with the unified SSD block (d_state=16), as
in the reference.  The full config's ``moe.impl`` is ``fse_dp``
(``core.fse_dp``): on one device it runs ``capacity``; serving runs
under the engine's spec (``capacity`` by default).
"""
from .base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    attn_every=8,              # 1 attn per 8 layers (1:7)
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, impl="fse_dp"),
    moe_every=2,               # MoE every other layer
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
    source="arXiv:2403.19887",
    verified="hf",
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-v0.1-52b-reduced", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, impl="dense"),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk_size=32))
