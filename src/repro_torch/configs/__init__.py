from .base import (FrontendConfig, ModelConfig, MoEConfig, SSMConfig,
                   get_config, list_configs, moe_capacity_rows, register)
from .shapes import SHAPE_ORDER, SHAPES, ShapeSpec, applicable, cells

ASSIGNED_ARCHS = [
    "nemotron-4-15b", "yi-6b", "stablelm-1.6b", "nemotron-4-340b",
    "jamba-v0.1-52b", "whisper-base", "granite-moe-1b-a400m",
    "phi3.5-moe-42b-a6.6b", "internvl2-2b", "mamba2-370m",
]

PAPER_MODELS = ["phi3.5-moe-42b-a6.6b", "yuan2-m32", "deepseek-moe-16b",
                "qwen3-30b-a3b"]


def reduced_config(name: str):
    """The reduced (smoke-test) variant of a registered arch."""
    import importlib
    from .base import _ARCH_MODULES
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        if mod.CONFIG.name == name:
            return mod.reduced()
    raise KeyError(name)


__all__ = ["ASSIGNED_ARCHS", "FrontendConfig", "ModelConfig", "MoEConfig",
           "PAPER_MODELS", "SHAPES", "SHAPE_ORDER", "SSMConfig", "ShapeSpec",
           "applicable", "cells", "get_config", "list_configs",
           "moe_capacity_rows", "reduced_config", "register"]
