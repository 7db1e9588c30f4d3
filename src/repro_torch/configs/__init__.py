from .base import (ModelConfig, MoEConfig, SSMConfig, get_config,
                   list_configs, moe_capacity_rows, register)


def reduced_config(name: str):
    """The reduced (smoke-test) variant of a ported arch."""
    import importlib
    from .base import _ARCH_MODULES
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        if mod.CONFIG.name == name:
            return mod.reduced()
    raise KeyError(name)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "list_configs", "moe_capacity_rows", "reduced_config", "register"]
