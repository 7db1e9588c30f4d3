"""Device resolution: ``cuda`` by default, ``cpu`` only when asked."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device that is not there raises
    instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda or cpu)")
    return dev


def resolve_init_device(device=None) -> torch.device:
    """:func:`resolve_device` for the parameter and cache initializers,
    which also take ``meta``: shapes and dtypes with nothing allocated,
    the port's ``jax.eval_shape`` (``launch.specs``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
