"""Weight bridge: a reference parameter tree of numpy leaves -> tensors.

The port's parameter dict mirrors the JAX tree leaf for leaf
(``{"embed", "final_norm", "lm_head", "periods": (slot dicts,)}``), so
the bridge is a copy.  A bf16 leaf arrives as an ``ml_dtypes`` array
(``dtype.name == "bfloat16"``) that ``torch.from_numpy`` cannot read: it
is viewed as ``uint16`` and reinterpreted as ``torch.bfloat16``, which is
bit-exact.  Leaves are copied first because ``np.asarray(jax_array)`` is
read-only.  Only the tests use this module.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy (bf16 comes back as fp32, which holds it exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_reference_params(tree, device=None):
    """Map a nested dict/tuple/list of numpy leaves to tensors."""
    if isinstance(tree, dict):
        return {k: from_reference_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_reference_params(v, device) for v in tree)
    return to_tensor(tree, device)


def from_reference_opt_state(state, device=None):
    """A reference ``optim.adamw.AdamWState`` of numpy leaves -> the port's
    ``AdamWState`` (step, m and v as tensors)."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(to_tensor(state.step, device),
                      from_reference_params(state.m, device),
                      from_reference_params(state.v, device))
