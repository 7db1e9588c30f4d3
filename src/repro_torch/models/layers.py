"""Primitive layers (port of ``repro.models.layers``): init helpers,
RMS norm, half-split rotary embedding, activations.

Functions take tensors and parameter dicts; initializers take an
explicit ``torch.Generator`` and ``device``.  Norm statistics and rotary
angles are computed in fp32 and cast back, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, *, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in fp32 on ``device``, cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, *, scale=None, lead=()):
    """(…lead, d_in, d_out) weights with std 1/sqrt(d_in) by default."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return normal(gen, (*lead, d_in, d_out), scale=scale, dtype=dtype,
                  device=device)


def embed_init(gen, vocab, d, dtype, device):
    return normal(gen, (vocab, d), scale=0.02, dtype=dtype, device=device)


def rmsnorm_init(d, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def norm_init(kind: str, d, device, lead=()):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported (rmsnorm only)")
    return rmsnorm_init(d, device, lead)


def apply_norm(kind: str, params, x):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported (rmsnorm only)")
    return rmsnorm(params, x)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    inv = torch.from_numpy(np.asarray(rope_freqs(hd, theta), np.float32)) \
        .to(x.device)
    ang = positions[..., None].float() * inv               # (..., seq, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(kind: str):
    if kind == "swiglu":              # the gate half; mlp.py multiplies
        return F.silu
    if kind == "relu2":
        return lambda x: torch.square(F.relu(x))
    if kind == "gelu":                # jax.nn.gelu's tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(kind)
