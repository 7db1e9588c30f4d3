"""Primitive layers (port of ``repro.models.layers``): init helpers,
RMS and layer norms, half-split rotary embedding, sinusoidal positions,
activations.

Functions take tensors and parameter dicts; initializers take an
explicit ``torch.Generator`` and ``device``.  Norm statistics and rotary
angles are computed in fp32 and cast back, as in the reference.
:func:`checkpointed` is the port's ``jax.checkpoint``.
"""
from __future__ import annotations

import contextvars

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def normal(gen: torch.Generator, shape, *, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in fp32 on ``device``, cast to ``dtype``.
    Scaled in place: a full-width expert stack in fp32 is 21 GB
    (DeepSeek-MoE-16B), and a second fp32 copy would not fit beside the
    model on one 80 GB card."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


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


def layernorm_init(d, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)}


def layernorm(params, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def norm_init(kind: str, d, device, lead=()):
    return rmsnorm_init(d, device, lead) if kind == "rmsnorm" \
        else layernorm_init(d, device, lead)


def apply_norm(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_ROPE_FREQS: dict = {}


def _rope_freqs_on(hd: int, theta: float, device) -> torch.Tensor:
    """The frequency table on ``device``, copied there once (the numpy
    values, bit for bit): later calls, the captured serving segments
    among them, make no host-to-device copy."""
    key = (hd, theta, device)
    inv = _ROPE_FREQS.get(key)
    if inv is None:
        inv = _ROPE_FREQS[key] = torch.from_numpy(
            np.asarray(rope_freqs(hd, theta), np.float32)).to(device)
    return inv


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    inv = _rope_freqs_on(hd, theta, x.device)
    ang = positions[..., None].float() * inv               # (..., seq, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) fp32 table: sin on even dims, cos on odd ones, built in
    numpy (float64) as the reference builds it."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d)[None, :]
    ang = pos / np.power(10000, 2 * (dim // 2) / d)
    enc = np.where(dim % 2 == 0, np.sin(ang), np.cos(ang))
    return torch.from_numpy(enc.astype(np.float32)).to(device)


def activation_fn(kind: str):
    if kind == "swiglu":              # the gate half; mlp.py multiplies
        return F.silu
    if kind == "relu2":
        return lambda x: torch.square(F.relu(x))
    if kind == "gelu":                # jax.nn.gelu's tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations dropped after the forward and
    recomputed in the backward (``jax.checkpoint``; non-reentrant
    ``torch.utils.checkpoint``).  The recompute runs under the context
    variables of this call (kernels on or off, sorted dispatch, the weight
    format, the mesh), since the backward may run outside their scope.
    With autograd off it is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        contextvars.copy_context().run, fn, *args, use_reentrant=False)
