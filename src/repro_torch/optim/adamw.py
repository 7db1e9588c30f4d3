"""AdamW with global-norm clipping and a cosine schedule (port of
``repro.optim.adamw``), with the reference's arithmetic: the update is
computed in fp32 and cast back to each parameter's dtype (a bf16
parameter so keeps the reference's rounding, small updates vanishing
included), the bias corrections come from the incremented step, and
clipping scales ``g`` in fp32 and casts back to its dtype.

``apply`` writes the new parameters and moments into the given tensors
(under ``torch.no_grad``), one leaf at a time, so the step needs no
second copy of the model and its state; it returns them with the new
state.  Leaves are taken in the reference's order (``repro_torch.tree``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tree
from repro_torch.tree import leaves


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, steps taken
    m: dict
    v: dict


def _dtype(d):
    if isinstance(d, torch.dtype):
        return d
    from repro_torch.device import torch_dtype
    return torch_dtype(str(d))


def init(params, state_dtype=torch.float32) -> AdamWState:
    dt = _dtype(state_dtype)
    first = tree.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree.map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        v=tree.map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> lr (an fp32 tensor): linear warmup to ``base_lr``, then a
    cosine to 0 at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1.0, warmup)
        frac = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in leaves(tree)])))


def _clip_scale(gnorm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def _clip(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree.map(lambda x: _clip(x, scale), grads), g


@torch.no_grad()
def apply(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.1, max_grad_norm=1.0, grad_norm=None):
    """One AdamW update, written into ``params``, ``state.m`` and
    ``state.v``.  ``lr`` is a scalar or a schedule(step) -> scalar, read at
    the step count before this update.  ``grad_norm``: the global norm to
    clip by, where ``grads`` are blocks of a gradient sharded over a mesh
    (``launch.steps``; the norm of the whole gradient, which no rank's
    blocks give), else the norm of ``grads``.  -> (params, AdamWState with
    the step count advanced, {"grad_norm": norm before clipping})."""
    if callable(lr):
        lr = lr(state.step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state.m), tree.leaves(state.v)):
        gf = _clip(g, scale).float()
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m2 / b1c
        vhat = v2 / b2c
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
        p.copy_(pf)
        m.copy_(m2)
        v.copy_(v2)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
