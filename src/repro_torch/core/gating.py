"""Top-K expert gating (port of ``repro.core.gating``).

Softmax over all expert logits, top-k, renormalized weights.  Top-k is a
stable descending sort: among equal probabilities the lower expert index
wins, as ``jax.lax.top_k`` does (``torch.topk`` leaves tie order open).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import dense_init


class Routing(NamedTuple):
    indices: torch.Tensor     # (T, k) int64 selected experts
    weights: torch.Tensor     # (T, k) renormalized gate weights
    probs: torch.Tensor       # (T, E) full softmax
    combine: torch.Tensor     # (T, E) weights scattered into expert slots


def router_init(gen, d_model, num_experts, dtype, device, lead=()):
    return {"w_router": dense_init(gen, d_model, num_experts, dtype, device,
                                   scale=0.02, lead=lead)}


def route(params, x, *, top_k: int, jitter: float = 0.0,
          generator: Optional[torch.Generator] = None) -> Routing:
    """x: (T, d) -> Routing over E experts.  With ``jitter`` and a
    ``generator`` (the reference's PRNG key), the logits take
    ``jitter * N(0, 1)`` noise before the softmax."""
    logits = (x @ params["w_router"]).float()                  # (T, E)
    if jitter and generator is not None:
        logits = logits + jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    weights, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, indices = weights[:, :top_k], indices[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    combine = torch.zeros_like(probs).scatter_(1, indices, weights)
    return Routing(indices, weights.to(x.dtype), probs, combine.to(x.dtype))


def aux_load_balance_loss(routing: Routing, num_experts: int) -> torch.Tensor:
    """Switch-transformer style: E * sum_e f_e * p_e."""
    assign = (routing.combine > 0).float()
    f = assign.sum(0) / torch.clamp(assign.sum(), min=1.0)
    p = routing.probs.mean(0)
    return num_experts * torch.sum(f * p)


def expert_token_counts(routing: Routing, mask=None) -> torch.Tensor:
    """(E,) tokens activating each expert, optionally over a (T,) row mask."""
    assign = routing.combine > 0
    if mask is not None:
        assign = assign & torch.as_tensor(mask, device=assign.device)[:, None]
    return assign.sum(0)
