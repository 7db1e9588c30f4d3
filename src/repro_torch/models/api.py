"""Model API surface the serving engine uses (port of the LM part of
``repro.models.api``): init, one-shot prefill, and the per-layer
``decode_*`` sub-steps."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from . import transformer


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters from ``seed``, drawn on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return transformer.init_lm(cfg, generator=generator, device=device)


def prefill_fn(params, batch, cfg: ModelConfig, max_seq: int, *, spec=None):
    """Prompt processing -> (logits, caches)."""
    return transformer.prefill(params, batch["tokens"], cfg, max_seq,
                               spec=spec)


decode_embed_merge = transformer.decode_embed_merge
decode_mixer = transformer.decode_mixer
decode_route = transformer.decode_route
decode_moe_exec = transformer.decode_moe_exec
decode_ffn = transformer.decode_ffn
decode_logits = transformer.decode_logits
