"""Model API (port of the LM part of ``repro.models.api``): init, the
scoring loss, one-shot prefill, and the per-layer ``decode_*`` sub-steps
the serving engine uses."""
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


def _xent(logits, labels, ignore_label=-1):
    """(sum of token cross-entropies, count of scored tokens), in fp32;
    tokens labelled ``ignore_label`` are not scored."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore_label).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


CE_CHUNK = 512


def fused_xent(h, head, labels, ignore_label=-1):
    """Unembed + mean cross-entropy, CE_CHUNK positions at a time, so the
    full (B, S, V) fp32 logits are never held; a ragged tail is one more
    chunk."""
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], CE_CHUNK):
        t, c = _xent(h[:, s0:s0 + CE_CHUNK] @ head,
                     labels[:, s0:s0 + CE_CHUNK], ignore_label)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def leaves(tree, prefix=""):
    """(path, tensor) for every tensor in a tree of dicts and sequences."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")


def loss_fn(params, batch, cfg: ModelConfig, *, spec=None, use_flash=False):
    """Scoring loss (CE + MoE aux) over ``batch = {"tokens", "labels"}``
    (labels -1 are not scored).  Returns (loss, {"ce", "aux"}).  Forward
    only: the backward belongs to the training slice."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for _, t in leaves(params)):
        raise NotImplementedError("loss_fn is forward only; its backward "
                                  "belongs to the training slice (ROADMAP "
                                  "A.15): call it under torch.no_grad()")
    h, aux = transformer.forward(params, batch["tokens"], cfg, spec=spec,
                                 use_flash=use_flash, return_hidden=True)
    ce = fused_xent(h, transformer.head_matrix(params), batch["labels"])
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    return ce + coef * aux, {"ce": ce, "aux": aux}


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
