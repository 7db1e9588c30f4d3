"""Model API (port of ``repro.models.api``): family dispatch for init, the
scoring loss, one-shot and chunked prefill and the one-token decode step,
and the per-layer ``decode_*`` sub-steps the serving engine uses.
Batches are dicts: ``tokens`` and ``labels``, ``prefix_embeds`` (B, P, d)
for a vision model, ``frames`` (B, F, d) for the encoder-decoder one."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from . import graphs, transformer, whisper
from .layers import checkpointed


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters from ``seed``, drawn on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    if cfg.is_encoder_decoder:
        return whisper.init_encdec(cfg, generator=generator, device=device)
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
    """Unembed + mean cross-entropy, CE_CHUNK positions at a time, each
    chunk recomputed in the backward, so the full (B, S, V) fp32 logits
    are never held; a ragged tail is one more chunk."""
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], CE_CHUNK):
        t, c = checkpointed(_xent_chunk, h[:, s0:s0 + CE_CHUNK], head,
                            labels[:, s0:s0 + CE_CHUNK], ignore_label)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def _xent_chunk(h, head, labels, ignore_label):
    return _xent(h @ head, labels, ignore_label)


def loss_fn(params, batch, cfg: ModelConfig, *, spec=None, remat=False,
            use_flash=False, unshard=False):
    """Training and scoring loss (CE + MoE aux) over ``batch = {"tokens",
    "labels"}`` (labels -1 are not scored), with ``prefix_embeds`` in
    front of the tokens (only the text positions are scored) or, for the
    encoder-decoder family, ``frames`` for the encoder.  Returns (loss,
    {"ce", "aux"}).  Differentiable; ``remat`` recomputes each period's
    (the encoder-decoder family: each layer's) activations in the
    backward.  The flash kernel has no backward: train with ``use_flash``
    off, as the reference does.  Under a sharding layout (the mesh steps)
    ``params`` are this rank's blocks, gathered as they are used;
    ``unshard``: ``transformer.forward``'s per-period gather.  On CUDA,
    where autograd does not record, the second call of a setting on is
    replayed from a CUDA graph (``models.graphs``)."""
    return graphs.call(_loss, params, batch, cfg, spec=spec, remat=remat,
                       use_flash=use_flash, unshard=unshard)


def _loss(params, batch, cfg, *, spec, remat, use_flash, unshard):
    if cfg.is_encoder_decoder:
        params = transformer.gathered(params)
        memory = whisper.encode(params, batch["frames"], cfg, remat=remat)
        h = whisper.decode_train(params, batch["tokens"], memory, cfg,
                                 remat=remat, return_hidden=True)
        ce = fused_xent(h, params["embed"].T, batch["labels"])
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}
    prefix = batch.get("prefix_embeds")
    h, aux = transformer.forward(params, batch["tokens"], cfg,
                                 prefix_embeds=prefix, spec=spec,
                                 use_flash=use_flash, remat=remat,
                                 unshard=unshard, return_hidden=True)
    if prefix is not None:              # score the text positions only
        h = h[:, prefix.shape[1]:]
    ce = fused_xent(h, transformer.gathered_head(params), batch["labels"])
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    return ce + coef * aux, {"ce": ce, "aux": aux}


def prefill_fn(params, batch, cfg: ModelConfig, max_seq: int, *, spec=None):
    """Prompt processing -> (logits, caches).  The encoder-decoder family
    encodes ``frames`` and returns the teacher-forced logits of the
    tokens beside caches holding the cross-attention K/V and an empty
    self-attention cache, as the reference does."""
    if cfg.is_encoder_decoder:
        params = transformer.gathered(params)
        memory = whisper.encode(params, batch["frames"], cfg)
        caches = whisper.init_decode_caches(params, memory, cfg,
                                            batch["frames"].shape[0], max_seq)
        return whisper.decode_train(params, batch["tokens"], memory,
                                    cfg), caches
    return transformer.prefill(params, batch["tokens"], cfg, max_seq,
                               prefix_embeds=batch.get("prefix_embeds"),
                               spec=spec)


def prefill_chunk_fn(params, tokens, caches, cache_len, cfg: ModelConfig, *,
                     spec=None, token_mask=None, return_hidden=False,
                     page_table=None):
    """Append one prompt chunk to the decode caches ->
    (logits or hidden, caches, per-layer expert counts)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("chunked prefill serves LM-family models")
    return transformer.prefill_chunk(params, tokens, caches, cache_len, cfg,
                                     spec=spec, token_mask=token_mask,
                                     return_hidden=return_hidden,
                                     page_table=page_table)


decode_embed_merge = transformer.decode_embed_merge
decode_mixer = transformer.decode_mixer
decode_route = transformer.decode_route
decode_moe_exec = transformer.decode_moe_exec
decode_ffn = transformer.decode_ffn
decode_span = transformer.decode_span
decode_logits = transformer.decode_logits


def decode_fn(params, token, caches, cache_len, cfg: ModelConfig, *,
              spec=None, unshard=False):
    """One decode step on dense caches -> (logits (B, 1, V), new caches).
    ``unshard``: ``transformer.decode_step``'s per-period gather."""
    if cfg.is_encoder_decoder:
        return whisper.decode_step(transformer.gathered(params), token,
                                   caches, cache_len, cfg)
    return transformer.decode_step(params, token, caches, cache_len, cfg,
                                   spec=spec, unshard=unshard)


def init_decode_caches(params, cfg: ModelConfig, batch: int, max_seq: int,
                       memory_len: int = 1500):
    """Empty decode caches on the parameters' device; the encoder-decoder
    family's cross-attention K/V from a zero memory of ``memory_len``
    frames."""
    device = params["embed"].device
    if cfg.is_encoder_decoder:
        mem = torch.zeros((batch, memory_len, cfg.d_model),
                          dtype=torch_dtype(cfg.dtype), device=device)
        return whisper.init_decode_caches(params, mem, cfg, batch, max_seq)
    return transformer.init_caches(cfg, batch, max_seq, device=device)
