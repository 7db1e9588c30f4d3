"""Shape-and-dtype stand-ins for every model input of every (architecture
x shape) cell (port of ``repro.launch.specs``): trees of ``meta`` tensors,
the port's ``jax.eval_shape``, so nothing is allocated.

    params_struct(cfg)           the parameter tree
    batch_struct(cfg, shape)     a train / prefill cell's batch
    decode_structs(cfg, shape)   (caches, token, cache_len) of a decode cell
    input_specs(cfg, shape)      every input of the cell's step function
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import torch_dtype
from repro_torch.models import api, transformer, whisper

WHISPER_TEXT_LEN = 448      # decoder length for enc-dec train/prefill cells
WHISPER_MEMORY_LEN = 1500   # encoder memory length for decode cells

META = torch.device("meta")


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def params_struct(cfg: ModelConfig):
    """The parameter tree as meta tensors, drawn through the model's own
    initializer (a CPU generator; nothing is drawn on ``meta``)."""
    gen = torch.Generator().manual_seed(0)
    if cfg.is_encoder_decoder:
        return whisper.init_encdec(cfg, generator=gen, device=META)
    return transformer.init_lm(cfg, generator=gen, device=META)


def batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for a train/prefill cell (tokens + frontend stubs)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if cfg.is_encoder_decoder:
        T = WHISPER_TEXT_LEN
        return {"frames": _struct((B, S, cfg.d_model), dt),
                "tokens": _struct((B, T), i32),
                "labels": _struct((B, T), i32)}
    if cfg.frontend and cfg.frontend.kind == "vision":
        Pfx = cfg.frontend.num_prefix_tokens
        St = S - Pfx
        return {"prefix_embeds": _struct((B, Pfx, cfg.d_model), dt),
                "tokens": _struct((B, St), i32),
                "labels": _struct((B, St), i32)}
    return {"tokens": _struct((B, S), i32), "labels": _struct((B, S), i32)}


def decode_structs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Any, Any, Any]:
    """(caches, token, cache_len) structs for a decode cell: one new token
    against a KV cache of seq_len."""
    B, S = shape.global_batch, shape.seq_len
    caches = api.init_decode_caches(params_struct(cfg), cfg, B, S,
                                    memory_len=WHISPER_MEMORY_LEN)
    return caches, _struct((B, 1), torch.int32), _struct((B,), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every input struct of the cell's step function."""
    if shape.kind in ("train", "prefill"):
        return batch_struct(cfg, shape)
    caches, token, cache_len = decode_structs(cfg, shape)
    return {"caches": caches, "token": token, "cache_len": cache_len}
