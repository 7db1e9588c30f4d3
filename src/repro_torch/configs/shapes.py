"""Input-shape cells and their applicability rules (the port's own copy of
``repro.configs.shapes``).

Four shapes per LM-family arch (40 cells total):

  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill_step (inference)
  decode_32k   seq=32768  global_batch=128   -> serve_step (1 new token, KV=seq)
  long_500k    seq=524288 global_batch=1     -> serve_step; sub-quadratic only
"""
from __future__ import annotations

from dataclasses import dataclass
from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per assignment)")
    if shape.kind == "decode" and not cfg.has_decode:
        return False, f"{cfg.name} is encoder-only; no decode step"
    return True, ""


def cells(cfg: ModelConfig):
    """All four cells with applicability annotation."""
    out = []
    for sname in SHAPE_ORDER:
        s = SHAPES[sname]
        ok, why = applicable(cfg, s)
        out.append((s, ok, why))
    return out
