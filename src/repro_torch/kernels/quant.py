"""Weight quantization for expert streaming (port of ``repro.kernels.quant``).

Streamed storage formats for the expert FFN weights:

  fp32 / bf16  — plain storage, 4 / 2 bytes per param;
  int8         — symmetric, per-(expert, output-channel) fp32 scales,
                 q = round(w / s) clipped to [-127, 127];
  fp8          — ``float8_e4m3fn`` with absmax mapped to 448.

Scales are taken over the contraction axis (-2) of a stacked
(E, d_in, d_out) weight: shape (E, 1, d_out).  Quantization happens per
call at the dispatch layer (``kernels.ops``); params keep their dtype.
torch's ``round`` (half to even), ``clamp`` and ``float8_e4m3fn`` casts
give the reference's bits on the CPU.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

WEIGHT_DTYPES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}
QUANTIZED = ("int8", "fp8")

INT8_MAX = 127.0
FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0

_WDT = contextvars.ContextVar("repro_torch_weight_dtype", default=None)


def check_weight_dtype(name):
    if name is not None and name not in WEIGHT_DTYPES:
        raise ValueError(f"unknown weight_dtype {name!r}; "
                         f"known: {sorted(WEIGHT_DTYPES)}")
    return name


@contextlib.contextmanager
def use_weight_dtype(name):
    """Ambient streamed-weight format for ``kernels.ops.streamed_moe``."""
    tok = _WDT.set(check_weight_dtype(name))
    try:
        yield
    finally:
        _WDT.reset(tok)


def weight_dtype():
    return _WDT.get()


def weight_bytes(name=None, default=None):
    """Streamed bytes per param for ``name`` (or the ambient format)."""
    if name is None:
        name = _WDT.get()
    if name is None:
        return default
    return WEIGHT_DTYPES[check_weight_dtype(name)]


def quantize(w: torch.Tensor, name: str):
    """w: (..., d_in, d_out) -> (q, scale (..., 1, d_out) fp32)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if name == "int8":
        scale = torch.where(absmax > 0, absmax, one) / INT8_MAX
        q = torch.clamp(torch.round(wf / scale), -INT8_MAX, INT8_MAX)
        return q.to(torch.int8), scale
    if name == "fp8":
        scale = torch.where(absmax > 0, absmax, one) / FP8_MAX
        return (wf / scale).to(FP8_DTYPE), scale
    raise ValueError(f"not a quantized weight_dtype: {name!r}")


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def storage_cast(w, name):
    """The unquantized formats: cast to the streamed storage dtype."""
    if w is None:
        return None
    if name == "bf16":
        return w.to(torch.bfloat16)
    if name in (None, "fp32"):
        return w
    raise ValueError(f"not a storage-cast weight_dtype: {name!r}")


def fake_quant(w, name):
    """Round-trip ``w`` through the streamed format, as fp32."""
    if w is None:
        return None
    if name in QUANTIZED:
        return dequantize(*quantize(w, name))
    return storage_cast(w, name).float()
