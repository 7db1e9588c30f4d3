"""Dispatch layer for the kernels (port of ``repro.kernels.ops``).

``streamed_moe``, ``flash_attention`` and ``ssd_intra_chunk`` are what
the model code calls.  With kernels on (the default) each hands its
operands to the kernel wrapper, which launches the CUDA kernel for CUDA
tensors; ``streamed_moe`` first quantizes or storage-casts the weights
to the ambient streamed format per call, as the reference does.
``use_kernels(False)`` routes to the reference's oracles instead; it is
an explicit switch (``chip_smoke.py`` uses it for its comparison run),
never a fallback.  The tiles are fixed in the kernel: the Hopper tile
planner (the counterpart of ``core.autotune.kernel_opts_for``) and with
it an autotuned entry point are later work.
"""
from __future__ import annotations

import contextlib
import contextvars

from . import quant, ref
from .flash_attention import flash_attention_kernel
from .ssd import ssd_intra_chunk_kernel
from .streamed_moe import streamed_moe_kernel

_USE = contextvars.ContextVar("repro_torch_use_kernels", default=True)


@contextlib.contextmanager
def use_kernels(enabled: bool):
    tok = _USE.set(enabled)
    try:
        yield
    finally:
        _USE.reset(tok)


def kernels_enabled() -> bool:
    return _USE.get()


def streamed_moe(xe, w_g, w_u, w_d, activation: str, weight_dtype=None):
    """Grouped expert FFN; ``w_g=None`` for the gateless activations.

    ``weight_dtype`` (or the ambient ``quant.use_weight_dtype``) selects
    the streamed format: int8/fp8 quantize per call with per-(expert,
    output-channel) scales, bf16/fp32 cast."""
    wdt = quant.check_weight_dtype(weight_dtype)
    if wdt is None:
        wdt = quant.weight_dtype()
    if not kernels_enabled():
        if wdt is None:
            return ref.streamed_moe_ref(xe, w_g, w_u, w_d, activation)
        return ref.streamed_moe_quant_ref(xe, w_g, w_u, w_d, activation, wdt)
    if activation != "swiglu":
        w_g = None
    if wdt in quant.QUANTIZED:
        s_g = None
        if w_g is not None:
            w_g, s_g = quant.quantize(w_g, wdt)
        w_u, s_u = quant.quantize(w_u, wdt)
        w_d, s_d = quant.quantize(w_d, wdt)
        return streamed_moe_kernel(xe, w_g, w_u, w_d, activation=activation,
                                   s_g=s_g, s_u=s_u, s_d=s_d)
    return streamed_moe_kernel(xe, quant.storage_cast(w_g, wdt),
                               quant.storage_cast(w_u, wdt),
                               quant.storage_cast(w_d, wdt),
                               activation=activation)


def flash_attention(q, k, v):
    """Causal attention over (B,S,H,hd) with KV broadcast to H heads."""
    if kernels_enabled():
        return flash_attention_kernel(q, k, v)
    return ref.flash_attention_ref(q, k, v)


def ssd_intra_chunk(xc, Bc, Cc, Ac, A_cumsum):
    """Mamba-2 SSD intra-chunk terms -> (Y_diag, states), fp32.  B and C
    come per group, (b,nc,c,g,n) with g dividing the h heads of xc."""
    if kernels_enabled():
        return ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, A_cumsum)
    return ref.ssd_intra_chunk_ref(xc, Bc, Cc, Ac, A_cumsum)
