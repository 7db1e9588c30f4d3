"""Dispatch layer for the kernels (port of ``repro.kernels.ops``).

``streamed_moe``, ``flash_attention`` and ``ssd_intra_chunk`` are what
the model code calls.  With kernels on (the default) each hands its
operands to the kernel wrapper, which launches the CUDA kernel for CUDA
tensors; ``streamed_moe`` first quantizes or storage-casts the weights
to the ambient streamed format per call, as the reference does.
``use_kernels(False)`` routes to the reference's oracles instead; it is
an explicit switch (``chip_smoke.py`` uses it for its comparison run),
never a fallback.  ``streamed_moe`` takes an explicit tile setting;
``streamed_moe_autotuned``, the entry point the MoE block calls, asks the
Hopper tile planner (``core.autotune.kernel_opts_for``) for the setting
of each call's shape under the ambient autotune level.

With kernels on, ``streamed_moe`` is differentiable through
:class:`StreamedMoE`: the forward is the kernel (its plain version on the
CPU), the backward the straight-through VJP of the fp32 oracle on the
original weights, as the reference's custom VJP is; no backward kernel.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

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


def streamed_moe(xe, w_g, w_u, w_d, activation: str, weight_dtype=None,
                 tiles=None):
    """Grouped expert FFN; ``w_g=None`` for the gateless activations.

    ``weight_dtype`` (or the ambient ``quant.use_weight_dtype``) selects
    the streamed format: int8/fp8 quantize per call with per-(expert,
    output-channel) scales, bf16/fp32 cast.  ``tiles`` names the kernel's
    tile setting (``kernels.streamed_moe.TILE_SETTINGS``; None: its
    default); the oracles of ``use_kernels(False)`` have none."""
    wdt = _streamed_format(weight_dtype)
    if not kernels_enabled():
        if wdt is None:
            return ref.streamed_moe_ref(xe, w_g, w_u, w_d, activation)
        return ref.streamed_moe_quant_ref(xe, w_g, w_u, w_d, activation, wdt)
    if activation != "swiglu":
        w_g = None
    return StreamedMoE.apply(xe, w_g, w_u, w_d, activation, wdt, tiles)


def _streamed_moe_raw(xe, w_g, w_u, w_d, activation, wdt, tiles):
    """The kernel on the weights quantized or cast to the format ``wdt``."""
    if wdt in quant.QUANTIZED:
        s_g = None
        if w_g is not None:
            w_g, s_g = quant.quantize(w_g, wdt)
        w_u, s_u = quant.quantize(w_u, wdt)
        w_d, s_d = quant.quantize(w_d, wdt)
        return streamed_moe_kernel(xe, w_g, w_u, w_d, activation=activation,
                                   s_g=s_g, s_u=s_u, s_d=s_d, tiles=tiles)
    return streamed_moe_kernel(xe, quant.storage_cast(w_g, wdt),
                               quant.storage_cast(w_u, wdt),
                               quant.storage_cast(w_d, wdt),
                               activation=activation, tiles=tiles)


class StreamedMoE(torch.autograd.Function):
    """The kernel forward with a straight-through backward (the reference's
    ``_streamed_moe_diff``).  The forward quantizes or casts the detached
    operands and launches the kernel; the backward differentiates
    ``ref.streamed_moe_ref`` on the saved original operands, whatever the
    streamed format, so 8-bit weights get the gradient of their fp32
    values.  A gateless call (``w_g`` None) gets no ``w_g`` gradient."""

    @staticmethod
    def forward(ctx, xe, w_g, w_u, w_d, activation, wdt, tiles):
        ctx.activation = activation
        ctx.save_for_backward(xe, w_g, w_u, w_d)
        w_g = None if w_g is None else w_g.contiguous()
        return _streamed_moe_raw(xe.contiguous(), w_g, w_u.contiguous(),
                                 w_d.contiguous(), activation, wdt, tiles)

    @staticmethod
    def backward(ctx, g):
        saved = [None if t is None else t.detach().requires_grad_(True)
                 for t in ctx.saved_tensors]
        need = [t is not None and n
                for t, n in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = ref.streamed_moe_ref(*saved, ctx.activation)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(saved, need) if n], g))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def _streamed_format(weight_dtype=None):
    wdt = quant.check_weight_dtype(weight_dtype)
    return quant.weight_dtype() if wdt is None else wdt


_FORMATS = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def streamed_moe_autotuned(xe, w_g, w_u, w_d, activation: str):
    """``streamed_moe`` with the tile setting the ``core.autotune`` planner
    chooses for this call's (E, C, d, m) shape under the ambient autotune
    level: ``off`` (the kernel's default), ``analytic`` (the cost model's
    pick) or ``measured`` (timed on the card, cached on disk).  The
    streamed weight format (the ambient one, else the stored dtype) and
    the activations' dtype pick the kernel path the planner scores.  CPU
    tensors and ``use_kernels(False)`` take the plain versions, which have
    no tiles."""
    tiles = None
    if kernels_enabled() and xe.is_cuda:
        from repro_torch.core import autotune
        E, C, d = xe.shape
        m = w_u.shape[-1]
        wdt = _streamed_format() or _FORMATS[w_u.dtype]
        tiles = autotune.kernel_opts_for(
            E, C, d, m, activation, x_dtype=_FORMATS[xe.dtype],
            weight_dtype=wdt).get("tiles")
    return streamed_moe(xe, w_g, w_u, w_d, activation, tiles=tiles)


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
