"""Grouped expert FFN over one d_expert slice: the CUDA kernel's wrapper.

Replaces ``repro/kernels/streamed_moe.py::streamed_moe_kernel`` (Pallas,
TPU).  The kernel (``csrc/streamed_moe.cu``) is bound by the weight
stream at serving shapes; its note says how the design spreads that
stream over the card.  bf16 activations with bf16 weights run on the
tensor cores (d and m multiples of 8), and so do int8 / fp8 weights with
either activation dtype (d and m multiples of 16; fp32 operands split
into three bf16 parts, so the products keep fp32 accuracy); fp32 weights,
or bf16 weights with fp32 activations, on CUDA cores.  For a CUDA tensor
the wrapper launches the kernel or raises; for
a CPU tensor it runs the plain version (``kernels.ref.streamed_moe_plain``),
which repeats the kernel's arithmetic.  ``LAUNCHES`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import launch_on

LAUNCHES = 0

ACTIVATIONS = {"swiglu": 0, "relu2": 1, "gelu": 2}
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("streamed_moe").streamed_moe_forward
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d):
    """Validate the operands -> (gated, quantized, tensors besides xe).
    Called on every launch, so it compares shapes and devices directly."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    gated = activation == "swiglu"
    if gated and w_g is None:
        raise ValueError("activation='swiglu' requires w_g")
    if xe.ndim != 3 or w_u.ndim != 3 or w_d.ndim != 3:
        raise ValueError("want xe (E,C,d), w_u (E,d,m), w_d (E,m,d)")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    if w_u.shape != (E, d, m) or w_d.shape != (E, m, d):
        raise ValueError(f"shape mismatch: xe {tuple(xe.shape)}, w_u "
                         f"{tuple(w_u.shape)}, w_d {tuple(w_d.shape)}")
    if gated and w_g.shape != w_u.shape:
        raise ValueError(f"w_g {tuple(w_g.shape)} != w_u {tuple(w_u.shape)}")
    if xe.dtype not in X_DTYPES:
        raise TypeError(f"xe dtype {xe.dtype} not in {list(X_DTYPES)}")
    ws = (w_g, w_u, w_d) if gated else (w_u, w_d)
    wdt = w_u.dtype
    if wdt not in W_DTYPES or any(w.dtype != wdt for w in ws):
        raise TypeError(f"weights must share one dtype of {list(W_DTYPES)}, "
                        f"got {[w.dtype for w in ws]}")
    quantized = wdt in QUANT_DTYPES
    tensors = ws
    if quantized:
        scales = ((s_g, (E, 1, m)),) if gated else ()
        scales += ((s_u, (E, 1, m)), (s_d, (E, 1, d)))
        for s, shape in scales:
            if s is None or s.shape != shape or s.dtype != torch.float32:
                raise ValueError(f"quantized {wdt} weights need fp32 "
                                 f"scales {shape}")
        tensors = ws + tuple(s for s, _ in scales)
    elif s_g is not None or s_u is not None or s_d is not None:
        raise ValueError(f"scales given for unquantized {wdt} weights")
    dev = xe.device
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must lie on one device")
    return gated, quantized, tensors


def streamed_moe_kernel(xe, w_g, w_u, w_d, *, activation: str,
                        s_g=None, s_u=None, s_d=None):
    """xe: (E,C,d) fp32|bf16; w_g (swiglu only) / w_u: (E,d,m); w_d:
    (E,m,d), all fp32, bf16, int8 or float8_e4m3fn.  Quantized weights
    take fp32 scales s_g/s_u (E,1,m) and s_d (E,1,d).  Returns (E,C,d)
    fp32."""
    checked = _check(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d)
    if xe.device.type == "cpu":
        gated = checked[0]
        return ref.streamed_moe_plain(
            xe, w_g if gated else None, w_u, w_d, activation,
            s_g=s_g if gated else None, s_u=s_u, s_d=s_d)
    return _launch(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d, checked)[1]


def _launch(xe, w_g, w_u, w_d, activation, s_g=None, s_u=None, s_d=None,
            checked=None):
    """Launch the kernel on CUDA tensors -> (h, out): its scratch beside
    the output, so a check can hold h itself.  The scratch is h (E,C,m) in
    bf16 for bf16 x bf16, in fp32 for fp32 weights or fp32 x x bf16
    weights; for int8 / fp8 weights it is flat, h's three bf16 planes
    ``hi + mid + lo`` (3,E,C,m) and then, for fp32 x, x's."""
    global LAUNCHES
    gated, quantized, tensors = checked or _check(
        xe, w_g, w_u, w_d, activation, s_g, s_u, s_d)
    if not xe.is_cuda:
        raise ValueError(f"the streamed_moe kernel runs on cuda, not "
                         f"{xe.device}")
    if not xe.is_contiguous() or not all(t.is_contiguous() for t in tensors):
        raise ValueError("streamed_moe kernel needs contiguous operands")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    tensor_cores = xe.dtype == torch.bfloat16 and w_u.dtype == torch.bfloat16
    if tensor_cores and (d % 8 or m % 8 or xe.data_ptr() % 16 or any(
            t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"the bf16 tensor-core path takes d and m multiples"
                         f" of 8 and 16-byte aligned operands, got d={d}, "
                         f"m={m}")
    if quantized and (d % 16 or m % 16 or xe.data_ptr() % 16 or any(
            t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"the 8-bit weight path takes d and m multiples of "
                         f"16 and 16-byte aligned operands, got d={d}, m={m}")
    if quantized:    # h as three bf16 planes, then fp32 x's three planes
        h = torch.empty((3 * E * C * (m + (d if xe.dtype == torch.float32
                                            else 0)),),
                        device=xe.device, dtype=torch.bfloat16)
    else:
        h = torch.empty((E, C, m), device=xe.device, dtype=torch.bfloat16
                        if tensor_cores else torch.float32)
    out = torch.empty((E, C, d), dtype=torch.float32, device=xe.device)
    q = quantized
    args = (xe.data_ptr(), w_g.data_ptr() if gated else None, w_u.data_ptr(),
            w_d.data_ptr(), s_g.data_ptr() if gated and q else None,
            s_u.data_ptr() if q else None, s_d.data_ptr() if q else None,
            h.data_ptr(), out.data_ptr(), E, C, d, m, X_DTYPES[xe.dtype],
            W_DTYPES[w_u.dtype], ACTIVATIONS[activation])
    rc = launch_on(xe.get_device(), _kernel_fn(), args)
    if rc != 0:
        raise RuntimeError(f"streamed_moe kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return h, out
