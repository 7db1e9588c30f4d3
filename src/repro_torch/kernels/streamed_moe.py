"""Grouped expert FFN over one d_expert slice: the CUDA kernel's wrapper.

Replaces ``repro/kernels/streamed_moe.py::streamed_moe_kernel`` (Pallas,
TPU).  The kernel (``csrc/streamed_moe.cu``) is bound by the weight
stream at serving shapes; its note says how the design spreads that
stream over the card.  For a CUDA tensor the wrapper launches the kernel
or raises; for a CPU tensor it runs the plain version
(``kernels.ref.streamed_moe_plain``), which repeats the kernel's
arithmetic.  ``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

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
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    gated = activation == "swiglu"
    if gated and w_g is None:
        raise ValueError("activation='swiglu' requires w_g")
    if xe.dim() != 3 or w_u.dim() != 3 or w_d.dim() != 3:
        raise ValueError("want xe (E,C,d), w_u (E,d,m), w_d (E,m,d)")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    if tuple(w_u.shape) != (E, d, m) or tuple(w_d.shape) != (E, m, d):
        raise ValueError(f"shape mismatch: xe {tuple(xe.shape)}, w_u "
                         f"{tuple(w_u.shape)}, w_d {tuple(w_d.shape)}")
    if gated and tuple(w_g.shape) != (E, d, m):
        raise ValueError(f"w_g {tuple(w_g.shape)} != w_u {tuple(w_u.shape)}")
    if xe.dtype not in X_DTYPES:
        raise TypeError(f"xe dtype {xe.dtype} not in {list(X_DTYPES)}")
    ws = [w for w in (w_g if gated else None, w_u, w_d) if w is not None]
    if any(w.dtype != w_u.dtype for w in ws) or w_u.dtype not in W_DTYPES:
        raise TypeError(f"weights must share one dtype of {list(W_DTYPES)}, "
                        f"got {[w.dtype for w in ws]}")
    quantized = w_u.dtype in QUANT_DTYPES
    scales = ([(s_g, (E, 1, m))] if gated else []) \
        + [(s_u, (E, 1, m)), (s_d, (E, 1, d))]
    if quantized:
        for s, shape in scales:
            if s is None or tuple(s.shape) != shape or s.dtype != torch.float32:
                raise ValueError(f"quantized {w_u.dtype} weights need fp32 "
                                 f"scales {shape}")
    elif any(s is not None for s in (s_g, s_u, s_d)):
        raise ValueError(f"scales given for unquantized {w_u.dtype} weights")
    tensors = ws + ([s for s, _ in scales] if quantized else [])
    if any(t.device != xe.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    return gated, quantized, tensors


def streamed_moe_kernel(xe, w_g, w_u, w_d, *, activation: str,
                        s_g=None, s_u=None, s_d=None):
    """xe: (E,C,d) fp32|bf16; w_g (swiglu only) / w_u: (E,d,m); w_d:
    (E,m,d), all fp32, bf16, int8 or float8_e4m3fn.  Quantized weights
    take fp32 scales s_g/s_u (E,1,m) and s_d (E,1,d).  Returns (E,C,d)
    fp32."""
    global LAUNCHES
    gated, quantized, tensors = _check(xe, w_g, w_u, w_d, activation,
                                       s_g, s_u, s_d)
    if xe.device.type == "cpu":
        return ref.streamed_moe_plain(
            xe, w_g if gated else None, w_u, w_d, activation,
            s_g=s_g if gated else None, s_u=s_u, s_d=s_d)
    if xe.device.type != "cuda":
        raise ValueError(f"streamed_moe runs on cuda or cpu, not {xe.device}")
    if not all(t.is_contiguous() for t in [xe] + tensors):
        raise ValueError("streamed_moe kernel needs contiguous operands")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    h = torch.empty((E, C, m), dtype=torch.float32, device=xe.device)
    out = torch.empty((E, C, d), dtype=torch.float32, device=xe.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        rc = _kernel_fn()(
            ptr(xe), ptr(w_g) if gated else None, ptr(w_u), ptr(w_d),
            ptr(s_g) if gated and quantized else None,
            ptr(s_u) if quantized else None, ptr(s_d) if quantized else None,
            ptr(h), ptr(out), E, C, d, m, X_DTYPES[xe.dtype],
            W_DTYPES[w_u.dtype], ACTIVATIONS[activation], stream)
    if rc != 0:
        raise RuntimeError(f"streamed_moe kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out
