"""Causal flash attention: the CUDA kernel's wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_kernel``
(Pallas, TPU).  The kernel (``csrc/flash_attention.cu``) is bound by
operations at the scoring path's shape; its note says what the design
does about that: bf16 and fp32 at hd 64 / 128 / 192 run on wgmma fed by
TMA (fp32 in split TF32, K's and V^T's planes written by a first kernel
into a scratch this wrapper allocates; at hd 192 bf16's P V runs 64 of
hd's columns at a time and fp32's K and V^T have rings of their own), hd
16 / 32 on the earlier bodies.  For
a CUDA tensor the wrapper launches the kernel or raises; for a CPU tensor
it runs the plain version (``kernels.ref.flash_attention_plain``), which
repeats the kernel's arithmetic.  ``LAUNCHES`` counts kernel launches and
nothing else.  The kernel has no backward, as the Pallas kernel has no VJP.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import launch_on

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192)      # the kernel's instantiations

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("flash_attention").flash_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("want q (B,Sq,H,hd), k and v (B,Sk,H,hd)")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Sq == 0 or Sk < Sq:
        raise ValueError(f"causal flash attention needs Sk >= Sq >= 1, got "
                         f"Sq={Sq}, Sk={Sk}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernel has no backward: the reference defines no "
            "VJP for it and trains without it")


def scratch_floats(B: int, H: int, Sk: int, hd: int) -> int:
    """The fp32 body's scratch (hd 64 / 128 / 192): K's lo TF32 plane (B,
    Sk, H, hd; K is its own hi plane), then V^T's hi and lo planes (2, B*H,
    hd, Sk rounded up to 32)."""
    return B * Sk * H * hd + 2 * B * H * hd * (-(-Sk // 32) * 32)


def flash_attention_kernel(q, k, v):
    """q: (B,Sq,H,hd); k, v: (B,Sk,H,hd) with the KV heads broadcast to H,
    Sk >= Sq; fp32 or bf16.  Causal, right-aligned.  -> (B,Sq,H,hd) in
    q's dtype."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous operands")
    B, Sq, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    tma = q.dtype == torch.bfloat16 or hd >= 64
    if tma and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the {q.dtype} flash kernel at hd={hd} needs "
                         f"16-byte aligned q, k, v")
    out = torch.empty_like(q)
    scratch = None
    if q.dtype == torch.float32 and hd >= 64:
        scratch = torch.empty(scratch_floats(B, H, k.shape[1], hd),
                              dtype=torch.float32, device=q.device)
    rc = launch_on(q.get_device(), _kernel_fn(), (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, H, Sq,
        k.shape[1], hd, DTYPES[q.dtype], ref.flash_scale_log2(hd)))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out
