"""Mamba-2 SSD intra-chunk terms: the CUDA kernel's wrapper.

Replaces ``repro/kernels/ssd.py::ssd_intra_chunk_kernel`` (Pallas, TPU),
with B and C taken per group, (b,nc,c,g,n) for g dividing h (g = h is the
reference's per-head layout).  The kernel (``csrc/ssd.cu``) is bound by
fp32 operations at mamba2-370m's shape: it computes C B^T once per group
into a scratch and then, per head, the output and the state in one block
with 8 x 8 fp32 FMA tiles; its note says why.  For a CUDA tensor the
wrapper launches the kernel or raises; for a CPU tensor it runs the plain
version (``kernels.ref.ssd_intra_chunk_plain``), which repeats the
kernel's arithmetic.  ``LAUNCHES`` counts kernel launches and nothing
else.  The kernel has no backward, as the Pallas kernel has no VJP.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import launch_on

LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128)      # the kernel's instantiations (P)
MAX_STATE = 128                    # largest d_state (n) its shared memory takes

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("ssd").ssd_intra_chunk_forward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(xc, Bc, Cc, Ac, A_cumsum):
    if xc.dim() != 5 or Bc.dim() != 5:
        raise ValueError("want xc (b,nc,c,h,p), Bc/Cc (b,nc,c,g,n), "
                         "Ac/A_cumsum (b,h,nc,c)")
    b, nc, c, h, p = xc.shape
    g, n = Bc.shape[-2:]
    if tuple(Bc.shape[:3]) != (b, nc, c) or tuple(Cc.shape) != tuple(Bc.shape):
        raise ValueError(f"shape mismatch: xc {tuple(xc.shape)}, Bc "
                         f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{g} groups of B and C do not divide {h} heads")
    for name, a in (("Ac", Ac), ("A_cumsum", A_cumsum)):
        if tuple(a.shape) != (b, h, nc, c):
            raise ValueError(f"{name} {tuple(a.shape)} != {(b, h, nc, c)}")
    if any(t.dtype != torch.float32 for t in (xc, Bc, Cc, A_cumsum)):
        raise TypeError("the SSD kernel takes fp32 operands")
    if any(t.device != xc.device for t in (Bc, Cc, Ac, A_cumsum)):
        raise ValueError("all operands must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xc, Bc, Cc, A_cumsum)):
        raise NotImplementedError("the SSD kernel has no backward; "
                                  "training is ROADMAP A.15")


def ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, A_cumsum):
    """xc: (b,nc,c,h,p); Bc/Cc: (b,nc,c,g,n) with g dividing h (head i
    reads group i // (h // g)); Ac/A_cumsum: (b,h,nc,c), all fp32.
    -> (Y_diag (b,nc,c,h,p), states (b,nc,h,p,n)) fp32.  ``Ac`` is checked
    and not read, as in the Pallas kernel."""
    global LAUNCHES
    _check(xc, Bc, Cc, Ac, A_cumsum)
    if xc.device.type == "cpu":
        return ref.ssd_intra_chunk_plain(xc, Bc, Cc, A_cumsum)
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not {xc.device}")
    if not all(t.is_contiguous() for t in (xc, Bc, Cc, A_cumsum)):
        raise ValueError("ssd_intra_chunk kernel needs contiguous operands")
    if xc.data_ptr() % 16:
        raise ValueError("ssd_intra_chunk kernel needs a 16-byte aligned xc")
    b, nc, c, h, p = xc.shape
    g, n = Bc.shape[-2:]
    if p not in HEAD_DIMS or n > MAX_STATE:
        raise ValueError(f"ssd_intra_chunk kernel takes head_dim in "
                         f"{HEAD_DIMS} and d_state <= {MAX_STATE}, got p={p}, "
                         f"n={n}")
    gt = torch.empty((b * nc * g, c, -(-c // 4) * 4), dtype=torch.float32,
                     device=xc.device)                  # C B^T per group
    y = torch.empty_like(xc)
    st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xc.device)
    rc = launch_on(xc.get_device(), _kernel_fn(), (
        xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), A_cumsum.data_ptr(),
        gt.data_ptr(), y.data_ptr(), st.data_ptr(), b, nc, c, h, g, p, n))
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return y, st
