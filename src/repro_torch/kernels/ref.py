"""Plain PyTorch versions of the ``streamed_moe`` kernel (port of
``repro.kernels.ref``).

* :func:`streamed_moe_ref` / :func:`streamed_moe_quant_ref` are the
  reference's oracles: einsums in the operands' (promoted) dtype, and the
  fp32 einsum over quantize->dequantize round-tripped weights.
* :func:`streamed_moe_plain` repeats the CUDA kernel's arithmetic step
  for step (fp32 accumulation, in-place dequantization, ``h`` cast to
  ``w_d``'s dtype before the down GEMM).  The kernel wrapper takes it for
  CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _act(kind: str, hu, hg=None):
    if kind == "swiglu":
        if hg is None:
            raise ValueError("activation='swiglu' requires w_g")
        return F.silu(hg) * hu
    if kind == "relu2":
        return torch.square(F.relu(hu))
    if kind == "gelu":                        # jax.nn.gelu's tanh form
        return F.gelu(hu, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def _mm(eq, a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def streamed_moe_ref(xe, w_g, w_u, w_d, activation: str):
    """xe: (E,C,d); w_g/w_u: (E,d,m); w_d: (E,m,d) -> (E,C,d) fp32."""
    hu = _mm("ecd,edm->ecm", xe, w_u)
    hg = _mm("ecd,edm->ecm", xe, w_g) if activation == "swiglu" \
        and w_g is not None else None
    h = _act(activation, hu, hg)
    return _mm("ecm,emd->ecd", h, w_d).float()


def streamed_moe_quant_ref(xe, w_g, w_u, w_d, activation: str,
                           weight_dtype: str):
    """The oracle over weights round-tripped through the streamed format."""
    from . import quant
    return streamed_moe_ref(xe.float(), quant.fake_quant(w_g, weight_dtype),
                            quant.fake_quant(w_u, weight_dtype),
                            quant.fake_quant(w_d, weight_dtype), activation)


def streamed_moe_plain(xe, w_g, w_u, w_d, activation: str, *,
                       s_g=None, s_u=None, s_d=None):
    """The kernel's arithmetic in plain PyTorch.

    Weights are stored fp32/bf16, or int8/fp8 with their fp32 scale rows
    (dequantized as ``w.float() * s``).  Both GEMMs accumulate in fp32;
    ``h`` is rounded to bf16 before the down GEMM when ``w_d`` is stored
    in bf16 (the Pallas body's ``h.astype(wd.dtype)``)."""
    def deq(w, s):
        return None if w is None else (w.float() if s is None
                                       else w.float() * s)
    x = xe.float()
    hu = torch.einsum("ecd,edm->ecm", x, deq(w_u, s_u))
    hg = torch.einsum("ecd,edm->ecm", x, deq(w_g, s_g)) \
        if activation == "swiglu" and w_g is not None else None
    h = _act(activation, hu, hg)
    if w_d.dtype == torch.bfloat16:
        h = h.to(torch.bfloat16).float()
    return torch.einsum("ecm,emd->ecd", h, deq(w_d, s_d))
