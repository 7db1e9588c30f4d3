"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``): each gradient is quantized per tensor,
symmetric, after adding the residual the last step's quantization left;
the new residual is what this step's loses."""
from __future__ import annotations

import torch

from repro_torch import tree


def quantize(g, *, bits: int = 8):
    """g -> (q int8, scale). Symmetric per-tensor scaling."""
    lim = 2.0 ** (bits - 1) - 1
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / lim
    q = torch.clamp(torch.round(gf / scale), -lim, lim).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_tree(grads, residual=None, *, bits: int = 8):
    """-> (decompressed grads in their dtypes, new fp32 residual):
    q = Q(g + r);  r' = (g + r) - deQ(q)."""
    if residual is None:
        residual = tree.map(lambda g: torch.zeros(g.shape, device=g.device),
                            grads)

    def one(g, r):
        corrected = g.float() + r
        deq = dequantize(*quantize(corrected, bits=bits))
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, r) for g, r in zip(tree.leaves(grads),
                                       tree.leaves(residual))]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(grads, [p[1] for p in pairs]))


def compressed_bytes_ratio(bits: int = 8, dtype_bits: int = 32) -> float:
    return bits / dtype_bits
