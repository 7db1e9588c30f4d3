"""Dense FFN blocks: SwiGLU, squared-ReLU, GELU (port of
``repro.models.mlp``)."""
from __future__ import annotations

import torch.nn.functional as F

from .layers import activation_fn, dense_init


def ffn_init(gen, d_model, d_ff, activation, dtype, device, lead=()):
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead=lead)}
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device, lead=lead)
    return p


def ffn(params, x, activation):
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = activation_fn(activation)(x @ params["w_up"])
    return h @ params["w_down"]
