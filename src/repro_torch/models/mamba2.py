"""Mamba-2 (SSD, state-space duality) block: the full-sequence forward
(port of the full-sequence part of ``repro.models.mamba2``).

``ssd_chunked`` follows the Mamba-2 paper's minimal chunked listing, as
the reference does; with ``use_kernel`` the intra-chunk terms go
through ``kernels.ops.ssd_intra_chunk`` (the CUDA SSD kernel), without
it through the same einsums as the kernel's oracle
(``kernels.ref.ssd_intra_chunk_ref``), one chunk at a time from 16
chunks on so that only one (c, c) mask is live.  ``ssd_naive`` is the
exact sequential recurrence the tests hold it against.  The causal
convolution is the reference's K-term sum, not ``F.conv1d``, which cuDNN
would run in TF32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import segsum, ssd_intra_chunk_ref
from .layers import dense_init, normal


def mamba2_init(gen, d_model, ssm: SSMConfig, dtype, device, lead=()):
    di = ssm.expand * d_model
    nh = di // ssm.head_dim
    d_xBC = di + 2 * ssm.n_groups * ssm.d_state
    u = torch.rand((*lead, nh), generator=gen, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(ssm.dt_max) - math.log(ssm.dt_min))
                   + math.log(ssm.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))            # inverse softplus
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(gen, d_model, 2 * di + 2 * ssm.n_groups
                              * ssm.d_state + nh, dtype, device, lead=lead),
        "conv_w": normal(gen, (*lead, ssm.d_conv, d_xBC), scale=0.1,
                         dtype=dtype, device=device),
        "conv_b": torch.zeros((*lead, d_xBC), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d_model, dtype, device, lead=lead),
        "A_log": a_log.expand(*lead, nh).clone(),
        "D": torch.ones((*lead, nh), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
    }


def ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state=None, use_kernel=False):
    """Chunked SSD scan.

    x: (b, l, h, p); dt: (b, l, h) positive step sizes; A: (h,) negative
    decay rates; Bm, Cm: (b, l, g, n) broadcast over heads (the kernel
    takes them per group, as they are).
    Returns y (b, l, h, p) in x's dtype and the final state (b, h, p, n)."""
    b, l, h, p = x.shape
    g, n = Bm.shape[-2:]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of {chunk}")
    nc = l // chunk
    Ch = torch.repeat_interleave(Cm, h // g, dim=2)

    # operands stay in the model dtype; fp32 only inside the chunk math
    xd = x * dt[..., None].to(x.dtype)
    dA = (dt * A[None, None, :]).float()                       # (b,l,h)

    xc = xd.reshape(b, nc, chunk, h, p)
    Cc = Ch.reshape(b, nc, chunk, h, n)
    Ac = dA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)       # (b,h,nc,c)
    A_cumsum = torch.cumsum(Ac, dim=-1)

    if use_kernel:
        Y_diag, states = ops.ssd_intra_chunk(
            xc.float().contiguous(),
            Bm.reshape(b, nc, chunk, g, n).float().contiguous(),
            Cm.reshape(b, nc, chunk, g, n).float().contiguous(), Ac,
            A_cumsum.contiguous())
    else:
        Bc = torch.repeat_interleave(Bm, h // g, dim=2) \
            .reshape(b, nc, chunk, h, n)
        if nc >= 16:
            # long sequences: one chunk at a time, so only one (c, c) mask
            # is live (O(nc c^2) -> O(c^2) memory)
            ys, sts = [], []
            for i in range(nc):
                yi, si = ssd_intra_chunk_ref(
                    xc[:, i:i + 1].float(), Bc[:, i:i + 1].float(),
                    Cc[:, i:i + 1].float(), Ac[:, :, i:i + 1],
                    A_cumsum[:, :, i:i + 1])
                ys.append(yi)
                sts.append(si)
            Y_diag, states = torch.cat(ys, dim=1), torch.cat(sts, dim=1)
        else:
            Y_diag, states = ssd_intra_chunk_ref(xc.float(), Bc.float(),
                                                 Cc.float(), Ac, A_cumsum)

    # inter-chunk recurrence
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None], states], dim=1)  # (b,nc+1,h,p,n)
    chunk_decay = A_cumsum[:, :, :, -1]                          # (b,h,nc)
    decay_chunk = torch.exp(segsum(F.pad(chunk_decay, (1, 0))))  # (b,h,nc+1,nc+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    state_decay_out = torch.exp(A_cumsum)                        # (b,h,nc,c)
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc.float(), prev_states,
                         state_decay_out)
    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y.to(x.dtype), final_state


def ssd_naive(x, dt, A, Bm, Cm, initial_state=None):
    """Exact sequential recurrence: S_t = S exp(dt A) + dt x B^T."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    Bh = torch.repeat_interleave(Bm, h // Bm.shape[2], dim=2).float()
    Ch = torch.repeat_interleave(Cm, h // Cm.shape[2], dim=2).float()
    S = initial_state if initial_state is not None else \
        torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        xt, dtt = x[:, t].float(), dt[:, t]
        decay = torch.exp(dtt * A[None, :])[..., None, None]        # (b,h,1,1)
        S = S * decay + torch.einsum("bhp,bhn->bhpn", xt * dtt[..., None],
                                     Bh[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1).to(x.dtype), S


def _causal_conv(x, w, b):
    """Depthwise causal conv as the K-term sum. x: (B,L,D); w: (K,D)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + L, :] * w[i] for i in range(K)) + b


def mamba2_block(params, x, ssm: SSMConfig, d_model, use_kernel=False):
    """Full-sequence forward. x: (B,L,d) -> (B,L,d)."""
    B_, L, _ = x.shape
    di = ssm.expand * d_model
    nh = di // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state

    zxbcdt = x @ params["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])                 # (B,L,nh)
    A = -torch.exp(params["A_log"])                                 # (nh,)

    xh = xs.reshape(B_, L, nh, ssm.head_dim)
    Bm = Bm.reshape(B_, L, g, n)
    Cm = Cm.reshape(B_, L, g, n)
    chunk = min(ssm.chunk_size, L)
    if L % chunk:
        chunk = 1  # degenerate fallback for odd lengths, as the reference
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk, use_kernel=use_kernel)
    y = y + params["D"][None, None, :, None] * xh                   # skip
    y = (y.reshape(B_, L, di) * F.silu(z)).to(x.dtype)
    return y @ params["out_proj"]
