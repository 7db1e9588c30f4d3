"""Mamba-2 (SSD, state-space duality) block (port of
``repro.models.mamba2``): the full-sequence forward and the serving
entry points.

``ssd_chunked`` follows the Mamba-2 paper's minimal chunked listing, as
the reference does; with ``use_kernel`` the intra-chunk terms go
through ``kernels.ops.ssd_intra_chunk`` (the CUDA SSD kernel), without
it through the same einsums as the kernel's oracle
(``kernels.ref.ssd_intra_chunk_ref``), one chunk at a time from 16
chunks on so that only one (c, c) mask is live.  ``ssd_naive`` is the
exact sequential recurrence the tests hold it against, and the one
``mamba2_chunk`` and the one-token decode step follow.  The causal
convolution is the reference's K-term sum, not ``F.conv1d``, which cuDNN
would run in TF32.

Serving keeps an :class:`SSMState` per slot: the rolling conv window in
the model dtype and the SSD state in fp32.  ``mamba2_prefill`` runs the
whole prompt (through the SSD kernel on a CUDA tensor), ``mamba2_chunk``
appends a prompt chunk with a per-row valid prefix, ``mamba2_decode``
advances one token.  The ``ssm_state_*`` helpers act on the engine's
period-stacked state, (n_periods, B, ...): snapshots are clones, and
restore and zero write in place, so the fused segments' graphs keep
their addresses.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import segsum, ssd_intra_chunk_ref
from .layers import checkpointed, dense_init, normal


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_xBC)   rolling conv window
    ssd: torch.Tensor     # (B, H, P, N)           recurrent state, fp32


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


def _intra_chunk(xc, Bc, Cc, Ac, A_cumsum):
    """One chunk's intra-chunk terms, the operands widened to fp32 here so
    that a checkpoint saves them in the model dtype."""
    return ssd_intra_chunk_ref(xc.float(), Bc.float(), Cc.float(), Ac,
                               A_cumsum)


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
            # is live (O(nc c^2) -> O(c^2) memory), recomputed in the
            # backward instead of saving every chunk's (c, c, h) scores
            ys, sts = [], []
            for i in range(nc):
                yi, si = checkpointed(
                    _intra_chunk, xc[:, i:i + 1], Bc[:, i:i + 1],
                    Cc[:, i:i + 1], Ac[:, :, i:i + 1],
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
    return mamba2_prefill(params, x, ssm, d_model, use_kernel=use_kernel)[0]


def ssd_decode_step(state, xt, dtt, A, Bt, Ct):
    """One-token recurrence. state: (b,h,p,n); xt: (b,h,p); dtt: (b,h);
    Bt, Ct: (b,h,n) -> (state, y (b,h,p) in xt's dtype)."""
    decay = torch.exp(dtt * A[None, :])[..., None, None]
    state = state * decay + torch.einsum("bhp,bhn->bhpn",
                                         xt.float() * dtt[..., None],
                                         Bt.float())
    y = torch.einsum("bhn,bhpn->bhp", Ct.float(), state)
    return state, y.to(xt.dtype)


def _in_proj(params, x, ssm: SSMConfig, d_model):
    """(z, xBC, dt) of the input projection; dt not yet activated."""
    di = ssm.expand * d_model
    gn = ssm.n_groups * ssm.d_state
    nh = di // ssm.head_dim
    return torch.split(x @ params["in_proj"], [di, di + 2 * gn, nh], dim=-1)


def _split_xbc(xBC, ssm: SSMConfig, d_model):
    di = ssm.expand * d_model
    gn = ssm.n_groups * ssm.d_state
    return torch.split(xBC, [di, gn, gn], dim=-1)


def _gate_out(params, y, xh, z, x_dtype):
    """Skip term, z gate and output projection: (B, L, h, p) -> (B, L, d)."""
    y = y + params["D"][None, None, :, None] * xh
    y = (y.reshape(*z.shape) * F.silu(z)).to(x_dtype)
    return y @ params["out_proj"]


def mamba2_prefill(params, x, ssm: SSMConfig, d_model, use_kernel=False):
    """Full forward also returning the final SSMState for decode.
    ``use_kernel`` sends the intra-chunk terms through the SSD kernel (the
    serving prefill sets it for CUDA tensors)."""
    B_, L, _ = x.shape
    nh = ssm.expand * d_model // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    z, xBC_raw, dt = _in_proj(params, x, ssm, d_model)
    xBC = F.silu(_causal_conv(xBC_raw, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = _split_xbc(xBC, ssm, d_model)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B_, L, nh, ssm.head_dim)
    chunk = min(ssm.chunk_size, L)
    if L % chunk:
        chunk = 1  # degenerate fallback for odd lengths, as the reference
    y, final = ssd_chunked(xh, dt, A, Bm.reshape(B_, L, g, n),
                           Cm.reshape(B_, L, g, n), chunk,
                           use_kernel=use_kernel)
    K = params["conv_w"].shape[0]
    conv_state = xBC_raw[:, -(K - 1):, :] if L >= K - 1 else F.pad(
        xBC_raw, (0, 0, K - 1 - L, 0))
    return _gate_out(params, y, xh, z, x.dtype), SSMState(conv_state, final)


def mamba2_chunk(params, x, state: SSMState, ssm: SSMConfig, d_model,
                 token_mask=None):
    """Chunked-prefill step: advance the SSM by a K-token chunk.

    x: (B,K,d); ``state`` carries the rolling conv window and the SSD
    state of the earlier chunks (``init_ssm_state`` zeros for the first).
    ``token_mask`` (B,K) marks each row's valid chunk prefix: masked steps
    have their dt zeroed (decay exp(0) = 1, input 0), so the state passes
    through them untouched, and the new conv window is gathered from the
    last valid inputs; an all-False row is a bit-exact no-op.  Uses the
    exact sequential recurrence (``ssd_naive``).

    Returns (y (B,K,d), new SSMState)."""
    B_, L, _ = x.shape
    nh = ssm.expand * d_model // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    z, xBC_raw, dt = _in_proj(params, x, ssm, d_model)
    Kc = params["conv_w"].shape[0]
    # the causal conv over [carried window | chunk]: _causal_conv's window
    # sum, seeded with the previous chunk's tail instead of zeros
    cat = torch.cat([state.conv.to(xBC_raw.dtype), xBC_raw], dim=1)
    xBC = sum(cat[:, i:i + L, :] * params["conv_w"][i] for i in range(Kc)) \
        + params["conv_b"]
    xs, Bm, Cm = _split_xbc(F.silu(xBC), ssm, d_model)
    dt = F.softplus(dt.float() + params["dt_bias"])
    if token_mask is not None:
        dt = dt * token_mask[..., None].to(dt.dtype)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B_, L, nh, ssm.head_dim)
    y, final = ssd_naive(xh, dt, A, Bm.reshape(B_, L, g, n),
                         Cm.reshape(B_, L, g, n), initial_state=state.ssd)
    # the new window: the Kc-1 raw inputs ending at each row's last valid
    # position, which start at offset v (valid count) into [carried | chunk]
    if token_mask is None:
        v = torch.full((B_,), L, dtype=torch.int64, device=x.device)
    else:
        v = token_mask.sum(1).to(torch.int64)
    widx = v[:, None] + torch.arange(Kc - 1, device=x.device)[None, :]
    conv_state = torch.gather(
        cat, 1, widx[..., None].expand(-1, -1, cat.shape[-1])) \
        .to(state.conv.dtype)
    return _gate_out(params, y, xh, z, x.dtype), SSMState(conv_state, final)


def mamba2_decode(params, x, state: SSMState, ssm: SSMConfig, d_model):
    """One-token decode. x: (B,1,d) -> (B,1,d), new state."""
    B_ = x.shape[0]
    nh = ssm.expand * d_model // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    z, xBC_raw, dt = _in_proj(params, x[:, 0], ssm, d_model)
    window = torch.cat([state.conv, xBC_raw[:, None]], dim=1)       # (B,K,D)
    xBC = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"])
                 + params["conv_b"])
    xs, Bm, Cm = _split_xbc(xBC, ssm, d_model)
    dt = F.softplus(dt.float() + params["dt_bias"])                 # (B,nh)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B_, nh, ssm.head_dim)
    Bm = torch.repeat_interleave(Bm.reshape(B_, g, n), nh // g, dim=1)
    Cm = torch.repeat_interleave(Cm.reshape(B_, g, n), nh // g, dim=1)
    new_ssd, y = ssd_decode_step(state.ssd, xh, dt, A, Bm, Cm)
    y = _gate_out(params, y[:, None], xh[:, None], z[:, None], x.dtype)
    return y, SSMState(window[:, 1:], new_ssd)


def ssm_state_slice(state: SSMState, row) -> SSMState:
    """Value snapshot of one batch row of a period-stacked state
    ((n_periods, B, ...) -> (n_periods, ...)): copies, no arithmetic, so
    snapshot -> restore is bit-identical."""
    return SSMState(state.conv[:, row].clone(), state.ssd[:, row].clone())


def ssm_state_restore(state: SSMState, snap: SSMState, row) -> SSMState:
    """Write a :func:`ssm_state_slice` snapshot back into batch ``row``, in
    place."""
    state.conv[:, row].copy_(snap.conv)
    state.ssd[:, row].copy_(snap.ssd)
    return state


def ssm_state_zero_row(state: SSMState, row) -> SSMState:
    """Reset one batch row to the initial (zero) state, in place: a
    recycled engine slot must not inherit its last occupant's state."""
    state.conv[:, row].zero_()
    state.ssd[:, row].zero_()
    return state


def init_ssm_state(batch, d_model, ssm: SSMConfig, dtype, device,
                   lead=()) -> SSMState:
    """Zero state: the conv window in ``dtype``, the SSD state in fp32;
    ``lead`` prepends dimensions (the engine's period stack)."""
    di = ssm.expand * d_model
    nh = di // ssm.head_dim
    d_xBC = di + 2 * ssm.n_groups * ssm.d_state
    return SSMState(
        conv=torch.zeros((*lead, batch, ssm.d_conv - 1, d_xBC), dtype=dtype,
                         device=device),
        ssd=torch.zeros((*lead, batch, nh, ssm.head_dim, ssm.d_state),
                        dtype=torch.float32, device=device))
