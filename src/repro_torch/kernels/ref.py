"""Plain PyTorch versions of the CUDA kernels (port of
``repro.kernels.ref``).

* ``*_ref`` are the reference's oracles: :func:`streamed_moe_ref` /
  :func:`streamed_moe_quant_ref` (einsums in the operands' promoted
  dtype; the fp32 einsum over quantize->dequantize round-tripped
  weights), :func:`flash_attention_ref` (full softmax attention) and
  :func:`ssd_intra_chunk_ref` (the SSD intra-chunk einsums).
* ``*_plain`` repeat each CUDA kernel's arithmetic step for step: tiles
  of the kernel's width, fp32 accumulation, and the kernel's roundings.
  A kernel wrapper takes its plain version for CPU tensors, and
  ``chip_smoke.py`` holds each kernel against it on the card.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
FLASH_TILE = 64     # keys per tile of csrc/flash_attention.cu (query rows here)


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


def _qmm(eq, a, w, s):
    """``a @ w`` in fp32 for weights stored fp32/bf16, or int8/fp8 with
    their fp32 scale row ``s``: the stored values are multiplied and the
    scale applied to the sum, as the kernel's epilogue does."""
    out = torch.einsum(eq, a, w.float())
    return out if s is None else out * s


def streamed_moe_plain_h(xe, w_g, w_u, w_d, activation: str, *,
                         s_g=None, s_u=None):
    """The kernel's first phase: ``h = act(x w_g, x w_u)`` in fp32 (E,C,m),
    rounded to bf16 (and back) when ``w_d`` is stored in bf16."""
    x = xe.float()
    hu = _qmm("ecd,edm->ecm", x, w_u, s_u)
    hg = _qmm("ecd,edm->ecm", x, w_g, s_g) \
        if activation == "swiglu" and w_g is not None else None
    h = _act(activation, hu, hg)
    if w_d.dtype == torch.bfloat16:
        h = h.to(torch.bfloat16).float()
    return h


def streamed_moe_plain(xe, w_g, w_u, w_d, activation: str, *,
                       s_g=None, s_u=None, s_d=None):
    """The kernel's arithmetic in plain PyTorch.

    Weights are stored fp32/bf16, or int8/fp8 with their fp32 scale rows
    (applied to each GEMM's fp32 sum).  Both GEMMs accumulate in fp32;
    ``h`` is rounded to bf16 before the down GEMM when ``w_d`` is stored
    in bf16 (the Pallas body's ``h.astype(wd.dtype)``), and stays fp32
    otherwise."""
    h = streamed_moe_plain_h(xe, w_g, w_u, w_d, activation, s_g=s_g, s_u=s_u)
    return _qmm("ecm,emd->ecd", h, w_d, s_d)


def flash_attention_ref(q, k, v):
    """q, k, v: (B,S,H,hd), kv already head-broadcast -> (B,Sq,H,hd).
    Causal, right-aligned (key j is visible to query i iff j <= i+Sk-Sq)."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    Sq, Sk = q.shape[1], k.shape[1]
    mask = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@functools.lru_cache(maxsize=None)
def flash_scale_log2(hd: int) -> float:
    """The kernel's score scale ``hd^-1/2 * log2(e)``, as the fp32 product of
    the two fp32 constants: scores in log2 units, so ``p = 2^(s - m)``."""
    return (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
            * torch.tensor(math.log2(math.e), dtype=torch.float32)).item()


def _flash_dot(a, b):
    """``a @ b`` over the last two axes with fp32 output, as the flash kernel
    forms its two products.  bf16 operands on the card take a bf16 GEMM with
    fp32 output, which runs on the tensor cores as the kernel's mma.sync
    does, so the scores match the kernel's bit for bit; a reordered fp32
    score would flip roundings of ``p`` that move a small output by
    hundreds of its ulps.  On the CPU, which has no such GEMM, and for fp32
    operands (the kernel's split-TF32 products, or its fp32 FMAs at hd 16 /
    32, both within 1e-5 of it), the fp32 product."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def flash_attention_plain(q, k, v):
    """The flash kernel's arithmetic: per query tile, a loop over key tiles
    of FLASH_TILE keys up to the diagonal with fp32 running max ``m``, sum
    ``l`` and accumulator; scores ``(q k^T) * flash_scale_log2(hd)`` (log2
    units; the product by :func:`_flash_dot`), masked keys at -1e30,
    ``p = exp2(s - m)``; ``p`` rounded to v's dtype before the PV product
    (``l`` sums the unrounded ``p``); each tile's PV added to
    ``acc * corr``; output ``acc / max(l, 1e-30)`` in q's dtype.  Key tiles
    above a row's diagonal that the loop still visits (the tile holds later
    rows too) are an exact no-op for it: ``exp2(-1e30 - m) == 0``."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = flash_scale_log2(hd)
    qh = q.permute(0, 2, 1, 3)                                # (B,H,Sq,hd)
    kt = k.permute(0, 2, 3, 1)                                # (B,H,hd,Sk)
    vh = v.permute(0, 2, 1, 3)
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, FLASH_TILE):
        q1 = min(q0 + FLASH_TILE, Sq)
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + (Sk - Sq)
        m = torch.full((B, H, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, q1 - q0, hd), device=q.device)
        for k0 in range(0, q1 + Sk - Sq, FLASH_TILE):
            k1 = min(k0 + FLASH_TILE, Sk)
            s = _flash_dot(qh[:, :, q0:q1], kt[..., k0:k1]) * scale
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _flash_dot(p.to(v.dtype),
                                                     vh[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def segsum(x):
    """x: (..., T) -> (..., T, T); out[..., i, j] = sum_{k=j+1..i} x[k],
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def _head_groups(h: int, g: int, device):
    """The group each of h heads reads: head i -> i // (h // g)."""
    if g == 0 or h % g:
        raise ValueError(f"{g} groups of B and C do not divide {h} heads")
    return torch.arange(h, device=device) // (h // g)


def ssd_intra_chunk_ref(xc, Bc, Cc, Ac, A_cumsum):
    """Intra-chunk SSD terms.  xc: (b,nc,c,h,p); Bc/Cc: (b,nc,c,g,n) with g
    dividing h, broadcast to the heads; Ac/A_cumsum: (b,h,nc,c) -> Y_diag
    (b,nc,c,h,p), states (b,nc,h,p,n), both fp32."""
    grp = _head_groups(xc.shape[3], Bc.shape[3], xc.device)
    Bc, Cc = Bc[:, :, :, grp], Cc[:, :, :, grp]
    L = torch.exp(segsum(Ac))                                    # (b,h,nc,c,c)
    G = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", G * L, xc)
    decay_states = torch.exp(A_cumsum[:, :, :, -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    return Y_diag.float(), states.float()


def ssd_intra_chunk_plain(xc, Bc, Cc, A_cumsum):
    """The SSD kernel's arithmetic, fp32 throughout.  ``G = C B^T`` once per
    (batch, chunk, group); per head, ``Y_diag = (G * L) x`` with
    ``L[i, j] = exp(acum[i] - acum[j])`` for i >= j and 0 above, and the
    state ``((B * exp(acum[-1] - acum)[:, None])^T x)^T``, (p, n), with B
    and G of the head's group.  The decays ``Ac`` themselves are not read
    (nor by the Pallas kernel)."""
    c, h = xc.shape[2:4]
    grp = _head_groups(h, Bc.shape[3], xc.device)
    x = xc.float().permute(0, 1, 3, 2, 4)                      # (b,nc,h,c,p)
    Bm = Bc.float().permute(0, 1, 3, 2, 4)                     # (b,nc,g,c,n)
    Cm = Cc.float().permute(0, 1, 3, 2, 4)
    acum = A_cumsum.float().permute(0, 2, 1, 3)                # (b,nc,h,c)
    G = (Cm @ Bm.transpose(-1, -2))[:, :, grp]                 # (b,nc,h,c,c)
    diff = acum[..., :, None] - acum[..., None, :]
    keep = torch.ones((c, c), dtype=torch.bool, device=xc.device).tril()
    y = torch.where(keep, G * torch.exp(diff), torch.zeros_like(diff)) @ x
    decay = torch.exp(acum[..., -1:] - acum)                    # (b,nc,h,c)
    st = ((Bm[:, :, grp] * decay[..., None]).transpose(-1, -2) @ x) \
        .transpose(-1, -2)
    return y.permute(0, 1, 3, 2, 4).contiguous(), st.contiguous()
