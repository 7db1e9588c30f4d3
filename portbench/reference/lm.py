"""Plain PyTorch reference of the two MoE language models the benchmark
runs, in float32 with TF32 off, written from the published equations
with the port's departures (``configs/*.json``, ``departures``):

    x = E[tokens]
    for each layer:
        h = RMSNorm(x) * g1                          (eps 1e-6, fp32 stats)
        x = x + Attn(h)                              (RoPE, half-split, GQA,
                                                      causal, 1/sqrt(hd))
        h = RMSNorm(x) * g2
        p = softmax(h W_r); top-k of p (ties to the lower expert),
            weights renormalised over the k
        x = x + sum_k w_k FFN_e_k(h) + FFN_shared(h)   (SwiGLU:
            (silu(h Wg) * (h Wu)) Wd)
    logits = (RMSNorm(x) * g) W_head

Every layer is MoE (DeepSeek-MoE-16B's first layer is dense as
published: a departure of the port), the shared experts are one SwiGLU
of n_shared x d_expert width, and granite's multipliers are left out
(a departure of the port).  With ``capacity_factor``, each expert takes
at most C = ceil(T k / E cf) rows, its tokens in token order, and a
token's choices beyond that are dropped (the Switch-style capacity the
scoring path runs); without, no token is dropped (serving's drop-free
capacity).  The load-balance term is E * sum_e f_e p_e over all k
choices, summed over layers.

The weights are the benchmark's own tensors (``weights.draw``), read by
the port's key names and upcast one layer at a time, so the float32
copy of a 31 GB bf16 model never has to fit at once.  Nothing here
imports the port.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


ROUTES = None       # a list to collect each layer's (T, k) choices in


def mm(a, b):
    """Every matrix product of the reference, in float32 (a control may
    put a lower precision's in its place)."""
    return a @ b


def _layer(weights: dict, layer: int, key: str):
    periods = weights["periods"]
    c, s = divmod(layer, len(periods))
    node = periods[s]
    for part in key.split("/"):
        node = node[part]
    return node[c].float()


def rmsnorm(x, g, eps=1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x, pos, theta):
    """x: (S, n, hd); pos: (S,).  Angles in float64, then float32."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (pos.double()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, conf, w, bounds):
    """Causal attention of each sequence ``[a, b)`` of ``h`` (T, d)."""
    H, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    theta = float(conf["rope_theta"])
    out = torch.empty((h.shape[0], H * hd), dtype=h.dtype, device=h.device)
    for a, b in bounds:
        x = h[a:b]
        S = b - a
        pos = torch.arange(S, device=h.device)
        q = rope(mm(x, w["wq"]).view(S, H, hd), pos, theta)
        k = rope(mm(x, w["wk"]).view(S, kv, hd), pos, theta)
        v = mm(x, w["wv"]).view(S, kv, hd)
        k = k.repeat_interleave(H // kv, dim=1)
        v = v.repeat_interleave(H // kv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        mask = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return mm(out, w["wo"])


def swiglu(h, wg, wu, wd):
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def moe(h, conf, layer, weights, capacity_factor):
    """-> (routed + shared output (T, d), the layer's load-balance term)."""
    E, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    T = h.shape[0]
    probs = torch.softmax(mm(h, _layer(weights, layer, "moe/router/w_router")),
                          dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    if ROUTES is not None:
        ROUTES.append(top_i)
    C = None if capacity_factor is None else \
        max(1, math.ceil(T * k / E * capacity_factor))
    wg = _layer(weights, layer, "moe/w_gate")
    wu = _layer(weights, layer, "moe/w_up")
    wd = _layer(weights, layer, "moe/w_down")
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)   # token order
        if C is not None:
            tok, slot = tok[:C], slot[:C]
        if tok.numel():
            y.index_add_(0, tok, top_w[tok, slot, None]
                         * swiglu(h[tok], wg[e], wu[e], wd[e]))
    del wg, wu, wd
    if conf.get("n_shared_experts", 0):
        y = y + swiglu(h, _layer(weights, layer, "moe/shared/w_gate"),
                       _layer(weights, layer, "moe/shared/w_up"),
                       _layer(weights, layer, "moe/shared/w_down"))
    f = torch.zeros((E,), dtype=torch.float32, device=h.device)
    f.index_add_(0, top_i.reshape(-1), torch.ones(top_i.numel(),
                                                  device=h.device))
    aux = E * torch.sum(f / f.sum() * probs.mean(0))
    return y, aux


def hidden(weights: dict, conf: dict, seqs: Sequence[Sequence[int]],
           capacity_factor: Optional[float] = None):
    """Final-normed hidden states (T, d) of the sequences laid end to end
    (token order: sequence by sequence), and the summed load-balance
    term."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = weights["embed"].device
        flat = torch.tensor([t for s in seqs for t in s], dtype=torch.int64,
                            device=dev)
        bounds, a = [], 0
        for s in seqs:
            bounds.append((a, a + len(s)))
            a += len(s)
        x = weights["embed"][flat].float()
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for layer in range(int(conf["num_hidden_layers"])):
            attn_w = {n: _layer(weights, layer, f"attn/{n}")
                      for n in ("wq", "wk", "wv", "wo")}
            h = rmsnorm(x, _layer(weights, layer, "norm1/scale"))
            x = x + attention(h, conf, attn_w, bounds)
            del attn_w
            h = rmsnorm(x, _layer(weights, layer, "norm2/scale"))
            y, a_l = moe(h, conf, layer, weights, capacity_factor)
            x = x + y
            aux = aux + a_l
        return rmsnorm(x, weights["final_norm"]["scale"].float()), aux
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def head(weights: dict) -> torch.Tensor:
    w = weights.get("lm_head")
    return (w if w is not None else weights["embed"].T).float()


def logits_at(weights: dict, hid: torch.Tensor, rows: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """(len(rows), V) float32 logits of the given rows of ``hid``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w = head(weights)
        return torch.cat([mm(hid[rows[i:i + block]], w)
                          for i in range(0, len(rows), block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def score_terms(weights: dict, conf: dict, tokens: torch.Tensor,
                labels: torch.Tensor, capacity_factor: float):
    """(mean cross-entropy of the scored labels (-1 not scored), summed
    load-balance term) over a (B, S) batch."""
    hid, aux = hidden(weights, conf, tokens.tolist(), capacity_factor)
    lab = labels.reshape(-1)
    keep = torch.nonzero(lab >= 0).reshape(-1)
    ce = []
    for i in range(0, len(keep), 1024):
        rows = keep[i:i + 1024]
        z = logits_at(weights, hid, rows)
        ce.append(torch.logsumexp(z, -1) - z.gather(1, lab[rows][:, None])[:, 0])
    return float(torch.cat(ce).mean()), float(aux)


def served_logits(weights: dict, conf: dict, prompts: List[List[int]],
                  served: List[List[int]]) -> List[torch.Tensor]:
    """For each request, the (len(served), V) logits at the positions that
    predict its served tokens, run once over the prompt and the served
    tokens (teacher forcing)."""
    seqs = [p + s[:-1] for p, s in zip(prompts, served)]
    hid, _ = hidden(weights, conf, seqs)
    out, a = [], 0
    for p, s in zip(prompts, served):
        rows = torch.arange(a + len(p) - 1, a + len(p) - 1 + len(s),
                            device=hid.device)
        out.append(logits_at(weights, hid, rows))
        a += len(p) + len(s) - 1
    return out


def gaps(z: torch.Tensor, tokens: List[int]) -> torch.Tensor:
    """How far each token's logit lies below the best of its row of
    ``z`` (0 where it is the best)."""
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=z.device)
    return z.max(-1).values - z.gather(1, tok[:, None])[:, 0]


def served_gaps(weights: dict, conf: dict, prompts: List[List[int]],
                served: List[List[int]]) -> List[torch.Tensor]:
    """For each request, the gap by which each served token's logit lies
    below the reference's best at its position (0 where they agree)."""
    return [gaps(z, s) for z, s in zip(served_logits(weights, conf, prompts,
                                                     served), served)]
