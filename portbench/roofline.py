"""Peaks of the card and the work that a cell's inputs need: operations
and bytes, from shapes and the program's counts.  Frozen here, with the
benchmark, so that a change to the program cannot move the bound it is
held to.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates, at its full
700 W power limit (the card's own limit is printed beside each run).
Every count is of what the inputs need: each weight read once per step
in which it is used, each activation read once and written once, the
operations of the rows that carry a token (not of padding or capacity
slots).  A count that leaves out work the card must do keeps the share
an honest lower bound; one that adds work the card need not do would let
a share pass 100%.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

PEAK_BF16_FLOPS = 989e12        # dense bf16 / fp16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
BF16 = 2
FP32 = 4


def bound_s(ops: float, moved: float) -> float:
    """Least time for ``ops`` bf16 operations moving ``moved`` bytes."""
    return max(ops / PEAK_BF16_FLOPS, moved / HBM_BYTES_PER_S)


class Shape:
    """The numbers of a configuration file that the counts need."""

    def __init__(self, conf: dict):
        self.L = int(conf["num_hidden_layers"])
        self.d = int(conf["hidden_size"])
        self.H = int(conf["num_attention_heads"])
        self.kv = int(conf["num_key_value_heads"])
        self.hd = int(conf["head_dim"])
        self.E = int(conf["n_routed_experts"])
        self.k = int(conf["num_experts_per_tok"])
        self.m = int(conf["moe_intermediate_size"])
        self.shared = int(conf.get("n_shared_experts", 0))
        self.V = int(conf["vocab_size"])

    # -- parameters -------------------------------------------------------
    def attn_params(self) -> int:
        return self.d * self.hd * (2 * self.H + 2 * self.kv)

    def expert_params(self) -> int:
        return 3 * self.d * self.m

    def layer_dense_params(self) -> int:
        """A layer's weights that every token uses: attention, router,
        shared experts (norms are a few KB and left out)."""
        return (self.attn_params() + self.d * self.E
                + self.shared * self.expert_params())

    def token_flops(self) -> float:
        """Operations of one token through the layers, experts included,
        attention scores excluded (see :meth:`attn_flops`)."""
        return 2.0 * self.L * (self.layer_dense_params()
                               + self.k * self.expert_params())

    def attn_flops(self, keys: int) -> float:
        """QK^T and PV of one query over ``keys`` keys, every layer."""
        return 4.0 * self.L * self.H * self.hd * keys

    def head_flops(self) -> float:
        return 2.0 * self.d * self.V

    def kv_bytes_per_token(self) -> int:
        return 2 * self.L * self.kv * self.hd * BF16


# -- streamed_moe ------------------------------------------------------------

def streamed_moe_call(d: int, m: int, counts: np.ndarray, capacity=None):
    """(operations, bytes) one ``streamed_moe`` call needs for ``counts``
    (E,) routed rows an expert: the weights (gate, up, down, bf16) of the
    experts that get a row, each routed row's bf16 input read once and
    fp32 output written once, and 2 x 3 x d x m operations a row.  With a
    ``capacity``, rows beyond it are dropped by the dispatch and not
    counted."""
    counts = np.asarray(counts, np.int64)
    if capacity is not None:
        counts = np.minimum(counts, int(capacity))
    rows = int(counts.sum())
    loaded = int((counts > 0).sum())
    moved = loaded * 3 * d * m * BF16 + rows * d * (BF16 + FP32)
    return 6.0 * d * m * rows, float(moved)


def streamed_moe_bound_s(d: int, m: int, counts_seq: Iterable[np.ndarray],
                         capacity=None) -> float:
    """Summed least time of a sequence of calls (one per counts vector)."""
    return sum(bound_s(*streamed_moe_call(d, m, c, capacity))
               for c in counts_seq)


# -- flash attention ---------------------------------------------------------

def flash_call(B: int, S: int, H: int, hd: int, elt: int = BF16):
    """(operations, bytes) of one causal flash call over (B, S, H, hd):
    both products over the (query, key) pairs the mask keeps; q, k, v
    read once and o written once."""
    pairs = S * (S + 1) // 2
    return 4.0 * hd * pairs * B * H, float(elt * B * H * hd * 4 * S)


# -- whole steps -------------------------------------------------------------

def decode_step(shape: Shape, decode_ctx: Iterable[int], prefill_tokens: int,
                loaded_experts: int, logits_rows: int):
    """(operations, bytes) one serving iteration needs.

    ``decode_ctx``: for each row that decodes a token, the keys it
    attends over; ``prefill_tokens``: prompt tokens the iteration caches
    (their attention scores are left out: a lower bound);
    ``loaded_experts``: over the layers, the experts that get a row from
    any token of the iteration; ``logits_rows``: rows whose logits the
    iteration needs (each token emitted).  Every weight a token uses is
    read once per iteration; the keys and values each decode row attends
    over are read once; the embedding rows and norms are left out."""
    ctx = list(decode_ctx)
    tokens = len(ctx) + int(prefill_tokens)
    ops = tokens * shape.token_flops() + sum(shape.attn_flops(c) for c in ctx) \
        + logits_rows * shape.head_flops()
    moved = (shape.L * shape.layer_dense_params()
             + int(loaded_experts) * shape.expert_params()
             + shape.d * shape.V) * BF16 \
        + sum(ctx) * shape.kv_bytes_per_token()
    return ops, float(moved)


def score_call_flops(shape: Shape, B: int, S: int) -> float:
    """Model operations of one scoring call over (B, S) tokens: every
    token through every layer with its top-k experts, causal attention
    scores, and the head."""
    pairs = S * (S + 1) // 2
    return (B * S * (shape.token_flops() + shape.head_flops())
            + 4.0 * shape.L * shape.H * shape.hd * pairs * B)
