"""Deterministic, resumable synthetic token pipeline (the port's copy of
``repro.data.pipeline``; numpy, so its batches are the reference's bit
for bit).

Batches are a pure function of (seed, step): a restart at step k replays
the same stream with no state files.  The synthetic language is a
first-order Markov chain whose successors follow a Zipf law, so a small
LM's loss falls visibly (a learnable bigram structure).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8        # Markov out-degree (lower = more learnable)


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branching
        # each token has B possible successors, drawn with Zipf weights
        self._succ = rng.integers(0, V, size=(V, B))
        p = 1.0 / np.arange(1, B + 1)
        self._succ_p = p / p.sum()

    def batch(self, step: int) -> dict:
        """{'tokens': (B,S) int32, 'labels': (B,S) int32} for this step."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 0xD47A))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        for t in range(S):
            choice = rng.choice(cfg.branching, size=B, p=self._succ_p)
            toks[:, t + 1] = self._succ[toks[:, t], choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_for(cfg: DataConfig, step: int) -> dict:
    return SyntheticLM(cfg).batch(step)
