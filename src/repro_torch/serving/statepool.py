"""Paged KV state pool: page bookkeeping (port of the page-table part of
``repro.serving.statepool``).

Attention KV lives in fixed-size physical pages shared by every serving
slot; one host page table (max_batch, NP) maps each slot's logical pages
to physical ones for every layer (allocation advances in lockstep across
layers).  The pool is host-only bookkeeping; the engine owns the device
tensors and applies :func:`merge_prefill` to them.  Prefix caching and
preemption are later work (ROADMAP A.10).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import KVCache


class PoolExhausted(RuntimeError):
    """No free pages left."""


class StatePool:
    """Free list, refcounts, per-slot page lists and the page table."""

    def __init__(self, *, max_batch: int, max_ctx: int, page_size: int,
                 num_pages: Optional[int] = None, bytes_per_page: int = 0):
        assert page_size >= 1 and max_ctx >= 1
        self.page_size = page_size
        self.pages_per_slot = -(-max_ctx // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 2 * max_batch * self.pages_per_slot)
        if self.num_pages < max_batch * self.pages_per_slot:
            raise ValueError(
                f"state pool too small: {self.num_pages} pages < "
                f"{max_batch} slots x {self.pages_per_slot} pages/slot")
        self.bytes_per_page = bytes_per_page
        self.table = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.free: Deque[int] = deque(range(self.num_pages))
        self.ref = np.zeros((self.num_pages,), np.int64)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.stats: Dict[str, int] = {
            "pool_pages": self.num_pages,
            "pool_pages_in_use": 0, "pool_peak_pages": 0,
            "resident_state_bytes": 0, "peak_resident_state_bytes": 0,
        }

    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    def _account(self) -> None:
        used = self.pages_in_use()
        self.stats["pool_pages_in_use"] = used
        self.stats["pool_peak_pages"] = max(self.stats["pool_peak_pages"], used)
        resident = used * self.bytes_per_page
        self.stats["resident_state_bytes"] = resident
        self.stats["peak_resident_state_bytes"] = max(
            self.stats["peak_resident_state_bytes"], resident)

    def _alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise PoolExhausted(f"state pool exhausted: need {n} pages, "
                                f"{len(self.free)} free of {self.num_pages}")
        ids = [self.free.popleft() for _ in range(n)]
        for pid in ids:
            self.ref[pid] = 1
        self._account()
        return ids

    def _deref(self, pid: int) -> None:
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, f"page {pid} refcount underflow"
        if self.ref[pid] == 0:
            self.free.append(pid)

    def ensure(self, slot: int, length: int) -> None:
        """Grow ``slot``'s page run to cover ``length`` tokens (called
        before each iteration, so every KV write has a page)."""
        need = -(-length // self.page_size)
        have = len(self.slot_pages[slot])
        if need <= have:
            return
        ids = self._alloc(need - have)
        self.table[slot, have:need] = ids
        self.slot_pages[slot].extend(ids)

    def release_slot(self, slot: int) -> None:
        for pid in self.slot_pages[slot]:
            self._deref(pid)
        self.slot_pages[slot] = []
        self._account()


def merge_prefill(caches, dense_caches, page_ids: List[int], page_size: int):
    """Scatter a one-shot (batch=1) prefill into the slot's pages, in
    place.  ``dense_caches`` KV: (n_periods, 1, max_ctx, n_kv, hd)."""
    ids = torch.as_tensor(page_ids, dtype=torch.int64)
    n = len(page_ids)
    for c, dc in zip(caches, dense_caches):
        for pages, dense in zip(c.kv, dc.kv):
            arr = dense[:, 0]                              # (n_periods, S, ...)
            need = n * page_size
            if need > arr.shape[1]:
                arr = torch.nn.functional.pad(
                    arr, (0, 0) * (arr.dim() - 2) + (0, need - arr.shape[1]))
            chunk = arr[:, :need].reshape(arr.shape[0], n, page_size,
                                          *arr.shape[2:])
            pages[:, ids.to(pages.device)] = chunk.to(pages.dtype)
    return caches


def state_bytes(caches) -> Tuple[int, int]:
    """(bytes per physical page across all attention layers, SSM bytes
    per slot row — always 0 here)."""
    page_b = 0
    for c in caches:
        if isinstance(c.kv, KVCache):
            for a in c.kv:
                # (n_periods, P, page_size, n_kv, hd): per page = all but P
                page_b += int(a.shape[0] * np.prod(a.shape[2:])) \
                    * a.element_size()
    return page_b, 0
