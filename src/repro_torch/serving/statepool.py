"""Paged KV / SSM state pool: page table, prefix cache, preemption (port
of ``repro.serving.statepool``).

Attention KV lives in fixed-size physical pages shared by every serving
slot; one host page table (max_batch, NP) maps each slot's logical pages
to physical ones for every layer (allocation advances in lockstep across
layers).  Mamba-2 conv / SSD state is O(1) per slot, so it stays dense
per row, and the pool holds it by value: snapshots are copies
(:func:`snapshot_ssm`), so snapshot -> restore is bit-exact.  The pool is
host-only bookkeeping; the engine owns the device tensors and applies
:func:`merge_prefill`, :func:`copy_page`, :func:`restore_ssm` and
:func:`zero_ssm` to them, in place (the last three, like
:func:`snapshot_ssm`, outside any open ``tracing.span``).  The device
pool holds one page more, the sink of masked writes
(``models.attention``): the state pool never hands it out, hashes it,
references it or copies it.

On top of the pages sit two behaviours:

* **Prefix caching** -- after each prefill chunk the engine registers the
  slot's pages under a content hash of the prompt-prefix chain
  (``h_i = sha256(h_{i-1} || token_i)``).  A later request that shares a
  cached prefix is admitted with those pages attached (full pages shared
  by refcount, the partial tail page copied, since decode writes into
  it) and its SSM snapshot restored, and computes only the rest of its
  prompt.  Entries are evicted LRU, past ``max_prefix_entries`` and when
  the free list runs dry.
* **Preemption** -- a request at an iteration boundary is evicted to a
  :class:`PreemptedState`: its page-table row detaches (the page
  references move to the handle, no data moves), its SSM rows are
  snapshot, and a restore into any free slot attaches the pages and
  writes the snapshot back.

A page is freed when no slot row, prefix entry or handle references it;
:class:`PoolExhausted` is raised only when eviction cannot free enough.
``resident_state_bytes`` counts the pages in use and the SSM rows that
entries and handles hold off their slots.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models.attention import KVCache


class PoolExhausted(RuntimeError):
    """No free pages left after evicting every evictable prefix entry."""


def hash_chain(tokens) -> List[bytes]:
    """``out[i]`` identifies the prefix ``tokens[:i+1]``: equal prefixes
    give equal keys whichever request produced them, and every key
    depends on the whole prefix."""
    h = hashlib.sha256()
    out: List[bytes] = []
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
        out.append(h.digest())
    return out


@dataclass
class PrefixEntry:
    """One cached prompt prefix: shared full pages and an owned tail copy."""
    key: bytes
    length: int                      # tokens covered
    page_ids: List[int]              # ceil(length / page_size) refcounted ids
    ssm: tuple = ()                  # per-slot SSMState snapshots, or ()
    hits: int = 0


@dataclass
class PreemptedState:
    """What resumes an evicted request with the same bits."""
    request: object                  # the engine's RequestState (progress 0)
    page_ids: List[int]              # references moved from the slot row
    cache_len: int
    ssm: tuple = ()


class StatePool:
    """Free list, refcounts, per-slot page lists, the page table and the
    prefix cache's LRU."""

    def __init__(self, *, max_batch: int, max_ctx: int, page_size: int,
                 num_pages: Optional[int] = None,
                 max_prefix_entries: int = 64, bytes_per_page: int = 0,
                 ssm_bytes_per_row: int = 0):
        assert page_size >= 1 and max_ctx >= 1
        self.page_size = page_size
        self.pages_per_slot = -(-max_ctx // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 2 * max_batch * self.pages_per_slot)
        if self.num_pages < max_batch * self.pages_per_slot:
            raise ValueError(
                f"state pool too small: {self.num_pages} pages < "
                f"{max_batch} slots x {self.pages_per_slot} pages/slot")
        self.max_prefix_entries = max_prefix_entries
        self.bytes_per_page = bytes_per_page
        self.ssm_bytes_per_row = ssm_bytes_per_row
        self.table = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.free: Deque[int] = deque(range(self.num_pages))
        self.ref = np.zeros((self.num_pages,), np.int64)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self._ssm_rows_held = 0          # snapshots held by entries, handles
        self.stats: Dict[str, int] = {
            "pool_pages": self.num_pages,
            "pool_pages_in_use": 0, "pool_peak_pages": 0,
            "resident_state_bytes": 0, "peak_resident_state_bytes": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
            "prefill_tokens_saved": 0,
        }

    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    def _account(self) -> None:
        used = self.pages_in_use()
        self.stats["pool_pages_in_use"] = used
        self.stats["pool_peak_pages"] = max(self.stats["pool_peak_pages"], used)
        resident = (used * self.bytes_per_page
                    + self._ssm_rows_held * self.ssm_bytes_per_row)
        self.stats["resident_state_bytes"] = resident
        self.stats["peak_resident_state_bytes"] = max(
            self.stats["peak_resident_state_bytes"], resident)

    def _alloc(self, n: int) -> List[int]:
        while len(self.free) < n and self.entries:
            self._evict_lru()
        if len(self.free) < n:
            raise PoolExhausted(
                f"state pool exhausted: need {n} pages, {len(self.free)} "
                f"free of {self.num_pages} (active slots and preemption "
                f"handles hold the rest)")
        ids = [self.free.popleft() for _ in range(n)]
        for pid in ids:
            self.ref[pid] = 1
        self._account()
        return ids

    def _addref(self, pid: int) -> None:
        self.ref[pid] += 1

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
        """Drop the slot row's references (request finished); pages shared
        with prefix entries survive by their refcounts."""
        for pid in self.slot_pages[slot]:
            self._deref(pid)
        self.slot_pages[slot] = []
        self._account()

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------

    def lookup_prefix(self, keys: List[bytes],
                      max_len: int) -> Optional[PrefixEntry]:
        """The longest cached prefix of a prompt, at most ``max_len``
        tokens (the engine passes ``len(prompt) - 1``: one prompt token
        must run for the first token's logits)."""
        best: Optional[PrefixEntry] = None
        for L in range(min(max_len, len(keys)), 0, -1):
            e = self.entries.get(keys[L - 1])
            if e is not None and e.length == L:
                best = e
                break
        if best is not None:
            self.entries.move_to_end(best.key)
            best.hits += 1
        return best

    def register_prefix(self, key: bytes, length: int, slot: int,
                        ssm: tuple = ()) -> Optional[Tuple[int, int]]:
        """Cache the first ``length`` tokens of ``slot``.  Full pages are
        shared by reference; a partial tail page gets a fresh page, and
        ``(src, dst)`` is returned for the engine to copy
        (:func:`copy_page`).  None when nothing is copied or the key is
        cached already."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return None
        n_full, tail = divmod(length, self.page_size)
        row = self.slot_pages[slot]
        assert len(row) >= n_full + (1 if tail else 0), \
            f"slot {slot} holds {len(row)} pages, prefix needs {length} tokens"
        ids = list(row[:n_full])
        for pid in ids:
            self._addref(pid)
        copy = None
        if tail:
            dst = self._alloc(1)[0]
            ids.append(dst)
            copy = (row[n_full], dst)
        self.entries[key] = PrefixEntry(key=key, length=length,
                                        page_ids=ids, ssm=ssm)
        if ssm != ():
            self._ssm_rows_held += 1
        while len(self.entries) > self.max_prefix_entries:
            self._evict_lru()
        self._account()
        return copy

    def attach_prefix(self, entry: PrefixEntry,
                      slot: int) -> Optional[Tuple[int, int]]:
        """Point ``slot``'s row at a cached prefix: full pages shared (the
        slot writes only at positions >= entry.length, past them), a
        partial tail page copied into a fresh page the slot owns
        (``(src, dst)`` returned for the engine)."""
        assert not self.slot_pages[slot], \
            f"attach_prefix into non-empty slot {slot}"
        n_full, tail = divmod(entry.length, self.page_size)
        ids = list(entry.page_ids[:n_full])
        for pid in ids:
            self._addref(pid)
        copy = None
        if tail:
            dst = self._alloc(1)[0]
            copy = (entry.page_ids[n_full], dst)
            ids.append(dst)
        self.table[slot, :len(ids)] = ids
        self.slot_pages[slot] = ids
        self.stats["cache_hits"] += 1
        self.stats["prefill_tokens_saved"] += entry.length
        self._account()
        return copy

    def _evict_lru(self) -> None:
        _, entry = self.entries.popitem(last=False)
        for pid in entry.page_ids:
            self._deref(pid)
        if entry.ssm != ():
            self._ssm_rows_held -= 1
        self.stats["cache_evictions"] += 1
        self._account()

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------

    def detach_slot(self, slot: int, *, has_ssm: bool = False) -> List[int]:
        """Move the slot row's page references to a preemption handle
        (refcounts unchanged).  The table row keeps its stale ids until a
        later ``ensure`` or attach overwrites them: an idle row's writes
        go to the sink page, and a new occupant writes only within the
        pages it was given.  ``has_ssm``: the handle holds an SSM
        snapshot, counted in ``resident_state_bytes`` (a pure-attention
        preemption holds none)."""
        ids = self.slot_pages[slot]
        self.slot_pages[slot] = []
        if has_ssm:
            self._ssm_rows_held += 1
        self._account()
        return ids

    def attach_pages(self, slot: int, page_ids: List[int], *,
                     has_ssm: bool = False) -> None:
        """Attach a preemption handle's pages to a free slot row;
        ``has_ssm`` as in :meth:`detach_slot`."""
        assert not self.slot_pages[slot], \
            f"attach_pages into non-empty slot {slot}"
        if len(page_ids) > self.pages_per_slot:
            raise ValueError(f"{len(page_ids)} pages exceed the "
                             f"{self.pages_per_slot}-page slot row")
        self.table[slot, :len(page_ids)] = page_ids
        self.slot_pages[slot] = list(page_ids)
        if has_ssm:
            self._ssm_rows_held -= 1
        self._account()

    def drop_handle(self, handle: PreemptedState) -> None:
        """Discard a preemption handle (its request restarts from the
        prompt)."""
        for pid in handle.page_ids:
            self._deref(pid)
        if handle.ssm != ():
            self._ssm_rows_held -= 1
        self._account()


def _is_ssm(part) -> bool:
    return isinstance(part, ssm_mod.SSMState)


def has_ssm(caches) -> bool:
    return any(_is_ssm(c.ssm) for c in caches)


@tracing.device_work
def snapshot_ssm(caches, row: int) -> tuple:
    """Value snapshot (copies) of one slot's SSM state across every SSM
    layer, ``()`` for attention layers."""
    return tuple(ssm_mod.ssm_state_slice(c.ssm, row) if _is_ssm(c.ssm)
                 else () for c in caches)


@tracing.device_work
def restore_ssm(caches, snap: tuple, row: int):
    """Write a :func:`snapshot_ssm` back into ``row``, in place."""
    for c, s in zip(caches, snap):
        if _is_ssm(c.ssm):
            ssm_mod.ssm_state_restore(c.ssm, s, row)
    return caches


@tracing.device_work
def zero_ssm(caches, row: int):
    """Reset one slot's SSM rows to the initial state, in place (a fresh
    admission into a recycled slot must not inherit the previous
    occupant's recurrent state)."""
    for c in caches:
        if _is_ssm(c.ssm):
            ssm_mod.ssm_state_zero_row(c.ssm, row)
    return caches


@tracing.device_work
def copy_page(caches, src: int, dst: int) -> None:
    """Copy one physical page across every attention layer's K and V, in
    place: the copy-on-write of a partial tail page.  It runs eagerly,
    between segments, never inside a captured graph."""
    for c in caches:
        if isinstance(c.kv, KVCache):
            for pages in c.kv:
                pages[:, dst] = pages[:, src]


def merge_prefill(caches, dense_caches, page_ids: List[int], slot: int,
                  page_size: int):
    """Scatter a one-shot (batch=1) prefill into the pool, in place.
    ``dense_caches`` KV (n_periods, 1, max_ctx, n_kv, hd) reshapes into the
    slot's pages; SSM (n_periods, 1, ...) is written at row ``slot``."""
    ids = torch.as_tensor(page_ids, dtype=torch.int64)
    n = len(page_ids)
    for c, dc in zip(caches, dense_caches):
        if _is_ssm(c.ssm):
            for big, small in zip(c.ssm, dc.ssm):
                big[:, slot] = small[:, 0].to(big.dtype)
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
    per slot row across all SSM layers): the pool's accounting constants."""
    page_b = ssm_b = 0
    for c in caches:
        if isinstance(c.kv, KVCache):
            for a in c.kv:
                # (n_periods, P, page_size, n_kv, hd): per page = all but P
                page_b += int(a.shape[0] * np.prod(a.shape[2:])) \
                    * a.element_size()
        if _is_ssm(c.ssm):
            for a in c.ssm:
                # (n_periods, B, ...): per row = all but B
                ssm_b += int(a.shape[0] * np.prod(a.shape[2:])) \
                    * a.element_size()
    return page_b, ssm_b
