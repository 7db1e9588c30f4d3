"""Fused serving segments, captured as CUDA graphs (port of
``repro.serving.megastep``).

The eager engine walks the network layer by layer in Python and pays the
host's launch work for every small kernel.  Here everything between MoE
boundaries runs as one segment, so a steady decode iteration is ``k + 1``
segments (``k`` MoE layers) with one host sync per boundary:

* ``first``   — fresh-token embed merge, the layers before the first
  boundary ``b0``, the mixer at ``b0`` and the route stage at ``b0``
  (routing and the expert counts of the rows that reach it);
* ``mid[j]``  — expert execution at ``b_{j-1}`` on the previous segment's
  routing (along the host-fed EMA trajectory when the schedule is
  dynamic), the layers up to ``b_j``, the mixer and route at ``b_j``;
* ``last``    — expert execution at the final boundary, the trailing
  layers, final norm and logits;
* ``only``    — a model without MoE layers, end to end;
* ``prefill`` — one chunk of prompt tokens for every prefilling row
  (``transformer.prefill_chunk``), with the logits of each row's last
  chunk position.

Every body is built from the ``transformer.decode_*`` / ``prefill_chunk``
calls the eager loop makes, so both paths give the same bits.

On CUDA each segment is a ``torch.cuda.CUDAGraph``: a graph replays fixed
kernels on fixed addresses, so everything a segment reads or writes is a
static buffer written in place (the counterpart of the reference's
donated buffers): the residual ``x``, the paged caches, the carried
``h`` and routing, the outputs, and one int64 input buffer that holds the
host's inputs (cache lengths, page table, fresh tokens, row masks, the
trajectory order, the prompt chunk) at fixed offsets.  The host writes a
numpy mirror and stages it with one copy from fresh pinned memory before
each segment.  The first call of a segment runs it on a side stream (the
warm-up CUDA graphs need, and the call of record), then captures it into
the engine's one memory pool; every later call replays it.  A capture
that fails raises: nothing falls back to eager segments.  On the CPU the
same segment functions are called directly.

Under the ``measured`` autotune level the tiles of each ``streamed_moe``
call are timed on the card the first time its shape is seen, and nothing
may be timed inside a capture (``core.autotune.measured_kernel_tiles``
raises there).  The segment's first call, the eager warm-up on the side
stream, is where that timing happens: by the capture the shape's tiles
are cached and the capture only looks them up.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import gating, trajectory
from repro_torch.kernels import streamed_moe as sm_kernel
from repro_torch.models import transformer


def chunk_last_logits(params, hid, token_mask):
    """(B, V) logits of each row's last valid chunk position (position 0
    for an all-False row, whose logits nobody reads)."""
    last = torch.clamp(token_mask.sum(1) - 1, min=0)
    rows = torch.arange(hid.shape[0], device=hid.device)
    return hid[rows, last] @ transformer.head_matrix(params)


class MegaStep:
    """The fused segments of one engine under one setting (kernels on or
    off, ambient weight dtype): their static buffers, and on CUDA their
    graphs.  ``captures`` counts captures (flat in steady state),
    ``replays`` the replays of each graph and ``captured`` the
    ``streamed_moe`` launches each graph holds.

    ``stats`` holds two host times in integer nanoseconds
    (``time.perf_counter_ns``); the engine points it at its own
    ``Engine.stats``:

    * ``sync_wait_ns`` -- the host blocked in :meth:`fetch`'s stream
      synchronize, waiting for the segments queued before it (0 on the
      CPU, where nothing is queued);
    * ``launch_ns`` -- a segment's start on a graph already captured:
      staging the host inputs (the pinned copy) and the graph replay; on
      the CPU, where the segment runs in the call, the staging and the
      run.  A capture is left out (``capture_s`` holds it)."""

    def __init__(self, params, cfg, spec, caches, x, *, max_batch: int,
                 chunk_tokens: int, table_cols: int, pool=None):
        self.params, self.cfg, self.spec = params, cfg, spec
        self.caches, self.x = caches, x
        p, plan = transformer.cached_period_plan(cfg)
        self.boundaries = [l for l in range(cfg.num_layers)
                           if plan[l % p][1] == "moe"]
        self.dynamic = spec.schedule == "dynamic"
        dev = x.device
        self.on_cuda = dev.type == "cuda"
        B, K = max_batch, max(1, chunk_tokens)
        E = cfg.moe.num_experts if cfg.moe else 1
        k = cfg.moe.top_k if cfg.moe else 1
        self.E = E
        fields = (("cache_len", (B,)), ("table", (B, table_cols)),
                  ("token_vec", (B,)), ("start_mask", (B,)),
                  ("exec_mask", (B,)), ("count_mask", (B,)), ("order", (E,)),
                  ("tokens", (B, K)), ("token_mask", (B, K)))
        self._fields: Dict[str, tuple] = {}
        off = 0
        for name, shape in fields:
            n = int(np.prod(shape))
            self._fields[name] = (off, n, shape)
            off += n
        self._host_in = np.zeros((off,), np.int64)
        self._inputs = torch.zeros((off,), dtype=torch.int64, device=dev)
        self.set(order=np.arange(E))
        dt = x.dtype
        V = cfg.vocab_size
        self.h = torch.zeros_like(x)
        self.routing = gating.Routing(
            torch.zeros((B, k), dtype=torch.int64, device=dev),
            torch.zeros((B, k), dtype=dt, device=dev),
            torch.zeros((B, E), dtype=torch.float32, device=dev),
            torch.zeros((B, E), dtype=dt, device=dev))
        self.route_out = torch.zeros((E + B * k,), dtype=torch.int64,
                                     device=dev)
        self.logits = torch.zeros((B, 1, V), dtype=dt, device=dev)
        self.pre_counts = torch.zeros((cfg.num_layers // p, p, E),
                                      dtype=torch.int64, device=dev)
        self.pre_logits = torch.zeros((B, V), dtype=dt, device=dev)
        # host mirrors of the outputs (pinned on CUDA, for async copies)
        self._host_out = {id(t): torch.empty(t.shape, dtype=t.dtype,
                                             pin_memory=self.on_cuda)
                          for t in (self.route_out, self.logits,
                                    self.pre_counts, self.pre_logits)}
        self._pool = pool
        self._side = torch.cuda.Stream(device=dev) if self.on_cuda else None
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.captured: Dict[str, int] = {}
        self.replays: Dict[str, int] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.stats = {"sync_wait_ns": 0, "launch_ns": 0}

    # ------------------------------------------------------------------
    # host inputs and outputs
    # ------------------------------------------------------------------

    def set(self, **values) -> None:
        """Write host inputs into the mirror (staged before the next
        segment)."""
        for name, v in values.items():
            off, n, _ = self._fields[name]
            self._host_in[off:off + n] = np.asarray(v).reshape(-1)

    def _stage(self) -> None:
        src = torch.from_numpy(self._host_in)
        if self.on_cuda:
            # fresh pinned memory: the host allocator keeps it until the
            # copy is done, so the mirror may change at once
            self._inputs.copy_(src.pin_memory(), non_blocking=True)
        else:
            self._inputs.copy_(src)

    def _in(self, name) -> torch.Tensor:
        off, n, shape = self._fields[name]
        return self._inputs[off:off + n].view(shape)

    def _mask(self, name) -> torch.Tensor:
        return self._in(name) != 0

    def fetch(self, *tensors) -> list:
        """Copy device outputs to the host: one copy each into pinned
        memory, then one synchronise."""
        outs = []
        for t in tensors:
            host = self._host_out[id(t)]
            host.copy_(t, non_blocking=self.on_cuda)
            outs.append(host)
        if self.on_cuda:
            t0 = time.perf_counter_ns()
            torch.cuda.current_stream(self.x.device).synchronize()
            self.stats["sync_wait_ns"] += time.perf_counter_ns() - t0
        return [o.to(torch.float32 if o.is_floating_point() else o.dtype,
                     copy=True).numpy() for o in outs]

    # ------------------------------------------------------------------
    # segment bodies (static buffers in, static buffers out)
    # ------------------------------------------------------------------

    def _schedule(self):
        """The host-fed EMA trajectory (dynamic) or None (static)."""
        if not self.dynamic:
            return None
        return trajectory.Schedule(policy="dynamic", order=self._in("order"))

    def _route(self, x, layer: int) -> None:
        h, routing, counts = transformer.decode_route(
            self.params, x, self.cfg, layer, self._mask("count_mask"))
        self.x.copy_(x)
        self.h.copy_(h)
        for buf, t in zip(self.routing, routing):
            buf.copy_(t)
        self.route_out[:self.E].copy_(counts)
        self.route_out[self.E:].copy_(routing.indices.reshape(-1))

    def _first(self) -> None:
        P, cfg, b0 = self.params, self.cfg, self.boundaries[0]
        cl, table = self._in("cache_len"), self._in("table")
        start = self._mask("start_mask")
        x = transformer.decode_embed_merge(P, self.x, self._in("token_vec"),
                                           start, cfg)
        x, _ = transformer.decode_span(P, x, self.caches, cl, cfg, 0, b0,
                                       start, page_table=table)
        x, _ = transformer.decode_mixer(P, x, self.caches, cl, cfg, b0, start,
                                        page_table=table)
        self._route(x, b0)

    def _exec(self, b: int, hi: int):
        """Experts at boundary ``b`` on the carried routing, then the
        layers up to ``hi``, for the ``exec_mask`` rows."""
        P, cfg = self.params, self.cfg
        cl, table = self._in("cache_len"), self._in("table")
        run = self._mask("exec_mask")
        x = transformer.decode_moe_exec(
            P, self.x, self.h, gating.Routing(*self.routing), cfg, b, run,
            spec=self.spec, schedule=self._schedule())
        x, _ = transformer.decode_span(P, x, self.caches, cl, cfg, b + 1, hi,
                                       run, page_table=table)
        return x, run

    def _mid(self, j: int) -> None:
        b = self.boundaries[j]
        x, run = self._exec(self.boundaries[j - 1], b)
        x, _ = transformer.decode_mixer(self.params, x, self.caches,
                                        self._in("cache_len"), self.cfg, b,
                                        run, page_table=self._in("table"))
        self._route(x, b)

    def _last(self) -> None:
        x, _ = self._exec(self.boundaries[-1], self.cfg.num_layers)
        self.x.copy_(x)
        self.logits.copy_(transformer.decode_logits(self.params, x, self.cfg))

    def _only(self) -> None:
        P, cfg = self.params, self.cfg
        start = self._mask("start_mask")
        x = transformer.decode_embed_merge(P, self.x, self._in("token_vec"),
                                           start, cfg)
        x, _ = transformer.decode_span(P, x, self.caches, self._in("cache_len"),
                                       cfg, 0, cfg.num_layers, start,
                                       page_table=self._in("table"))
        self.x.copy_(x)
        self.logits.copy_(transformer.decode_logits(P, x, cfg))

    def _prefill(self) -> None:
        mask = self._mask("token_mask")
        hid, _, counts = transformer.prefill_chunk(
            self.params, self._in("tokens"), self.caches,
            self._in("cache_len"), self.cfg, spec=self.spec, token_mask=mask,
            return_hidden=True, page_table=self._in("table"))
        self.pre_counts.copy_(counts)
        self.pre_logits.copy_(chunk_last_logits(self.params, hid, mask))

    # ------------------------------------------------------------------
    # running a segment: called directly on the CPU, a graph on CUDA
    # ------------------------------------------------------------------

    def first(self) -> None:
        self._run("first", self._first)

    def mid(self, j: int) -> None:
        self._run(f"mid{j}", lambda: self._mid(j))

    def last(self) -> None:
        self._run("last", self._last)

    def only(self) -> None:
        self._run("only", self._only)

    def prefill(self) -> None:
        self._run("prefill", self._prefill)

    def _run(self, name: str, body) -> None:
        g = self.graphs.get(name)
        if self.on_cuda and g is None:
            self._stage()
            self._capture(name, body)
            return
        t0 = time.perf_counter_ns()
        self._stage()
        if g is None:
            body()
        else:
            g.replay()
            self.replays[name] += 1
        self.stats["launch_ns"] += time.perf_counter_ns() - t0

    def _capture(self, name: str, body) -> None:
        """Run ``body`` once on a side stream (the warm-up: lazy module
        loading, kernel attributes, cuBLAS handles, measured tiles; and the
        call of record), then capture it into the engine's pool."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.x.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            body()
        cur.wait_stream(self._side)
        g = torch.cuda.CUDAGraph()
        before = sm_kernel.CAPTURED
        with torch.cuda.graph(g, pool=self._pool):
            body()
        self.captured[name] = sm_kernel.CAPTURED - before
        self.graphs[name] = g
        self.replays[name] = 0
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def launches(self) -> int:
        """``streamed_moe`` launches made by graph replays: captured
        launches times replays, summed over the graphs."""
        return sum(self.captured[n] * self.replays[n] for n in self.graphs)
