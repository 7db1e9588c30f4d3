"""CUDA graphs of the scoring call (``api.loss_fn`` where autograd does
not record).

A scoring loop calls ``loss_fn`` back to back on batches of one shape.
Eager, each call enqueues a few thousand kernels from one host thread
(granite-moe-1b-a400m over 2 x 2048 tokens: ~2,600, 35-70 ms of host
work as the host's load varies, against ~30 ms on an H100), so the host
paces the loop and its speed sets the rate.  Here the second call of a
setting is captured into a CUDA graph and every later call replays it:
the batch's tensors are copied into the graph's inputs and the outputs
are cloned out, so a caller may keep them.

A setting is what a capture bakes in: the storage of the parameters
(addresses, shapes, strides, dtypes), the shapes and dtypes of the
batch, the config, the call's options and the switches the forward reads
(kernels, weight dtype, sorted dispatch, autotune level).  The first
call of a setting runs eagerly and is the warm-up (kernels loaded, tiles
planned, library handles made).  A capture that fails (the call reads a
value back to the host, or runs a collective) leaves the setting eager
for good.  Only a call on CUDA tensors that autograd does not record,
outside a mesh, a sharding layout and a process group, and not inside
another capture, is replayed.

A kernel wrapper counts a launch it makes during a capture in its
``CAPTURED`` (``streamed_moe``, ``moe_dispatch``) or in its ``LAUNCHES``
(``flash_attention``, ``ssd``); after a capture those ``LAUNCHES`` are
set back, and each replay adds the graph's launches to the ``LAUNCHES``
of their wrappers, so that ``LAUNCHES`` counts the kernels a scoring call
runs whether it ran eagerly or replayed.  ``CAPTURES`` and ``REPLAYS``
count captures and replays.

One graph is kept, the latest setting's; it goes when another setting
is seen or when its parameters are freed, and its memory pool, which
holds the call's intermediates, with it.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core import autotune
from repro_torch.kernels import flash_attention, moe_dispatch, ops, quant, \
    ssd, streamed_moe
from repro_torch.parallel import meshctx, sharding

CAPTURES = 0
REPLAYS = 0

# the wrappers whose launches a scoring call may capture
_COUNTED = (flash_attention, moe_dispatch, ssd, streamed_moe)

_kept = {"key": None, "graph": None}      # the latest setting seen
_eager = set()                            # settings whose capture failed


def _storage(tree):
    """What a call reads of ``tree``: each tensor's address, shape,
    strides, dtype and device, every other leaf as it is."""
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(), tree.shape, tree.stride(), tree.dtype,
                tree.device)
    if isinstance(tree, dict):
        return tuple((k, _storage(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_storage(v) for v in tree)
    return tree


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree


def replayable(batch) -> bool:
    """Whether a call on ``batch`` may replay a graph: its tensors on
    CUDA, autograd not recording, one device's forward (no mesh, layout
    or process group) and no capture under way."""
    tensors = [v for v in batch.values() if isinstance(v, torch.Tensor)]
    if not tensors or not all(t.is_cuda for t in tensors):
        return False
    if torch.is_grad_enabled() or torch.cuda.is_current_stream_capturing():
        return False
    if meshctx.get_mesh() is not None or sharding.get_layout() is not None:
        return False
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized())


def _setting(params, batch, cfg, options):
    from . import moe
    shapes = tuple((k, (v.shape, v.dtype, v.device))
                   if isinstance(v, torch.Tensor) else (k, v)
                   for k, v in batch.items())
    return (cfg, options, shapes, _storage(params), ops.kernels_enabled(),
            quant.weight_dtype(), moe.sorted_dispatch_enabled(),
            autotune.autotune_level())


class _Graph:
    """One captured call: its input buffers, outputs and launches."""

    def __init__(self, fn, params, batch, cfg, kw):
        self.inputs = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in batch.items()}
        before = [(m.LAUNCHES, getattr(m, "CAPTURED", 0)) for m in _COUNTED]
        stream = torch.cuda.current_stream()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(params, self.inputs, cfg, **kw)
        finally:
            # a failed capture can leave its side stream current
            torch.cuda.set_stream(stream)
            self.launches = [m.LAUNCHES - n + getattr(m, "CAPTURED", 0) - c
                             for m, (n, c) in zip(_COUNTED, before)]
            for m, (n, _) in zip(_COUNTED, before):
                m.LAUNCHES = n

    def replay(self, batch):
        global REPLAYS
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                self.inputs[k].copy_(v)
        self.graph.replay()
        for m, n in zip(_COUNTED, self.launches):
            m.LAUNCHES += n
        REPLAYS += 1
        return _clone(self.outputs)


def _forget(ref):
    if _kept["graph"] is not None and _kept["graph"] is ref():
        _kept.update(key=None, graph=None)


def call(fn, params, batch, cfg, **kw):
    """``fn(params, batch, cfg, **kw)``, replayed from a CUDA graph where
    the call may be (:func:`replayable`) from the second call of its
    setting on."""
    global CAPTURES
    if not replayable(batch):
        return fn(params, batch, cfg, **kw)
    key = _setting(params, batch, cfg, tuple(sorted(kw.items())))
    try:
        hash(key)
    except TypeError:               # an option with no value to key on
        return fn(params, batch, cfg, **kw)
    if key in _eager:
        return fn(params, batch, cfg, **kw)
    if _kept["key"] != key:
        _kept.update(key=key, graph=None)
        return fn(params, batch, cfg, **kw)
    g = _kept["graph"]
    if g is None:
        try:
            g = _Graph(fn, params, batch, cfg, kw)
        except RuntimeError:
            _eager.add(key)
            _kept.update(key=None, graph=None)
            return fn(params, batch, cfg, **kw)
        CAPTURES += 1
        _kept["graph"] = g
        leaf = _first_tensor(params)
        if leaf is not None:
            weakref.finalize(leaf, _forget, weakref.ref(g)).atexit = False
    return g.replay(batch)
