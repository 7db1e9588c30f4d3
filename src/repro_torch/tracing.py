"""Host-only spans of the serving loop, on the profiler's own clock.

``span(name)`` marks a stretch of the program's host work (admission,
page bookkeeping, an MoE boundary's bookkeeping, sampling) as a
``torch.profiler.record_function`` range while the profiler records, so
a trace can say what the host did while the device waited.  With the
profiler off it returns one shared no-op context: the check is a read
of the profiler's module flag, and no ``record_function`` is entered.

Every span is a host-only leaf: it encloses no kernel launch, copy,
graph replay or synchronize, and no other span.  A range that encloses a
launch gets a device-side annotation of its own in the trace, which
would count as device work; so a function that does device work inside
host bookkeeping (a prefix-cache page copy, an SSM snapshot) is marked
``@device_work``: it leaves the open span for its call and enters it
again after, and the span covers only the host parts around it.

    with tracing.span("repro_torch.engine.pages"):
        ...
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_current = threading.local()    # .span: the span open on this thread


class _Span:
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        _current.span = self
        return self

    def __exit__(self, *exc):
        _current.span = None
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A ``record_function`` range named ``name`` while the profiler
    records, else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def device_work(fn):
    """Run ``fn`` outside the open span (if any), which resumes, under
    the same name, when ``fn`` returns."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        sp = getattr(_current, "span", None)
        if sp is None:
            return fn(*args, **kwargs)
        sp.__exit__(None, None, None)
        try:
            return fn(*args, **kwargs)
        finally:
            sp.__enter__()
    return call
