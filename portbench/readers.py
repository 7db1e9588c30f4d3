"""What the metric readers share: the window's steps and requests."""
from __future__ import annotations


def window_steps(ctx) -> list:
    """Scheduler steps that ran wholly inside the measured window."""
    a, b = ctx.window
    return [s for s in ctx.steps if s.t0 >= a and s.t1 <= b]


def due_in_window(ctx) -> list:
    """Requests whose due time falls in the window (open loop)."""
    a, b = ctx.window
    return [r for r in ctx.requests.values() if a <= r.due < b]


def counter_delta(ctx, name: str) -> int:
    return ctx.counters["close"][name] - ctx.counters["open"][name]
