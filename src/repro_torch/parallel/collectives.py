"""Collectives along a :class:`~repro_torch.parallel.meshctx.ProcessMesh`
axis: the port's counterparts of the reference's ``ppermute``, ``psum``,
``all_to_all`` and ``all_gather`` inside ``shard_map``.

The backend is the group's own.  NCCL (one GPU a rank) takes CUDA
tensors.  gloo takes host tensors: on the CPU, the tests' case, they are
the payloads themselves; for CUDA payloads (several ranks sharing one
card, where NCCL cannot run) each collective copies its payload to a
host buffer, runs there and copies the result back to the card.  That
transport, ``gloo-host``, moves the same values; only the compute stays
on the card, and its times are no ring's speed.  ``COUNTS`` counts the
collectives this process issued, by name, backward ones included.
``BYTES`` sums the bytes each one delivered to this rank (its output's
size, as the reference's ``launch.analysis.collective_bytes`` sums the
output shapes of the compiled program's collectives), by the reference's
categories: ``all-gather``, ``all-reduce`` (a psum), ``reduce-scatter``
(an all-gather's backward: the rank's slice of the sum), ``all-to-all``
and ``collective-permute`` (a ring shift's receives).

**Gradients.**  Each collective is differentiable, its backward the
transpose of its forward as a linear map over all the ranks' inputs:
the ring shift's is the shift back, the all-to-all's the all-to-all
back, the all-gather's the reduce-scatter (each rank keeps its slice of
the sum over the axis) and the sum's the sum (``shard_map``'s transposes
with replication checks off).  A rank's backward so gives the gradient
of the sum of every rank's loss with respect to its own inputs: a rank
takes its share of the loss (its own rows, or a replicated loss divided
by the ranks that hold it), and a parameter every rank holds gets its
gradient summed over the ranks by :func:`psum_grads`, as a data-parallel
trainer sums them.  The backward runs its collectives synchronously.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()
BYTES: Counter = Counter()
CATEGORIES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def transport(mesh, axis: str, device) -> str:
    """'nccl', 'gloo' or 'gloo-host' (CUDA payloads through host buffers)."""
    backend = dist.get_backend(mesh.group(axis))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo-host"
    return backend


def _host(t: torch.Tensor, backend: str) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if backend == "gloo" and t.is_cuda else t


class RingShift:
    """Receives posted by :func:`ring_shift`; ``wait()`` returns them on
    the payloads' device (differentiable when a payload requires grad)."""

    def __init__(self, works, recvs, sends, tensors, mesh, axis, reverse):
        self._works, self._recvs = works, recvs
        self._sends = sends          # kept alive until the sends complete
        self._tensors, self._mesh, self._axis = tensors, mesh, axis
        self._reverse = reverse

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sends = None
        device = self._tensors[0].device
        recvs = [r.to(device) for r in self._recvs]
        if len(recvs) < len(self._tensors):          # one packed payload
            sizes = [t.numel() for t in self._tensors]
            recvs = [r.view(t.shape) for r, t in
                     zip(torch.split(recvs[0], sizes), self._tensors)]
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in self._tensors)):
            return recvs
        return list(_Shifted.apply(self._mesh, self._axis, self._reverse,
                                   recvs, *self._tensors))


class _Shifted(torch.autograd.Function):
    """The received payloads of a ring shift as a function of the sent
    ones; the backward shifts the gradients back the other way."""

    @staticmethod
    def forward(ctx, mesh, axis, reverse, recvs, *sent):
        ctx.mesh, ctx.axis, ctx.reverse = mesh, axis, reverse
        return tuple(recvs)

    @staticmethod
    def backward(ctx, *grads):
        back = ring_shift(grads, ctx.mesh, ctx.axis,
                          reverse=not ctx.reverse).wait()
        return (None, None, None, None, *back)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axis: str, *,
               reverse: bool = False) -> RingShift:
    """Post the sends of ``tensors`` to the next rank of the ``axis`` ring,
    (i + 1) % P, and the receives of the previous rank's, without
    waiting: the reference's ``ppermute`` over ``[(i, (i + 1) % P)]``.
    ``reverse`` shifts the other way.  Payloads of one dtype travel as
    one flat message (the ring's weight slices: one send a hop, not
    three)."""
    group = mesh.group(axis)
    backend = dist.get_backend(group)
    line, i = mesh.line(axis), mesh.index(axis)
    step = -1 if reverse else 1
    nxt, prv = line[(i + step) % len(line)], line[(i - step) % len(line)]
    payload = [t.detach() for t in tensors]
    if len(payload) > 1 and len({t.dtype for t in payload}) == 1:
        payload = [torch.cat([t.reshape(-1) for t in payload])]
    sends = [_host(t, backend) for t in payload]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    COUNTS["ring_shift"] += 1
    BYTES["collective-permute"] += sum(_nbytes(r) for r in recvs)
    return RingShift(dist.batch_isend_irecv(ops), recvs, sends,
                     list(tensors), mesh, axis, reverse)


def _all_reduce(t: torch.Tensor, group, category="all-reduce"
                ) -> torch.Tensor:
    buf = _host(t.detach(), dist.get_backend(group)).clone()
    dist.all_reduce(buf, group=group)
    COUNTS["psum"] += 1
    if category:
        BYTES[category] += _nbytes(buf)
    return buf.to(t.device)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    src = _host(t.detach(), dist.get_backend(group))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    COUNTS["all_to_all"] += 1
    BYTES["all-to-all"] += _nbytes(out)
    return out.to(t.device)


def _all_gather(t: torch.Tensor, group, P: int, dim: int) -> torch.Tensor:
    src = _host(t.detach(), dist.get_backend(group))
    parts = [torch.empty_like(src) for _ in range(P)]
    dist.all_gather(parts, src, group=group)
    COUNTS["all_gather"] += 1
    out = torch.cat(parts, dim)
    BYTES["all-gather"] += _nbytes(out)
    return out.to(t.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, P, index, dim):
        ctx.group, ctx.index, ctx.dim, ctx.n = group, index, dim, t.shape[dim]
        return _all_gather(t, group, P, dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group, category=None)
        mine = total.narrow(ctx.dim, ctx.index * ctx.n, ctx.n)
        BYTES["reduce-scatter"] += _nbytes(mine)
        return mine, None, None, None, None


def psum(t: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Sum over the ``axis`` line (``None``: over the whole mesh)."""
    return _Psum.apply(t, None if axis is None else mesh.group(axis))


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Split ``t`` along dim 0 into P equal chunks, send chunk j to rank j
    of the ``axis`` line and stack what arrives in rank order (the
    reference's tiled ``all_to_all`` over dim 0)."""
    return _AllToAll.apply(t, mesh.group(axis))


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ``axis`` line's tensors, concatenated along ``dim`` in rank
    order."""
    return _AllGather.apply(t, mesh.group(axis), mesh.size(axis),
                            mesh.index(axis), dim)


def reset_counters():
    """Zero ``COUNTS`` and ``BYTES``."""
    COUNTS.clear()
    BYTES.clear()


def psum_grads(grads, mesh):
    """Each gradient summed over every rank of the mesh: the gradient of a
    parameter that every rank holds.  ``grads`` is a sequence of tensors
    (None kept); -> a list."""
    return [None if g is None else _all_reduce(g, None) for g in grads]
