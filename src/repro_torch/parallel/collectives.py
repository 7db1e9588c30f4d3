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
collectives this process issued, by name.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()


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
    the payloads' device."""

    def __init__(self, works, recvs, sends, device):
        self._works, self._recvs, self._device = works, recvs, device
        self._sends = sends          # kept alive until the sends complete

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sends = None
        return [r.to(self._device) for r in self._recvs]


def ring_shift(tensors: Sequence[torch.Tensor], mesh,
               axis: str) -> RingShift:
    """Post the sends of ``tensors`` to the next rank of the ``axis`` ring,
    (i + 1) % P, and the receives of the previous rank's, without
    waiting: the reference's ``ppermute`` over ``[(i, (i + 1) % P)]``."""
    group = mesh.group(axis)
    backend = dist.get_backend(group)
    line, i = mesh.line(axis), mesh.index(axis)
    nxt, prv = line[(i + 1) % len(line)], line[(i - 1) % len(line)]
    sends = [_host(t, backend) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    COUNTS["ring_shift"] += 1
    return RingShift(dist.batch_isend_irecv(ops), recvs, sends,
                     tensors[0].device)


def psum(t: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Sum over the ``axis`` line (``None``: over the whole mesh)."""
    group = None if axis is None else mesh.group(axis)
    buf = _host(t, dist.get_backend(group)).clone()
    dist.all_reduce(buf, group=group)
    COUNTS["psum"] += 1
    return buf.to(t.device)


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Split ``t`` along dim 0 into P equal chunks, send chunk j to rank j
    of the ``axis`` line and stack what arrives in rank order (the
    reference's tiled ``all_to_all`` over dim 0)."""
    backend = dist.get_backend(mesh.group(axis))
    src = _host(t, backend)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    COUNTS["all_to_all"] += 1
    return out.to(t.device)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ``axis`` line's tensors, concatenated along ``dim`` in rank
    order."""
    group = mesh.group(axis)
    P = mesh.size(axis)
    src = _host(t, dist.get_backend(group))
    parts = [torch.empty_like(src) for _ in range(P)]
    dist.all_gather(parts, src, group=group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim).to(t.device)
