"""Mesh context (port of ``repro.parallel.meshctx``).

A :class:`ProcessMesh` lays the ``torch.distributed`` world out as named
axes, as a ``jax.sharding.Mesh`` lays out devices: ranks in row-major
order over ``axis_sizes`` (``("data", "model")`` = (2, 4) puts rank r at
data r // 4, model r % 4), one process group per line along each axis,
and this rank's coordinates.  Model code finds the active mesh with
:func:`get_mesh` inside :func:`with_mesh`; with no mesh, or a model axis
of size 1, :func:`model_axis_size` is 1 and the distributed strategies
run on one device.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@dataclass(frozen=True)
class ProcessMesh:
    """This rank's view of the world as named axes.  ``groups[i]`` is the
    process group of this rank's line along ``axis_names[i]`` (the ranks
    that share every other coordinate), ``lines[i]`` its global ranks in
    axis order."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Any, ...]
    lines: Tuple[Tuple[int, ...], ...]
    rank: int

    @classmethod
    def create(cls, axis_sizes: Sequence[int],
               axis_names: Sequence[str]) -> "ProcessMesh":
        """Collective over the initialized world, whose size must be the
        product of ``axis_sizes``: every rank creates every line's group,
        in one order."""
        import torch.distributed as dist
        sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for axes {names}")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                             f"{math.prod(sizes)} ranks, the world has {world}")
        rank = dist.get_rank()
        coords = tuple(_unravel(rank, sizes))
        groups, lines = [], []
        for i in range(len(sizes)):
            others = [range(s) for j, s in enumerate(sizes) if j != i]
            for rest in itertools.product(*others):
                line = tuple(_ravel(rest[:i] + (k,) + rest[i:], sizes)
                             for k in range(sizes[i]))
                group = dist.new_group(list(line))
                if rank in line:
                    groups.append(group)
                    lines.append(line)
        return cls(names, sizes, coords, tuple(groups), tuple(lines), rank)

    @property
    def world_size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def _axis(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.axis_sizes[self._axis(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._axis(axis)]

    def group(self, axis: str):
        return self.groups[self._axis(axis)]

    def line(self, axis: str) -> Tuple[int, ...]:
        """Global ranks of this rank's line along ``axis``, in order."""
        return self.lines[self._axis(axis)]


@dataclass(frozen=True)
class MeshShape:
    """A mesh as names and sizes only, with no process group: the port's
    ``jax.sharding.AbstractMesh``.  The sharding rules and the shape-only
    dry run take it where no world of ranks exists (the 256- and 512-rank
    production meshes)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes",
                           tuple(int(s) for s in self.axis_sizes))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def world_size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, axis: str) -> int:
        return self.axis_sizes[self.axis_names.index(axis)]


def _unravel(rank: int, sizes):
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return reversed(out)


def _ravel(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


@contextlib.contextmanager
def with_mesh(mesh: Optional[ProcessMesh]):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def get_mesh() -> Optional[ProcessMesh]:
    return _MESH.get()


def model_axis_size(axis: str = "model") -> int:
    mesh = get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.size(axis)


def batch_axes(mesh, axis: str = "model"):
    """All mesh axes except the model axis (the batch's axes)."""
    return tuple(a for a in mesh.axis_names if a != axis)


# named optimizations, as the reference's: 'sorted' switches the MoE
# dispatch to gathers (``models.moe.sorted_dispatch_enabled``); the
# reference's 'sp_attn' and 'scatter_cache' name paths of its attention
# that the port does not have, and nothing reads them
_OPTS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_opts",
                                                       default=frozenset())


@contextlib.contextmanager
def with_opts(*names: str):
    tok = _OPTS.set(frozenset(_OPTS.get()) | set(names))
    try:
        yield
    finally:
        _OPTS.reset(tok)


def opt_enabled(name: str) -> bool:
    return name in _OPTS.get()
