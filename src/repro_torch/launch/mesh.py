"""Production mesh construction (port of ``repro.launch.mesh``).

A mesh here lays the initialized ``torch.distributed`` world out as named
axes (``parallel.meshctx.ProcessMesh``); ``shape_only=True`` gives the
same axes as a :class:`~repro_torch.parallel.meshctx.MeshShape`, with no
world, for the sharding rules and the shape-only dry run.
"""
from __future__ import annotations

from repro_torch.parallel.meshctx import MeshShape, ProcessMesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         shape_only: bool = False):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  On
    ranks the world must have that size (``ProcessMesh.create`` raises
    otherwise)."""
    return make_mesh(*PRODUCTION[bool(multi_pod)], shape_only=shape_only)


def make_mesh(shape, axes, *, shape_only: bool = False):
    """Any mesh (tests use small ones).  On ranks: collective over the
    world."""
    if shape_only:
        return MeshShape(tuple(axes), tuple(shape))
    return ProcessMesh.create(tuple(shape), tuple(axes))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: every axis except 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")
