"""Process meshes, collectives and a local launcher (port of
``repro.parallel``): ``meshctx`` lays the ``torch.distributed`` world out
as named axes, ``collectives`` moves tensors along them, ``localrun``
starts N gloo ranks on one host."""
from . import meshctx, sharding
from .meshctx import get_mesh, with_mesh
