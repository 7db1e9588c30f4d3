"""Sharding rules (port of ``repro.parallel.sharding``): every parameter,
cache and batch leaf mapped to a :class:`PartitionSpec` on the (pod,
data, model) production mesh, and the port's realisation of that layout
on ``torch.distributed`` ranks.

The rules are the reference's, leaf for leaf (Megatron column / row
sharding of the dense weights on ``model``; the MoE experts' d_expert on
``model``, the FSE-DP layout with one copy of every expert per group;
ZeRO-3 in-dims over (pod, data) above :data:`FSDP_THRESHOLD` parameters;
every proposed axis divisibility-guarded):

  embed (V,d)              -> (None, model)
  lm_head (d,V)            -> (fsdp?, model)
  attn wq/wk/wv (d, H*hd)  -> (fsdp?, model)
  attn wo (H*hd, d)        -> (model, fsdp?)
  ffn w_up/w_gate (d, f)   -> (fsdp?, model)
  ffn w_down (f, d)        -> (model, fsdp?)
  MoE w_gate/w_up (E,d,de) -> (None, fsdp?, model)
  MoE w_down (E,de,d)      -> (None, model, fsdp?)
  ssm in_proj (d, Z)       -> (fsdp?, model)
  ssm out_proj (di, d)     -> (model, fsdp?)
  router / norms / scalars -> replicated

**On ranks.**  No compiler partitions the ops here.  A rank *stores* its
block of each leaf (:meth:`NamedSharding.shard`; along a tuple of axes
such as ("pod", "data") the blocks go in row-major order over them) and,
before the leaf is used, *gathers* it (:meth:`NamedSharding.gather`, an
all-gather over each named axis in turn, differentiable: its backward is
the reduce-scatter).  The MoE expert leaves stay on ``model``: their
stored block is the rank's d_expert slice, which the FSE-DP bodies
consume as it is.  Model code learns the layout from :func:`with_layout`,
which the mesh steps (``launch.steps``) set, as ``meshctx.with_mesh``
sets the mesh; with no layout, every function here that model code calls
returns its input.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

FSDP_THRESHOLD = 20e9   # params; above this, in-dims shard over 'data'


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None, an axis name, or a tuple of names
    (the reference's ``jax.sharding.PartitionSpec``, as a tuple)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return mesh.shape[axis]


def _fit(mesh, axis, dim: int):
    """axis if it divides dim (and exists in the mesh), else None."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        axes = tuple(a for a in axis if a in mesh.axis_names)
        if not axes:
            return None
        if dim % _axis_size(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        # try shrinking the product
        for sub in (axes[1:], axes[:1]):
            if sub and dim % _axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    if axis not in mesh.axis_names:
        return None
    return axis if dim % mesh.shape[axis] == 0 else None


def _pad(spec_tail, ndim: int) -> PartitionSpec:
    tail = tuple(spec_tail)
    assert len(tail) <= ndim, (tail, ndim)
    return P(*((None,) * (ndim - len(tail)) + tail))


_LAST = lambda path: path.split("/")[-1]


def path_key(path: str) -> str:
    """The reference's key of a leaf from its ``repro_torch.tree`` path:
    a NamedTuple field, which ``tree`` writes ``.field``, is ``field``."""
    return "/".join(p[1:] if p.startswith(".") else p
                    for p in path.split("/"))


def param_spec(path: str, shape, mesh, *, fsdp: bool) -> PartitionSpec:
    """PartitionSpec for a parameter leaf, identified by its path name."""
    name = _LAST(path)
    nd = len(shape)
    f = ("pod", "data") if fsdp else None   # ZeRO dims span pods when present
    model = "model"
    in_moe = "moe" in path.split("/")

    if name in ("scale", "bias", "A_log", "D", "dt_bias", "conv_b"):
        return P()
    if name == "w_router":
        return P()
    if name == "embed":
        return _pad((None, _fit(mesh, model, shape[-1])), nd)
    if name == "lm_head":
        return _pad((_fit(mesh, f, shape[-2]), _fit(mesh, model, shape[-1])), nd)
    if name in ("wq", "wk", "wv"):
        return _pad((_fit(mesh, f, shape[-2]), _fit(mesh, model, shape[-1])), nd)
    if name == "wo":
        return _pad((_fit(mesh, model, shape[-2]), _fit(mesh, f, shape[-1])), nd)
    if name in ("w_up", "w_gate"):
        if in_moe and nd >= 3:   # (E, d, de): FSE-DP d_expert sharding
            return _pad((None, _fit(mesh, f, shape[-2]),
                         _fit(mesh, model, shape[-1])), nd)
        return _pad((_fit(mesh, f, shape[-2]), _fit(mesh, model, shape[-1])), nd)
    if name == "w_down":
        if in_moe and nd >= 3:   # (E, de, d)
            return _pad((None, _fit(mesh, model, shape[-2]),
                         _fit(mesh, f, shape[-1])), nd)
        return _pad((_fit(mesh, model, shape[-2]), _fit(mesh, f, shape[-1])), nd)
    if name == "in_proj":
        return _pad((_fit(mesh, f, shape[-2]), _fit(mesh, model, shape[-1])), nd)
    if name == "out_proj":
        return _pad((_fit(mesh, model, shape[-2]), _fit(mesh, f, shape[-1])), nd)
    if name == "conv_w":
        return _pad((None, _fit(mesh, model, shape[-1])), nd)
    return P()   # anything unrecognized: replicate


def cache_spec(path: str, shape, mesh, *, batch_axes) -> PartitionSpec:
    """Decode-cache leaf specs: KV sequence over ``model`` (the
    reference's sequence-parallel decode), batch over (pod, data), SSM
    state heads over ``model``."""
    name = _LAST(path)
    nd = len(shape)
    if nd == 0:
        return P()
    if name in ("k", "v"):           # (nper, B, S, kv, hd)
        b = _fit(mesh, batch_axes, shape[-4])
        s = _fit(mesh, "model", shape[-3])
        return _pad((b, s, None, None), nd)
    if name == "ssd":                # (nper, B, nh, hd, n)
        b = _fit(mesh, batch_axes, shape[-4])
        h = _fit(mesh, "model", shape[-3])
        return _pad((b, h, None, None), nd)
    if name == "conv":               # (nper, B, K, d_xBC)
        b = _fit(mesh, batch_axes, shape[-3])
        dd = _fit(mesh, "model", shape[-1])
        return _pad((b, None, dd), nd)
    if name in ("cross_k", "cross_v"):   # (L, B, F, kv, hd)
        b = _fit(mesh, batch_axes, shape[-4])
        return _pad((b, None, None, None), nd)
    # fallback: shard the largest dim that fits the batch axes
    return _pad((_fit(mesh, batch_axes, shape[1]) if nd > 1 else None,),
                min(nd, 2))


def batch_spec(name: str, shape, mesh, batch_axes) -> PartitionSpec:
    nd = len(shape)
    b = _fit(mesh, batch_axes, shape[0]) if nd else None
    return P(*((b,) + (None,) * (nd - 1)))


# ---------------------------------------------------------------------------
# shardings: a spec on a mesh, and a rank's block of a leaf
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh`` (a ``meshctx.ProcessMesh``, or a
    ``meshctx.MeshShape`` for shapes only)."""

    mesh: Any
    spec: PartitionSpec

    def _entries(self, ndim: int):
        spec = tuple(self.spec)
        if len(spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"{ndim}-d leaf")
        return spec + (None,) * (ndim - len(spec))

    def block_shape(self, shape) -> Tuple[int, ...]:
        """The shape of a rank's block of a leaf of global ``shape``."""
        out = []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = _axis_size(self.mesh, _axes(entry) or None)
            if dim % n:
                raise ValueError(f"{self.spec} does not divide {tuple(shape)}")
            out.append(dim // n)
        return tuple(out)

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is not split over (its copies)."""
        used = {a for e in self.spec for a in _axes(e)}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def _block_index(self, axes) -> int:
        """This rank's block along a dimension split over ``axes``
        (row-major over them)."""
        i = 0
        for a in axes:
            i = i * self.mesh.size(a) + self.mesh.index(a)
        return i

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``full`` (a view)."""
        out = full
        for dim, entry in enumerate(self._entries(full.dim())):
            axes = _axes(entry)
            if axes:
                n = full.shape[dim] // _axis_size(self.mesh, axes)
                out = out.narrow(dim, self._block_index(axes) * n, n)
        return out

    def gather(self, block: torch.Tensor, skip=()) -> torch.Tensor:
        """The global tensor from every rank's ``block``: an all-gather
        over each named axis in turn, the innermost of a dimension's axes
        first (``collectives.all_gather``, whose backward is the
        reduce-scatter).  Axes in ``skip`` stay split."""
        from . import collectives
        out = block
        for dim, entry in enumerate(self._entries(block.dim())):
            for a in reversed(_axes(entry)):
                if a not in skip and self.mesh.size(a) > 1:
                    out = collectives.all_gather(out, self.mesh, a, dim=dim)
        return out

    def is_primary(self) -> bool:
        """True on the one rank of each set of copies of a block: the one
        at coordinate 0 along every replicated axis."""
        return all(self.mesh.index(a) == 0 for a in self.replicated_axes())

    def drop_leading(self, n: int = 1) -> "NamedSharding":
        """The sharding of ``leaf[i]`` (its first ``n`` dims taken away),
        which must not be split."""
        head = tuple(self.spec)[:n]
        if any(e is not None for e in head):
            raise ValueError(f"{self.spec}: a split leading dimension")
        return NamedSharding(self.mesh, P(*tuple(self.spec)[n:]))


def _tree_shardings(struct, mesh, fn):
    """``fn(path key, shape)`` -> spec for every leaf -> a tree of
    NamedSharding of ``struct``'s structure."""
    specs = [NamedSharding(mesh, fn(path_key(k), tuple(leaf.shape)))
             for k, leaf in tree_mod.leaves_with_path(struct)]
    return tree_mod.unflatten(struct, specs)


def param_shardings(params_struct, mesh, *, fsdp: bool):
    return _tree_shardings(params_struct, mesh,
                           lambda k, s: param_spec(k, s, mesh, fsdp=fsdp))


def opt_shardings(opt_struct, params_struct, mesh, *, fsdp: bool):
    """m / v follow their parameter's spec; step is replicated."""
    pspec = param_shardings(params_struct, mesh, fsdp=fsdp)
    return type(opt_struct)(step=replicated(mesh), m=pspec, v=pspec)


def cache_shardings(cache_struct, mesh, batch_axes):
    return _tree_shardings(cache_struct, mesh, lambda k, s: cache_spec(
        k, s, mesh, batch_axes=batch_axes))


def cache_batch_shardings(cache_struct, mesh, batch_axes):
    """:func:`cache_shardings` with ``model`` taken out: the port's serve
    and prefill steps hold a data group's caches whole on each model rank
    (no sequence-parallel decode)."""
    def spec(k, s):
        return P(*(None if e == "model" else e for e in cache_spec(
            k, s, mesh, batch_axes=batch_axes)))
    return _tree_shardings(cache_struct, mesh, spec)


def batch_shardings(batch_struct, mesh, batch_axes):
    return {k: NamedSharding(mesh, batch_spec(k, v.shape, mesh, batch_axes))
            for k, v in batch_struct.items()}


def replicated(mesh):
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# the layout model code runs under
# ---------------------------------------------------------------------------

_EXPERT_LEAVES = {"w_gate": -1, "w_up": -1, "w_down": -2}   # d_expert dim


def is_expert_leaf(key: str) -> bool:
    """A routed expert stack (``.../moe/w_up``), not a shared expert."""
    parts = key.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" \
        and parts[-1] in _EXPERT_LEAVES


@dataclass(frozen=True)
class Layout:
    """How a parameter tree is stored on ``mesh``: the NamedSharding of
    every leaf by its path key, global shapes implied."""

    mesh: Any
    shardings: Dict[str, NamedSharding]
    expert_axes: Tuple[str, ...] = field(default=())

    @classmethod
    def of(cls, shardings_tree, mesh) -> "Layout":
        flat = {path_key(k): s for k, s
                in tree_mod.leaves_with_path(shardings_tree)}
        expert = set()
        for k, s in flat.items():
            if is_expert_leaf(k) and len(s.spec):
                expert.add(_axes(s.spec[_EXPERT_LEAVES[k.split("/")[-1]]]))
        if len(expert) > 1:
            raise ValueError(f"expert leaves split over different axes: "
                             f"{sorted(expert)}")
        return cls(mesh, flat, next(iter(expert), ()))

    def experts_on(self, axis: str) -> bool:
        """Whether the expert stacks are stored split on ``axis`` along
        d_expert (each rank its slice)."""
        return axis in self.expert_axes


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_layout", default=None)


@contextlib.contextmanager
def with_layout(layout: Optional[Layout]):
    tok = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(tok)


def get_layout() -> Optional[Layout]:
    return _LAYOUT.get()


def gather_params(sub, prefix: str, lead: int = 0, *, keep="model"):
    """The leaves of ``sub`` (the subtree at ``prefix`` of the stored
    parameters, indexed by ``lead`` leading dims, e.g. one period of a
    stacked slot) gathered whole: each over every axis of its stored
    spec, but the expert stacks stay split on ``keep``, the axis the MoE
    runs on.  With no layout: ``sub``."""
    lay = get_layout()
    if lay is None:
        return sub

    def one(path, leaf):
        key = path_key(f"{prefix}/{path}" if path else prefix)
        sh = lay.shardings[key].drop_leading(lead)
        return sh.gather(leaf, skip=(keep,) if is_expert_leaf(key) else ())
    pairs = list(tree_mod.leaves_with_path(sub))
    return tree_mod.unflatten(sub, [one(k, v) for k, v in pairs])


def unshard_slot_params(slot, prefix: str):
    """ZeRO-3 per-layer gather: one period's parameters of the stacked
    slot at ``prefix`` (``periods/<s>``) gathered inside the period body,
    so the backward's recompute gathers again and no gathered leaf
    outlives its period."""
    return gather_params(slot, prefix, lead=1)


def gather_experts(params, axis: str = "model"):
    """A MoE layer's parameters with the expert stacks whole along
    d_expert, for the dataflows that take every expert's full FFN (one
    device's, EP's): gathered over ``axis`` when the layout stores them
    split there, else as given."""
    lay = get_layout()
    if lay is None or not lay.experts_on(axis) or lay.mesh.size(axis) == 1:
        return params
    from . import collectives
    out = dict(params)
    for k, dim in _EXPERT_LEAVES.items():
        if k in params:
            out[k] = collectives.all_gather(params[k], lay.mesh, axis,
                                            dim=params[k].dim() + dim)
    return out


# ---------------------------------------------------------------------------
# trees of blocks
# ---------------------------------------------------------------------------


def shard_tree(full, shardings):
    """Each leaf of ``full`` cut to this rank's block (contiguous)."""
    return tree_mod.map(lambda t, s: s.shard(t).contiguous(), full,
                        shardings)


def gather_tree(blocks, shardings):
    """Each leaf of ``blocks`` gathered whole (no autograd)."""
    with torch.no_grad():
        return tree_mod.map(lambda t, s: s.gather(t), blocks, shardings)


def block_bytes(struct, shardings) -> int:
    """Bytes of one rank's blocks of ``struct`` (tensors or meta tensors)
    under ``shardings``."""
    return sum(math.prod(s.block_shape(t.shape)) * t.element_size()
               for t, s in zip(tree_mod.leaves(struct),
                               tree_mod.leaves(shardings)))


def reduce_grads(grads, shardings):
    """Each block's gradient summed over the axes its leaf is replicated
    on (the gathers' backward already summed over the named ones): every
    copy of a block then holds the gradient of the whole loss."""
    from . import collectives
    out = []
    for g, s in zip(grads, shardings):
        for a in s.replicated_axes():
            if s.mesh.size(a) > 1:
                g = collectives.psum(g, s.mesh, a)
        out.append(g)
    return out


def global_sq_norm(grads, shardings) -> torch.Tensor:
    """The squared global norm of the whole gradient from every rank's
    blocks: each distinct block's fp32 sum of squares counted once (on its
    primary copy), summed over the mesh."""
    from . import collectives
    mesh = shardings[0].mesh
    dev = grads[0].device
    local = torch.zeros((), dtype=torch.float32, device=dev)
    for g, s in zip(grads, shardings):
        if s.is_primary():
            local = local + torch.sum(torch.square(g.float()))
    return collectives.psum(local.detach(), mesh)
