"""Random weights of a cell, drawn by the benchmark from ``--seed`` on the
device, in the port's parameter layout and the dtype they are served in.

The layout (key names, shapes, dtypes) is the port's own, read from its
initializer on the ``meta`` device, which allocates nothing; the values
are the benchmark's: every random leaf is a view into one flat buffer
filled by a few large ``normal_`` calls from a generator on the device,
then scaled in place.  The same seed gives the same tensors, so the
reference is handed the same weights by drawing them again once the
program's state is freed.

Scales follow the port's initializer: 0.02 for the embedding and the
router, 1/sqrt(fan-in) for every other matrix, norms at 1 (bias 0).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

CHUNK = 1 << 30                 # elements a normal_ call fills


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values[path]


def _scale(path: tuple, shape) -> float:
    if path[-1] in ("embed", "w_router"):
        return 0.02
    return shape[-2] ** -0.5


def layout(model_cfg):
    """The port's parameter tree on ``meta``: shapes and dtypes only."""
    from repro_torch.models import transformer
    return transformer.init_lm(model_cfg, generator=None, device="meta")


def draw(model_cfg, seed: int, device) -> dict:
    """The cell's weights for ``seed`` on ``device``."""
    tree = layout(model_cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    values, random_leaves = {}, []
    for path, t in _leaves(tree):
        if path[-1] == "scale":
            values[path] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif path[-1] == "bias":
            values[path] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            random_leaves.append((path, t))
    by_dtype: dict = {}
    for path, t in random_leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    for dtype, group in by_dtype.items():
        total = sum(t.numel() for _, t in group)
        flat = torch.empty((total,), dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        off = 0
        for path, t in group:
            n = t.numel()
            values[path] = flat[off:off + n].view(t.shape).mul_(
                _scale(path, t.shape))
            off += n
    return _rebuild(tree, values)
