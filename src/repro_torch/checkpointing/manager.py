"""Atomic checkpointing with auto-resume (port of
``repro.checkpointing.manager``), in the reference's layout:

  <dir>/step_00000100.tmp-<pid>/   (written fully, fsync'd)
  <dir>/step_00000100/             (atomic rename: crash-safe)
  <dir>/LATEST                     (text pointer, written last)

Each step directory holds ``arrays.npz``, one array per leaf keyed by its
path (``repro_torch.tree``: dict key, sequence index or ``.field``,
joined by ``/``, as the reference keys them), and ``meta.json``.  A
params checkpoint the reference wrote therefore restores here.  bf16
tensors are stored as fp32 arrays (numpy has no bf16; fp32 holds them
exactly) and cast back on restore; a bf16 array the reference wrote is
read by its bits.

On a mesh of ranks (``launch.steps``), :func:`save` with ``shardings``
gathers each leaf from the ranks' blocks and rank 0 writes the same
layout and keys, and :func:`restore` with ``shardings`` gives each rank
its block of every leaf on whatever mesh the shardings name: the elastic
reshard (a checkpoint taken on one mesh reloads onto another, or onto one
device).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod

def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor,
                sharding=None) -> torch.Tensor:
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        # a bf16 leaf the reference wrote (read back as 2-byte void
        # without ml_dtypes): reinterpret its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if sharding is not None:                 # this rank's block, cut on the host
        t = sharding.shard(t).contiguous()
    device = "cpu" if like.device.type == "meta" else like.device
    return t.to(device=device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None, shardings: Any = None) -> str:
    """Write ``tree`` as step ``step``.  ``shardings`` (a matching tree of
    ``parallel.sharding.NamedSharding``): ``tree`` holds this rank's
    blocks; every rank of the world must call, rank 0 writes, and all
    return once the step is published."""
    if shardings is not None:
        import torch.distributed as dist
        from repro_torch.parallel.sharding import gather_tree
        full = gather_tree(tree, shardings)
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        if dist.get_rank() == 0:
            path = save(ckpt_dir, step, full, extra)
        dist.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: _to_numpy(v) for k, v in tree_mod.leaves_with_path(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "keys": sorted(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        # the pointer is ahead of a crash: the newest complete step
        steps = all_steps(ckpt_dir)
        return steps[-1] if steps else None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings: Any = None):
    """Restore into the structure of ``like``: each tensor takes the dtype
    and device of its ``like`` leaf (the CPU for a ``meta`` one).
    ``shardings``: a matching tree of ``parallel.sharding.NamedSharding``
    on this rank's mesh; each leaf is then this rank's block of the
    stored one.  -> (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    flat = list(tree_mod.leaves_with_path(like))
    missing = {k for k, _ in flat} - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    shards = tree_mod.leaves(shardings) if shardings is not None \
        else [None] * len(flat)
    restored = [_from_numpy(data[k], leaf, sh)
                for (k, leaf), sh in zip(flat, shards)]
    return (tree_mod.unflatten(like, restored), meta["step"],
            meta.get("extra", {}))


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and ".tmp" not in d)


def gc_old(ckpt_dir: str, keep: int = 3):
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
