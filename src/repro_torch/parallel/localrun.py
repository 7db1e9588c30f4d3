"""Start N ``torch.distributed`` ranks on this host and collect what each
returns: the port's counterpart of the reference's
``--xla_force_host_platform_device_count`` mesh of fake devices.

    from repro_torch.parallel import localrun
    results = localrun.run(worker, 8, *args)      # [worker(0, 8, *args), ...]

Each rank is a spawned process: it joins a gloo group through a file
store in a temporary directory, takes one intra-op thread
(``torch.set_num_threads(1)``), runs ``fn(rank, world_size, *args)`` and
sends back its result, which must pickle (numpy arrays and Python values;
not CUDA tensors).  ``fn`` must be importable by name (a module-level
function), since the ranks import it afresh.  A rank that raises fails
the run with its traceback; the others are then stopped.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import traceback

TIMEOUT_S = 600


def _rank_main(rank, world_size, store_path, fn, args, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            results.put((rank, fn(rank, world_size, *args), None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


def run(fn, world_size: int, *args):
    """-> [fn(r, world_size, *args) for each rank r], run as ``world_size``
    processes joined in one gloo process group; a rank that has not
    answered within TIMEOUT_S seconds fails the run."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world_size, store, fn, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        out, errors = {}, []
        try:
            while len(out) + len(errors) < world_size:
                try:
                    rank, value, err = results.get(timeout=TIMEOUT_S)
                except queue_mod.Empty:
                    raise TimeoutError(f"localrun: no result within "
                                       f"{TIMEOUT_S} s") from None
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                    break
                out[rank] = value
            if not errors:
                for p in procs:
                    p.join(TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    if errors:
        raise RuntimeError("localrun: a rank failed\n" + "\n".join(errors))
    return [out[r] for r in range(world_size)]
