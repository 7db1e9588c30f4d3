"""Build the CUDA kernels from the sources in ``csrc/`` and load them.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``.  Libraries land in
``build/repro_torch/`` at the repository root (``REPRO_TORCH_BUILD``
overrides it), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built when this module is imported:
:func:`load` builds on first use, and :func:`build_all` starts one
``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("streamed_moe", "flash_attention", "ssd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, Tuple[float, str]] = {}    # name -> (seconds, ptxas log)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    root = Path(env) if env else \
        Path(__file__).resolve().parents[3] / "build" / "repro_torch"
    root.mkdir(parents=True, exist_ok=True)
    return root


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() \
        + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, (tmp, time.perf_counter(),
                 subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        BUILD_LOG.setdefault(name, (0.0, "cached"))
        return
    tmp, t0, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build_all(names: List[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source that is not built yet, all in parallel."""
    jobs = {n: _start(n) for n in names}
    for n, (out, job) in jobs.items():
        _finish(n, out, job)
    return {n: out for n, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def launch_on(device: int, fn, args) -> int:
    """Call a kernel's launch function as ``fn(*args, stream)`` on the
    current stream of CUDA device ``device`` (made the current device for
    the call if it is not) -> the function's cudaError code."""
    import torch
    if device == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device))
