"""What every cell shares: finding its files by name, the run's context,
the modules a run may not load, and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``, one
per kind of window).  Each metric that ``BENCHMARK.json`` gives the cell
is read by ``metrics/<metric>.py`` (or the reader of its stem, the
name up to its first dot), a function ``read(ctx)`` that
returns a number or None (nothing to read: the metric is left out).  So
a configuration, a cell or a metric is added as files, and no file that
is here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    """A traffic mix: the parameters ``traffic.Traffic`` (or a scoring
    driver) reads."""
    return _json(HERE / "mixes" / f"{name}.json")


def load(cell_name: str, bench: dict):
    """(cell, configuration, mix) of a cell, held to its entry in
    ``BENCHMARK.json``."""
    c = cell(cell_name)
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell_name)
    if entry is None:
        raise KeyError(f"{cell_name!r} is not a workload of BENCHMARK.json")
    for key in ("config", "traffic", "chips"):
        if c[key] != entry[key]:
            raise ValueError(f"{cell_name}: {key} is {c[key]!r} in its file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    return c, config(c["config"]), mix(c["traffic"])


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module("drivers", name)


def metric_reader(name: str):
    """``metrics/<name>.py``, or where there is none, the reader of the
    name's stem (the part before its first dot): ``device_idle.chat``
    and ``device_idle.score`` share ``metrics/device_idle.py``."""
    stem = name.split(".")[0]
    if not (HERE / "metrics" / f"{name}.py").exists() and \
            (HERE / "metrics" / f"{stem}.py").exists():
        name = stem
    return _module("metrics", name)


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end ones,
    or with ``trace`` its per-layer ones.  A metric with ``workloads``
    belongs to the cells listed; an end-to-end one without, to every
    cell; a per-layer one without, to every cell that reports the
    end-to-end metric it ``moves``."""
    def listed(m):
        return "workloads" not in m or cell_name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file: the registry
    entry at the file's depth, dtype and tying of the output head to the
    embedding.  Every other number the file states must be the
    registry's, so the file is what runs."""
    from repro_torch.configs import get_config
    base = get_config(conf["registry"])
    cfg = base.replace(num_layers=int(conf["num_hidden_layers"]),
                       dtype=conf["dtype"],
                       tie_embeddings=bool(conf["tie_word_embeddings"]))
    want = {"hidden_size": cfg.d_model,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "vocab_size": cfg.vocab_size,
            "rope_theta": cfg.rope_theta,
            "n_routed_experts": cfg.moe.num_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "moe_intermediate_size": cfg.moe.d_expert,
            "n_shared_experts": cfg.moe.num_shared_experts,
            "capacity_factor": cfg.moe.capacity_factor,
            "router_aux_loss_coef": cfg.moe.aux_loss_coef}
    bad = {k: (conf.get(k), v) for k, v in want.items()
           if float(conf.get(k, -1)) != float(v)}
    if bad:
        raise ValueError(f"{conf['name']}: the file's numbers differ from "
                         f"the port's registry entry (file, port): {bad}")
    return cfg


@dataclass
class Context:
    """One run: its inputs, and what the driver recorded for the readers.

    Times are ``time.perf_counter()`` seconds.  ``window`` is the measured
    window ``(open, close)``; ``steps`` and ``requests`` (serving) or
    ``calls`` (scoring) what happened in and around it; ``counters`` the
    program's counters at the window's open and close; ``profile`` the
    traced segment's summary (``profiling.Summary``) when ``--trace 1``."""
    cell_name: str
    cell: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    model_cfg: Any = None
    t_start: float = 0.0
    window: tuple = (0.0, 0.0)
    steps: list = field(default_factory=list)
    requests: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)
    counters: Dict[str, dict] = field(default_factory=dict)
    profile: Any = None
    checks: Dict[str, dict] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def stamp(self, name: str) -> None:
        """Record how far into the run a set-up phase ended (seconds)."""
        self.extra.setdefault("setup_stamps", {})[name] = round(
            now() - self.t_start, 3)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def check(self, name: str, value: float, limit: float,
              bad_when: str = "above") -> bool:
        """Record a compared number beside its limit; True if it holds."""
        ok = value <= limit if bad_when == "above" else value >= limit
        self.checks[name] = {"value": value, "limit": limit, "ok": ok}
        return ok


def weight_bits(model_cfg, spec=None) -> float:
    """Bits of each expert weight as the program streams it: the
    ``weight_dtype`` of its execution spec, or the ambient one, or else
    the dtype the weights are stored in.  A cell holds it to the bits of
    the dtype its configuration states (``check`` in the drivers), so a
    program that quantizes its experts by default runs another
    configuration and is not correct."""
    import torch
    from repro_torch.kernels import quant
    name = getattr(spec, "weight_dtype", None) or quant.weight_dtype()
    stored = torch.finfo(getattr(torch, model_cfg.dtype)).bits
    return 8.0 * quant.weight_bytes(name, default=stored / 8)


def stated_bits(conf: dict) -> float:
    import torch
    return float(torch.finfo(getattr(torch, conf["dtype"])).bits)


def loaded_forbidden() -> List[str]:
    """Modules in this process whose top-level name is one the benchmark
    may not load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def now() -> float:
    return time.perf_counter()


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a cell's first run there builds."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build / "repro_torch")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(build / "autotune")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
