"""Step analysis: collective bytes, FLOP counts and roofline terms (port of
``repro.launch.analysis``).

The reference parses the collectives out of a compiled program's HLO and
reads XLA's cost analysis.  The port has no compiled program: the
collectives count their own bytes as they run
(``parallel.collectives.BYTES``, each one's output per rank, the sum the
reference takes over output shapes), and :func:`step_cost` counts a run's
FLOPs with ``torch.utils.flop_counter.FlopCounterMode``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.parallel import collectives

# One NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's H100 data sheet
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction (900 GB/s both)
# the largest shared memory one thread block may take on compute
# capability 9.0 (CUDA C++ Programming Guide, "Technical Specifications
# per Compute Capability"): the kernel working-set budget
SMEM_BYTES = 227 * 2 ** 10

_COLLECTIVES = collectives.CATEGORIES


def collective_bytes() -> Dict[str, float]:
    """Per-category byte totals this rank's collectives delivered since
    ``collectives.reset_counters()``, in the reference's dict: each
    category, ``count`` (collectives issued) and ``total``."""
    out = {c: float(collectives.BYTES.get(c, 0)) for c in _COLLECTIVES}
    out["count"] = int(sum(collectives.COUNTS.values()))
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def step_cost(fn, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` -> {"flops": this
    rank's FLOPs} (the counterpart of the reference's ``cost_dict`` /
    ``lowering_cost``).  There is no "bytes accessed": nothing here sees
    the memory traffic of the operators."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> Dict[str, float]:
    """Three roofline terms in seconds.

    ``flops``/``hbm_bytes``/``coll_bytes`` are GLOBAL totals (summed over
    devices); the dry-run records per-device numbers × chips.
    """
    compute = flops / (chips * PEAK_FLOPS)
    memory = hbm_bytes / (chips * HBM_BW)
    collective = coll_bytes / (chips * LINK_BW)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dom[0], "bound_s": dom[1]}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N·D prefill / 2·N·B decode (active params)."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch            # one token per sequence
