"""Low-batch MoE serving with token buffering on the port (the paper's
target scenario): batched requests through the serving engine, slack 0
against slack 0.3: identical outputs, fewer cold-expert loads.

It serves on ``cuda`` (the fused engine's CUDA graphs, the
``streamed_moe`` kernel) unless ``--device cpu`` is given; asking for
``cuda`` where there is none raises.

  PYTHONPATH=src python examples/serve_low_batch_torch.py
  PYTHONPATH=src python examples/serve_low_batch_torch.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import Engine, ServeConfig


def run_engine(params, cfg, slack, prompts, device, n_threshold=None):
    eng = Engine(params, cfg, ServeConfig(max_batch=8, max_ctx=64,
                                          buffering_slack=slack, theta_min=3,
                                          n_threshold=n_threshold),
                 device=device)
    rids = [eng.submit(p, max_new=12) for p in prompts]
    t0 = time.time()
    outs = eng.run()
    dt = time.time() - t0
    return eng, [outs[r] for r in rids], dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config("granite-moe-1b-a400m").replace(dtype="float32")
    params = api.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=rng.integers(3, 10)).tolist()
               for _ in range(6)]

    eng0, outs0, dt0 = run_engine(params, cfg, 0.0, prompts, device)
    eng1, outs1, dt1 = run_engine(params, cfg, 0.3, prompts, device,
                                  n_threshold=3)

    if outs0 != outs1:
        raise AssertionError("token buffering must not change outputs")
    print("outputs identical with and without token buffering ✓\n")
    hdr = (f"{'':18s}{'iterations':>11s}{'deferrals':>10s}"
           f"{'expert loads':>13s}{'loads saved':>12s}")
    print(hdr)
    for label, e in (("slack=0.0", eng0), ("slack=0.3", eng1)):
        s = e.stats
        print(f"{label:18s}{s['iterations']:>11d}{s['deferrals']:>10d}"
              f"{s['expert_loads']:>13d}{s['expert_loads_saved']:>12d}")
    saved = eng1.stats["expert_loads_saved"]
    total = eng0.stats["expert_loads"]
    print(f"\ncold-expert DDR fetches avoided: {saved}/{total} "
          f"({100*saved/max(total,1):.1f}%) at "
          f"{eng1.stats['iterations']-eng0.stats['iterations']} extra "
          f"iterations (the paper's QoS-for-efficiency trade)")
    # per-layer paired-load order from live routing stats
    t = eng1.trace[0]
    print(f"\nexample paired-load order (iter {t['iter']}, layer "
          f"{t['layer']}): {t['order'][:8]}... "
          f"counts={t['counts'][t['order'][:8]].tolist()}")
    return {"engines": (eng0, eng1), "outputs": (outs0, outs1),
            "seconds": (dt0, dt1)}


if __name__ == "__main__":
    main()
