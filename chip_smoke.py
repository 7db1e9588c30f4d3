#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits 1:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version and the
   reference oracle on the card, at the serving path's shape and at a
   small odd shape, with CUDA-event median times and the byte bound;
4. slice: ``repro_torch.launch.serve`` serves 4 requests x 16 tokens of
   granite-moe-1b-a400m at full width in bf16; the kernel's launch count
   must equal the number of MoE-layer expert calls;
5. path parity: the same path in fp32 with kernels and with
   ``use_kernels(False)`` — prefill logits and greedy tokens must agree;
6. features: ``--schedule dynamic --slack 0.2`` and ``--weight-dtype fp8``;
7. profile: the slice once more under ``torch.profiler`` — device kernel
   time by name and the device's busy share of the wall time;
8. summary: one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
   name/power line, and the contract line
   ``{"ok": true, "device": {"platform": "gpu", ...}}`` last.

Weights are random from seed 0.  JAX is never imported.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

ARCH = "granite-moe-1b-a400m"
# Tolerances are max abs error over max |want|.  The plain version repeats
# the kernel's arithmetic step for step (bf16 rounding of h included), so
# the kernel is held to it at 1e-5 in every format.  Against the fp32
# oracle: the reference's KERNEL_TOL (tests/test_quantization.py) for the
# fp32, int8 and fp8 paths; bf16 rounds h before the down GEMM, as the
# Pallas kernel does, so it is held at 3e-2 there.
PLAIN_TOL = 1e-5
ORACLE_TOL = {"fp32": 2e-5, "int8": 2e-5, "fp8": 2e-5, "bf16": 3e-2}
# fp32 path parity: kernel path vs plain path prefill logits, max abs
# error over max |logit| (both accumulate in fp32, in other orders)
LOGIT_TOL = 1e-4
# a greedy token may differ only where the plain run's top-2 logit
# margin is below this (the order of fp32 sums can flip such a tie)
MARGIN_TOL = 1e-3
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "fp8": 1979e12}
WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(phase, msg):
    print(f"[{phase}] FAIL: {msg}", flush=True)
    sys.exit(1)


def median_ms(fn, reps=30, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def streamed_moe_bound_ms(E, C, d, m, wdt, x_bytes, gated=True):
    """Least time for one call: each input read once, the fp32 output
    written once, against the multiply-adds of both GEMMs."""
    n_mats = 3 if gated else 2
    weights = n_mats * E * d * m * WEIGHT_BYTES[wdt]
    scales = 0 if wdt not in ("int8", "fp8") else 4 * E * ((n_mats - 1) * m + d)
    moved = weights + scales + E * C * d * x_bytes + E * C * d * 4
    ops = 2 * E * C * d * m * n_mats
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[wdt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------


def phase_env():
    import torch
    if not torch.cuda.is_available():
        fail("env", "torch.cuda.is_available() is False: this smoke test "
                    "needs an NVIDIA GPU")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail("env", f"the repro_torch package is not next to chip_smoke.py "
                    f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave no output"
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device "
               f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("env", f"nvidia-smi: {card}")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    for name, (secs, out) in build.BUILD_LOG.items():
        regs = [ln.split("info    :")[-1].strip() for ln in out.splitlines()
                if "registers" in ln]
        log("build", f"{name}: nvcc {secs:.1f}s sm_90a; ptxas: "
                     f"{sorted(set(regs))}")
    log("build", f"all kernels built in {time.perf_counter() - t0:.1f}s")


def _moe_inputs(E, C, d, m, act, x_dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    xe = torch.randn(E, C, d, **kw).to(x_dtype)
    wg = torch.randn(E, d, m, **kw) / d ** 0.5
    wu = torch.randn(E, d, m, **kw) / d ** 0.5
    wd = torch.randn(E, m, d, **kw) / m ** 0.5
    return xe, (wg if act == "swiglu" else None), wu, wd


def _stream_operands(wg, wu, wd, wdt):
    from repro_torch.kernels import quant
    if wdt in quant.QUANTIZED:
        (qg, sg), (qu, su), (qd, sd) = [
            quant.quantize(w, wdt) if w is not None else (None, None)
            for w in (wg, wu, wd)]
        return (qg, qu, qd), dict(s_g=sg, s_u=su, s_d=sd)
    return tuple(quant.storage_cast(w, wdt) for w in (wg, wu, wd)), {}


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    main = None
    E, C, d, m = 32, 64, 1024, 512          # granite, 8 slot rows, top-8
    cases = [(E, C, d, m, "swiglu", wdt) for wdt in ("bf16", "fp32", "int8",
                                                     "fp8")]
    cases += [(4, 37, 256, 96, act, wdt) for act in ("relu2", "gelu")
              for wdt in ("fp32", "bf16", "int8", "fp8")]
    for (E_, C_, d_, m_, act, wdt) in cases:
        x_dtype = torch.float32 if wdt == "fp32" or C_ == 37 else torch.bfloat16
        xe, wg, wu, wd = _moe_inputs(E_, C_, d_, m_, act, x_dtype)
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        got = sm.streamed_moe_kernel(xe, *ws, activation=act, **scales)
        torch.cuda.synchronize()
        plain = ref.streamed_moe_plain(xe, *ws, act, **scales)
        oracle = ref.streamed_moe_quant_ref(xe, wg, wu, wd, act, wdt)
        if not torch.isfinite(got).all():
            fail("kernels", f"non-finite output {act} {wdt}")
        err_plain = (got - plain).abs().max().item()
        rel_plain = err_plain / plain.abs().max().item()
        rel_oracle = ((got - oracle).abs().max() / oracle.abs().max()).item()
        tol = ORACLE_TOL[wdt]
        line = (f"streamed_moe E={E_} C={C_} d={d_} m={m_} {act} w={wdt} "
                f"x={str(x_dtype)[6:]}: max_abs_err vs plain {err_plain:.3e} "
                f"(rel {rel_plain:.3e}, tol {PLAIN_TOL:g}), rel vs oracle "
                f"{rel_oracle:.3e} (tol {tol:g})")
        if rel_plain > PLAIN_TOL or rel_oracle > tol:
            fail("kernels", line)
        if C_ == C:
            ms = median_ms(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, **scales))
            plain_ms = median_ms(lambda: ref.streamed_moe_plain(
                xe, *ws, act, **scales))
            bound, by = streamed_moe_bound_ms(E_, C_, d_, m_, wdt,
                                              xe.element_size())
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"bound {bound * 1e3:.1f} us ({by})")
            if wdt == "bf16":
                main = dict(max_abs_err=err_plain, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by)
        log("kernels", line)
    return main


def _serve(argv):
    from repro_torch.launch import serve
    return serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"] + argv))


def _n_moe(cfg):
    return sum(1 for f in cfg.ffn_kinds() if f == "moe")


def _check_on_card(res, phase):
    bad = [k for k, t in _leaves(res["params"]) if not t.is_cuda]
    bad += [k for k, t in _leaves(res["engine"].caches) if not t.is_cuda]
    if bad:
        fail(phase, f"tensors on the CPU: {bad[:5]}")


def _leaves(tree, prefix=""):
    import torch
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")


def phase_slice(kernel_ms):
    import torch
    from repro_torch.kernels import streamed_moe as sm
    torch.cuda.reset_peak_memory_stats()
    sm.LAUNCHES = 0
    res = _serve(["--requests", "4", "--prompt-len", "8", "--max-new", "16"])
    launches = sm.LAUNCHES
    eng, cfg = res["engine"], res["cfg"]
    peak = torch.cuda.max_memory_allocated()
    toks = [t for seq in res["outs"].values() for t in seq]
    if len(toks) != 64:
        fail("slice", f"{len(toks)} tokens emitted, want 64")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        fail("slice", "token id out of the vocabulary")
    expected = _n_moe(cfg) * (4 + eng.stats["iterations"])
    if launches != expected:
        fail("slice", f"streamed_moe launched {launches} times, want "
                      f"{expected} MoE-layer calls")
    _check_on_card(res, "slice")
    n_params = sum(t.numel() for _, t in _leaves(res["params"]))
    tps = len(toks) / res["seconds"]
    log("slice", f"{ARCH} full width bf16 ({n_params / 1e9:.3f} B params, "
                 f"{cfg.num_layers} layers): 4 requests x 16 tokens = "
                 f"{len(toks)} tokens in {res['seconds']:.3f}s ({tps:.1f} "
                 f"tok/s), {eng.stats['iterations']} decode iterations, "
                 f"streamed_moe launches {launches} == {expected} MoE calls, "
                 f"peak memory {peak / 2**30:.2f} GiB")
    log("slice", f"streamed_moe share of wall time ~ launches x median "
                 f"kernel ms / wall = {launches * kernel_ms / 1e3 / res['seconds']:.3f}")
    return launches


def phase_profile():
    """The slice once more under torch.profiler: device kernel time by
    kernel name and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = _serve(["--requests", "4", "--prompt-len", "8", "--max-new", "16"])
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _, _ in rows) / 1e3
    log("profile", f"wall {res['seconds']:.3f}s, device kernel time "
                   f"{busy:.3f}s, busy share {busy / res['seconds']:.3f}")
    for ms, n, name in rows[:10]:
        log("profile", f"{ms:9.2f} ms {n:6d} x {name[:100]}")


def phase_parity():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving import Engine, ServeConfig

    class Recording(Engine):
        def _sample(self, lf):
            lf = np.asarray(lf, np.float32)
            top = np.sort(lf)[-2:]
            self.samples.append((int(lf.argmax()), float(top[1] - top[0])))
            return super()._sample(lf)

    cfg = get_config(ARCH).replace(dtype="float32")
    params = api.init_params(cfg, seed=0, device="cuda")
    spec = ExecutionSpec(strategy="capacity")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).tolist()
               for _ in range(4)]
    tokens = torch.as_tensor([prompts[0]], device="cuda")

    def run(kernels):
        with torch.no_grad(), ops.use_kernels(kernels):
            logits, _ = api.prefill_fn(params, {"tokens": tokens}, cfg, 32,
                                       spec=spec)
            eng = Recording(params, cfg, ServeConfig(max_batch=8, max_ctx=32,
                                                     spec=spec), device="cuda")
            eng.samples = []
            for p in prompts:
                eng.submit(p, max_new=16)
            eng.run()
        return logits, eng.samples

    lk, sk = run(True)
    lp, sp = run(False)
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    if not torch.isfinite(lk).all() or rel > LOGIT_TOL:
        fail("parity", f"fp32 prefill logits differ: rel {rel:.3e} > "
                       f"{LOGIT_TOL:g}")
    first = next((i for i, (a, b) in enumerate(zip(sk, sp)) if a[0] != b[0]),
                 None)
    min_margin = min(m for _, m in sp)
    if len(sk) != len(sp):
        fail("parity", f"sample counts differ: {len(sk)} vs {len(sp)}")
    if first is not None and sp[first][1] >= MARGIN_TOL:
        fail("parity", f"greedy tokens differ at sample {first} where the "
                       f"plain run's top-2 margin {sp[first][1]:.3e} >= "
                       f"{MARGIN_TOL:g}")
    where = "identical" if first is None else \
        f"first differ at sample {first} (plain margin {sp[first][1]:.3e})"
    log("parity", f"fp32 full width: prefill logits rel err {rel:.3e} "
                  f"(tol {LOGIT_TOL:g}); greedy tokens over {len(sk)} samples "
                  f"{where}; smallest plain top-2 margin {min_margin:.3e}")
    del params
    torch.cuda.empty_cache()


def phase_features():
    from repro_torch.kernels import streamed_moe as sm
    for argv in (["--schedule", "dynamic", "--slack", "0.2"],
                 ["--weight-dtype", "fp8"]):
        sm.LAUNCHES = 0
        res = _serve(["--requests", "4", "--prompt-len", "8",
                      "--max-new", "16"] + argv)
        eng, s = res["engine"], res["engine"].stats
        toks = [t for seq in res["outs"].values() for t in seq]
        if len(toks) != 64 or sm.LAUNCHES == 0:
            fail("features", f"{argv}: {len(toks)} tokens, "
                             f"{sm.LAUNCHES} launches")
        if "--schedule" in argv and s["dynamic_schedules"] == 0:
            fail("features", "dynamic schedule never ran")
        if "--weight-dtype" in argv and sm.LAUNCHES != \
                _n_moe(res["cfg"]) * (4 + s["iterations"]):
            fail("features", f"fp8: {sm.LAUNCHES} launches")
        _check_on_card(res, "features")
        log("features", f"{' '.join(argv)}: {len(toks)} tokens in "
                        f"{res['seconds']:.3f}s, {s['iterations']} iterations, "
                        f"deferrals {s['deferrals']}, loads saved "
                        f"{s['expert_loads_saved']}, dynamic schedules "
                        f"{s['dynamic_schedules']}, launches {sm.LAUNCHES}")
        del res, eng


def main():
    try:
        card = phase_env()
        import torch
        phase_build()
        main_k = phase_kernels()
        launches = phase_slice(main_k["ms"])
        phase_parity()
        phase_features()
        phase_profile()
        if "jax" in sys.modules:
            fail("summary", "jax was imported")
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("FAIL: a phase raised", flush=True)
        sys.exit(1)
    print(json.dumps({"kernels": [{
        "name": "streamed_moe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streamed_moe.cu",
        "replaces": "src/repro/kernels/streamed_moe.py:201",
        "launches": launches, "max_abs_err": main_k["max_abs_err"],
        "ms": main_k["ms"], "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"], "bound_by": main_k["bound_by"],
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
