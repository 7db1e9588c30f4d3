#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits 1:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version and the
   reference oracle on the card, at its path's shapes and at small odd
   ones (the bf16 tensor-core paths of flash attention and streamed_moe
   included, held element by element; streamed_moe's int8 / fp8 weights
   with bf16 and fp32 activations; SSD with B and C per group, g = 1 and
   g = h), with the time of one call of each
   kernel with its host work beside its device time per call, the bound,
   and for flash attention the times of ``F.scaled_dot_product_attention``
   on the same tensors;
4. slice: ``repro_torch.launch.serve`` serves 4 requests x 16 tokens of
   granite-moe-1b-a400m at full width in bf16 on the default fused engine:
   a first run captures the CUDA graphs (capture seconds logged), a second
   run on the same engine replays them: no new capture, ``nb + 1`` host
   syncs per steady iteration, and streamed_moe launches (the wrapper's
   count plus captured launches x replays) equal to the MoE-layer calls;
   its wall, tok/s and peak memory;
5. fused: the fused engine against the eager per-layer loop on the card
   (bf16, full width, the same prompts): static, ``--schedule dynamic
   --slack 0.2`` and chunked admission; tokens, the trace record for
   record and the statistics must be identical;
6. traffic: ``Scheduler`` + ``run_closed_loop`` over 16 Poisson requests
   (prompts about 64 tokens, 16-token chunks, max_batch 8) on the
   iteration clock: all complete, none dropped; TTFT / TPOT / queue delay
   in iterations and modeled seconds, wall tok/s, prefill chunks, host
   syncs per iteration and the streamed_moe launches at C = 1024;
7. path parity: the same serving path in fp32 with kernels and with
   ``use_kernels(False)`` (fused engines both) — prefill logits and
   greedy tokens must agree;
8. features: ``--schedule dynamic --slack 0.2`` and ``--weight-dtype fp8``
   on the fused engine (its streamed_moe launch count, 24 per prefill and
   decode iteration, is the ``serve_fp8`` path's);
9. forward: ``api.loss_fn`` scores 2 x 2048 tokens of granite-moe-1b-a400m
   at full width in bf16 through the flash and streamed_moe kernels (24
   launches each), then the same batch in fp32 with kernels and with
   ``use_kernels(False)``: losses within 1e-4, argmax agreement reported;
10. mamba: ``api.loss_fn`` over 2 x 2048 tokens of mamba2-370m at full
   width in bf16, then each layer's ``mamba2_block`` with the SSD kernel
   (48 launches, B and C per group: n_groups = 1) against the plain path on
   the same activations, in bf16 (reported) and fp32 (within 2e-5);
11. profile: the fused slice (bf16, then ``--weight-dtype fp8``) and the
    traffic run on engines whose graphs are captured, and both scoring
    losses, once more under ``torch.profiler`` — device kernel time by
    name, the device's busy share of the wall time, and the profiler's
    ``up_kernel`` launches against the counted ones;
12. summary: one ``{"kernels": [...]}`` JSON line with one entry per
    kernel and path (``streamed_moe`` on the serve path in bf16 and in fp8,
    on the chunked-prefill path of the traffic run (``serve_chunked``, C =
    1024) and on the forward path, ``flash_attention`` on the forward path,
    ``ssd`` on the mamba path),
    each with that path's launches and its shape's times (``ms`` one call
    with its host work, ``device_ms`` the device time per call) and bound; the
    ``nvidia-smi`` name/power line; and the contract line
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
# streamed_moe.  Tolerances are max abs error over max |want|.  On every path
# but bf16 x bf16 (fp32 activations, or fp32 / int8 / fp8 weights, the 8-bit
# ones on the tensor cores with fp32-exact products) the plain version
# repeats the kernel's arithmetic step for step (bf16 rounding of h
# included), so the kernel is held to it at 1e-5.  Against the fp32 oracle:
# the reference's KERNEL_TOL (tests/test_quantization.py) for the fp32, int8
# and fp8 paths; bf16 rounds h before the down GEMM, as the Pallas kernel
# does, so it is held at 3e-2 there.
PLAIN_TOL = 1e-5
ORACLE_TOL = {"fp32": 2e-5, "int8": 2e-5, "fp8": 2e-5, "bf16": 3e-2}
# Two fp32 dot products of K terms taken in other orders, one on the tensor
# cores (whose sums truncate rather than round to nearest) and one in the
# plain version, differ by at most DOT_GAMMA * K * sum_k |a_k b_k| (K 2^-23
# for the first, K 2^-24 for the second).
DOT_GAMMA = 1.5 * 2.0 ** -23
# bf16 activations x bf16 weights run on the tensor cores, so a bf16
# rounding of h may flip and move the output by ~2^-8 |h_j w_j|.  That path
# is held in two parts (moe_bf16_check):
# (a) h element by element against the plain h: within one bf16 ulp plus
#     the image, through the activation, of the dot-product bound
#     DOT_GAMMA * K * sum_k |x_k w_k| of each pre-activation (|silu'| <= 1.1,
#     |gelu'| <= 1.13, and relu(u)^2 moves by at most du (2|u| + du)), plus
#     2^-20 |h| for the two activations' own fp32 evaluation (one ulp alone
#     does not hold: where a pre-activation cancels, its two sums differ by
#     more than an ulp of h); and at most MOE_FLIP_SHARE of the elements
#     differing;
# (b) the down product: out against einsum(h_kernel, w_d) in fp32 within
#     MOE_DOWN_TOL of max |out| (only the order of fp32 sums differs).
MOE_FLIP_SHARE = 1e-2
MOE_DOWN_TOL = 1e-5
# fp32 path parity: kernel path vs plain path prefill logits, max abs
# error over max |logit| (both accumulate in fp32, in other orders)
LOGIT_TOL = 1e-4
# a greedy token may differ only where the plain run's top-2 logit
# margin is below this (the order of fp32 sums can flip such a tie)
MARGIN_TOL = 1e-3
# the scoring forward in fp32: the share of positions whose argmax may
# differ where the plain run's top-2 margin is MARGIN_TOL or more (a
# flipped top-k tie moves a token between capacity slots)
ARGMAX_MISS = 1e-3
# Flash attention.  fp32: max abs error over max |want| within 1e-5 of the
# plain version.  bf16, element by element: the plain version repeats the
# kernel's arithmetic (its scores and PV products from the tensor cores, as
# the kernel's), but its other fp32 sums (l, acc) run in another order, so a
# rounding of p or of the output may flip by one ulp; each element is held
# within FLASH_BF16_ULPS bf16 ulps of the plain one (plus 1e-6), and at most
# FLASH_FLIP_SHARE of the elements may differ at all.  Against the exact
# fp32 attention, each element is held to the error the bf16 roundings can
# make: p rounded (unit roundoff u = 2^-8 of p, so u * sum p|v| / l) and the
# output rounded (u |o|), times FLASH_BOUND_SLACK for the fp32 sums.
# Against the oracle: the reference's max-abs tolerances (tests/test_kernels.py).
FLASH_PLAIN_TOL = 1e-5
FLASH_BF16_ULPS = 2
FLASH_FLIP_SHARE = 1e-2
FLASH_BOUND_SLACK = 1.05
FLASH_ORACLE_TOL = {"fp32": 2e-4, "bf16": 4e-2}
# SSD: 1e-5 against its plain version, the reference's 2e-5 against the oracle
SSD_PLAIN_TOL = 1e-5
SSD_ORACLE_TOL = 2e-5
# the scoring forward in fp32, kernels vs use_kernels(False): relative loss
LOSS_TOL = 1e-4
# the Mamba-2 block in fp32 with and without the SSD kernel, max abs error
# over max |want|
BLOCK_TOL = 2e-5
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}
# the scoring runs (phases 7 and 8): batch x sequence, random tokens
SCORE_B, SCORE_S = 2, 2048
# the traffic run's engine: 8 slots, 16-token prefill chunks, so a prefill
# chunk's MoE runs drop-free at C = 8 * 16 * top_k = 1024 rows per expert
TRAFFIC_BATCH, CHUNK = 8, 16
C_CHUNK = TRAFFIC_BATCH * CHUNK * 8
# the traffic stream: TrafficConfig(num_requests=16, rate=0.5,
# avg_prompt=64, max_prompt=128, min_new=2, max_new=32, mix="poisson",
# seed=0), arrivals on the iteration clock
TRAFFIC_ARGV = ["--traffic", "--traffic-requests", "16", "--traffic-rate",
                "0.5", "--avg-prompt", "64", "--prompt-len", "64",
                "--max-new", "32", "--chunk-tokens", str(CHUNK),
                "--max-batch", str(TRAFFIC_BATCH)]
# engine statistics that fused and eager serving must share (the eager
# loop counts no host syncs)
SHARED_STATS = ("deferrals", "expert_loads", "expert_loads_saved",
                "dynamic_schedules", "iterations", "tokens_emitted",
                "prefill_chunks", "prefill_tokens")
MAMBA = "mamba2-370m"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(phase, msg):
    print(f"[{phase}] FAIL: {msg}", flush=True)
    sys.exit(1)


def median_ms(fn, reps=30, warmup=3):
    """Median CUDA-event time of one call, host work included: the events
    bracket the Python call, so a call whose host work outlasts its device
    work reads the host's time."""
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


def device_ms(fn, reps=20, warmup=3):
    """Device time of one call: ``reps`` calls queued back to back behind a
    spin kernel long enough that the host has queued them all before the
    card reaches the first, so the card runs them without waiting for the
    host.  Returns (ms per call, whether the queue stayed ahead of the card;
    if it did not, the time includes host gaps)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    for attempt in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 ** attempt * 4e9 * (host_s * reps + 1e-3)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            break
    return a.elapsed_time(b) / reps, ahead


def kernel_times(fn):
    """A kernel wrapper's times: ``ms`` the median time of one call with its
    host work (``median_ms``, the kernels line's ``ms``), ``device_ms`` its
    device time per call (``device_ms``); -> (times, text)."""
    dev, ahead = device_ms(fn)
    times = dict(ms=median_ms(fn), device_ms=dev)
    behind = "" if ahead else "; queue fell behind"
    text = (f"kernel {times['ms']:.4f} ms a call with its host work "
            f"({dev:.4f} ms on the device{behind})")
    return times, text


def streamed_moe_bound_ms(E, C, d, m, wdt, x_bytes, gated=True):
    """Least time for one call: each input read once, the fp32 output
    written once, against the multiply-adds of both GEMMs at the peak of
    their operands' type (bf16 unless x or the weights are fp32; 8-bit
    weights meet bf16 activations, so not the int8 / fp8 rate)."""
    n_mats = 3 if gated else 2
    weights = n_mats * E * d * m * WEIGHT_BYTES[wdt]
    scales = 0 if wdt not in ("int8", "fp8") else 4 * E * ((n_mats - 1) * m + d)
    moved = weights + scales + E * C * d * x_bytes + E * C * d * 4
    ops = 2 * E * C * d * m * n_mats
    return _bound(moved, ops, "fp32" if wdt == "fp32" or x_bytes == 4
                  else "bf16")


def _bound(moved, ops, kind):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(B, Sq, Sk, H, hd, kind, elt):
    """q, k, v read once and o written once, against the multiply-adds of
    both products over the (query, key) pairs the causal mask keeps."""
    pairs = Sq * (Sk - Sq) + Sq * (Sq + 1) // 2
    return _bound(elt * B * H * hd * (2 * Sq + 2 * Sk), 4 * hd * pairs * B * H,
                  kind)


def ssd_bound_ms(b, nc, c, h, g, p, n):
    """x, B and C (per group) and A_cumsum read once, Y_diag and the states
    written once (fp32), against the fp32 multiply-adds (67 TFLOP/s) of C B^T
    once per group and of (G o L) x per head over the causal (i >= j) pairs,
    and of the state product."""
    heads, groups = b * nc * h, b * nc * g
    pairs = c * (c + 1) // 2
    moved = 4 * (heads * c * 2 * p + groups * c * 2 * n + heads * c
                 + heads * p * n)
    ops = groups * 2 * pairs * n + heads * (2 * pairs * p + 2 * c * n * p)
    return _bound(moved, ops, "fp32")


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


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
    return {"streamed_moe": _check_streamed_moe(), "flash_attention":
            _check_flash(), "ssd": _check_ssd()}


def moe_bf16_check(h, out, h_plain, xe, w_g, w_u, w_d, act):
    """The bf16 x bf16 streamed_moe held as the MOE_* comment says: ``h``
    and ``out`` are the kernel's scratch and output, ``h_plain`` the plain
    version's h.  Returns (ok, metrics): ``over`` the largest h error over
    its bound, ``flips`` the share of h elements that differ, ``beyond_ulp``
    how many differ by more than one bf16 ulp, ``down`` the down product's
    error over max |out|."""
    import torch
    import torch.nn.functional as F

    def mm(a, b):
        return torch.einsum("ecd,edm->ecm", a.float(), b.float())

    hk, hp, x = h.float(), h_plain.float(), xe.float()
    gamma = DOT_GAMMA * x.shape[-1]
    u, du = mm(x, w_u), gamma * mm(x.abs(), w_u.abs())
    if act == "swiglu":
        g, dg = mm(x, w_g), gamma * mm(x.abs(), w_g.abs())
        moved = (F.silu(g).abs() + 1.1 * dg) * du + 1.1 * u.abs() * dg
    elif act == "relu2":
        moved = du * (2 * u.abs() + du)
    else:
        moved = 1.13 * du
    diff = (hk - hp).abs()
    _, e = torch.frexp(torch.maximum(hk.abs(), hp.abs()))
    ulp = torch.ldexp(torch.ones_like(hp), e - 8)
    over = (diff / (ulp + moved + 2.0 ** -20 * hp.abs())).max().item()
    want = torch.einsum("ecm,emd->ecd", hk, w_d.float())
    down = ((out.float() - want).abs().max() / want.abs().max()).item()
    metrics = dict(over=over, flips=(diff > 0).float().mean().item(),
                   beyond_ulp=int((diff > ulp).sum().item()), down=down)
    ok = over <= 1.0 and metrics["flips"] <= MOE_FLIP_SHARE \
        and down <= MOE_DOWN_TOL
    return ok, metrics


def _check_streamed_moe():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    paths = {}
    E, C, d, m = 32, 64, 1024, 512          # granite, 8 slot rows, top-8
    C_SCORE = 1280                          # the scoring forward's capacity
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(E, C, d, m, "swiglu", wdt, f32 if wdt == "fp32" else bf)
             for wdt in ("bf16", "fp32", "int8", "fp8")]
    cases += [(E, C_, d, m, "swiglu", "bf16", bf) for C_ in (C_CHUNK, C_SCORE)]
    cases += [(4, 37, 256, 96, act, wdt, f32) for act in ("relu2", "gelu")
              for wdt in ("fp32", "bf16", "int8", "fp8")]
    # the tensor-core paths at ragged edges, and a down product with K = 1024
    cases += [(4, 37, 256, 96, act, wdt, bf) for act in ("relu2", "gelu")
              for wdt in ("bf16", "int8", "fp8")]
    cases += [(4, 64, 512, 1024, "swiglu", wdt, bf)
              for wdt in ("bf16", "int8", "fp8")]
    for (E_, C_, d_, m_, act, wdt, x_dtype) in cases:
        xe, wg, wu, wd = _moe_inputs(E_, C_, d_, m_, act, x_dtype)
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        h, got = sm._launch(xe, *ws, act, **scales)
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
                f"(rel {rel_plain:.3e}")
        if wdt == "bf16" and x_dtype == bf:   # bf16 x bf16 on the tensor cores
            ok, mt = moe_bf16_check(h, got, ref.streamed_moe_plain_h(
                xe, *ws, act, **scales), xe, *ws, act)
            line += (f"), h: at most {mt['over']:.3f} of its bound (tol 1), "
                     f"share differing {mt['flips']:.3e} (tol "
                     f"{MOE_FLIP_SHARE:g}), {mt['beyond_ulp']} beyond one "
                     f"ulp; down product rel {mt['down']:.3e} (tol "
                     f"{MOE_DOWN_TOL:g})")
        else:
            ok = rel_plain <= PLAIN_TOL
            line += f", tol {PLAIN_TOL:g})"
        line += f", rel vs oracle {rel_oracle:.3e} (tol {tol:g})"
        if not ok or rel_oracle > tol:
            fail("kernels", line)
        if (E_, d_, m_, act) == (E, d, m, "swiglu") and \
                C_ in (C, C_CHUNK, C_SCORE):
            times, text = kernel_times(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, **scales))
            plain_ms = median_ms(lambda: ref.streamed_moe_plain(
                xe, *ws, act, **scales))
            bound, by = streamed_moe_bound_ms(E_, C_, d_, m_, wdt,
                                              xe.element_size())
            line += (f"; {text}, plain {plain_ms:.4f} ms, "
                     f"bound {bound * 1e3:.1f} us ({by})")
            path = {("bf16", C): "serve", ("fp8", C): "serve_fp8",
                    ("bf16", C_CHUNK): "serve_chunked",
                    ("bf16", C_SCORE): "forward"}.get((wdt, C_))
            if path:
                paths[path] = dict(
                    max_abs_err=err_plain, **times, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
        log("kernels", line)
    return paths


def _flash_inputs(B, Sq, Sk, H, hd, dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, s, H, hd, generator=g, device="cuda").to(dtype)
            for s in (Sq, Sk, Sk)]


def flash_bf16_check(got, plain, q, k, v):
    """The bf16 flash output held element by element (see FLASH_BF16_ULPS).
    -> (ok, metrics): ``ulps`` the largest difference from the plain version
    in ulps of the plain element, ``flips`` the share of elements that
    differ, ``over`` the largest error against the exact fp32 attention over
    the bound the bf16 roundings allow."""
    import torch
    from repro_torch.kernels import ref
    got, plain = got.float(), plain.float()
    diff = (got - plain).abs()
    _, e = torch.frexp(plain)
    ulp = torch.where(plain == 0, torch.zeros_like(plain),
                      torch.ldexp(torch.ones_like(plain), e - 8))
    ulps = ((diff - 1e-6).clamp(min=0) / ulp).nan_to_num(posinf=1e9).max()
    qf, kf, vf = q.float(), k.float(), v.float()
    exact = ref.flash_attention_ref(qf, kf, vf)
    spread = ref.flash_attention_ref(qf, kf, vf.abs())     # sum p|v| / l
    bound = 2.0 ** -8 * (exact.abs() + spread) + 1e-6
    metrics = dict(ulps=ulps.item(), flips=(diff > 0).float().mean().item(),
                   over=((got - exact).abs() / bound).max().item())
    ok = metrics["ulps"] <= FLASH_BF16_ULPS and \
        metrics["flips"] <= FLASH_FLIP_SHARE and \
        metrics["over"] <= FLASH_BOUND_SLACK
    return ok, metrics


def _check_flash():
    """The scoring path's (2, 2048, 16, 64) in bf16 and fp32, odd S,
    Sk = 2 Sq, and in bf16 hd = 16 and ragged Sk > Sq; the bf16 path shape
    is the one the summary reports."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, S, H, hd = SCORE_B, SCORE_S, 16, 64
    main = None
    cases = [(B, S, S, H, hd, "bf16"), (B, S, S, H, hd, "fp32"),
             (1, 17, 17, 3, 64, "fp32"), (2, 100, 100, 4, 64, "bf16"),
             (1, 100, 200, 2, 64, "fp32"), (2, 64, 128, 4, 128, "bf16"),
             (2, 77, 77, 3, 16, "bf16"), (1, 100, 165, 2, 32, "bf16"),
             (1, 130, 301, 2, 64, "bf16")]
    for (B_, Sq, Sk, H_, hd_, kind) in cases:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        q, k, v = _flash_inputs(B_, Sq, Sk, H_, hd_, dtype)
        got = fa.flash_attention_kernel(q, k, v)
        torch.cuda.synchronize()
        plain = ref.flash_attention_plain(q, k, v)
        oracle = ref.flash_attention_ref(q, k, v)
        if not torch.isfinite(got).all():
            fail("kernels", f"flash non-finite output {(B_, Sq, Sk, H_, hd_)}")
        err_plain = (got.float() - plain.float()).abs().max().item()
        rel_plain, rel_oracle = rel_err(got, plain), rel_err(got, oracle)
        line = (f"flash_attention B={B_} Sq={Sq} Sk={Sk} H={H_} hd={hd_} {kind}: "
                f"max_abs_err vs plain {err_plain:.3e} (rel {rel_plain:.3e}")
        if kind == "fp32":
            bad = rel_plain > FLASH_PLAIN_TOL
            line += f", tol {FLASH_PLAIN_TOL:g})"
        else:
            ok, mt = flash_bf16_check(got, plain, q, k, v)
            bad = not ok
            line += (f"), per element: at most {mt['ulps']:.3f} ulps from "
                     f"plain (tol {FLASH_BF16_ULPS}), share differing {mt['flips']:.3e} (tol "
                     f"{FLASH_FLIP_SHARE:g}), error vs exact fp32 "
                     f"{mt['over']:.3f} of the bf16 rounding bound (tol "
                     f"{FLASH_BOUND_SLACK:g})")
        line += (f"; rel vs oracle {rel_oracle:.3e} (tol "
                 f"{FLASH_ORACLE_TOL[kind]:g})")
        if bad or rel_oracle > FLASH_ORACLE_TOL[kind]:
            fail("kernels", line)
        if Sq == S:
            times, text = kernel_times(
                lambda: fa.flash_attention_kernel(q, k, v))
            plain_ms = median_ms(lambda: ref.flash_attention_plain(q, k, v),
                                 reps=5, warmup=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            lib_ms, lib_dev = median_ms(sdpa), device_ms(sdpa)[0]
            bound, by = flash_bound_ms(B_, Sq, Sk, H_, hd_, kind,
                                       q.element_size())
            line += (f"; {text}, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
                     f"ms ({lib_dev:.4f} on the device), bound {bound * 1e3:.1f} us ({by})")
            if kind == "bf16":
                main = dict(max_abs_err=err_plain, **times, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        log("kernels", line)
    return {"forward": main}


def _check_ssd():
    """mamba2-370m's (b, nc, c, h, p, n) = (2, 8, 256, 32, 64, 128) with B and
    C per group as the path passes them (g = 1, the one the summary
    reports) and per head (g = h, the reference's layout), then a chunk of
    one partial tile (c = 32) and one whose last tile is partial after a
    full one (c = 100), each with g = 1 and g = h = 3."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd
    main = None
    shapes = [(SCORE_B, SCORE_S // 256, 256, 32, g, 64, 128) for g in (1, 32)]
    shapes += [(1, 3, 32, 3, g, 32, 16) for g in (1, 3)]
    shapes += [(1, 2, 100, 3, g, 64, 16) for g in (1, 3)]
    for shape in shapes:
        b, nc, c, h, g_, p, n = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(generator=gen, device="cuda")
        xc = torch.randn(b, nc, c, h, p, **kw)
        Bc, Cc = (torch.randn(b, nc, c, g_, n, **kw) for _ in range(2))
        Ac = -torch.rand(b, h, nc, c, **kw) * 0.1
        Acum = torch.cumsum(Ac, -1)
        got = ssd.ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, Acum)
        torch.cuda.synchronize()
        plain = ref.ssd_intra_chunk_plain(xc, Bc, Cc, Acum)
        oracle = ref.ssd_intra_chunk_ref(xc, Bc, Cc, Ac, Acum)
        if not all(torch.isfinite(t).all() for t in got):
            fail("kernels", f"ssd non-finite output {shape}")
        err_plain = max((a - w).abs().max().item() for a, w in zip(got, plain))
        rel_plain = max(rel_err(a, w) for a, w in zip(got, plain))
        rel_oracle = max(rel_err(a, w) for a, w in zip(got, oracle))
        line = (f"ssd_intra_chunk (b,nc,c,h,g,p,n)={shape}: max_abs_err vs "
                f"plain {err_plain:.3e} (rel {rel_plain:.3e}, tol "
                f"{SSD_PLAIN_TOL:g}), rel vs oracle {rel_oracle:.3e} (tol "
                f"{SSD_ORACLE_TOL:g})")
        if rel_plain > SSD_PLAIN_TOL or rel_oracle > SSD_ORACLE_TOL:
            fail("kernels", line)
        if c == 256:
            times, text = kernel_times(lambda: ssd.ssd_intra_chunk_kernel(
                xc, Bc, Cc, Ac, Acum))
            plain_ms = median_ms(lambda: ref.ssd_intra_chunk_plain(xc, Bc, Cc,
                                                                   Acum))
            bound, by = ssd_bound_ms(*shape)
            line += (f"; {text}, plain {plain_ms:.4f} ms, "
                     f"bound {bound * 1e3:.1f} us ({by})")
            if main is None:
                main = dict(max_abs_err=err_plain, **times, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=None)
        log("kernels", line)
    return {"mamba": main}


def _serve(argv):
    from repro_torch.launch import serve
    return serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"] + argv))


def _n_moe(cfg):
    return sum(1 for f in cfg.ffn_kinds() if f == "moe")


def _check_on_card(res, phase):
    from repro_torch.models.api import leaves
    bad = [k for k, t in leaves(res["params"]) if not t.is_cuda]
    bad += [k for k, t in leaves(res["engine"].caches) if not t.is_cuda]
    if bad:
        fail(phase, f"tensors on the CPU: {bad[:5]}")


def _launches(eng):
    """streamed_moe launches of an engine's runs since the counts were last
    set to 0: the wrapper's (eager calls, and the first call of each
    segment, made before its capture) plus the graphs' replays."""
    from repro_torch.kernels import streamed_moe as sm
    return sm.LAUNCHES + eng.graph_launches()


def _zero_counts(eng=None):
    """Set the launch counts to 0 (the graphs' replay counts too)."""
    from repro_torch.kernels import streamed_moe as sm
    sm.LAUNCHES = 0
    if eng is not None:
        for ms in eng._megasteps.values():
            ms.replays = dict.fromkeys(ms.replays, 0)


SLICE_ARGV = ["--requests", "4", "--prompt-len", "8", "--max-new", "16"]


def phase_slice(kernel_ms):
    """The default (fused) engine: a first run that captures the graphs,
    then a second run on the same engine that only replays them."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.api import leaves
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cold = _serve(SLICE_ARGV)
    eng, cfg = cold["engine"], cold["cfg"]
    ms = eng.megastep()
    nb = len(ms.boundaries)
    launches = _launches(eng)
    expected = _n_moe(cfg) * (4 + eng.stats["iterations"])
    if launches != expected:
        fail("slice", f"first run: streamed_moe launched {launches} times, "
                      f"want {expected} MoE-layer calls")
    log("slice", f"first run (captures): {cold['seconds']:.3f}s, "
                 f"{ms.captures} graphs captured in {ms.capture_s:.3f}s, "
                 f"streamed_moe launches {launches} == {expected}")
    captures, syncs0, iters0 = ms.captures, eng.stats["host_syncs"], \
        eng.stats["iterations"]
    _zero_counts(eng)
    res = serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"]
                                     + SLICE_ARGV), engine=eng)
    launches = _launches(eng)
    iters = eng.stats["iterations"] - iters0
    syncs = eng.stats["host_syncs"] - syncs0
    peak = torch.cuda.max_memory_allocated()
    toks = [t for seq in res["outs"].values() for t in seq]
    if len(toks) != 64:
        fail("slice", f"{len(toks)} tokens emitted, want 64")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        fail("slice", "token id out of the vocabulary")
    expected = _n_moe(cfg) * (4 + iters)
    if launches != expected:
        fail("slice", f"streamed_moe launched {launches} times (graphs "
                      f"{eng.graph_launches()}), want {expected} MoE-layer "
                      f"calls")
    if ms.captures != captures:
        fail("slice", f"recaptured in steady state: {captures} -> "
                      f"{ms.captures} captures")
    if syncs != iters * (nb + 1):
        fail("slice", f"{syncs} host syncs over {iters} steady iterations, "
                      f"want {nb + 1} each")
    _check_on_card(res, "slice")
    n_params = sum(t.numel() for _, t in leaves(res["params"]))
    tps = len(toks) / res["seconds"]
    log("slice", f"{ARCH} full width bf16 ({n_params / 1e9:.3f} B params, "
                 f"{cfg.num_layers} layers), fused engine, graphs captured: "
                 f"4 requests x 16 tokens = {len(toks)} tokens in "
                 f"{res['seconds']:.3f}s ({tps:.1f} tok/s; the 4 one-shot "
                 f"eager prefills of submit {res['submit_seconds']:.3f}s, the"
                 f" fused steps {res['seconds'] - res['submit_seconds']:.3f}s"
                 f"), {iters} decode "
                 f"iterations, {syncs / iters:.1f} host syncs per iteration "
                 f"(nb + 1 = {nb + 1}), captures {ms.captures} (unchanged), "
                 f"streamed_moe launches {launches} == {expected} MoE calls "
                 f"({eng.graph_launches()} by graph replays), peak memory "
                 f"{peak / 2**30:.2f} GiB")
    log("slice", f"streamed_moe share of wall time ~ launches x device "
                 f"kernel ms / wall = {launches * kernel_ms / 1e3 / res['seconds']:.3f}")
    return launches


def _same_run(fused, eager, what):
    """Tokens, the trace record for record and the shared statistics of a
    fused and an eager run must be identical."""
    import numpy as np
    (ef, of), (ee, oe) = fused, eager
    if of != oe:
        first = next(i for i, (a, b) in enumerate(zip(of, oe)) if a != b)
        fail("fused", f"{what}: tokens differ, request {first}: fused "
                      f"{of[first]} eager {oe[first]}")
    if len(ef.trace) != len(ee.trace):
        fail("fused", f"{what}: trace lengths {len(ef.trace)} vs "
                      f"{len(ee.trace)}")
    for n, (a, b) in enumerate(zip(ef.trace, ee.trace)):
        same = set(a) == set(b) and all(
            np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
            else a[k] == b[k] for k in a)
        if not same:
            fail("fused", f"{what}: trace record {n} differs: {a} vs {b}")
    for k in SHARED_STATS:
        if ef.stats[k] != ee.stats[k]:
            fail("fused", f"{what}: stats[{k!r}] {ef.stats[k]} vs "
                          f"{ee.stats[k]}")


def phase_fused_vs_eager():
    """The fused engine (CUDA graphs) against the eager per-layer loop on
    the card, bf16, full width, the same prompts: static; dynamic with
    slack 0.2 (so deferral fires); and chunked admission."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serving import Engine, ServeConfig

    def serve(eng, prompts, max_new, chunked=False):
        sub = eng.submit_chunked if chunked else eng.submit
        rids = [sub(list(p), max_new=max_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        return [outs[r] for r in rids], time.perf_counter() - t0

    params = None
    for argv in ([], ["--schedule", "dynamic", "--slack", "0.2"]):
        res = _serve(SLICE_ARGV + argv)
        params, eng = res["params"], res["engine"]
        eager = Engine(params, res["cfg"], dataclasses.replace(
            eng.scfg, fused=False), device="cuda")
        got, secs = serve(eager, res["prompts"], res["max_new"])
        _same_run((eng, list(res["outs"].values())), (eager, got),
                  " ".join(argv) or "static")
        log("fused", f"{' '.join(argv) or 'static'}: fused == eager (tokens, "
                     f"{len(eng.trace)} trace records, stats); deferrals "
                     f"{eng.stats['deferrals']}, dynamic schedules "
                     f"{eng.stats['dynamic_schedules']}; wall fused "
                     f"{res['seconds']:.3f}s (with captures), eager "
                     f"{secs:.3f}s")
        del res, eng, eager
    cfg = _serve_cfg()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (64, 30, 100, 17, 64, 50, 9, 120)]
    runs = []
    for fused in (True, False):
        eng = Engine(params, cfg, ServeConfig(
            max_batch=TRAFFIC_BATCH, max_ctx=152, chunk_tokens=CHUNK,
            fused=fused), device="cuda")
        runs.append((eng, serve(eng, prompts, 24, chunked=True)))
    (ef, (of, tf)), (ee, (oe, te)) = runs
    _same_run((ef, of), (ee, oe), "chunked admission")
    log("fused", f"chunked admission (8 prompts of 9-120 tokens, 16-token "
                 f"chunks): fused == eager (tokens, {len(ef.trace)} trace "
                 f"records, {ef.stats['prefill_chunks']} prefill chunks); "
                 f"wall fused {tf:.3f}s (with captures), eager {te:.3f}s")
    del runs, ef, ee
    torch.cuda.empty_cache()


def _serve_cfg():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def _traffic(engine=None):
    from repro_torch.launch import serve
    return serve.run_traffic(serve.parse_args(
        ["--arch", ARCH, "--seed", "0"] + TRAFFIC_ARGV), wall_clock=False,
        engine=engine)


def phase_traffic():
    """Scheduler + run_closed_loop over a Poisson stream at full width,
    bf16, on the iteration clock (as the reference's benchmarks); the
    modeled chiplet clock beside it.  -> (the engine, the streamed_moe
    launches at C = C_CHUNK, all launches)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    res = _traffic()
    eng, out = res["engine"], res["result"]
    m = out["metrics"]
    ms = eng.megastep()
    if m.completed != 16 or out["dropped"]:
        fail("traffic", f"{m.completed}/16 completed, dropped "
                        f"{out['dropped']}")
    toks = sum(len(t) for t in out["outputs"].values())
    prefill_steps = len({r["iter"] for r in eng.trace
                         if r["phase"] == "prefill"})
    # a segment's first call is the call of record, then its replays
    chunk_launches = ms.captured["prefill"] * (ms.replays["prefill"] + 1)
    decode_steps = ms.replays["last"] + 1
    n_moe = _n_moe(res["cfg"])
    launches = _launches(eng)
    if chunk_launches != n_moe * prefill_steps or \
            launches != n_moe * (prefill_steps + decode_steps):
        fail("traffic", f"streamed_moe launches {launches} ({chunk_launches}"
                        f" at C = {C_CHUNK}), want {n_moe} x ({prefill_steps}"
                        f" prefill + {decode_steps} decode steps)")
    s = eng.stats
    log("traffic", f"{ARCH} full width bf16, 16 Poisson requests (rate 0.5 "
                   f"per iteration, prompts ~64 of at most 128, 2-32 new "
                   f"tokens), max_batch {TRAFFIC_BATCH}, {CHUNK}-token "
                   f"chunks: {m.completed}/16 completed, 0 dropped, "
                   f"{m.iterations} iterations, {toks} tokens in "
                   f"{res['seconds']:.3f}s ({toks / res['seconds']:.1f} tok/s "
                   f"wall, graphs captured during the run: {ms.captures} in "
                   f"{ms.capture_s:.3f}s)")
    for name, pct, pct_m in (("ttft", m.ttft, m.ttft_modeled),
                             ("tpot", m.tpot, m.tpot_modeled),
                             ("queue_delay", m.queue_delay,
                              m.queue_delay_modeled)):
        log("traffic", f"{name}: p50 {pct['p50']:.2f} p95 {pct['p95']:.2f} "
                       f"iterations; modeled p50 {pct_m['p50'] * 1e3:.4f} "
                       f"p95 {pct_m['p95'] * 1e3:.4f} ms")
    log("traffic", f"{s['prefill_chunks']} prefill chunks ({s['prefill_tokens']}"
                   f" tokens) in {prefill_steps} prefill steps, "
                   f"{s['host_syncs'] / m.iterations:.2f} host syncs per "
                   f"iteration, streamed_moe launches {launches} "
                   f"({chunk_launches} at C = {C_CHUNK}), peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return eng, chunk_launches


def _profile(label, fn, launches=None):
    """Run ``fn`` once under torch.profiler: device kernel time by kernel
    name and the device's busy share of the wall time.  ``launches()``,
    if given, is the streamed_moe launch count of that run, held against
    the profiler's count of ``up_kernel`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _, _ in rows) / 1e3
    log("profile", f"{label}: wall {wall:.3f}s, device kernel time "
                   f"{busy:.3f}s, busy share {busy / wall:.3f}")
    # the ten largest, then the port's own kernels further down the list
    ours = ("::up_kernel", "::down_kernel", "::flash_fwd", "::ssd_", "::split3")
    for ms, n, name in rows[:10] + [r for r in rows[10:]
                                    if any(k in r[2] for k in ours)]:
        log("profile", f"{label}: {ms:9.2f} ms {n:6d} x {name[:100]}")
    if launches is not None:
        seen = sum(n for _, n, name in rows if "up_kernel" in name)
        counted = launches()
        if seen != counted:
            fail("profile", f"{label}: the profiler saw {seen} up_kernel "
                            f"launches, the counts say {counted}")
        log("profile", f"{label}: the profiler's up_kernel launches {seen} "
                       f"== streamed_moe launches counted {counted}")


def phase_profile(traffic_engine):
    """The fused slice (bf16, then fp8 weights) and the traffic run, each
    on an engine whose graphs are captured already, and the two bf16
    scoring losses, once more under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    for label, argv in (("slice", []), ("slice fp8", ["--weight-dtype", "fp8"])):
        eng = _serve(SLICE_ARGV + argv)["engine"]          # captures
        _zero_counts(eng)
        _profile(label, lambda: serve.run(serve.parse_args(
            ["--arch", ARCH, "--seed", "0"] + SLICE_ARGV + argv), engine=eng),
            launches=lambda: _launches(eng))
        del eng
    _zero_counts(traffic_engine)
    _profile("traffic", lambda: _traffic(traffic_engine),
             launches=lambda: _launches(traffic_engine))
    for label, arch, kw in (("forward", ARCH, dict(spec="capacity",
                                                   use_flash=True)),
                            ("mamba", MAMBA, {})):
        cfg = get_config(arch)
        params = api.init_params(cfg, seed=0, device="cuda")
        batch = _score_batch(cfg)
        with torch.no_grad():
            _profile(label, lambda: api.loss_fn(params, batch, cfg, **kw))
        del params
        torch.cuda.empty_cache()


def _score_batch(cfg, seed=0):
    """SCORE_B x SCORE_S random tokens; labels are the tokens shifted by
    one, the last not scored (-1)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (SCORE_B, SCORE_S), generator=g,
                           device="cuda")
    labels = torch.cat([tokens[:, 1:], torch.full((SCORE_B, 1), -1,
                                                  device="cuda")], dim=1)
    return {"tokens": tokens, "labels": labels}


def phase_forward():
    """Path A: the scoring forward of full-width granite with flash
    attention and the capacity MoE (C = 1280 at T = 4096), bf16; then the
    same batch in fp32 with kernels and with use_kernels(False)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api, transformer
    cfg = get_config(ARCH)
    params = api.init_params(cfg, seed=0, device="cuda")
    batch = _score_batch(cfg)
    n_attn = sum(1 for m in cfg.layer_kinds() if m == "attn")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = sm.LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, m = api.loss_fn(params, batch, cfg, spec="capacity",
                              use_flash=True)
    loss = loss.item()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES, "streamed_moe": sm.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"flash_attention": n_attn, "streamed_moe": _n_moe(cfg)}:
        fail("forward", f"launches {launches}, want {n_attn} flash and "
                        f"{_n_moe(cfg)} streamed_moe")
    if not torch.isfinite(torch.tensor(loss)):
        fail("forward", f"loss {loss}")
    T = SCORE_B * SCORE_S
    log("forward", f"{ARCH} full width bf16, {SCORE_B} x {SCORE_S} tokens "
                   f"(MoE C = {cfg.moe.capacity_rows(T)}): loss {loss:.4f} (ce "
                   f"{m['ce'].item():.4f}, aux {m['aux'].item():.4f}) in "
                   f"{secs:.3f}s = {T / secs:.0f} scored tok/s; launches "
                   f"{launches}; peak memory {peak / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    params = api.init_params(cfg32, seed=0, device="cuda")
    out = {}
    for kernels in (True, False):
        with torch.no_grad(), ops.use_kernels(kernels):
            loss32, _ = api.loss_fn(params, batch, cfg32, spec="capacity",
                                    use_flash=True)
            logits, _ = transformer.forward(params, batch["tokens"], cfg32,
                                            spec="capacity", use_flash=True)
            out[kernels] = (loss32.item(), logits)
    (lk, zk), (lp, zp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    top2 = zp.topk(2, dim=-1).values
    differ = zk.argmax(-1) != zp.argmax(-1)
    miss = (differ & (top2[..., 0] - top2[..., 1] >= MARGIN_TOL)).float() \
        .mean().item()
    line = (f"fp32 parity: loss {lk:.6f} with kernels, {lp:.6f} with "
            f"use_kernels(False), rel {rel:.3e} (tol {LOSS_TOL:g}); argmax "
            f"agrees at {1 - differ.float().mean().item():.4f} of {T} "
            f"positions, differs where the plain top-2 margin is >= "
            f"{MARGIN_TOL:g} at {miss:.4f} (tol {ARGMAX_MISS:g}); logits "
            f"rel err {rel_err(zk, zp):.3e}")
    if rel > LOSS_TOL or miss > ARGMAX_MISS:
        fail("forward", line)
    log("forward", line)
    del params, out, zk, zp
    torch.cuda.empty_cache()
    return launches


def _mamba_layers(params, cfg, tokens):
    """Each layer with the SSD kernel and without, on the activations that
    reach it in the plain-path forward: the largest error of the layer's
    output over the largest entry of what its block adds, across layers."""
    import torch
    from repro_torch.models import transformer
    x = transformer._embed(params, tokens)
    worst = 0.0
    with torch.no_grad():
        for layer, slot, mixer, ffn_kind in transformer.layer_slots(params,
                                                                    cfg):
            xk, xp = (transformer._apply_slot_full(
                slot, x, cfg, mixer, ffn_kind, positions=None, spec=None,
                layer=layer, use_flash=False, ssd_kernel=k)[0]
                for k in (True, False))
            if not torch.isfinite(xk).all():
                fail("mamba", f"layer {layer}: non-finite block output")
            worst = max(worst, rel_err(xk - x, xp - x))
            x = xp
    return worst


def phase_mamba():
    """Path B: the full-width mamba2-370m scoring loss (the plain SSD path,
    as the reference's forward), then every layer's block with the SSD
    kernel against the plain path, bf16 (reported) and fp32 (held)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.models import api
    cfg = get_config(MAMBA)
    params = api.init_params(cfg, seed=0, device="cuda")
    batch = _score_batch(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = api.loss_fn(params, batch, cfg)
    loss = loss.item()
    secs = time.perf_counter() - t0
    bf16_err = _mamba_layers(params, cfg, batch["tokens"])
    launches = ssd.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers:
        fail("mamba", f"ssd launched {launches} times, want {cfg.num_layers}")
    if not torch.isfinite(torch.tensor(loss)):
        fail("mamba", f"loss {loss}")
    T = SCORE_B * SCORE_S
    log("mamba", f"{MAMBA} full width bf16, {SCORE_B} x {SCORE_S} tokens: "
                 f"loss {loss:.4f} in {secs:.3f}s = {T / secs:.0f} scored "
                 f"tok/s; per-layer blocks with the SSD kernel: {launches} "
                 f"launches, bf16 rel err vs plain path {bf16_err:.3e}; peak "
                 f"memory {peak / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    params = api.init_params(cfg32, seed=0, device="cuda")
    err = _mamba_layers(params, cfg32, batch["tokens"])
    line = (f"fp32: block with the SSD kernel vs without, worst layer rel err "
            f"{err:.3e} (tol {BLOCK_TOL:g})")
    if err > BLOCK_TOL:
        fail("mamba", line)
    log("mamba", line)
    del params
    torch.cuda.empty_cache()
    return launches


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
    """-> the fp8 run's streamed_moe launches (the serve_fp8 path)."""
    for argv in (["--schedule", "dynamic", "--slack", "0.2"],
                 ["--weight-dtype", "fp8"]):
        _zero_counts()
        res = _serve(SLICE_ARGV + argv)
        eng, s = res["engine"], res["engine"].stats
        launches = _launches(eng)
        toks = [t for seq in res["outs"].values() for t in seq]
        if len(toks) != 64 or launches == 0 or not eng.megastep().graphs:
            fail("features", f"{argv}: {len(toks)} tokens, {launches} "
                             f"launches, {eng.megastep().captures} graphs")
        if "--schedule" in argv and s["dynamic_schedules"] == 0:
            fail("features", "dynamic schedule never ran")
        if "--weight-dtype" in argv and launches != \
                _n_moe(res["cfg"]) * (4 + s["iterations"]):
            fail("features", f"fp8: {launches} launches")
        _check_on_card(res, "features")
        log("features", f"{' '.join(argv)}: fused engine, {len(toks)} tokens "
                        f"in {res['seconds']:.3f}s (graphs captured during "
                        f"the run), {s['iterations']} iterations, deferrals "
                        f"{s['deferrals']}, loads saved "
                        f"{s['expert_loads_saved']}, dynamic schedules "
                        f"{s['dynamic_schedules']}, host syncs "
                        f"{s['host_syncs']}, launches {launches} "
                        f"({eng.graph_launches()} by graph replays)")
        if "--weight-dtype" in argv:
            fp8_launches = launches
        del res, eng
    return fp8_launches


SOURCES = {"streamed_moe": "src/repro/kernels/streamed_moe.py:201",
           "flash_attention": "src/repro/kernels/flash_attention.py:81",
           "ssd": "src/repro/kernels/ssd.py:51"}


def main():
    try:
        card = phase_env()
        import torch
        phase_build()
        rows = phase_kernels()
        launches = {("streamed_moe", "serve"): phase_slice(
            rows["streamed_moe"]["serve"]["device_ms"])}
        phase_fused_vs_eager()
        traffic_engine, launches["streamed_moe", "serve_chunked"] = \
            phase_traffic()
        phase_parity()
        launches["streamed_moe", "serve_fp8"] = phase_features()
        for k, n in phase_forward().items():
            launches[k, "forward"] = n
        launches["ssd", "mamba"] = phase_mamba()
        phase_profile(traffic_engine)
        if "jax" in sys.modules:
            fail("summary", "jax was imported")
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("FAIL: a phase raised", flush=True)
        sys.exit(1)
    print(json.dumps({"kernels": [dict(
        name=name, path=path, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces=SOURCES[name], launches=n, **rows[name][path])
        for (name, path), n in launches.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
