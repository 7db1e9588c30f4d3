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
3b. dispatch: ``moe_capacity`` with one-hot and with sorted dispatch on
   one routing at granite width, at C = 64 (a decode step), C = 1024 (a
   traffic prefill step) and C = 1280 (the scoring forward, with
   overflow), static and dynamic: sorted agrees with one-hot (fp32 2e-5,
   bf16 3e-2), is the same bits twice and dynamic == static bit for bit;
   under drop-free capacity a token's output keeps its bits at another
   row among other tokens, one-hot and sorted;
   the device time of dispatch plus combine, one-hot against sorted, with
   the streamed_moe kernel's beside it at the analytic level's tiles and
   at the default's (the kernel held against its plain version on the
   sorted rows at C = 1024);
3c. tiles: every streamed_moe tile setting (``TILE_SETTINGS``) against the
   default one on the same operands, bit for bit (output and scratch):
   bf16 at C = 64, 1024, 1280, int8 and fp8 at C = 64, and the ragged
   cases of phase 3, each also held against the plain version with phase
   3's checks; then at granite width (C = 64, 1024, 1280 bf16; C = 64
   int8 and fp8) each setting's device time beside the planner's
   prediction and its compiled registers, spills and shared memory, the
   analytic and the measured picks, and three ``torch.bmm`` plus the
   activation as a yardstick; the analytic pick must take at most 1.10
   times the default's device time at the three bf16 shapes;
3d. tiers: one granite MoE layer at C = 64 and C = 1024 (drop-free), one-hot
   and sorted: ``moe_hybrid`` (8 hot experts, 24 cold) against
   ``moe_capacity`` on the same routing and schedule bit for bit; the
   kernel at E = 8 and E = 24 against the matching rows of the E = 32 call
   bit for bit (output and scratch), under the analytic tiles and the
   default; the device time of both MoE paths and of the reorder copies;
4. slice: ``repro_torch.launch.serve`` serves 4 requests x 16 tokens of
   granite-moe-1b-a400m at full width in bf16 on the default fused engine,
   under ``--autotune analytic`` (the default), ``off`` and ``measured``:
   a first run captures the CUDA graphs (capture seconds logged), a second
   run on the same engine replays them: no new capture, ``nb + 1`` host
   syncs per steady iteration, and streamed_moe launches (the wrapper's
   count plus captured launches x replays) equal to the MoE-layer calls;
   its wall, tok/s and peak memory; the three levels give the same tokens
   and launches; under ``measured`` (its cache in a temporary directory,
   ``REPRO_AUTOTUNE_CACHE``) the first engine times tile candidates and
   writes ``kernel_tiles_torch.json``, and a second engine, the memory
   dropped, reads the file, times nothing (``autotune.TIMINGS``) and
   serves the same tokens (a timing inside a capture would raise);
4h. hybrid: the slice under ``--strategy hybrid --schedule dynamic`` and
   under ``capacity`` with the dynamic schedule (a cold run, then a warm
   one on the same engine): the same tokens, twice the streamed_moe
   launches per MoE layer, no recapture, a ``hot`` list of ``_n_hot`` ids
   on every MoE trace record; then with ``--resident-budget-mb 576`` (8
   experts of each of the 24 MoE layers resident): the same tokens,
   ``resident_weight_bytes`` 8 x 24 x ``expert_bytes``, DDR bytes saved,
   a modeled total at most the run's without the tier; then phase 6's
   Poisson stream under ``hybrid`` (the ``serve_hybrid_chunked`` path at C
   = 1024): phase 6's one-hot tokens, twice its launches;
5. fused: the fused engine against the eager per-layer loop on the card
   (bf16, full width, the same prompts, the analytic level): static, ``--schedule dynamic
   --slack 0.2`` and chunked admission, then with sorted dispatch
   (``--moe-spec``, ``"sorted_dispatch": true``) static and dynamic with
   slack 0.2; tokens, the trace record for record and the statistics must
   be identical;
6. traffic: ``Scheduler`` + ``run_closed_loop`` over 16 Poisson requests
   (prompts about 64 tokens, 16-token chunks, max_batch 8) on the
   iteration clock: all complete, none dropped; TTFT / TPOT / queue delay
   in iterations and modeled seconds, wall tok/s, prefill chunks, host
   syncs per iteration and the streamed_moe launches at C = 1024; then
   the same stream with sorted dispatch (the ``serve_sorted`` path);
6b. prefix: phase 6's stream with four Zipf-shared 64-token system
   prompts in front of each prompt, max_batch 8, max_ctx 256, three closed
   loops on the fused engine: unbounded, ``preempt_queue_depth=0``, and
   that with the prefix cache; all complete, the last two give the first
   one's tokens, with preemptions == restores > 0 and cache hits > 0;
   prefill tokens saved and their share logged; the cached loop once more
   on its engine, warm (no new capture, the same tokens; the
   ``serve_prefix`` path's launches); once with one-hot and once with
   sorted dispatch;
6r. referee: the traces phase 6 took on the card (one-hot and sorted) and
   phase 4h's resident run's, replayed through the port's chiplet
   simulator (``simulate_trajectory`` / ``replay_trace`` on
   ``spec_from_config`` of the full-width config): every record's
   ``modeled_s`` within 5%, the total within 2%; the worst record and the
   total gap printed; then, not gated, the paper's strategies
   (``simulate_layer``) and ``rank_modes`` on the card's busiest prefill
   and decode iterations;
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
   and the bf16 batch with sorted dispatch: loss within 1e-4 of one-hot's;
10. mamba: ``api.loss_fn`` over 2 x 2048 tokens of mamba2-370m at full
   width in bf16, then each layer's ``mamba2_block`` with the SSD kernel
   (48 launches, B and C per group: n_groups = 1) against the plain path on
   the same activations, in bf16 (reported) and fp32 (within 2e-5);
11. profile: the fused slice (bf16, ``--weight-dtype fp8``, the dynamic
    schedule, and ``hybrid``, whose reorder copies are named: the
    index_select kernels beyond the static slice's) and the
    traffic run (one-hot, then sorted) on engines whose graphs are
    captured, and the scoring losses (one-hot and sorted) and mamba's,
    once more under ``torch.profiler`` — device kernel time by name, the
    device's busy share of the wall time, and the profiler's ``up_kernel``
    launches against the counted ones;
12. summary: one ``{"kernels": [...]}`` JSON line with one entry per
    kernel and path (``streamed_moe`` on the serve path in bf16 and in fp8,
    on the chunked-prefill path of the traffic run (``serve_chunked``, C =
    1024), on the sorted traffic path (``serve_sorted``) and the prefix
    traffic path (``serve_prefix``), both with the kernel measured at C =
    1024 in phase 3b, under ``hybrid`` at C = 64 (``serve_hybrid``, phase
    4h's warm slice) and C = 1024 (``serve_hybrid_chunked``, phase 4h's
    stream), two launches (E = 8 and 24) a MoE layer timed together in
    phase 3d, and on the forward path, ``flash_attention`` on the
    forward path, ``ssd`` on the mamba path),
    each with that path's launches and its shape's times (``ms`` one call
    with its host work, ``device_ms`` the device time per call) and bound,
    and for streamed_moe the tile setting the path ran (``tiles``); the
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
# phase 3b: moe_capacity with sorted dispatch against one-hot on the same
# routing, max abs error over max |one-hot|: the reference's MoE-block
# tolerances (fp32 2e-5, bf16 3e-2).  Cases (what, T, drop-free): a decode
# step of 8 slots (C = T k = 64), a traffic prefill step of 8 x 16 tokens
# (C = 1024), and the scoring forward's tokens at granite's capacity
# factor 1.25 (C = 1280; the routing is skewed so that experts overflow)
DISPATCH_TOL = {"fp32": 2e-5, "bf16": 3e-2}
DISPATCH_CASES = (("decode", TRAFFIC_BATCH, True),
                  ("prefill", TRAFFIC_BATCH * CHUNK, True),
                  ("scoring", SCORE_B * SCORE_S, False))
SORTED_SPEC = {"strategy": "capacity", "sorted_dispatch": True}
# phase 3c: every tile setting against the default on these operands (E,
# C, d, m, activation, weight format, activations' dtype) must give the
# same bits: the serving shapes (decode C = 64, the traffic prefill C =
# 1024, the scoring forward C = 1280) and phase 3's ragged ones
TILE_BITS_CASES = tuple(
    [(32, C_, 1024, 512, "swiglu", "bf16", "bf16") for C_ in (64, 1024, 1280)]
    + [(32, 64, 1024, 512, "swiglu", w, "bf16") for w in ("int8", "fp8")]
    + [(4, 37, 256, 96, act, w, x) for act in ("relu2", "gelu")
       for w in ("bf16", "int8", "fp8") for x in ("bf16", "fp32")
       if not (w == "bf16" and x == "fp32")]
    + [(4, 64, 512, 1024, "swiglu", w, "bf16")
       for w in ("bf16", "int8", "fp8")])
# ... and is timed at these (bf16 activations); the analytic pick must take
# at most TILE_GATE times the default's device time on the bf16 ones
TILE_TIME_CASES = tuple(
    [(32, C_, 1024, 512, "swiglu", "bf16") for C_ in (64, 1024, 1280)]
    + [(32, 64, 1024, 512, "swiglu", w) for w in ("int8", "fp8")])
TILE_GATE = 1.10
# phase 3d: one granite MoE layer at a decode step of 8 slots (C = 64) and
# a traffic prefill step of 8 x 16 tokens (C = 1024), drop-free as the
# engine serves, under ``hybrid`` (default_hot(32) = 8 hot experts, 24
# cold ones): two streamed_moe launches where ``capacity`` makes one
TIER_CASES = (("decode", TRAFFIC_BATCH), ("prefill", TRAFFIC_BATCH * CHUNK))
# phase 4h: the slice under hybrid with the dynamic schedule, then with
# the resident tier at 576 MiB: 24 MiB for each of granite's 24 MoE
# layers, 8 bf16 experts of 3 MiB (3 x 1024 x 512 x 2 bytes) each
HYBRID_ARGV = ["--strategy", "hybrid", "--schedule", "dynamic"]
RESIDENT_MB = 576
RESIDENT_PER_LAYER = 8
# phase 6r: the modeled clock against its discrete referee on the card's
# traces, the reference's tolerances (tests/test_modeled_clock.py)
REFEREE_RECORD_TOL = 0.05
REFEREE_TOTAL_TOL = 0.02
SIM_STRATEGIES = ("ep", "hydra", "fse_dp_naive", "fse_dp", "fse_dp_paired",
                  "fse_dp_rule5")
# phase 6b: phase 6's stream with four Zipf-shared 64-token system prompts
# in front of each private part (cut so the prompt stays within 128
# tokens); 16-token chunks, so the prefixes end on chunk boundaries
PREFIX_TRAFFIC = dict(num_requests=16, rate=0.5, avg_prompt=64,
                      max_prompt=128, min_new=2, max_new=32,
                      mix="poisson+zipf_prefix", num_prefixes=4,
                      prefix_len=64, seed=0)
PREFIX_LOOPS = (("unbounded", False, None), ("preempt", False, 0),
                ("preempt+cache", True, 0))
# the reference's floor on the prefill tokens its own shared-prefix mix
# saves (benchmarks/check_regression.py), reported beside the port's share
PREFIX_SAVINGS_FLOOR = 0.40
# engine statistics that fused and eager serving must share (the eager
# loop counts no host syncs)
SHARED_STATS = ("deferrals", "expert_loads", "expert_loads_saved",
                "dynamic_schedules", "iterations", "tokens_emitted",
                "prefill_chunks", "prefill_tokens")
MAMBA = "mamba2-370m"
# phase 11: seconds the profiler's capture window stays open before and
# after the profiled work, and the spin kernels run first in it (see
# _profiled)
PROFILE_PAD_S = 0.5
PROFILE_WARMUP = 512


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
            # timed with the tiles the serving paths run (the analytic
            # level's); phase 3c holds every setting to these bits
            tiles = _planned(E_, C_, d_, m_, act,
                             "fp32" if x_dtype == f32 else "bf16", wdt)
            times, text = kernel_times(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, tiles=tiles, **scales))
            plain_ms = median_ms(lambda: ref.streamed_moe_plain(
                xe, *ws, act, **scales))
            bound, by = streamed_moe_bound_ms(E_, C_, d_, m_, wdt,
                                              xe.element_size())
            line += (f"; tiles {tiles}: {text}, plain {plain_ms:.4f} ms, "
                     f"bound {bound * 1e3:.1f} us ({by})")
            path = {("bf16", C): "serve", ("fp8", C): "serve_fp8",
                    ("bf16", C_CHUNK): "serve_chunked",
                    ("bf16", C_SCORE): "forward"}.get((wdt, C_))
            if path:
                paths[path] = dict(
                    max_abs_err=err_plain, **times, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None,
                    tiles=tiles)
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


def phase_dispatch():
    """``moe_capacity`` with one-hot and with sorted dispatch on one routing,
    at granite width (one MoE layer from seed 0), in fp32 and bf16, for each
    of DISPATCH_CASES.  -> the kernels line's row of streamed_moe at C =
    C_CHUNK, on the rows sorted dispatch gathered (the rows one-hot
    dispatch gives are the same bits)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import gating, trajectory
    from repro_torch.models import moe
    cfg = get_config(ARCH)
    mc, act = cfg.moe, cfg.activation
    E, k, d = mc.num_experts, mc.top_k, cfg.d_model
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        kind = "fp32" if dtype == torch.float32 else "bf16"
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = moe.moe_init(gen, d, mc, act, dtype, "cuda")
        # a sharper router and a direction every token shares skew the
        # load, so that a finite capacity overflows
        params["router"]["w_router"] = params["router"]["w_router"] * 50
        shared = torch.randn(d, generator=gen, device="cuda")
        for what, T, drop_free in DISPATCH_CASES:
            mcfg = dataclasses.replace(mc, capacity_factor=float(E)) \
                if drop_free else mc
            C = mcfg.capacity_rows(T)
            x = (torch.randn(T, d, generator=gen, device="cuda")
                 + shared).to(dtype)
            r = gating.route(params["router"], x, top_k=k)
            load = gating.expert_token_counts(r)
            dropped = int((load - C).clamp(min=0).sum())

            def run(sorted_, schedule=None):
                with torch.no_grad(), moe.use_sorted_dispatch(sorted_):
                    return moe.moe_capacity(params, x, r, mcfg, act,
                                            schedule=schedule)
            one_hot, got = run(False), run(True)
            again, dyn = run(True), run(True, trajectory.DYNAMIC)
            torch.cuda.synchronize()
            err = rel_err(got, one_hot)
            same, dyn_same = torch.equal(got, again), torch.equal(dyn, got)
            line = (f"{what} T={T} C={C} {kind}: sorted vs one-hot rel "
                    f"{err:.3e} (tol {DISPATCH_TOL[kind]:g}); {dropped} of "
                    f"{T * k} choices past capacity (max load "
                    f"{int(load.max())}); sorted the same bits twice: "
                    f"{same}; dynamic == static: {dyn_same}")
            if not torch.isfinite(got).all() or err > DISPATCH_TOL[kind] \
                    or not same or not dyn_same:
                fail("dispatch", line)
            if not drop_free and not dropped:
                fail("dispatch", f"{line}: no choice overflowed")
            if drop_free:
                line += _batch_invariance(params, x, mcfg, act, gen)
            if kind == "bf16":
                text, kernel_row = _dispatch_times(params, x, r, mcfg, act, C)
                line += text
                row = kernel_row or row
            log("dispatch", line)
        del params
        torch.cuda.empty_cache()
    return row


def _batch_invariance(params, x, mcfg, act, gen, trials=4):
    """Half of the tokens placed at other rows among other tokens: under
    drop-free capacity each of their outputs must keep its bits, with
    one-hot and with sorted dispatch (what serving with preemption and the
    prefix cache needs: a request's tokens may not depend on its slot or on
    who shares the batch)."""
    import torch
    from repro_torch.core import gating
    from repro_torch.models import moe
    T, k = x.shape[0], mcfg.top_k
    half = T // 2
    moved = {False: 0, True: 0}
    for _ in range(trials):
        other = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        rows = torch.randperm(T, generator=gen, device="cuda")[:half]
        other[rows] = x[:half]
        for sorted_ in moved:
            with torch.no_grad(), moe.use_sorted_dispatch(sorted_):
                y = moe.moe_capacity(params, x, gating.route(
                    params["router"], x, top_k=k), mcfg, act)
                y2 = moe.moe_capacity(params, other, gating.route(
                    params["router"], other, top_k=k), mcfg, act)
            moved[sorted_] += int((y2[rows] != y[:half]).any(-1).sum())
    text = (f"; batch invariance: {half} tokens at other rows among other "
            f"tokens, {trials} times: outputs that moved one-hot "
            f"{moved[False]}, sorted {moved[True]}")
    if any(moved.values()):
        fail("dispatch", text)
    return text


def _dispatch_times(params, x, r, mcfg, act, C):
    """Device time of dispatch plus combine as ``moe_capacity`` runs them,
    one-hot against sorted, with the streamed_moe kernel's on the dispatched
    rows beside it; at C = C_CHUNK the kernel is also held against its
    plain version there.  -> (text, the kernels line's row or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import moe
    T, E = x.shape[0], mcfg.num_experts
    ws = tuple(params[k] for k in ("w_gate", "w_up", "w_down"))
    xe = moe.gather_dispatch(x, moe.dispatch_tables(r, T, E, C).idx)
    h, ye = sm._launch(xe, *ws, act)

    def one_hot():
        dispatch, combine = moe.dispatch_masks(r, T, E, C)
        torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        return moe.one_hot_combine(combine, ye).to(x.dtype)

    def sorted_():
        tables = moe.dispatch_tables(r, T, E, C)
        moe.gather_dispatch(x, tables.idx)
        return moe.scatter_combine(ye, tables.rows, tables.weights) \
            .to(x.dtype)

    tiles = _planned(E, C, x.shape[1], ws[1].shape[-1], act)

    def kernel(tiles=tiles):
        return sm.streamed_moe_kernel(xe, *ws, activation=act, tiles=tiles)
    with torch.no_grad():
        t_oh, t_so = device_ms(one_hot)[0], device_ms(sorted_)[0]
        t_k = device_ms(kernel)[0]
        t_off = device_ms(lambda: kernel(None))[0]
        combine = moe.dispatch_masks(r, T, E, C)[1]
        cost = {label: (device_ms(lambda: fn(combine, ye))[0],
                        _peak_bytes(lambda: fn(combine, ye)))
                for label, fn in _combines().items()}
    text = (f"; dispatch + combine on the device: one-hot {t_oh:.4f} ms, "
            f"sorted {t_so:.4f} ms ({t_oh / t_so:.1f}x); streamed_moe "
            f"{t_k:.4f} ms at the analytic level ({tiles}), {t_off:.4f} ms "
            f"at off (the default); the one-hot combine alone: " + ", ".join(
                f"{label} {ms:.4f} ms (+{b / 2**20:.1f} MiB at its peak)"
                for label, (ms, b) in cost.items()))
    if C != C_CHUNK:
        return text, None
    ok, mt = moe_bf16_check(h, ye, ref.streamed_moe_plain_h(xe, *ws, act),
                            xe, *ws, act)
    err = (ye - ref.streamed_moe_plain(xe, *ws, act)).abs().max().item()
    text += (f"; kernel on the sorted rows vs plain: h at most "
             f"{mt['over']:.3f} of its bound, share differing "
             f"{mt['flips']:.3e}, down product rel {mt['down']:.3e}")
    if not ok:
        fail("dispatch", text)
    times, ktext = kernel_times(kernel)
    plain_ms = median_ms(lambda: ref.streamed_moe_plain(xe, *ws, act))
    bound, by = streamed_moe_bound_ms(E, C, x.shape[1], ws[1].shape[-1],
                                      "bf16", x.element_size())
    text += (f"; {ktext}, plain {plain_ms:.4f} ms, bound "
             f"{bound * 1e3:.1f} us ({by})")
    return text, dict(max_abs_err=err, **times, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=by, library_ms=None,
                      tiles=tiles)


def _planned(E, C, d, m, act, x_dtype="bf16", weight_dtype="bf16"):
    """The setting the analytic level runs for this call's shape."""
    from repro_torch.core import autotune
    return autotune.plan_kernel_tiles(E, C, d, m, act, None, x_dtype,
                                      weight_dtype)["tiles"]


def _same_bits(a, b):
    """Bit for bit, NaNs included."""
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view[a.dtype]), b.view(view[b.dtype]))


def phase_tiles():
    """Every setting of TILE_SETTINGS against the default one (the tiles
    the kernel took before it took settings) on the same operands: the
    same bits, output and scratch, on the bf16 and the 8-bit paths at
    TILE_BITS_CASES, and each held against the plain version with phase
    3's checks.  Then at TILE_TIME_CASES every setting's device time
    beside the planner's prediction and its compiled registers, spills
    and shared memory; the analytic and measured picks; three torch.bmm
    plus the activation as a yardstick; and the gate: the analytic pick
    at most TILE_GATE times the default's device time on the serving
    shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import autotune
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    profile = autotune.CardProfile.detect()
    log("tiles", f"card profile: {profile}")
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for (E, C, d, m, act, wdt, x) in TILE_BITS_CASES:
        x_dtype = dtypes[x]
        xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, x_dtype)
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        path = sm.tile_path(x_dtype, ws[1].dtype)
        h0, out0 = sm._launch(xe, *ws, act, **scales)
        plain = ref.streamed_moe_plain(xe, *ws, act, **scales)
        h_plain = ref.streamed_moe_plain_h(xe, *ws, act, **scales) \
            if path == "bf16" else None
        worst = 0.0
        for name in sm.TILE_SETTINGS[path]:
            h, out = sm._launch(xe, *ws, act, tiles=name, **scales)
            torch.cuda.synchronize()
            what = f"E={E} C={C} d={d} m={m} {act} w={wdt} x={x} tiles {name}"
            if not (_same_bits(out, out0) and _same_bits(h, h0)):
                diff = (out - out0).abs().max().item()
                fail("tiles", f"{what}: not the default's bits (out max abs "
                              f"diff {diff:.3e}, h equal "
                              f"{_same_bits(h, h0)})")
            if path == "bf16":
                ok, mt = moe_bf16_check(h, out, h_plain, xe, *ws, act)
                worst = max(worst, mt["over"])
            else:
                err = rel_err(out, plain)
                ok = err <= PLAIN_TOL
                worst = max(worst, err)
            if not ok:
                fail("tiles", f"{what}: fails phase 3's hold against plain")
        log("tiles", f"E={E} C={C} d={d} m={m} {act} w={wdt} "
                     f"x={x}: all {len(sm.TILE_SETTINGS[path])} "
                     f"settings give the default's bits (out and h); against"
                     f" plain " + (f"h at most {worst:.3f} of its bound"
                                   if path == "bf16" else
                                   f"rel at most {worst:.3e} (tol "
                                   f"{PLAIN_TOL:g})"))
    for (E, C, d, m, act, wdt) in TILE_TIME_CASES:
        xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, torch.bfloat16)
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        path = sm.tile_path(xe.dtype, ws[1].dtype)
        plan = autotune.plan_kernel_tiles(E, C, d, m, act, profile, "bf16",
                                          wdt)
        times = {}
        for name in sm.TILE_SETTINGS[path]:
            times[name] = device_ms(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, tiles=name, **scales))[0]
            cost = autotune.tile_cost(E, C, d, m, act, name, profile, "bf16",
                                      wdt)
            up, down = cost["phases"]
            log("tiles", f"E={E} C={C} d={d} m={m} {act} w={wdt} {name}: "
                         f"device {times[name]:.4f} ms, predicted "
                         f"{cost['t'] * 1e3:.4f} ms (fits {cost['fits']}); "
                         + "; ".join(
                             f"{ph} {p['regs']} regs, {p['spill']} B spilled,"
                             f" {p['smem']} B shared, {p['threads']} threads,"
                             f" {p['blocks_per_sm']} blocks an SM, "
                             f"{p['waves']:.2f} waves"
                             for ph, p in (("up", up), ("down", down))))
        entry = autotune.measured_kernel_tiles(E, C, d, m, act, "bf16", wdt,
                                               profile=profile)
        default, pick = plan["default"], plan["tiles"]
        line = (f"E={E} C={C} d={d} m={m} {act} w={wdt}: default {default} "
                f"{times[default]:.4f} ms (predicted "
                f"{plan['default_s'] * 1e3:.4f}); analytic pick {pick} "
                f"{times[pick]:.4f} ms (predicted "
                f"{plan['predicted_s'] * 1e3:.4f}, "
                f"{times[pick] / times[default]:.3f} of the default's); "
                f"measured pick {entry['tiles']} {entry['ms']:.4f} ms of "
                f"{len(entry['candidates'])} timed; fastest here "
                f"{min(times, key=times.get)} {min(times.values()):.4f} ms")
        if wdt == "bf16":
            def chain():
                g = torch.bmm(xe, ws[0])
                h = F.silu(g) * torch.bmm(xe, ws[1])
                return torch.bmm(h, ws[2]).float()
            line += (f"; bmm_chain_ms (3 torch.bmm + silu, a yardstick the "
                     f"port never calls) {device_ms(chain)[0]:.4f}")
            if times[pick] > TILE_GATE * times[default]:
                fail("tiles", f"{line}: the analytic pick is over "
                              f"{TILE_GATE:g} times the default's time")
        log("tiles", line)


def phase_tiers():
    """One full-width granite MoE layer (bf16, seed 0) at each of
    TIER_CASES: ``moe_hybrid`` against ``moe_capacity`` on the same routing
    and schedule (none, in-call dynamic, a host schedule), one-hot and
    sorted, bit for bit; the kernel at E = 8 and E = 24 on the rows
    ``moe_hybrid`` hands it against the matching rows of the E = 32 call,
    output and scratch bit for bit, each under the analytic level's tiles
    and the default; then the device time of both MoE paths and of the
    reorder copies.  -> {path: the kernels line's row} for serve_hybrid (C
    = 64) and serve_hybrid_chunked (C = C_CHUNK)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import gating, trajectory
    from repro_torch.core.strategy import default_hot
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import moe
    cfg = get_config(ARCH)
    mc, act, d = cfg.moe, cfg.activation, cfg.d_model
    E, k = mc.num_experts, mc.top_k
    mcfg = dataclasses.replace(mc, capacity_factor=float(E))
    H = default_hot(E)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe.moe_init(gen, d, mc, act, torch.bfloat16, "cuda")
    rows = {}
    for (what, T), path in zip(TIER_CASES, ("serve_hybrid",
                                            "serve_hybrid_chunked")):
        x = torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
        r = gating.route(params["router"], x, top_k=k)
        C = mcfg.capacity_rows(T)
        counts = gating.expert_token_counts(r)
        host = trajectory.build_schedule(counts.cpu().numpy())
        with torch.no_grad():
            for sorted_ in (False, True):
                with moe.use_sorted_dispatch(sorted_):
                    for sched in (None, trajectory.DYNAMIC, host):
                        cap = moe.moe_capacity(params, x, r, mcfg, act,
                                               schedule=sched)
                        hyb = moe.moe_hybrid(params, x, r, mcfg, act,
                                             hot_experts=H, schedule=sched)
                        if not _same_bits(cap, hyb):
                            diff = (cap.float() - hyb.float()).abs().max()
                            fail("tiers", f"{what} C={C} sorted={sorted_} "
                                          f"schedule {sched}: moe_hybrid is "
                                          f"not moe_capacity's bits (max "
                                          f"abs diff {diff.item():.3e})")
            order = torch.sort(-counts.to(torch.int64), stable=True).indices
            p = moe._reorder_experts(params, order)
            dispatch, _ = moe.dispatch_masks(r, T, E, C)
            xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype),
                              x).index_select(0, order).contiguous()
            ws = [p[n] for n in ("w_gate", "w_up", "w_down")]
            m = ws[1].shape[-1]
            planned = {e: _planned(e, C, d, m, act) for e in (H, E - H, E)}
            full = [sm._launch(xe, *ws, act, tiles=t)
                    for t in (None, planned[E])]
            for lo, hi in ((0, H), (H, E)):
                for t in (None, planned[hi - lo]):
                    h, out = sm._launch(xe[lo:hi], *(w[lo:hi] for w in ws),
                                        act, tiles=t)
                    for fh, fout in full:
                        if not (_same_bits(out, fout[lo:hi])
                                and _same_bits(h, fh[lo:hi])):
                            fail("tiers", f"{what} C={C}: E={hi - lo} "
                                          f"tiles {t} is not the E={E} "
                                          f"call's rows {lo}:{hi}")

            def pair():
                return torch.cat([sm.streamed_moe_kernel(
                    xe[lo:hi], *(w[lo:hi] for w in ws), activation=act,
                    tiles=planned[hi - lo]) for lo, hi in ((0, H), (H, E))])
            ye = pair()
            h = torch.cat([sm._launch(xe[lo:hi], *(w[lo:hi] for w in ws),
                                      act, tiles=planned[hi - lo])[0]
                           for lo, hi in ((0, H), (H, E))])
            ok, mt = moe_bf16_check(h, ye, ref.streamed_moe_plain_h(
                xe, *ws, act), xe, *ws, act)
            plain = ref.streamed_moe_plain(xe, *ws, act)
            err = (ye - plain).abs().max().item()
            if not ok:
                fail("tiers", f"{what} C={C}: the two launches fail phase "
                              f"3's hold against plain: {mt}")
            times, ktext = kernel_times(pair)
            plain_ms = median_ms(lambda: ref.streamed_moe_plain(xe, *ws, act))
            bound, by = streamed_moe_bound_ms(E, C, d, m, "bf16", 2)
            t_one = device_ms(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, tiles=planned[E]))[0]
            halves = {(hi - lo, t or "default"): device_ms(
                lambda lo=lo, hi=hi, t=t: sm.streamed_moe_kernel(
                    xe[lo:hi], *(w[lo:hi] for w in ws), activation=act,
                    tiles=t))[0]
                for lo, hi in ((0, H), (H, E))
                for t in (planned[hi - lo], None)}
            t_cap = device_ms(lambda: moe.moe_capacity(params, x, r, mcfg,
                                                       act))[0]
            t_hyb = device_ms(lambda: moe.moe_hybrid(params, x, r, mcfg, act,
                                                     hot_experts=H))[0]
            t_dyn = device_ms(lambda: moe.moe_capacity(
                params, x, r, mcfg, act, schedule=trajectory.DYNAMIC))[0]
            t_reo = device_ms(lambda: moe._reorder_experts(params, order))[0]
        log("tiers", f"{what} T={T} C={C}: moe_hybrid == moe_capacity bit "
                     f"for bit (one-hot and sorted; no schedule, in-call "
                     f"dynamic, host); the kernel at E={H} and E={E - H} "
                     f"(analytic tiles {planned[H]} / {planned[E - H]}, and "
                     f"the default) gives the E={E} call's rows bit for bit "
                     f"(its analytic {planned[E]} and default); the two "
                     f"launches vs plain: h at most {mt['over']:.3f} of its "
                     f"bound, share differing {mt['flips']:.3e}, max abs "
                     f"{err:.3e}; {ktext} for both launches, one E={E} "
                     f"launch {t_one:.4f} ms on the device, plain "
                     f"{plain_ms:.4f} ms, bound {bound * 1e3:.1f} us ({by})")
        log("tiers", f"{what} C={C} device ms of each launch: " + ", ".join(
            f"E={e} {t} {ms:.4f}" for (e, t), ms in halves.items())
            + f"; one E={E} launch {planned[E]} {t_one:.4f}")
        log("tiers", f"{what} C={C} device ms per MoE layer: capacity "
                     f"{t_cap:.4f}, capacity dynamic {t_dyn:.4f}, hybrid "
                     f"{t_hyb:.4f} (its two launches and reorder); the "
                     f"reorder copies of the weight stacks alone "
                     f"{t_reo:.4f} ({3 * E * d * m * 2 / 2**20:.0f} MiB "
                     f"read and written, {t_reo / t_hyb:.3f} of hybrid's)")
        rows[path] = dict(max_abs_err=err, **times, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, library_ms=None,
                          tiles=f"hot E={H}: {planned[H]}; cold E={E - H}: "
                                f"{planned[E - H]}")
    del params
    torch.cuda.empty_cache()
    return rows


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


def phase_slice(kernel_ms, cache_root):
    """The default (fused) engine under each autotune level (``--autotune
    off``, ``analytic``, the default, and ``measured``): a first run that
    captures the graphs, then a second run on the same engine that only
    replays them; the three give the same tokens and launches.  Under
    ``measured`` the first engine times the tiles into an empty cache
    under ``cache_root`` and writes the file, and a second engine, with
    the memory dropped, reads it and times nothing.  -> the analytic run's
    streamed_moe launches."""
    import torch
    from repro_torch.core import autotune
    runs = {}
    for level in ("off", "analytic", "measured"):
        if level == "measured":
            cache = os.path.join(cache_root, "slice")
            os.environ["REPRO_AUTOTUNE_CACHE"] = cache
            autotune.forget_measured()
            timed = autotune.TIMINGS
        runs[level] = _slice_run(level, kernel_ms)
        if level == "measured":
            path = os.path.join(cache, autotune.CACHE_FILE)
            if autotune.TIMINGS == timed or not os.path.exists(path):
                fail("slice", f"measured: {autotune.TIMINGS - timed} "
                              f"timings, cache file written "
                              f"{os.path.exists(path)}")
            with open(path) as f:
                entries = json.load(f)
            autotune.forget_measured()
            timed = autotune.TIMINGS
            again = _serve(SLICE_ARGV + ["--autotune", "measured"])
            toks = list(again["outs"].values())
            if autotune.TIMINGS != timed or toks != runs[level]["outs"]:
                fail("slice", f"measured, second engine: "
                              f"{autotune.TIMINGS - timed} timings (want 0 "
                              f"from the cache), same tokens "
                              f"{toks == runs[level]['outs']}")
            log("slice", f"measured: the first engine timed "
                         f"{runs[level]['timed']} candidates and wrote "
                         f"{autotune.CACHE_FILE} ({len(entries)} entries: "
                         + "; ".join(f"{k.split('/')[-1]} -> {v['tiles']} "
                                     f"{v['ms']:.4f} ms" for k, v in
                                     entries.items())
                         + "); a second engine read it, timed 0, captured "
                           "its graphs and served the same tokens")
            del again
        torch.cuda.empty_cache()
    for level, run in runs.items():
        if run["outs"] != runs["analytic"]["outs"] or \
                run["launches"] != runs["analytic"]["launches"]:
            fail("slice", f"--autotune {level}: tokens equal "
                          f"{run['outs'] == runs['analytic']['outs']}, "
                          f"launches {run['launches']} vs "
                          f"{runs['analytic']['launches']} at analytic")
    log("slice", "the same tokens and streamed_moe launches under every "
                 "level; warm tok/s " + ", ".join(
                     f"{level} {run['tps']:.1f}" for level, run in
                     runs.items()))
    return runs["analytic"]["launches"]


def _slice_run(level, kernel_ms):
    """One engine at ``--autotune level``: the cold run, then the warm one
    on the same engine.  -> the warm run's outputs, launches and tok/s, and
    the tiles timed during the cold run."""
    import torch
    from repro_torch.core import autotune
    from repro_torch.launch import serve
    from repro_torch.models.api import leaves
    argv = SLICE_ARGV + ["--autotune", level]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    timed, timing = autotune.TIMINGS, autotune.TIMING_LAUNCHES
    cold = _serve(argv)
    timed = autotune.TIMINGS - timed
    timing = autotune.TIMING_LAUNCHES - timing
    eng, cfg = cold["engine"], cold["cfg"]
    ms = eng.megastep()
    nb = len(ms.boundaries)
    launches = _launches(eng)
    expected = _n_moe(cfg) * (4 + eng.stats["iterations"])
    if launches != expected + timing:
        fail("slice", f"{level} first run: streamed_moe launched {launches} "
                      f"times, want {expected} MoE-layer calls and {timing} "
                      f"launches of the tile timing")
    log("slice", f"--autotune {level} first run (captures): "
                 f"{cold['seconds']:.3f}s, "
                 f"{ms.captures} graphs captured in {ms.capture_s:.3f}s, "
                 f"streamed_moe launches {launches} == {expected} MoE calls "
                 f"+ {timing} of the timing of {timed} tile candidates")
    captures, syncs0, iters0 = ms.captures, eng.stats["host_syncs"], \
        eng.stats["iterations"]
    _zero_counts(eng)
    res = serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"] + argv),
                    engine=eng)
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
    log("slice", f"--autotune {level}: {ARCH} full width bf16 "
                 f"({n_params / 1e9:.3f} B params, "
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
    log("slice", f"--autotune {level}: streamed_moe share of wall time ~ "
                 f"launches x device kernel ms / wall = "
                 f"{launches * kernel_ms / 1e3 / res['seconds']:.3f}")
    return dict(outs=list(res["outs"].values()), launches=launches, tps=tps,
                timed=timed)


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


def phase_fused_vs_eager(spec_path):
    """The fused engine (CUDA graphs) against the eager per-layer loop on
    the card, bf16, full width, the same prompts: static; dynamic with
    slack 0.2 (so deferral fires); both again with sorted dispatch (the
    spec at ``spec_path``); and chunked admission."""
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
    dynamic = ["--schedule", "dynamic", "--slack", "0.2"]
    sorted_ = ["--moe-spec", spec_path]
    for argv in ([], dynamic, sorted_, sorted_ + dynamic):
        res = _serve(SLICE_ARGV + argv)
        params, eng = res["params"], res["engine"]
        eager = Engine(params, res["cfg"], dataclasses.replace(
            eng.scfg, fused=False), device="cuda")
        got, secs = serve(eager, res["prompts"], res["max_new"])
        what = " ".join(argv).replace(spec_path, "sorted dispatch") \
            or "static"
        _same_run((eng, list(res["outs"].values())), (eager, got), what)
        log("fused", f"{what}: fused == eager (tokens, "
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


def _traffic(engine=None, extra=()):
    from repro_torch.launch import serve
    return serve.run_traffic(serve.parse_args(
        ["--arch", ARCH, "--seed", "0"] + TRAFFIC_ARGV + list(extra)),
        wall_clock=False, engine=engine)


def _steps(eng, since):
    """(prefill steps, decode steps) an engine ran after iteration ``since``,
    from its trace."""
    return tuple(len({r["iter"] for r in eng.trace
                      if r.get("phase") == ph and r["iter"] > since})
                 for ph in ("prefill", "decode"))


def _check_traffic_launches(eng, n_moe, since, phase, per_layer=1):
    """streamed_moe launches since the counts were set to 0 (the engine's
    first run, or a warm one from iteration ``since``): ``per_layer`` (2
    under ``hybrid``) per MoE layer per prefill step and per decode step.
    -> (all launches, those of the prefill graph, at C = C_CHUNK)."""
    ms = eng.megastep()
    prefill_steps, decode_steps = _steps(eng, since)
    n = n_moe * per_layer
    # a segment's first call, before its capture, is the call of record
    chunk = ms.captured["prefill"] * ms.replays["prefill"] + \
        (n if since == 0 and prefill_steps else 0)
    launches = _launches(eng)
    if chunk != n * prefill_steps or \
            launches != n * (prefill_steps + decode_steps):
        fail(phase, f"streamed_moe launches {launches} ({chunk} at C = "
                    f"{C_CHUNK}), want {n} x ({prefill_steps} prefill + "
                    f"{decode_steps} decode steps)")
    return launches, chunk


def phase_traffic(spec_path):
    """Scheduler + run_closed_loop over a Poisson stream at full width,
    bf16, on the iteration clock (as the reference's benchmarks); the
    modeled chiplet clock beside it; then the same stream with sorted
    dispatch.  -> {path: (the engine, the streamed_moe launches at C =
    C_CHUNK, the outputs)} for serve_chunked and serve_sorted."""
    out = {"serve_chunked": _traffic_run("one-hot")}
    out["serve_sorted"] = _traffic_run("sorted dispatch",
                                       ["--moe-spec", spec_path])
    a, b = (res["result"]["outputs"] for res, _ in out.values())
    log("traffic", f"sorted dispatch: {sum(a[r] == b[r] for r in a)} of "
                   f"{len(a)} requests emit one-hot's tokens (bf16: the two "
                   f"combines round their fp32 sums apart)")
    return {path: (res["engine"], n, res["result"]["outputs"])
            for path, (res, n) in out.items()}


def _traffic_run(what, extra=()):
    import torch
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    res = _traffic(extra=extra)
    eng, out = res["engine"], res["result"]
    m = out["metrics"]
    ms = eng.megastep()
    if m.completed != 16 or out["dropped"]:
        fail("traffic", f"{what}: {m.completed}/16 completed, dropped "
                        f"{out['dropped']}")
    toks = sum(len(t) for t in out["outputs"].values())
    prefill_steps, _ = _steps(eng, 0)
    launches, chunk_launches = _check_traffic_launches(
        eng, _n_moe(res["cfg"]), 0, "traffic")
    s = eng.stats
    log("traffic", f"{what}: {ARCH} full width bf16, 16 Poisson requests "
                   f"(rate 0.5 per iteration, prompts ~64 of at most 128, 2-32 new "
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
        log("traffic", f"{what} {name}: p50 {pct['p50']:.2f} p95 "
                       f"{pct['p95']:.2f} "
                       f"iterations; modeled p50 {pct_m['p50'] * 1e3:.4f} "
                       f"p95 {pct_m['p95'] * 1e3:.4f} ms")
    log("traffic", f"{what}: {s['prefill_chunks']} prefill chunks "
                   f"({s['prefill_tokens']} tokens) in {prefill_steps} prefill steps, "
                   f"{s['host_syncs'] / m.iterations:.2f} host syncs per "
                   f"iteration, streamed_moe launches {launches} "
                   f"({chunk_launches} at C = {C_CHUNK}), peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return res, chunk_launches


def phase_hybrid(traffic):
    """The slice (phase 4's requests, bf16, full width) on the fused engine
    under ``hybrid`` and under ``capacity``, both with the dynamic schedule:
    a cold run that captures, then a warm one that replays.  The same
    tokens; twice the streamed_moe launches per MoE layer; no recapture;
    a ``hot`` list of ``_n_hot`` ids on every MoE record.  Then hybrid
    with ``--resident-budget-mb 576``: the same tokens, 8 x 24 experts
    resident, DDR bytes saved, a modeled total no larger.  Then phase 6's
    Poisson stream under ``hybrid`` (static): phase 6's one-hot tokens,
    twice its launches.  ``traffic`` is phase 6's result.  -> (the
    kernels line's launches for serve_hybrid (the warm slice) and
    serve_hybrid_chunked (at C = C_CHUNK), the resident run's engine)."""
    import torch
    from repro_torch.launch import serve
    runs = {}
    for what, argv in (("capacity", ["--strategy", "capacity",
                                     "--schedule", "dynamic"]),
                       ("hybrid", HYBRID_ARGV),
                       ("hybrid+resident", HYBRID_ARGV + [
                           "--resident-budget-mb", str(RESIDENT_MB)])):
        _zero_counts()
        cold = _serve(SLICE_ARGV + argv)
        eng, cfg = cold["engine"], cold["cfg"]
        ms = eng.megastep()
        captures, iters0 = ms.captures, eng.stats["iterations"]
        _zero_counts(eng)
        warm = serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"]
                                          + SLICE_ARGV + argv), engine=eng)
        iters = eng.stats["iterations"] - iters0
        launches = _launches(eng)
        per_layer = 1 if what == "capacity" else 2
        want = per_layer * _n_moe(cfg) * (4 + iters)
        if launches != want:
            fail("hybrid", f"{what}: streamed_moe launched {launches} times "
                           f"in the warm run, want {want}")
        if ms.captures != captures:
            fail("hybrid", f"{what}: recaptured in steady state: "
                           f"{captures} -> {ms.captures}")
        recs = [r for r in eng.trace if "counts" in r]
        if what != "capacity" and not all(
                len(r.get("hot", ())) == eng._n_hot for r in recs):
            fail("hybrid", f"{what}: a MoE record without {eng._n_hot} hot "
                           f"ids")
        _check_on_card(warm, "hybrid")
        runs[what] = dict(eng=eng, outs=[list(cold["outs"].values()),
                                         list(warm["outs"].values())],
                          launches=launches, iters=iters,
                          modeled=sum(r["modeled_s"] for r in recs))
        s = eng.stats
        log("hybrid", f"{what}: {ARCH} full width bf16, fused, dynamic "
                      f"schedule, 4 requests x 16 tokens: cold "
                      f"{cold['seconds']:.3f}s ({ms.captures} captures), "
                      f"warm {warm['seconds']:.3f}s, {iters} decode "
                      f"iterations, streamed_moe launches {launches} == "
                      f"{per_layer} x {_n_moe(cfg)} x (4 + {iters}), "
                      f"captures unchanged; hot ids {eng._n_hot} a record, "
                      f"{s['hybrid_repartitions']} repartitions; resident "
                      f"{s['resident_weight_bytes']} bytes "
                      f"({eng._n_resident}/layer), DDR bytes saved "
                      f"{s['ddr_bytes_saved']}; modeled "
                      f"{runs[what]['modeled'] * 1e3:.4f} ms over "
                      f"{len(recs)} records")
        del cold, warm
    cap, hyb, res = (runs[w] for w in ("capacity", "hybrid",
                                       "hybrid+resident"))
    if hyb["outs"] != cap["outs"] or res["outs"] != cap["outs"]:
        fail("hybrid", f"tokens differ from capacity's: hybrid "
                       f"{hyb['outs'] == cap['outs']}, resident "
                       f"{res['outs'] == cap['outs']}")
    if hyb["launches"] != 2 * cap["launches"] or hyb["iters"] != cap["iters"]:
        fail("hybrid", f"hybrid launches {hyb['launches']} over "
                       f"{hyb['iters']} iterations, capacity "
                       f"{cap['launches']} over {cap['iters']}")
    eng = res["eng"]
    want = RESIDENT_PER_LAYER * _n_moe(eng.cfg) * eng.cost_model.expert_bytes
    if eng._n_resident != RESIDENT_PER_LAYER or \
            eng.stats["resident_weight_bytes"] != want or \
            eng.stats["ddr_bytes_saved"] <= 0 or \
            res["modeled"] > hyb["modeled"]:
        fail("hybrid", f"resident tier: {eng._n_resident}/layer, "
                       f"{eng.stats['resident_weight_bytes']} bytes (want "
                       f"{want}), {eng.stats['ddr_bytes_saved']} DDR bytes "
                       f"saved, modeled {res['modeled']} vs {hyb['modeled']}")
    log("hybrid", f"hybrid == capacity token for token (cold and warm), "
                  f"launches {hyb['launches']} == 2 x {cap['launches']}; "
                  f"resident: the same tokens, {want} resident bytes, "
                  f"modeled {res['modeled'] / hyb['modeled']:.4f} of "
                  f"hybrid's")
    for w in ("capacity", "hybrid"):
        del runs[w]["eng"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = _traffic(extra=["--strategy", "hybrid"])
    teng, out = t["engine"], t["result"]
    want = traffic["serve_chunked"][2]
    if out["outputs"] != want or out["dropped"]:
        fail("hybrid", f"traffic under hybrid: "
                       f"{sum(out['outputs'].get(r) == want[r] for r in want)}"
                       f" of {len(want)} requests emit capacity's tokens, "
                       f"dropped {out['dropped']}")
    launches, chunk = _check_traffic_launches(teng, _n_moe(t["cfg"]), 0,
                                              "hybrid", per_layer=2)
    log("hybrid", f"phase 6's stream under hybrid: the one-hot capacity "
                  f"run's tokens for all {len(want)} requests; streamed_moe "
                  f"launches {launches} ({chunk} at C = {C_CHUNK}), twice "
                  f"capacity's; {t['seconds']:.3f}s with "
                  f"{teng.megastep().captures} captures; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del t, teng
    torch.cuda.empty_cache()
    return {"serve_hybrid": hyb["launches"],
            "serve_hybrid_chunked": chunk}, eng


def referee_gaps(trace, spec, cf):
    """A trace's ``modeled_s`` against the port's discrete referee on the
    Table-I prototype: each record's against ``simulate_trajectory`` (its
    recorded trajectory when dynamic, the padded plan when static, its
    resident experts streaming nothing), the total against
    ``replay_trace``.  -> (worst record gap, that record as (iteration,
    layer, phase, activations, modeled s, referee s), total gap, records
    held, total modeled s, total referee s)."""
    import numpy as np
    from repro_torch.sim import hardware, modes
    hw = hardware.PROTOTYPE_2X2
    worst, where, n = 0.0, None, 0
    for rec in trace:
        if "counts" not in rec:
            continue
        counts = np.asarray(rec["counts"], np.float64)
        if counts.sum() <= 0:
            continue
        kw = dict(capacity_factor=cf, resident=rec.get("resident"))
        if rec["schedule"] == "dynamic":
            ref = modes.simulate_trajectory(
                hw, spec, counts, order=rec.get("trajectory") or rec["order"],
                **kw)
        else:
            ref = modes.simulate_trajectory(hw, spec, counts, padded=True,
                                            **kw)
        gap = abs(rec["modeled_s"] - ref) / ref
        n += 1
        if gap >= worst:
            worst, where = gap, (rec["iter"], rec["layer"], rec["phase"],
                                 int(counts.sum()), rec["modeled_s"], ref)
    total_m = sum(r.get("modeled_s", 0.0) for r in trace)
    total_r = modes.replay_trace(hw, spec, trace, capacity_factor=cf)
    return worst, where, abs(total_m - total_r) / total_r, n, total_m, total_r


def phase_referee(traces):
    """Each trace the card produced (``traces``: label -> engine) replayed
    through the port's chiplet simulator on ``spec_from_config`` of the
    engine's full-width config (``referee_gaps``): every record within
    5%, the total within 2%.  Then, not gated, the paper's strategies
    (``simulate_layer`` on ``workloads_from_trace``) and ``rank_modes``
    on the busiest prefill and decode iterations of the first trace."""
    from repro_torch.sim import engine as sim_engine
    from repro_torch.sim import hardware, modes, workload
    hw = hardware.PROTOTYPE_2X2
    first = None
    for label, eng in traces.items():
        spec = hardware.spec_from_config(
            eng.cfg, weight_bytes=eng.cost_model.weight_bytes)
        worst, where, agg, n, total_m, total_r = referee_gaps(
            eng.trace, spec, eng.cfg.moe.capacity_factor)
        line = (f"{label}: {n} records; worst record {worst:.4%} (iteration "
                f"{where[0]}, layer {where[1]}, {where[2]}, {where[3]} "
                f"activations: modeled {where[4] * 1e6:.3f} us, referee "
                f"{where[5] * 1e6:.3f} us; tol {REFEREE_RECORD_TOL:.0%}); "
                f"total modeled {total_m * 1e3:.4f} ms, replay_trace "
                f"{total_r * 1e3:.4f} ms, gap {agg:.4%} (tol "
                f"{REFEREE_TOTAL_TOL:.0%})")
        if worst > REFEREE_RECORD_TOL or agg > REFEREE_TOTAL_TOL:
            fail("referee", line)
        log("referee", line)
        if first is None:
            first = (label, eng, spec)
    label, eng, spec = first
    groups = {}
    recs = [r for r in eng.trace if "counts" in r]
    for rec, (it, _, wl) in zip(recs, workload.workloads_from_trace(
            eng.trace, hw.num_chiplets)):
        groups.setdefault((rec["phase"], it), []).append(wl)
    for ph in ("prefill", "decode"):
        keys = [key for key in groups if key[0] == ph]
        if not keys:
            continue
        key = max(keys, key=lambda k: sum(w.total_tokens for w in groups[k]))
        it, wls = key[1], groups[key]
        tokens = max(1, wls[0].total_tokens // spec.top_k)
        lat = {st: sum(sim_engine.simulate_layer(hw, spec, wl, st).latency
                       for wl in wls) for st in SIM_STRATEGIES}
        ranks = modes.rank_modes(hw, spec, tokens, B=tokens, S=1)
        log("referee", f"{label}, {ph} iteration {it} ({tokens} tokens, "
                       f"{len(wls)} MoE layers) on the modeled 2x2 array, "
                       f"not gated: simulate_layer ms " + ", ".join(
                           f"{st} {v * 1e3:.4f}" for st, v in lat.items())
                       + f" (FSE-DP paired over EP "
                       f"{lat['ep'] / lat['fse_dp_paired']:.3f}x); "
                       f"rank_modes ms " + ", ".join(
                           f"{m} {v * 1e3:.4f}" for m, v in ranks.items()))


def phase_prefix():
    """PREFIX_TRAFFIC through the scheduler on fused engines (max_batch 8,
    max_ctx 256, CHUNK-token chunks), once with one-hot and once with
    sorted dispatch: the PREFIX_LOOPS closed loops, then the cached loop
    once more on its engine, warm.  -> the warm one-hot run's streamed_moe
    launches at C = C_CHUNK (the serve_prefix path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import api
    from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                     ServeConfig, TrafficConfig,
                                     make_traffic, run_closed_loop)
    cfg = get_config(ARCH)
    n_moe = _n_moe(cfg)
    params = api.init_params(cfg, seed=0, device="cuda")
    traffic = make_traffic(TrafficConfig(vocab=cfg.vocab_size,
                                         **PREFIX_TRAFFIC))
    n_req = PREFIX_TRAFFIC["num_requests"]

    def loop(eng, label):
        since = eng.iterations
        _zero_counts(eng)
        sched = Scheduler(eng, SchedulerConfig(queue_capacity=64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_closed_loop(sched, traffic)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = res["metrics"]
        if m.completed != n_req or res["dropped"]:
            fail("prefix", f"{label}: {m.completed}/{n_req} completed, "
                           f"dropped {res['dropped']}")
        launches, chunk = _check_traffic_launches(eng, n_moe, since, "prefix")
        toks = sum(len(t) for t in res["outputs"].values())
        return res, dict(secs=secs, toks=toks, launches=launches, chunk=chunk)

    serve_prefix = None
    for spec in (ExecutionSpec(strategy="capacity"),
                 ExecutionSpec(**SORTED_SPEC)):
        what = "sorted" if spec.sorted_dispatch else "one-hot"
        runs = {}
        for name, cache, depth in PREFIX_LOOPS:
            eng = Engine(params, cfg, ServeConfig(
                max_batch=TRAFFIC_BATCH, max_ctx=256, chunk_tokens=CHUNK,
                prefix_cache=cache, preempt_queue_depth=depth, spec=spec),
                device="cuda")
            res, info = loop(eng, f"{what} {name}")
            runs[name] = (eng, res, info)
        want = runs["unbounded"][1]["outputs"]
        base_tokens = runs["unbounded"][0].stats["prefill_tokens"]
        for name, (eng, res, info) in runs.items():
            m, s = res["metrics"], eng.stats
            if res["outputs"] != want:
                bad = [r for r in want if res["outputs"][r] != want[r]]
                fail("prefix", f"{what} {name}: {len(bad)} requests emit "
                               f"other tokens than the unbounded run "
                               f"({bad[:4]})")
            if name != "unbounded" and not (m.preemptions > 0
                                           and m.preemptions == m.restores):
                fail("prefix", f"{what} {name}: {m.preemptions} preemptions,"
                               f" {m.restores} restores")
            if "cache" in name and m.cache_hits == 0:
                fail("prefix", f"{what} {name}: no cache hit")
            ms = eng.megastep()
            share = 1 - s["prefill_tokens"] / base_tokens
            log("prefix", f"{what} {name}: {m.completed}/{n_req} completed, "
                          f"outputs == unbounded; {m.iterations} "
                          f"iterations, {info['toks']} tokens in "
                          f"{info['secs']:.3f}s with {ms.captures} captures; "
                          f"{m.preemptions} preemptions / {m.restores} "
                          f"restores, {m.cache_hits} cache hits / "
                          f"{m.cache_misses} misses, "
                          f"{s['prefill_tokens_saved']} prefill tokens "
                          f"saved, prefill tokens computed "
                          f"{s['prefill_tokens']} of the unbounded run's "
                          f"{base_tokens} (share saved {share:.3f}; the "
                          f"reference gates {PREFIX_SAVINGS_FLOOR:.2f} on "
                          f"its own mix); TTFT p50 {m.ttft['p50']:.2f} p95 "
                          f"{m.ttft['p95']:.2f} iterations; streamed_moe "
                          f"launches {info['launches']} ({info['chunk']} at "
                          f"C = {C_CHUNK}); pool peak {s['pool_peak_pages']}"
                          f"/{s['pool_pages']} pages")
        eng, _, _ = runs["preempt+cache"]
        ms = eng.megastep()
        captures = ms.captures
        res, info = loop(eng, f"{what} warm")
        if len(eng._megasteps) != 1 or ms.captures != captures:
            fail("prefix", f"{what} warm: recaptured ({captures} -> "
                           f"{ms.captures} captures, "
                           f"{len(eng._megasteps)} settings)")
        if res["outputs"] != want:
            fail("prefix", f"{what} warm: outputs differ from the unbounded "
                           f"run")
        m = res["metrics"]
        log("prefix", f"{what} preempt+cache warm, on the same engine: "
                      f"outputs == unbounded, no new capture ({captures}); "
                      f"{info['toks']} tokens in {info['secs']:.3f}s "
                      f"({info['toks'] / info['secs']:.1f} tok/s wall); "
                      f"{m.preemptions} preemptions, {m.cache_hits} cache "
                      f"hits; streamed_moe launches {info['launches']} "
                      f"({info['chunk']} at C = {C_CHUNK}, "
                      f"{eng.graph_launches()} by graph replays)")
        if not spec.sorted_dispatch:
            serve_prefix = info["chunk"]
        del runs, eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return serve_prefix


def _profiled(fn):
    """Run ``fn`` once under torch.profiler.  -> (wall seconds of ``fn``,
    its device records as (ms, count, name), largest first, the kineto
    events, how far past the host's idle time the last device record
    ends (ms), the warm-up records kept).

    Kineto keeps only the device records that lie inside its capture
    window, and on the card their timestamps stray from the host's clock
    (PERF.md, section 6): a run's last records can end tens of ms after
    the host saw the device idle, and the first records of a session can
    be stamped before the window opened.  So the window opens
    PROFILE_PAD_S before ``fn``'s work, PROFILE_WARMUP spin kernels run
    first and take the stray first stamps, and the window closes
    PROFILE_PAD_S after the device is idle.  The spin kernels are left
    out of the records returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        idle_ns = time.time_ns()
        time.sleep(PROFILE_PAD_S)
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    work = [e for e in device if "spin_kernel" not in e.name()]
    by_name = {}
    for e in work:
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    late = (max(e.end_ns() for e in work) - idle_ns) / 1e6
    return (wall, sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                         reverse=True), events, late, len(device) - len(work))


def _graph_breakdown(events, eng):
    """The profiler's ``up_kernel`` records by the launch they belong to,
    against the engine's counts: graph launches seen and replayed, and
    the multiset of up_kernel records per graph launch against captured
    launches x replays of each graph."""
    import collections
    from torch.autograd import DeviceType
    from repro_torch.kernels import streamed_moe as sm
    graph = {e.correlation_id() for e in events
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cudaGraphLaunch")}
    per_launch = collections.Counter(dict.fromkeys(graph, 0))
    eager = 0
    for e in events:
        if e.device_type() == DeviceType.CUDA and "up_kernel" in e.name():
            if e.correlation_id() in graph:
                per_launch[e.correlation_id()] += 1
            else:
                eager += 1
    want = collections.Counter()
    for ms in eng._megasteps.values():
        for name, n in ms.replays.items():
            want[ms.captured[name]] += n
    return (f"graph launches seen {len(graph)}, replayed "
            f"{sum(want.values())}; up_kernel records per graph launch "
            f"{dict(sorted(collections.Counter(per_launch.values()).items()))}"
            f", counted {dict(sorted(want.items()))}; eager up_kernel "
            f"records {eager}, counted {sm.LAUNCHES}")


def _profile(label, fn, eng=None):
    """Run ``fn`` once under torch.profiler: device kernel time by kernel
    name and the device's busy share of the wall time; -> (device busy
    seconds, the rows of ``_profiled``).  With an engine,
    its streamed_moe launches in that run (the counts set to 0 first) are
    held against the profiler's count of ``up_kernel`` launches; on a
    mismatch the records are broken down by graph launch, and the phase
    fails."""
    if eng is not None:
        _zero_counts(eng)
    wall, rows, events, late, _ = _profiled(fn)
    busy = sum(ms for ms, _, _ in rows) / 1e3
    log("profile", f"{label}: wall {wall:.3f}s, device kernel time "
                   f"{busy:.3f}s, busy share {busy / wall:.3f}; the last "
                   f"device record ends {late:.3f} ms after the host saw "
                   f"the device idle (window closes {PROFILE_PAD_S}s after)")
    # the ten largest, then the port's own kernels further down the list
    ours = ("::up_kernel", "::down_kernel", "::flash_fwd", "::ssd_", "::split3")
    for ms, n, name in rows[:10] + [r for r in rows[10:]
                                    if any(k in r[2] for k in ours)]:
        log("profile", f"{label}: {ms:9.2f} ms {n:6d} x {name[:100]}")
    if eng is not None:
        seen = sum(n for _, n, name in rows if "up_kernel" in name)
        counted = _launches(eng)
        if seen != counted:
            fail("profile", f"{label}: the profiler saw {seen} up_kernel "
                            f"launches, the counts say {counted}: "
                            f"{_graph_breakdown(events, eng)}")
        log("profile", f"{label}: the profiler's up_kernel launches {seen} "
                       f"== streamed_moe launches counted {counted}")
    return busy, rows


def _index_select_ms(rows):
    """Device ms of the kernels ``index_select`` runs as (a vectorized
    gather, or indexSelect*) among profiled rows: the expert reorder
    copies, and any other gather by index."""
    return sum(ms for ms, _, name in rows
               if any(k in name.lower().replace("_", "")
                      for k in ("indexselect", "gatherkernel")))


def phase_profile(traffic_engines):
    """The fused slice (bf16, then fp8 weights) and the traffic runs
    (one-hot, sorted), each on an engine whose graphs are captured already,
    and the bf16 scoring losses (granite one-hot and sorted, mamba), once
    more under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    selected = {}
    for label, argv in (("slice", []),
                        ("slice fp8", ["--weight-dtype", "fp8"]),
                        ("slice capacity dynamic", ["--schedule", "dynamic"]),
                        ("slice hybrid", HYBRID_ARGV)):
        eng = _serve(SLICE_ARGV + argv)["engine"]          # captures
        busy, rows = _profile(label, lambda: serve.run(serve.parse_args(
            ["--arch", ARCH, "--seed", "0"] + SLICE_ARGV + argv), engine=eng),
            eng)
        selected[label] = (_index_select_ms(rows), busy * 1e3)
        del eng
    (s_ms, _), (d_ms, _), (h_ms, h_busy) = (selected[k] for k in (
        "slice", "slice capacity dynamic", "slice hybrid"))
    log("profile", f"slice hybrid: index_select's gather kernels "
                   f"{h_ms:.2f} ms of {h_busy:.2f} ms device time "
                   f"({h_ms / h_busy:.3f}); the "
                   f"static capacity slice's {s_ms:.2f} ms are gathers that "
                   f"are no reorder, so the reorder copies (weight stacks, "
                   f"rows and their restore) take {h_ms - s_ms:.2f} ms, "
                   f"{(h_ms - s_ms) / h_busy:.3f} of hybrid's device time "
                   f"(capacity dynamic: {d_ms - s_ms:.2f} ms)")
    for path, eng in traffic_engines.items():
        _profile({"serve_chunked": "traffic",
                  "serve_sorted": "traffic sorted"}[path],
                 lambda: _traffic(eng), eng)
    for label, arch, kw in (("forward", ARCH, dict(spec="capacity",
                                                   use_flash=True)),
                            ("forward sorted", ARCH, dict(spec=SORTED_SPEC,
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
    _forward_sorted(params, batch, cfg, loss, n_attn)
    _combine_cost(params, batch, cfg)
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


def _single_gemm_combine(combine, ye):
    """The reference's one-hot combine: one (T, E·C) x (E·C, d) fp32
    product, whose sums follow where a token's k terms fall along E·C (not
    batch invariant on the card: PERF.md, section 6).  Timed beside the
    port's ``moe.one_hot_combine``, never used to serve."""
    import torch
    return torch.einsum("tec,ecd->td", combine, ye)


def _combines():
    """The one-hot combines timed side by side: the port's, and the
    reference's single product."""
    from repro_torch.models import moe
    return {"per-expert": moe.one_hot_combine,
            "single GEMM": _single_gemm_combine}


def _peak_bytes(fn):
    """Device memory ``fn`` allocates at its peak beyond what is held."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _combine_cost(params, batch, cfg):
    """The cost of the batch-invariant one-hot combine on the default
    path: the bf16 scoring forward with ``moe.one_hot_combine`` and with
    the single product patched in its place, run in turn (a, b, b, a
    after one warm-up each), wall and peak memory of each."""
    import torch
    from unittest import mock
    from repro_torch.models import api, moe

    def score(fn):
        with mock.patch.object(moe, "one_hot_combine", fn), torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = api.loss_fn(params, batch, cfg, spec="capacity",
                                  use_flash=True)
            loss.item()
            return time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    fns = _combines()
    for fn in fns.values():
        score(fn)
    got = {label: [] for label in fns}
    for label in list(fns) + list(fns)[::-1]:
        got[label].append(score(fns[label]))
    log("forward", "one-hot combine on the bf16 scoring forward (C = "
                   f"{cfg.moe.capacity_rows(SCORE_B * SCORE_S)}): " + "; ".join(
                       f"{label} wall {statistics.mean(w for w, _ in runs):.4f}s, "
                       f"peak memory {max(p for _, p in runs) / 2**30:.3f} GiB"
                       for label, runs in got.items()))


def _forward_sorted(params, batch, cfg, loss_one_hot, n_attn):
    """The bf16 scoring batch with sorted dispatch: the loss within
    LOSS_TOL (relative) of the one-hot run's; both timed again, one after
    the other."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api

    def score(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = api.loss_fn(params, batch, cfg, spec=spec,
                                  use_flash=True)
        loss = loss.item()
        return loss, time.perf_counter() - t0

    fa.LAUNCHES = sm.LAUNCHES = 0
    loss, secs = score(SORTED_SPEC)
    launches = {"flash_attention": fa.LAUNCHES, "streamed_moe": sm.LAUNCHES}
    _, secs_oh = score("capacity")
    T = SCORE_B * SCORE_S
    rel = abs(loss - loss_one_hot) / abs(loss_one_hot)
    line = (f"sorted dispatch, bf16: loss {loss:.6f} against one-hot's "
            f"{loss_one_hot:.6f}, rel {rel:.3e} (tol {LOSS_TOL:g}); "
            f"{secs:.3f}s = {T / secs:.0f} scored tok/s (one-hot timed "
            f"again right after: {secs_oh:.3f}s = {T / secs_oh:.0f} scored "
            f"tok/s); launches {launches}")
    if launches != {"flash_attention": n_attn, "streamed_moe": _n_moe(cfg)}:
        fail("forward", line)
    if not rel <= LOSS_TOL:
        fail("forward", line)
    log("forward", line)


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
        import tempfile
        import torch
        # the measured level's cache: never the checkout's
        autotune_cache = tempfile.TemporaryDirectory()
        os.environ["REPRO_AUTOTUNE_CACHE"] = autotune_cache.name
        phase_build()
        rows = phase_kernels()
        sorted_row = phase_dispatch()
        rows["streamed_moe"].update(serve_sorted=sorted_row,
                                    serve_prefix=sorted_row)
        phase_tiles()
        rows["streamed_moe"].update(phase_tiers())
        with tempfile.TemporaryDirectory() as cache_root:
            launches = {("streamed_moe", "serve"): phase_slice(
                rows["streamed_moe"]["serve"]["device_ms"], cache_root)}
        with tempfile.TemporaryDirectory() as tmp:
            spec_path = os.path.join(tmp, "sorted-dispatch.json")
            with open(spec_path, "w") as f:
                json.dump(SORTED_SPEC, f)
            phase_fused_vs_eager(spec_path)
            traffic = phase_traffic(spec_path)
        for path, (_, n, _) in traffic.items():
            launches["streamed_moe", path] = n
        hybrid, resident = phase_hybrid(traffic)
        for path, n in hybrid.items():
            launches["streamed_moe", path] = n
        phase_referee({"traffic one-hot": traffic["serve_chunked"][0],
                       "traffic sorted": traffic["serve_sorted"][0],
                       "hybrid + resident slice": resident})
        del resident
        launches["streamed_moe", "serve_prefix"] = phase_prefix()
        phase_parity()
        launches["streamed_moe", "serve_fp8"] = phase_features()
        for k, n in phase_forward().items():
            launches[k, "forward"] = n
        launches["ssd", "mamba"] = phase_mamba()
        phase_profile({path: eng for path, (eng, _, _) in traffic.items()})
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
