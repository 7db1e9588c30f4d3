#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits 1:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version and the
   reference oracle on the card, at its path's shapes and at small odd
   ones (flash at Nemotron-4-340B's (2, 2048, 96, 192) in bf16 and fp32,
   timed beside SDPA, and at hd 192 with odd S, Sk > Sq and a ragged last
   tile; the bf16 tensor-core paths of flash attention and streamed_moe
   included, held element by element; streamed_moe's int8 / fp8 weights
   with bf16 and fp32 activations, timed at C = 64 and 1024 beside the
   bf16 body's device time; its split-TF32 body (fp32 weights; bf16
   weights with fp32 activations take it for the down product) timed at C
   = 64 and 1280 with fp32 weights and at C = 64 with bf16 weights, and
   held at down products of K = 1024 and 4096; flash in fp32 at hd 64 and
   128, split TF32, odd S and Sk > Sq included, timed at the scoring shape
   beside SDPA fp32; SSD with B and C per group, g = 1 and
   g = h, at c = 256, 100, 65, 64, 32 and 1, through the body the
   wrapper picks and, up to c = 100, through each of its two bodies, with
   plain fp32 on the card (TF32 matmuls refused); the main shape the same
   bits twice; both bodies' device times at c = 8, 32, 64 and 100, where
   the switch was chosen; the split-TF32 bodies' bound is that of their
   TF32 terms, and their rows also carry the fp32 FMAs' as
   ``bound_fp32_ms``), with the time of one call of each
   kernel with its host work beside its device time per call, the bound,
   and for flash attention the times of ``F.scaled_dot_product_attention``
   on the same tensors and the kernel's device time over SDPA's (flash
   in bf16 also at InternVL2's (2, 2304, 16, 128) and at hd 128 with Sq
   not a multiple of 128 and Sk > Sq);
3b. dispatch: ``moe_capacity`` (its rows moved by the ``moe_dispatch``
   kernels) against the one-hot products on one routing at granite
   width, at C = 64 (a decode step), C = 1024 (a traffic prefill step)
   and C = 1280 (the scoring forward, with overflow), static and dynamic:
   it agrees with one-hot (fp32 2e-5, bf16 3e-2), is the same bits twice
   and dynamic == static bit for bit; under drop-free capacity a token's
   output keeps its bits at another row among other tokens, with kernels
   and with ``use_kernels(False)`` and sorted dispatch;
   the device time of dispatch plus combine, one-hot against the plain
   gathers and the ``moe_dispatch`` kernels, with
   the streamed_moe kernel's beside it at the analytic level's tiles and
   at the default's (the kernel held against its plain version on the
   sorted rows at C = 1024); then the ``moe_dispatch`` kernels at the
   benchmark cells' shapes (``ROW_CASES``), bf16: each bit for bit its
   plain version, timed beside its bytes bound, the pair beside the plain
   versions and the one-hot products (the kernels line's moe_dispatch
   rows);
3c. tiles: every streamed_moe tile setting (``TILE_SETTINGS``) against the
   default one on the same operands, bit for bit (output and scratch):
   bf16 at C = 64, 1024, 1280, int8 and fp8 at C = 64, split TF32 (fp32
   weights at C = 64 and 1280, bf16 weights with fp32 x at C = 64), and
   the ragged cases of phase 3 with every weight format under bf16 and
   fp32 x, each also held against the plain version with phase 3's
   checks; then at granite width (C = 64, 1024, 1280 bf16; C = 64 int8
   and fp8; fp32 at C = 64 and 1280; bf16 weights with fp32 x at C = 64)
   each setting's device time beside the planner's prediction and its
   compiled registers, spills and shared memory, the analytic and the
   measured picks, and three ``torch.bmm`` plus the activation as a
   yardstick; the analytic pick must take at most 1.10 times the
   default's device time at each of these eight;
3d. tiers: one granite MoE layer at C = 64 and C = 1024 (drop-free), one-hot
   and sorted: ``moe_hybrid`` (8 hot experts, 24 cold) against
   ``moe_capacity`` on the same routing and schedule bit for bit; the
   kernel at E = 8 and E = 24 against the matching rows of the E = 32 call
   bit for bit (output and scratch), under the analytic tiles and the
   default; the device time of both MoE paths and of the reorder copies;
3j. ssm kernels: streamed_moe at Jamba's decode step (E = 16, C = 16, d =
   4096, m = 14336, bf16, 5.64 GB of weights) against its plain version
   (``moe_bf16_check``, the down product's tolerance scaled to its K) and
   the fp32 oracle (3e-2), every tile setting the default's bits, each
   timed beside the planner's prediction and the 1.68 ms bytes bound;
   then with int8 and fp8 weights against plain (1e-5) and the oracle
   (2e-5), every 8-bit setting the default's bits, timed beside the 8-bit
   bytes bound and the bf16 call's device time; SSD
   at the SSM serving prefill's shapes (one 8-token chunk of mamba2-370m
   and of Jamba, d_state 128 and 16; Jamba's heads at c = 1) against its
   plain version (1e-5) and the oracle, through both bodies;
3m. family kernels: streamed_moe at the decode steps of the paper's Table I
   MoE models (DeepSeek-MoE-16B E = 64, C = 48, d = 2048, m = 1408;
   Qwen3-30B-A3B 128, 64, 2048, 768; Yuan2-M32 32, 16, 2048, 4096;
   Phi-3.5-MoE 16, 16, 4096, 6400; bf16, swiglu) held as in phase 3j, the
   analytic pick's device time over the default's, and with int8 and fp8
   weights as in phase 3j; flash attention at
   InternVL2's scoring shape (2, 2304, 16, 128), bf16 and fp32 (each
   timed, with SDPA), against its plain version and the oracle;
3r. ring widths: streamed_moe at the per-rank widths of the FSE-DP ring at
   P = 8, m = d_expert / (8 micro-slices) on a decode step of 8 slots a
   rank, drop-free: granite (E = 32, C = 64, d = 1024) at 1, 2, 4, 8 and
   16 micro-slices (m = 64, 32, 16, 8, 4) and DeepSeek-MoE-16B (E = 64,
   C = 48, d = 2048) at 2 (m = 88), bf16, plus int8 and fp8 weights at m
   = 4 and 88; the wrapper zero-pads m to its path's multiple (8 for bf16,
   16 for 8-bit weights): the padded launch held with phase 3's checks at
   the default tile setting and at the planner's (the one the ring runs),
   the wrapper's output its bits at each, each timed beside the bytes
   bound with the padding's share of its device time;
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
   greedy tokens must agree; the kernels run's streamed_moe launches are
   the ``serve_fp32`` path's;
8. features: ``--schedule dynamic --slack 0.2`` and ``--weight-dtype fp8``
   on the fused engine (its streamed_moe launch count, 24 per prefill and
   decode iteration, is the ``serve_fp8`` path's);
9. forward: ``api.loss_fn`` scores 2 x 2048 tokens of granite-moe-1b-a400m
   at full width in bf16 through the flash and streamed_moe kernels (24
   launches each), then the same batch in fp32 with kernels (the
   split-TF32 bodies, 24 launches each) and with ``use_kernels(False)``,
   each timed warm (wall, scored tok/s): losses within 1e-4, argmax
   agreement reported; the bf16 call makes two moe_dispatch launches a
   MoE layer and keeps no one-hot product; then REPLAY_CALLS more bf16
   calls, the first capturing a CUDA graph and the rest replaying it
   (``models.graphs``): the first call's loss bits and launches in each;
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
    launches against the counted ones; on the fp8 slice the 8-bit kernel's
    share of the device time beside ``quant.quantize``'s (each call
    quantizes its three weight stacks first);
12. mamba-serve (run after phase 10): mamba2-370m at full width on the
   serve CLI's fused engine (the ``only`` segment): a first run that
   captures, fused == eager on it, a warm run that only replays (1 host
   sync an iteration, 192 SSD launches from the one-shot prefills),
   profiled; chunked
   admission fused == eager; one prefill chunk step's device kernels
   counted under the profiler; a request preempted mid-decode, two
   intruders through both slots, restored: its SSM rows bit for bit and
   the never-preempted run's tokens;
12j. jamba (run after phase 12): Jamba-v0.1 at its published widths, one
   period deep (8 of 32 layers), the parameters built once: the static slice
   (first run, fused == eager, a warm run: 5 host syncs an iteration, no
   recapture, 76 streamed_moe and 28 SSD launches, profiled), the slice
   under the dynamic schedule fused == eager, the prefill kernel count,
   the preemption check, phase 6b's shared-prefix stream unbounded and
   with preemption + the prefix cache (every hit restores an SSM
   snapshot): the same tokens; peak device memory;
13. deepseek (run after phase 12j): DeepSeek-MoE-16B at full width and
   depth (28 layers, 16.88 B parameters, 64 experts top-6 and two shared
   experts on every layer), bf16, ``capacity``: the static slice (first
   run, fused == eager, a warm run: 29 host syncs an iteration, no
   recapture, 28 streamed_moe launches a prefill and a step, profiled),
   the dynamic slice fused == eager, phase 6b's shared-prefix stream
   unbounded and with preemption + the prefix cache: the same tokens;
   peak device memory; and phase dist1's check: one ``decode_fn`` step
   with no spec (``fse_dp``) == ``capacity`` bit for bit, 28 launches;
13q. qwen3: Qwen3-30B-A3B at its published widths, 12 of 48 layers (the
   48 are 61 GB of bf16), the same slice checks without the stream;
14. internvl2: InternVL2-2b at full width and depth: ``loss_fn`` over 2 x
   (256 random patch embeddings + 2048 text tokens) through flash (hd =
   128, 24 launches), bf16, scored tok/s; fp32 with kernels (24 flash
   launches, split TF32) vs ``use_kernels(False)`` (loss 1e-4 relative,
   argmax); fp32
   ``prefill_fn`` with the prefix and greedy ``decode_fn`` steps vs the
   teacher-forced forward (logits 1e-4 of max |logit|);
15. whisper: Whisper-base at full width and depth over 1500 frames:
   ``loss_fn`` (bf16), then fp32 ``prefill_fn`` and 16 greedy
   ``decode_fn`` steps == ``decode_train``'s teacher-forced logits (rtol =
   atol = 2e-3, the reference's test); no TPU kernel on this path;
nemotron. (run after phase 15, once phase 11's traffic engines are gone)
   Nemotron-4-340B, the dense family, at its published widths (d 18432, 96
   heads of hd 192, d_ff 73728, vocab 256000): (b) one layer in fp32,
   ``loss_fn`` through flash (1 launch, split TF32) against
   ``use_kernels(False)``: loss within 1e-4 relative, argmax misses 0.1%;
   then 4 of its 96 layers in bf16, the parameters built once: (a)
   ``loss_fn`` over 2 x 2048 tokens (4 flash launches, no streamed_moe,
   finite, peak memory under 80 GB, scored tok/s) and (c) the slice served
   through ``_serve_family`` (fused == eager, a warm run with no
   recapture and 1 host sync an iteration, warm tok/s, peak memory; no
   kernel: paged attention at hd 192 is torch ops); ``python3
   chip_smoke.py --only nemotron`` runs env, build and this phase alone;
dist1. (run after phase 11) one rank, full width: ``api.loss_fn`` on
   granite (2 x 256 tokens, bf16) with no spec (its config names ``fse_dp``), ``ExecutionSpec()``
   (``auto``), ``ep`` and ``tp``: ``capacity``'s bits, 24 streamed_moe
   launches each; ``serve --moe-spec examples/moe-spec.json`` (``auto``,
   ``fse_dp`` prefill, ``ep`` decode, a layer override, the dynamic
   schedule) against the same spec with every strategy ``capacity``: the
   same tokens, no recapture, the same host syncs an iteration (DeepSeek's
   ``decode_fn`` with no spec runs in phase 13);
dist2. (run after dist1) gloo ranks on the one card (``parallel.localrun``;
   the CUDA payloads go through host buffers): 2 ranks, one full-width granite MoE layer
   (drop-free) on 2 x 64 tokens a rank under ``fse_dp`` forced to stream and
   index at 1 and 4 micro-slices and to slice, ``ep``, ``tp`` and ``auto``,
   static and dynamic, fp32 within 2e-5 and bf16 within 3e-2 of the P = 1
   ``capacity`` output in the same format, dynamic == static bit for bit,
   each rank's launches exactly the case's (2 x micro-slices for stream
   and index, 1 for slice, ep and tp, auto's by its plan); then 8 ranks running the ring at phase 3r's
   widths (bf16; int8 and fp8 where 3r pads them), each within 3e-2 (fp8
   6e-2) of ``capacity``, 8 x micro-slices launches a rank; the seconds a
   call are gloo through host memory, no ring's speed;
train. (run after dist2) the training slice: (a) ``training.train`` on
   granite at full width and depth, bf16, ``remat``, 20 AdamW steps on
   2 x 2048 SyntheticLM tokens (C = 1280): median step, training tok/s,
   peak memory, exactly 48 streamed_moe launches a step (forward and
   recompute), the loss falls and every loss and grad norm is finite;
   (b) fp32 at 4 layers, ``loss_fn`` gradients with kernels vs
   ``use_kernels(False)`` on the plain run's top-k, every leaf within 2e-4
   of its max; int8 weights within 5% relative norm (straight-through);
   (c) ``remat`` == no remat within 1e-6; (d) a crash at step 2 of 4 and
   an auto-resume through checkpoints == the straight run (1e-5); (e) the
   ring (stream, index, slice) at P = 2 and on a (2, 4) mesh, ``ep`` and
   ``tp`` at P = 2, on gloo ranks sharing the card: every rank's weight
   gradients within rtol 5e-3, atol 5e-4 of one rank's ``capacity``
   gradients;
mesh. (run after train) the mesh machinery: streamed_moe timed alone at
   the ring's per-rank call of (a) (E = 32, C = 320, d = 1024, m = 16);
   (a) ``launch.steps.build_train_step`` on granite at full width and
   depth, bf16, remat, lr 1e-4, on a (2, 2) ("data", "model") mesh of 4
   gloo ranks sharing the card (gloo-host), 5 steps of 2 x 2048
   SyntheticLM tokens (a row a data group): finite losses, the same on
   every rank, each rank's streamed_moe launches a step exactly its
   plan's (forward and recompute), each rank storing the d_expert slice
   of every expert; stored bytes of params + AdamW state a rank against
   one device's, peak memory by rank, the median step; (b) fp32 at 4
   layers, drop-free, aux coefficient 0, one step with fsdp off and
   forced on against one device's step: every gathered leaf of params,
   m and v within 2e-4 of its max, the loss within 1e-5 relative; (c) a
   checkpoint saved from (2, 2) restored onto (1, 4) and onto one device
   bit for bit; (d) the dry run: 15 reduced cells (granite, Jamba,
   mamba2-370m, Whisper, InternVL2 x train / prefill / decode at (64,
   8)) on a (2, 4) mesh of 8 ranks on the card, all ok, and shape-only
   every assigned arch x shape on pod16x16 / pod2x16x16 with no error;
   ``python3 chip_smoke.py --only mesh`` runs it alone after the build;
examples. (run after mesh) the port's four examples in this process on
   the card, as a user runs them (``examples/*_torch.py``): the quickstart
   at 2 gloo ranks (step 1's micro-slice sum through ``streamed_moe`` at
   (E, C, d, m) = (4, 16, 32, 16) fp32 within 2e-5 of the whole expert;
   step 2's strategies and forced FSE-DP modes within 2e-4 of the dense
   oracle; step 3 the simulator), the serve example (slack 0 against 0.3
   on reduced fp32 granite: identical outputs), the training example at
   30 steps (the last logged loss below the first) and the simulator
   example; the seconds of each against the phase's 60 s budget, the
   ``streamed_moe`` launches of these runs (the quickstart ranks' are
   their own processes'), then the kernel at the training example's
   forward shape (16, 320, 512, 256) fp32 against its plain version and
   timed; ``python3 chip_smoke.py --only examples`` runs env, build and
   this phase alone;
16. summary: one ``{"kernels": [...]}`` JSON line with one entry per
    kernel and path (``streamed_moe`` on the serve path in bf16 and in fp8,
    on the chunked-prefill path of the traffic run (``serve_chunked``, C =
    1024), on the sorted traffic path (``serve_sorted``) and the prefix
    traffic path (``serve_prefix``), both with the kernel measured at C =
    1024 in phase 3b, under ``hybrid`` at C = 64 (``serve_hybrid``, phase
    4h's warm slice) and C = 1024 (``serve_hybrid_chunked``, phase 4h's
    stream), two launches (E = 8 and 24) a MoE layer timed together in
    phase 3d, at Jamba's decode step (``serve_jamba``, phase 3j's shape),
    and on the forward path, in fp32 on the forward path
    (``forward_fp32``, C = 1280) and the fp32 serving parity run
    (``serve_fp32``, phase 7, with the C = 64 row's times),
    ``flash_attention`` on the forward path in bf16 and in fp32
    (``forward_fp32``),
    ``ssd`` on the mamba path and on the one-shot serving prefill of
    mamba2-370m (``serve_prefill``) and of Jamba
    (``serve_prefill_jamba``), streamed_moe on the served DeepSeek and Qwen3
    slices (``serve_deepseek``, ``serve_qwen3``, phase 3m's shapes),
    ``moe_dispatch`` on the forward path (the scoring forward's launches,
    the times at ROW_CASES' forward shape) and on the served DeepSeek slice
    (``serve_deepseek``, the times at its decode shape),
    flash on InternVL2's scoring forward in bf16 and fp32
    (``forward_internvl2``, ``forward_internvl2_fp32``), flash on
    Nemotron-4-340B's scoring forward in bf16 (``forward_nemotron``, 4
    launches) and its fp32 parity (``forward_nemotron_fp32``, 1 launch),
    both with phase 3's (2, 2048, 96, 192) times,
    streamed_moe on the no-spec granite loss of phase dist1
    (``dist1_loss``), on the ring of phase dist2 at phase 3r's widths
    (``ring_granite_p8_m64`` ... ``_m4``, ``ring_deepseek_p8_m88``, the
    launches of all 8 ranks), on the training path (``train``, phase
    train (a), with the C = 1280 row's times), and on the mesh train step
    (``mesh_train``, phase mesh (a), the launches of all 4 ranks, with
    the per-rank call's times), and on the examples (``examples``, with
    the training example's shape's times)),
    each with that path's launches and its shape's times (``ms`` one call
    with its host work, ``device_ms`` the device time per call) and bound,
    and for streamed_moe the tile setting the path ran (``tiles``); the
    ``nvidia-smi`` name/power line; and the contract line
    ``{"ok": true, "device": {"platform": "gpu", ...}}`` last.

Weights are random from seed 0.  JAX is never imported.
"""
from __future__ import annotations

import gc
import json
import math
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
# but bf16 x bf16 (fp32 activations, or fp32 / int8 / fp8 weights: split
# TF32 or fp32-exact bf16 products on the tensor cores, and with bf16
# weights and fp32 x an h from the plain version's fp32 FMA order, rounded
# to bf16 as it rounds it) the plain version repeats the kernel's
# arithmetic step for step, so the kernel is held to it at 1e-5.  Against
# the fp32 oracle:
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
# ... established for down products of K <= MOE_DOWN_K terms (phase 3's
# cases go to K = 1024).  The error of an fp32 sum grows with its number of
# terms (DOT_GAMMA * K above), so a longer down product is held to
# MOE_DOWN_TOL * K / MOE_DOWN_K: Jamba's K = m = 14336 (phase 3j) to 1.4e-4
MOE_DOWN_K = 1024
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
# SSD's two bodies are both held at every case whose chunk body 2 (sized by
# c) takes, and timed against each other at these chunk lengths, mamba2-370m
# width, where the wrapper's switch (kernels.ssd.SHORT_MAX) was chosen
SSD_BOTH_MAX_C = 100
SSD_SWITCH_C = (8, 32, 64, 100)
# the scoring forward in fp32, kernels vs use_kernels(False): relative loss
LOSS_TOL = 1e-4
# the Mamba-2 block in fp32 with and without the SSD kernel, max abs error
# over max |want|
BLOCK_TOL = 2e-5
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
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
# phase 9: scoring calls after the first (the second captures a CUDA graph,
# the later ones replay it)
REPLAY_CALLS = 4
# phase 3b: the moe_dispatch kernels at the benchmark cells' shapes (T, E,
# C, k, d), bf16, held bit for bit to their plain versions and timed:
# granite's scoring call (the kernels line's forward row), DeepSeek's
# decode step (serve_deepseek) and its drop-free 128-token chunk pass
ROW_CASES = {"forward": (4096, 32, 1280, 8, 1024),
             "serve_deepseek": (8, 64, 48, 6, 2048),
             "chunk_deepseek": (128, 64, 768, 6, 2048)}
# phase 3c: every tile setting against the default on these operands (E,
# C, d, m, activation, weight format, activations' dtype) must give the
# same bits: the serving shapes (decode C = 64, the traffic prefill C =
# 1024, the scoring forward C = 1280) and phase 3's ragged ones
TILE_BITS_CASES = tuple(
    [(32, C_, 1024, 512, "swiglu", "bf16", "bf16") for C_ in (64, 1024, 1280)]
    + [(32, 64, 1024, 512, "swiglu", w, "bf16") for w in ("int8", "fp8")]
    + [(32, C_, 1024, 512, "swiglu", "fp32", "fp32") for C_ in (64, 1280)]
    + [(32, 64, 1024, 512, "swiglu", "bf16", "fp32")]
    + [(4, 37, 256, 96, act, w, x) for act in ("relu2", "gelu")
       for w in ("fp32", "bf16", "int8", "fp8") for x in ("bf16", "fp32")]
    + [(4, 64, 512, 1024, "swiglu", w, "bf16")
       for w in ("bf16", "int8", "fp8")]
    + [(4, 64, 512, 1024, "swiglu", "fp32", "fp32")])
# ... and is timed at these (weights, activations); the analytic pick must
# take at most TILE_GATE times the default's device time on each of them
TILE_TIME_CASES = tuple(
    [(32, C_, 1024, 512, "swiglu", "bf16", "bf16") for C_ in (64, 1024, 1280)]
    + [(32, 64, 1024, 512, "swiglu", w, "bf16") for w in ("int8", "fp8")]
    + [(32, C_, 1024, 512, "swiglu", "fp32", "fp32") for C_ in (64, 1280)]
    + [(32, 64, 1024, 512, "swiglu", "bf16", "fp32")])
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
# phases 3j, 12 and 12j: the SSM and hybrid families.  Jamba runs at its
# published widths, one period deep (1 attention and 7 Mamba-2 layers, 4
# MoE and 4 dense FFN layers, 26.4 GB of bf16 weights): its 32 layers'
# 104 GB do not fit one 80 GB card
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
# streamed_moe at Jamba's decode step: E = 16 experts, C = 8 slots x top-2
# rows (drop-free), d = 4096, m = 14336, swiglu, bf16 (5.64 GB of weights)
JAMBA_MOE = (16, TRAFFIC_BATCH * 2, 4096, 14336)
# SSD at the serving prefill's shapes (b, nc, c, h, g, p, n): an 8-token
# prompt of mamba2-370m and of Jamba (one chunk, c = L = 8), and Jamba's
# heads at c = 1 (the chunk a prompt over 256 tokens that 256 does not
# divide falls back to), not timed
SSD_SERVE_SHAPES = (("serve_prefill", (1, 1, 8, 32, 1, 64, 128)),
                    ("serve_prefill_jamba", (1, 1, 8, 128, 1, 64, 16)),
                    (None, (1, 8, 1, 128, 1, 64, 16)))
# phases 3m and 13-15: the rest of the families (ROADMAP A.13b).  streamed_moe
# at the decode step of the paper's Table I MoE models, (path, E, C, d, m):
# C = TRAFFIC_BATCH slots x top-k rows (drop-free), swiglu, bf16
FAMILY_MOE = (("serve_deepseek", (64, TRAFFIC_BATCH * 6, 2048, 1408)),
              ("serve_qwen3", (128, TRAFFIC_BATCH * 8, 2048, 768)),
              ("decode_yuan2", (32, TRAFFIC_BATCH * 2, 2048, 4096)),
              ("decode_phi3.5", (16, TRAFFIC_BATCH * 2, 4096, 6400)))
DEEPSEEK, QWEN = "deepseek-moe-16b", "qwen3-30b-a3b"
# Qwen3-30B-A3B at its published widths, cut to 12 of its 48 layers: the 48
# are 61 GB of bf16, too little room beside the graph pools and the dynamic
# schedule's 1.2 GB reorder copy on one 80 GB card; every layer has the same
# shapes, so depth adds only time
QWEN_LAYERS = 12
# InternVL2-2b's scoring batch: SCORE_B x SCORE_S text tokens behind its 256
# patch embeddings (flash at (2, 2304, 16, 128)), then greedy decode steps
VLM = "internvl2-2b"
DECODE_STEPS = 16
# Whisper-base: 30 s of audio is 1500 encoder frames; WHISPER_B clips, the
# loss over WHISPER_TOKENS decoder tokens (the decoder's 448-token context);
# decode == teacher forcing at the reference's tests/test_whisper.py
# tolerance (rtol = atol = 2e-3)
WHISPER = "whisper-base"
WHISPER_FRAMES, WHISPER_B, WHISPER_TOKENS = 1500, 4, 448
TF_TOL = 2e-3
# Nemotron-4-340B (arXiv:2402.16819) at its published widths: d 18432, 96
# heads (8 KV) of hd 192, squared-ReLU d_ff 73728, vocab 256000 untied.  A
# layer is 6.91 GB in bf16 and the embedding and head 18.9 GB, so 4 of its
# 96 layers are scored and served (46.5 GB); the fp32 parity takes 1 (13.8
# GB + 37.8 GB of fp32 embedding and head)
NEMOTRON = "nemotron-4-340b"
NEMOTRON_LAYERS, NEMOTRON_FP32_LAYERS = 4, 1
NEMOTRON_HEADS, NEMOTRON_HD = 96, 192
NEMOTRON_PEAK_GB = 80
# phases 5, 12: chunked admission of 8 prompts of 9-120 tokens
CHUNKED_LENS = (64, 30, 100, 17, 64, 50, 9, 120)
# phase 11: seconds the profiler's capture window stays open before and
# after the profiled work, and the spin kernels run first in it (see
# _profiled)
PROFILE_PAD_S = 0.5
PROFILE_WARMUP = 512


_T0 = time.perf_counter()
_LAST_PHASE = [None]


def log(phase, msg):
    """Print ``[phase] msg``; before a phase's first line, the script's
    seconds so far (``[time]``), so the gaps give each phase's share."""
    if phase != _LAST_PHASE[0]:
        _LAST_PHASE[0] = phase
        print(f"[time] {phase} at {time.perf_counter() - _T0:.1f}s",
              flush=True)
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


def streamed_moe_bound_ms(E, C, d, m, wdt, x_bytes, gated=True, split=False):
    """Least time for one call: each input read once, the fp32 output
    written once, against the multiply-adds of both GEMMs at the peak of
    their operands' type (bf16 unless x or the weights are fp32; 8-bit
    weights meet bf16 activations, so not the int8 / fp8 rate).  ``split``
    (fp32 weights): the products as split TF32 on the tensor cores instead
    (495 TFLOP/s), one TF32 product a term: hi hi, hi lo and lo hi, the
    second dropped for bf16 x (exact in TF32)."""
    n_mats = 3 if gated else 2
    weights = n_mats * E * d * m * WEIGHT_BYTES[wdt]
    scales = 0 if wdt not in ("int8", "fp8") else 4 * E * ((n_mats - 1) * m + d)
    moved = weights + scales + E * C * d * x_bytes + E * C * d * 4
    ops = 2 * E * C * d * m * n_mats
    if split:
        if wdt != "fp32":
            raise ValueError("split TF32 takes fp32 weights")
        up = 3 if x_bytes == 4 else 2
        ops = 2 * E * C * d * m * ((n_mats - 1) * up + 3)
        return _bound(moved, ops, "tf32")
    return _bound(moved, ops, "fp32" if wdt == "fp32" or x_bytes == 4
                  else "bf16")


def _bound(moved, ops, kind):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(B, Sq, Sk, H, hd, kind, elt, split=False):
    """q, k, v read once and o written once, against the multiply-adds of
    both products over the (query, key) pairs the causal mask keeps.
    ``split``: fp32 products as split TF32 on the tensor cores instead,
    three TF32 products each at 495 TFLOP/s."""
    pairs = Sq * (Sk - Sq) + Sq * (Sq + 1) // 2
    ops = 4 * hd * pairs * B * H
    moved = elt * B * H * hd * (2 * Sq + 2 * Sk)
    if split:
        return _bound(moved, 3 * ops, "tf32")
    return _bound(moved, ops, kind)


def ssd_bound_ms(b, nc, c, h, g, p, n, split=False):
    """x, B and C (per group) and A_cumsum read once, Y_diag and the states
    written once (fp32), against the fp32 multiply-adds (67 TFLOP/s) of C B^T
    once per group and of (G o L) x per head over the causal (i >= j) pairs,
    and of the state product.  ``split``: those products as split TF32 on
    the tensor cores instead, three TF32 products each at 495 TFLOP/s."""
    heads, groups = b * nc * h, b * nc * g
    pairs = c * (c + 1) // 2
    moved = 4 * (heads * c * 2 * p + groups * c * 2 * n + heads * c
                 + heads * p * n)
    ops = groups * 2 * pairs * n + heads * (2 * pairs * p + 2 * c * n * p)
    return _bound(moved, 3 * ops if split else ops, "tf32" if split else "fp32")


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
    error over max |out|, ``down_tol`` its tolerance at this K."""
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
    down_tol = MOE_DOWN_TOL * max(1.0, w_d.shape[1] / MOE_DOWN_K)
    metrics = dict(over=over, flips=(diff > 0).float().mean().item(),
                   beyond_ulp=int((diff > ulp).sum().item()), down=down,
                   down_tol=down_tol)
    ok = over <= 1.0 and metrics["flips"] <= MOE_FLIP_SHARE \
        and down <= down_tol
    return ok, metrics


def _check_streamed_moe():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    paths = {}
    bf16_device = {}                        # the bf16 body's device ms by C
    E, C, d, m = 32, 64, 1024, 512          # granite, 8 slot rows, top-8
    C_SCORE = 1280                          # the scoring forward's capacity
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(E, C, d, m, "swiglu", wdt, f32 if wdt == "fp32" else bf)
             for wdt in ("bf16", "fp32", "int8", "fp8")]
    cases += [(E, C_, d, m, "swiglu", "bf16", bf) for C_ in (C_CHUNK, C_SCORE)]
    # the split-TF32 body: fp32 at the scoring forward's C, fp32 x x bf16
    # weights at decode, and down products of K = 1024 and 4096
    cases += [(E, C_SCORE, d, m, "swiglu", "fp32", f32),
              (E, C, d, m, "swiglu", "bf16", f32),
              (4, 64, 512, 1024, "swiglu", "fp32", f32),
              (4, 16, 512, 4096, "swiglu", "fp32", f32)]
    # the 8-bit body at the traffic prefill's C, timed beside the bf16 one
    cases += [(E, C_CHUNK, d, m, "swiglu", wdt, bf) for wdt in ("int8", "fp8")]
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
                     f"{mt['down_tol']:g})")
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
            # fp32 weights run in split TF32: their bound is that of the
            # split terms, the fp32 FMAs' beside it
            split = wdt == "fp32"
            bound, by = streamed_moe_bound_ms(E_, C_, d_, m_, wdt,
                                              xe.element_size(), split=split)
            line += (f"; tiles {tiles}: {text}, plain {plain_ms:.4f} ms, "
                     f"{'split-TF32 ' if split else ''}bound "
                     f"{bound * 1e3:.1f} us ({by}), "
                     f"{times['device_ms'] / bound:.2f}x it")
            bound_fp32 = None
            if split:
                bound_fp32, fp32_by = streamed_moe_bound_ms(
                    E_, C_, d_, m_, wdt, xe.element_size())
                line += (f"; fp32-FMA bound {bound_fp32 * 1e3:.1f} us "
                         f"({fp32_by})")
            if wdt == "bf16" and x_dtype == bf:
                bf16_device[C_] = times["device_ms"]
            elif wdt in ("int8", "fp8"):
                line += (f"; the bf16 body's device time here "
                         f"{bf16_device[C_]:.4f} ms")
            path = {("bf16", bf, C): "serve", ("fp8", bf, C): "serve_fp8",
                    ("bf16", bf, C_CHUNK): "serve_chunked",
                    ("bf16", bf, C_SCORE): "forward",
                    ("fp32", f32, C): "serve_fp32",
                    ("fp32", f32, C_SCORE): "forward_fp32"}.get(
                        (wdt, x_dtype, C_))
            if path:
                paths[path] = dict(
                    max_abs_err=err_plain, **times, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None,
                    tiles=tiles)
                if bound_fp32 is not None:
                    paths[path]["bound_fp32_ms"] = bound_fp32
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
    Sk = 2 Sq, and in bf16 hd = 16 and ragged Sk > Sq, InternVL2's
    (2, 2304, 16, 128) (timed in phase 3m) and hd = 128 with Sq not a
    multiple of the 128-row query tile and Sk > Sq, in bf16 and in fp32
    (the split-TF32 body at hd 64 and 128, the CUDA-core one at hd 16 and
    32); Nemotron-4-340B's scoring shape (2, 2048, 96, 192) in bf16 and
    fp32, and at hd 192 odd S, Sk > Sq and one (batch x head) whose last
    query and key tiles are ragged, in both.  The scoring shapes' rows are
    the summary's forward (bf16), forward_fp32, forward_nemotron and
    forward_nemotron_fp32."""
    B, S, H, hd = SCORE_B, SCORE_S, 16, 64
    cases = [(B, S, S, H, hd, "bf16"), (B, S, S, H, hd, "fp32"),
             (1, 17, 17, 3, 64, "fp32"), (2, 100, 100, 4, 64, "bf16"),
             (1, 100, 200, 2, 64, "fp32"), (2, 64, 128, 4, 128, "bf16"),
             (2, 77, 77, 3, 16, "bf16"), (1, 100, 165, 2, 32, "bf16"),
             (1, 130, 301, 2, 64, "bf16"),
             (B, S + 256, S + 256, H, 128, "bf16"),
             (1, 200, 331, 2, 128, "bf16")]
    cases += [(2, 64, 128, 4, 128, "fp32"), (1, 130, 301, 2, 64, "fp32"),
              (1, 200, 331, 2, 128, "fp32"), (2, 77, 77, 3, 16, "fp32"),
              (1, 100, 165, 2, 32, "fp32")]
    cases += [(1, 77, 77, 3, NEMOTRON_HD, kind) for kind in ("bf16", "fp32")]
    cases += [(1, 100, 165, 2, NEMOTRON_HD, kind) for kind in ("bf16", "fp32")]
    cases += [(1, 200, 331, 1, NEMOTRON_HD, kind) for kind in ("bf16", "fp32")]
    rows = [_flash_case(*case, timed=case[1] == S) for case in cases]
    nemotron = [_flash_case(B, S, S, NEMOTRON_HEADS, NEMOTRON_HD, kind,
                            timed=True) for kind in ("bf16", "fp32")]
    return {"forward": rows[0], "forward_fp32": rows[1],
            "forward_nemotron": nemotron[0],
            "forward_nemotron_fp32": nemotron[1]}


def _flash_case(B_, Sq, Sk, H_, hd_, kind, timed=False):
    """Flash attention on one shape against its plain version (fp32 1e-5,
    bf16 ``flash_bf16_check``) and the oracle; ``timed``: its times, the
    plain version's and ``scaled_dot_product_attention``'s beside the
    bound.  -> the kernels line's row when timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
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
    row = None
    if timed:
        times, text = kernel_times(
            lambda: fa.flash_attention_kernel(q, k, v))
        plain_ms = median_ms(lambda: ref.flash_attention_plain(q, k, v),
                             reps=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=True)
        lib_ms, lib_dev = median_ms(sdpa), device_ms(sdpa)[0]
        # fp32 at hd 64 / 128 / 192 runs in split TF32: its bound is that
        # of the split terms, the fp32 FMAs' beside it
        split = kind == "fp32" and hd_ >= 64
        bound, by = flash_bound_ms(B_, Sq, Sk, H_, hd_, kind,
                                   q.element_size(), split=split)
        line += (f"; {text}, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
                 f"ms ({lib_dev:.4f} on the device; the kernel's device "
                 f"time over sdpa's {times['device_ms'] / lib_dev:.3f}), "
                 f"{'split-TF32 ' if split else ''}bound {bound * 1e3:.1f} "
                 f"us ({by}), {times['device_ms'] / bound:.2f}x it")
        row = dict(max_abs_err=err_plain, **times, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=lib_ms,
                   library_device_ms=lib_dev)
        if split:
            row["bound_fp32_ms"], fp32_by = flash_bound_ms(
                B_, Sq, Sk, H_, hd_, kind, q.element_size())
            line += (f"; fp32-FMA bound {row['bound_fp32_ms'] * 1e3:.1f} us "
                     f"({fp32_by})")
    log("kernels", line)
    return row


def _check_ssd():
    """mamba2-370m's (b, nc, c, h, p, n) = (2, 8, 256, 32, 64, 128) with B and
    C per group as the path passes them (g = 1, the one the summary
    reports) and per head (g = h, the reference's layout), then a chunk of
    one partial tile (c = 32) and one whose last tile is partial after a
    full one (c = 100), each with g = 1 and g = h = 3; c = 64 and 65 at
    mamba2-370m's width (one tile, and one row past it) and c = 1.  The
    main shape gives the same bits twice.  Then both bodies' device times at
    SSD_SWITCH_C."""
    import torch
    from repro_torch.kernels import ssd
    shapes = [(SCORE_B, SCORE_S // 256, 256, 32, g, 64, 128) for g in (1, 32)]
    shapes += [(1, 3, 32, 3, g, 32, 16) for g in (1, 3)]
    shapes += [(1, 2, 100, 3, g, 64, 16) for g in (1, 3)]
    shapes += [(SCORE_B, SCORE_S // 256, c, 32, 1, 64, 128) for c in (64, 65)]
    shapes += [(1, 8, 1, 32, 1, 64, 128)]
    main = _ssd_case(shapes[0], timed=True)
    for shape in shapes[1:]:
        _ssd_case(shape)
    t = _ssd_inputs(shapes[0])
    a, b = ssd.ssd_intra_chunk_kernel(*t), ssd.ssd_intra_chunk_kernel(*t)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("kernels", f"ssd {shapes[0]}: two calls differ")
    log("kernels", f"ssd {shapes[0]}: the same bits twice")
    times = []
    for c in SSD_SWITCH_C:
        shape = (SCORE_B, SCORE_S // 256, c, 32, 1, 64, 128)
        t = _ssd_inputs(shape)
        ms = [device_ms(lambda: ssd.ssd_intra_chunk_kernel(*t, body=body))[0]
              for body in (1, 2)]
        times.append(f"c={c} body 1 {ms[0]:.4f} / body 2 {ms[1]:.4f}")
    log("kernels", f"ssd bodies' device ms at (b, nc, c, h, g, p, n) = "
                   f"({SCORE_B}, {SCORE_S // 256}, c, 32, 1, 64, 128): "
                   + "; ".join(times) + f" (switch: c <= {ssd.SHORT_MAX} "
                   f"runs body 2)")
    return {"mamba": main}


def _ssd_inputs(shape):
    import torch
    b, nc, c, h, g_, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(generator=gen, device="cuda")
    xc = torch.randn(b, nc, c, h, p, **kw)
    Bc, Cc = (torch.randn(b, nc, c, g_, n, **kw) for _ in range(2))
    Ac = -torch.rand(b, h, nc, c, **kw) * 0.1
    return xc, Bc, Cc, Ac, torch.cumsum(Ac, -1)


def _ssd_case(shape, timed=False):
    """SSD at one (b, nc, c, h, g, p, n) against its plain version (1e-5)
    and the oracle (2e-5), through the body the wrapper picks and, where c
    is at most SSD_BOTH_MAX_C, through each body; timed: -> its
    kernels-line row (the wrapper's pick)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd
    # plain fp32 on the card: one TF32 product would miss the tolerances
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("kernels", "fp32 matmuls run in TF32: the plain SSD would not "
                        "be fp32")
    xc, Bc, Cc, Ac, Acum = _ssd_inputs(shape)
    plain = ref.ssd_intra_chunk_plain(xc, Bc, Cc, Acum)
    oracle = ref.ssd_intra_chunk_ref(xc, Bc, Cc, Ac, Acum)
    line, err_plain = f"ssd_intra_chunk (b,nc,c,h,g,p,n)={shape}:", None
    bodies = (None, 1, 2) if shape[2] <= SSD_BOTH_MAX_C else (None,)
    for body in bodies:
        got = ssd.ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, Acum, body=body)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            fail("kernels", f"ssd non-finite output {shape}, body {body}")
        err = max((a - w).abs().max().item() for a, w in zip(got, plain))
        rel_plain = max(rel_err(a, w) for a, w in zip(got, plain))
        rel_oracle = max(rel_err(a, w) for a, w in zip(got, oracle))
        name = (f"body {ssd.body_for(shape[2])} (the switch's)"
                if body is None else f"body {body}")
        line += (f" {name}: max_abs_err vs plain {err:.3e} (rel "
                 f"{rel_plain:.3e}, tol {SSD_PLAIN_TOL:g}), rel vs oracle "
                 f"{rel_oracle:.3e} (tol {SSD_ORACLE_TOL:g});")
        if rel_plain > SSD_PLAIN_TOL or rel_oracle > SSD_ORACLE_TOL:
            fail("kernels", line)
        if body is None:
            err_plain = err
    row = None
    if timed:
        times, text = kernel_times(lambda: ssd.ssd_intra_chunk_kernel(
            xc, Bc, Cc, Ac, Acum))
        plain_ms = median_ms(lambda: ref.ssd_intra_chunk_plain(xc, Bc, Cc,
                                                               Acum))
        # SSD runs in split TF32: the split terms' bound, the fp32 FMAs'
        # beside it
        bound, by = ssd_bound_ms(*shape, split=True)
        fp32, fp32_by = ssd_bound_ms(*shape)
        line += (f" {text}, plain {plain_ms:.4f} ms, split-TF32 bound "
                 f"{bound * 1e3:.1f} us ({by}; fp32 FMAs {fp32 * 1e3:.1f} "
                 f"us, {fp32_by})")
        row = dict(max_abs_err=err_plain, **times, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, bound_fp32_ms=fp32,
                   library_ms=None)
    log("kernels", line)
    return row


def phase_dispatch():
    """``moe_capacity`` (its rows moved by the ``moe_dispatch`` kernels)
    against the one-hot products on one routing, at granite width (one MoE
    layer from seed 0), in fp32 and bf16, for each of DISPATCH_CASES; then
    the kernels alone at ROW_CASES (``_dispatch_kernels``).  -> (the
    kernels line's row of streamed_moe at C = C_CHUNK, on the gathered
    rows (the rows one-hot dispatch gives are the same bits); the
    kernels line's rows of moe_dispatch by path)."""
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
            one_hot, got = _one_hot_layer(params, x, r, mcfg, act), run(True)
            again, dyn = run(True), run(True, trajectory.DYNAMIC)
            torch.cuda.synchronize()
            err = rel_err(got, one_hot)
            same, dyn_same = torch.equal(got, again), torch.equal(dyn, got)
            line = (f"{what} T={T} C={C} {kind}: kernel rows vs one-hot rel "
                    f"{err:.3e} (tol {DISPATCH_TOL[kind]:g}); {dropped} of "
                    f"{T * k} choices past capacity (max load "
                    f"{int(load.max())}); the same bits twice: "
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
    return row, _dispatch_kernels()


def moe_dispatch_bound_ms(tables, T, E, C, k, d, x_bytes):
    """Least time of the gather and of the combine, each input byte read
    once and each output byte written once at HBM_BYTES_PER_S: the gather
    reads the rows of the tokens it sends and the (E, C) int64 table and
    writes the (E, C, d) rows; the combine reads the fp32 rows that carry
    a token and 12 bytes a (t, k) entry (int64 row, fp32 weight) and
    writes each token's row.  -> (gather ms, combine ms)."""
    sent = int(tables.idx[tables.idx < T].unique().numel())
    kept = int((tables.rows < E * C).sum())
    gather = sent * d * x_bytes + E * C * 8 + E * C * d * x_bytes
    combine = kept * d * 4 + T * k * 12 + T * d * x_bytes
    return (gather / HBM_BYTES_PER_S * 1e3, combine / HBM_BYTES_PER_S * 1e3)


def _dispatch_kernels():
    """The gather and combine kernels at ROW_CASES, bf16, on a routing
    drawn by numpy: each held bit for bit to its plain version
    (``gather_dispatch``, ``scatter_combine(...).to``), then each timed
    (``kernel_times``) beside its bytes bound, and the pair's device time
    beside the plain versions' and the one-hot products' (the masks, the
    einsum, ``one_hot_combine(...).to``: the library ops they replace, the
    row's ``library_ms``).  -> the kernels line's rows by path."""
    import numpy as np
    import torch
    from repro_torch.core import gating
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.models import moe
    dt, rows = torch.bfloat16, {}
    for path, (T, E, C, k, d) in ROW_CASES.items():
        rng = np.random.default_rng(0)
        idx = np.argsort(-rng.standard_normal((T, E)), axis=1)[:, :k]
        w = rng.random((T, k)) + 0.1
        w = w / w.sum(1, keepdims=True)
        indices = torch.from_numpy(idx).cuda()
        weights = torch.from_numpy(w.astype(np.float32)).cuda().to(dt)
        comb = torch.zeros(T, E, device="cuda", dtype=dt).scatter_(
            1, indices, weights)
        r = gating.Routing(indices, weights, comb.float(), comb)
        x = torch.from_numpy(rng.standard_normal(
            (T, d), dtype=np.float32)).cuda().to(dt)
        ye = torch.from_numpy(rng.standard_normal(
            (E, C, d), dtype=np.float32)).cuda()
        tables = moe.dispatch_tables(r, T, E, C)

        def gather():
            return kmd.gather_dispatch_kernel(x, tables.idx)

        def combine():
            return kmd.scatter_combine_kernel(ye, tables.rows,
                                              tables.weights, dt)

        def plain():
            kmd.gather_dispatch(x, tables.idx)
            return kmd.scatter_combine(ye, tables.rows, tables.weights).to(dt)

        def one_hot():
            dispatch, cw = moe.dispatch_masks(r, T, E, C)
            torch.einsum("tec,td->ecd", dispatch.to(dt), x)
            return moe.one_hot_combine(cw, ye).to(dt)
        with torch.no_grad():
            same = (_same_bits(gather(), kmd.gather_dispatch(x, tables.idx))
                    and _same_bits(combine(), kmd.scatter_combine(
                        ye, tables.rows, tables.weights).to(dt)))
            g, g_text = kernel_times(gather)
            c, c_text = kernel_times(combine)
            pair = device_ms(lambda: (gather(), combine()))[0]
            t_plain = device_ms(plain)[0]
            t_one_hot = device_ms(one_hot, reps=5)[0]
        b_g, b_c = moe_dispatch_bound_ms(tables, T, E, C, k, d,
                                         x.element_size())
        line = (f"moe_dispatch {path} (T, E, C, k, d) = {(T, E, C, k, d)} "
                f"bf16: the plain versions' bits {same}; gather {g_text}, "
                f"bound {b_g * 1e3:.1f} us; combine {c_text}, bound "
                f"{b_c * 1e3:.1f} us (bytes); the pair {pair:.4f} ms on "
                f"the device, plain {t_plain:.4f} ms, one-hot products "
                f"{t_one_hot:.4f} ms")
        if not same:
            fail("dispatch", line)
        log("dispatch", line)
        rows[path] = dict(max_abs_err=0.0, ms=g["ms"] + c["ms"],
                          device_ms=pair, gather_ms=g["ms"],
                          gather_device_ms=g["device_ms"], combine_ms=c["ms"],
                          combine_device_ms=c["device_ms"], plain_ms=t_plain,
                          bound_ms=b_g + b_c, bound_by="bytes",
                          library_ms=t_one_hot, shape=[T, E, C, k, d])
        del x, ye, tables, r
        torch.cuda.empty_cache()
    return rows


def _one_hot_layer(params, x, r, mcfg, act):
    """One MoE layer through the one-hot products (``moe_capacity``'s
    path where autograd records), the streamed_moe kernel between them."""
    import torch
    from repro_torch.models import moe
    T, E = x.shape[0], mcfg.num_experts
    C = mcfg.capacity_rows(T)
    with torch.no_grad():
        dispatch, combine = moe.dispatch_masks(r, T, E, C)
        xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        ye = moe._expert_ffn(params, xe.contiguous(), act)
        return moe.one_hot_combine(combine, ye).to(x.dtype)


def _batch_invariance(params, x, mcfg, act, gen, trials=4):
    """Half of the tokens placed at other rows among other tokens: under
    drop-free capacity each of their outputs must keep its bits, with
    kernels on (the ``moe_dispatch`` kernels and streamed_moe) and with
    ``use_kernels(False)`` under ``use_sorted_dispatch`` (the plain
    gathers and FFN) (what serving with preemption and the prefix cache
    needs: a request's tokens may not depend on its slot or on who shares
    the batch)."""
    import torch
    from repro_torch.core import gating
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    T, k = x.shape[0], mcfg.top_k
    half = T // 2
    moved = {True: 0, False: 0}
    for _ in range(trials):
        other = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        rows = torch.randperm(T, generator=gen, device="cuda")[:half]
        other[rows] = x[:half]
        for kernels in moved:
            with torch.no_grad(), ops.use_kernels(kernels), \
                    moe.use_sorted_dispatch(not kernels):
                y = moe.moe_capacity(params, x, gating.route(
                    params["router"], x, top_k=k), mcfg, act)
                y2 = moe.moe_capacity(params, other, gating.route(
                    params["router"], other, top_k=k), mcfg, act)
            moved[kernels] += int((y2[rows] != y[:half]).any(-1).sum())
    text = (f"; batch invariance: {half} tokens at other rows among other "
            f"tokens, {trials} times: outputs that moved with kernels "
            f"{moved[True]}, sorted with use_kernels(False) {moved[False]}")
    if any(moved.values()):
        fail("dispatch", text)
    return text


def _dispatch_times(params, x, r, mcfg, act, C):
    """Device time of dispatch plus combine as ``moe_capacity`` runs them,
    one-hot against sorted, with the streamed_moe kernel's on the dispatched
    rows beside it; at C = C_CHUNK the kernel is also held against its
    plain version there.  -> (text, the kernels line's row or None)."""
    import torch
    from repro_torch.kernels import moe_dispatch as kmd
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

    def kernels():
        tables = moe.dispatch_tables(r, T, E, C)
        kmd.gather_dispatch_kernel(x, tables.idx)
        return kmd.scatter_combine_kernel(ye, tables.rows, tables.weights,
                                          x.dtype)

    tiles = _planned(E, C, x.shape[1], ws[1].shape[-1], act)

    def kernel(tiles=tiles):
        return sm.streamed_moe_kernel(xe, *ws, activation=act, tiles=tiles)
    with torch.no_grad():
        t_oh, t_so = device_ms(one_hot)[0], device_ms(sorted_)[0]
        t_kd = device_ms(kernels)[0]
        t_k = device_ms(kernel)[0]
        t_off = device_ms(lambda: kernel(None))[0]
        combine = moe.dispatch_masks(r, T, E, C)[1]
        cost = {label: (device_ms(lambda: fn(combine, ye))[0],
                        _peak_bytes(lambda: fn(combine, ye)))
                for label, fn in _combines().items()}
    text = (f"; dispatch + combine on the device: one-hot {t_oh:.4f} ms, "
            f"plain gathers {t_so:.4f} ms ({t_oh / t_so:.1f}x), the "
            f"moe_dispatch kernels with their tables {t_kd:.4f} ms "
            f"({t_oh / t_kd:.1f}x); streamed_moe "
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
        # bf16 x bf16 rounds h to bf16 on the tensor cores: held by
        # moe_bf16_check (phase 3)
        rounded = path == "bf16"
        h_plain = ref.streamed_moe_plain_h(xe, *ws, act, **scales) \
            if rounded else None
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
            if rounded:
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
                                   if rounded else
                                   f"rel at most {worst:.3e} (tol "
                                   f"{PLAIN_TOL:g})"))
    for (E, C, d, m, act, wdt, x) in TILE_TIME_CASES:
        xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, dtypes[x])
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        path = sm.tile_path(xe.dtype, ws[1].dtype)
        plan = autotune.plan_kernel_tiles(E, C, d, m, act, profile, x, wdt)
        times = {}
        for name in sm.TILE_SETTINGS[path]:
            times[name] = device_ms(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=act, tiles=name, **scales))[0]
            cost = autotune.tile_cost(E, C, d, m, act, name, profile, x, wdt)
            up, down = cost["phases"]
            log("tiles", f"E={E} C={C} d={d} m={m} {act} w={wdt} x={x} {name}: "
                         f"device {times[name]:.4f} ms, predicted "
                         f"{cost['t'] * 1e3:.4f} ms (fits {cost['fits']}); "
                         + "; ".join(
                             f"{ph} {p['regs']} regs, {p['spill']} B spilled,"
                             f" {p['smem']} B shared, {p['threads']} threads,"
                             f" {p['blocks_per_sm']} blocks an SM, "
                             f"{p['waves']:.2f} waves"
                             for ph, p in (("up", up), ("down", down))))
        entry = autotune.measured_kernel_tiles(E, C, d, m, act, x, wdt,
                                               profile=profile)
        default, pick = plan["default"], plan["tiles"]
        line = (f"E={E} C={C} d={d} m={m} {act} w={wdt} x={x}: default {default} "
                f"{times[default]:.4f} ms (predicted "
                f"{plan['default_s'] * 1e3:.4f}); analytic pick {pick} "
                f"{times[pick]:.4f} ms (predicted "
                f"{plan['predicted_s'] * 1e3:.4f}, "
                f"{times[pick] / times[default]:.3f} of the default's); "
                f"measured pick {entry['tiles']} {entry['ms']:.4f} ms of "
                f"{len(entry['candidates'])} timed; fastest here "
                f"{min(times, key=times.get)} {min(times.values()):.4f} ms")
        if wdt == "bf16" and x == "bf16":
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
    from repro_torch.tree import leaves_with_path
    bad = [k for k, t in leaves_with_path(res["params"]) if not t.is_cuda]
    bad += [k for k, t in leaves_with_path(res["engine"].caches)
            if not t.is_cuda]
    if bad:
        fail(phase, f"tensors on the CPU: {bad[:5]}")


def _launches(eng):
    """streamed_moe launches of an engine's runs since the counts were last
    set to 0: the wrapper's (eager calls, and the first call of each
    segment, made before its capture) plus the graphs' replays."""
    from repro_torch.kernels import streamed_moe as sm
    return sm.LAUNCHES + eng.graph_launches()


def _zero_counts(eng=None):
    """Set the launch counts to 0 (the graphs' replay counts too), and the
    moe_dispatch kernels' and the MoE calls that kept the one-hot
    products."""
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import moe
    sm.LAUNCHES = kmd.LAUNCHES = kmd.CAPTURED = moe.ONE_HOT_CALLS = 0
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
    from repro_torch.tree import leaves
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
    n_params = sum(t.numel() for t in leaves(res["params"]))
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


def _serve_prompts(eng, prompts, max_new, chunked=False):
    """Admit ``prompts`` (one-shot or chunked) and run the engine dry.
    -> (each prompt's tokens, seconds of the run after admission)."""
    import torch
    sub = eng.submit_chunked if chunked else eng.submit
    rids = [sub(list(p), max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    return [outs[r] for r in rids], time.perf_counter() - t0


def _chunked_fused_vs_eager(params, cfg, phase, spec=None):
    """Chunked admission of CHUNKED_LENS prompts (CHUNK-token chunks,
    max_batch TRAFFIC_BATCH) on the fused engine and the eager loop: the
    same tokens, trace and statistics."""
    import numpy as np
    import torch
    from repro_torch.serving import Engine, ServeConfig
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in CHUNKED_LENS]
    runs = []
    for fused in (True, False):
        eng = Engine(params, cfg, ServeConfig(
            max_batch=TRAFFIC_BATCH, max_ctx=152, chunk_tokens=CHUNK,
            fused=fused, spec=spec), device="cuda")
        runs.append((eng, _serve_prompts(eng, prompts, 24, chunked=True)))
    (ef, (of, tf)), (ee, (oe, te)) = runs
    _same_run((ef, of), (ee, oe), f"{phase}: chunked admission")
    log(phase, f"chunked admission (8 prompts of 9-120 tokens, {CHUNK}-token"
               f" chunks): fused == eager (tokens, {len(ef.trace)} trace "
               f"records, {ef.stats['prefill_chunks']} prefill chunks); "
               f"wall fused {tf:.3f}s (with captures), eager {te:.3f}s")
    del runs, ef, ee
    torch.cuda.empty_cache()


def phase_fused_vs_eager(spec_path):
    """The fused engine (CUDA graphs) against the eager per-layer loop on
    the card, bf16, full width, the same prompts: static; dynamic with
    slack 0.2 (so deferral fires); both again with sorted dispatch (the
    spec at ``spec_path``); and chunked admission."""
    import dataclasses
    from repro_torch.serving import Engine

    params = None
    dynamic = ["--schedule", "dynamic", "--slack", "0.2"]
    sorted_ = ["--moe-spec", spec_path]
    for argv in ([], dynamic, sorted_, sorted_ + dynamic):
        res = _serve(SLICE_ARGV + argv)
        params, eng = res["params"], res["engine"]
        eager = Engine(params, res["cfg"], dataclasses.replace(
            eng.scfg, fused=False), device="cuda")
        got, secs = _serve_prompts(eager, res["prompts"], res["max_new"])
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
    _chunked_fused_vs_eager(params, _serve_cfg(), "fused")


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


def _fp8_shares(rows, busy_ms, launches):
    """The fp8 slice's device time: the 8-bit kernel's share (its two
    phases' profiled records), and quant.quantize's, each call quantizing
    the layer's three bf16 weight stacks before its launch: ``launches``
    times the device time of quantizing granite's three stacks, timed
    here alone."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quant
    mc, d = get_config(ARCH).moe, get_config(ARCH).d_model
    E, m = mc.num_experts, mc.d_expert
    g = torch.Generator(device="cuda").manual_seed(0)
    stacks = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
              for shape in ((E, d, m), (E, d, m), (E, m, d))]
    q_ms = device_ms(lambda: [quant.quantize(w, "fp8") for w in stacks])[0]
    k_ms = sum(ms for ms, _, name in rows
               if "up_kernel_q" in name or "down_kernel_q" in name)
    log("profile", f"slice fp8: the 8-bit streamed_moe kernels {k_ms:.2f} ms "
                   f"of {busy_ms:.2f} ms device time ({k_ms / busy_ms:.3f}); "
                   f"quant.quantize before each of the {launches} launches "
                   f"{q_ms:.4f} ms a call (timed alone), {launches * q_ms:.2f}"
                   f" ms ({launches * q_ms / busy_ms:.3f})")


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
        if label == "slice fp8":
            _fp8_shares(rows, busy * 1e3, _launches(eng))
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
    same batch in fp32 (both kernels' split-TF32 bodies) with kernels and
    with use_kernels(False), each timed.  -> launches of the bf16 and of
    the fp32 kernels run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import ops
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api, moe, transformer
    cfg = get_config(ARCH)
    params = api.init_params(cfg, seed=0, device="cuda")
    batch = _score_batch(cfg)
    n_attn = sum(1 for m in cfg.layer_kinds() if m == "attn")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = sm.LAUNCHES = kmd.LAUNCHES = kmd.CAPTURED = 0
    moe.ONE_HOT_CALLS = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, m = api.loss_fn(params, batch, cfg, spec="capacity",
                              use_flash=True)
    loss = loss.item()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES, "streamed_moe": sm.LAUNCHES,
                "moe_dispatch": kmd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": n_attn, "streamed_moe": _n_moe(cfg),
            "moe_dispatch": 2 * _n_moe(cfg)}
    if launches != want or moe.ONE_HOT_CALLS or kmd.CAPTURED:
        fail("forward", f"launches {launches}, want {want}; MoE calls that "
                        f"kept the one-hot products {moe.ONE_HOT_CALLS}")
    if not torch.isfinite(torch.tensor(loss)):
        fail("forward", f"loss {loss}")
    T = SCORE_B * SCORE_S
    log("forward", f"{ARCH} full width bf16, {SCORE_B} x {SCORE_S} tokens "
                   f"(MoE C = {cfg.moe.capacity_rows(T)}): loss {loss:.4f} (ce "
                   f"{m['ce'].item():.4f}, aux {m['aux'].item():.4f}) in "
                   f"{secs:.3f}s = {T / secs:.0f} scored tok/s; launches "
                   f"{launches} (moe_dispatch: the gather and the combine "
                   f"of each MoE layer); MoE calls that kept the one-hot "
                   f"products {moe.ONE_HOT_CALLS}; peak memory "
                   f"{peak / 2**30:.2f} GiB")
    _forward_replays(params, batch, cfg, loss, launches)
    del params
    torch.cuda.empty_cache()

    # fp32: the split-TF32 bodies of both kernels, timed (the loss call
    # after a warm-up) against use_kernels(False)
    cfg32 = cfg.replace(dtype="float32")
    params = api.init_params(cfg32, seed=0, device="cuda")
    out, walls, launches32 = {}, {}, {}
    for kernels in (True, False):
        with torch.no_grad(), ops.use_kernels(kernels):
            api.loss_fn(params, batch, cfg32, spec="capacity", use_flash=True)
            torch.cuda.synchronize()
            fa.LAUNCHES = sm.LAUNCHES = 0
            t0 = time.perf_counter()
            loss32, _ = api.loss_fn(params, batch, cfg32, spec="capacity",
                                    use_flash=True)
            loss32 = loss32.item()
            walls[kernels] = time.perf_counter() - t0
            if kernels:
                launches32 = {"flash_attention": fa.LAUNCHES,
                              "streamed_moe": sm.LAUNCHES}
            logits, _ = transformer.forward(params, batch["tokens"], cfg32,
                                            spec="capacity", use_flash=True)
            out[kernels] = (loss32, logits)
    if launches32 != {"flash_attention": n_attn, "streamed_moe": _n_moe(cfg)}:
        fail("forward", f"fp32 launches {launches32}, want {n_attn} flash and "
                        f"{_n_moe(cfg)} streamed_moe")
    log("forward", f"fp32 full width, {SCORE_B} x {SCORE_S} tokens: the loss "
                   f"(warm) in {walls[True]:.3f}s = {T / walls[True]:.0f} "
                   f"scored tok/s with kernels (launches {launches32}), "
                   f"{walls[False]:.3f}s = {T / walls[False]:.0f} scored tok/s "
                   f"with use_kernels(False)")
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
    return launches, launches32


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


def _forward_replays(params, batch, cfg, loss_first, launches):
    """The bf16 scoring batch scored again, REPLAY_CALLS times, as a
    scoring loop calls ``loss_fn``: the second call captures a CUDA graph
    (``models.graphs``) and the later ones replay it.  Each call's loss
    is the first (eager) call's bits, each counts the first call's
    launches; their wall times, and the host's time to enqueue one
    replay."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api, graphs
    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    walls, losses, counts, enqueue = [], [], [], []
    for _ in range(REPLAY_CALLS):
        n = (fa.LAUNCHES, sm.LAUNCHES, kmd.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = api.loss_fn(params, batch, cfg, spec="capacity",
                                  use_flash=True)
        enqueue.append(time.perf_counter() - t0)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
        counts.append(dict(zip(launches, (fa.LAUNCHES - n[0],
                                          sm.LAUNCHES - n[1],
                                          kmd.LAUNCHES - n[2]))))
    T = SCORE_B * SCORE_S
    line = (f"{REPLAY_CALLS} more scoring calls: captures "
            f"{graphs.CAPTURES - captures}, replays "
            f"{graphs.REPLAYS - replays}; the first call's loss bits in "
            f"each {all(x == loss_first for x in losses)}; launches a call "
            f"{counts[-1]} (each as the first call's: "
            f"{all(c == launches for c in counts)}); the capturing call "
            f"{walls[0]:.3f}s, a replay {statistics.median(walls[1:]):.4f}s "
            f"= {T / statistics.median(walls[1:]):.0f} scored tok/s (its "
            f"host enqueue {1e3 * statistics.median(enqueue[1:]):.2f} ms)")
    if graphs.CAPTURES - captures != 1 or \
            graphs.REPLAYS - replays != REPLAY_CALLS or \
            any(x != loss_first for x in losses) or \
            any(c != launches for c in counts):
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
            _zero_counts()
            logits, _ = api.prefill_fn(params, {"tokens": tokens}, cfg, 32,
                                       spec=spec)
            eng = Recording(params, cfg, ServeConfig(max_batch=8, max_ctx=32,
                                                     spec=spec), device="cuda")
            eng.samples = []
            for p in prompts:
                eng.submit(p, max_new=16)
            eng.run()
        return logits, eng.samples, _launches(eng)

    lk, sk, launches = run(True)
    lp, sp, plain_launches = run(False)
    if launches == 0 or plain_launches != 0:
        fail("parity", f"streamed_moe launches {launches} with kernels (want "
                       f"> 0), {plain_launches} without (want 0)")
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
                  f"{where}; smallest plain top-2 margin {min_margin:.3e}; "
                  f"streamed_moe launches (split TF32) {launches}")
    del params
    torch.cuda.empty_cache()
    return launches


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


# ---------------------------------------------------------------------------
# the SSM and hybrid families: kernels at their shapes (3j), mamba2-370m
# serving (12), Jamba serving (12j)
# ---------------------------------------------------------------------------


def phase_ssm_kernels():
    """streamed_moe at Jamba's decode step (JAMBA_MOE), a shape no earlier
    path reached (``_moe_decode_shape``).  Then SSD at the SSM serving
    prefill's shapes (d_state 16, c = 8 and c = 1) against its plain
    version (1e-5) and the oracle.  -> the rows of the streamed_moe
    serve_jamba path and the ssd serve_prefill paths."""
    moe_row = _moe_decode_shape(JAMBA_MOE, "Jamba decode")
    _moe_decode_8bit(JAMBA_MOE, "Jamba decode", moe_row["device_ms"])
    ssd_rows = {}
    for path, shape in SSD_SERVE_SHAPES:
        row = _ssd_case(shape, timed=path is not None)
        if path is not None:
            ssd_rows[path] = row
    return {"serve_jamba": moe_row}, ssd_rows


def _moe_decode_shape(shape, label):
    """streamed_moe at one decode step's (E, C, d, m), swiglu, bf16:
    against its plain version (``moe_bf16_check``, the down product's
    tolerance scaled to its K) and the fp32 oracle (3e-2); every tile
    setting the default's bits (output and scratch), each timed beside the
    planner's prediction and the bound; the analytic pick's device time
    over the default's.  -> the kernels line's row."""
    import torch
    from repro_torch.core import autotune
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    E, C, d, m = shape
    act = "swiglu"
    what = f"streamed_moe E={E} C={C} d={d} m={m} {act} bf16 ({label})"
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, torch.bfloat16)
    ws, _ = _stream_operands(wg, wu, wd, "bf16")
    oracle = ref.streamed_moe_quant_ref(xe, wg, wu, wd, act, "bf16")
    del wg, wu, wd
    torch.cuda.empty_cache()
    h0, out0 = sm._launch(xe, *ws, act)
    torch.cuda.synchronize()
    plain = ref.streamed_moe_plain(xe, *ws, act)
    ok, mt = moe_bf16_check(h0, out0, ref.streamed_moe_plain_h(xe, *ws, act),
                            xe, *ws, act)
    err_plain = (out0 - plain).abs().max().item()
    rel_oracle = rel_err(out0, oracle)
    line = (f"{what}: max_abs_err vs plain {err_plain:.3e}; h at most "
            f"{mt['over']:.3f} of its bound (tol 1), share differing "
            f"{mt['flips']:.3e} (tol {MOE_FLIP_SHARE:g}); down product rel "
            f"{mt['down']:.3e} (tol {mt['down_tol']:g}, K = {m}); rel vs "
            f"oracle {rel_oracle:.3e} (tol {ORACLE_TOL['bf16']:g})")
    if not ok or rel_oracle > ORACLE_TOL["bf16"] or \
            not torch.isfinite(out0).all():
        fail("kernels", line)
    log("kernels", line)
    del oracle, plain
    profile = autotune.CardProfile.detect()
    bound, by = streamed_moe_bound_ms(E, C, d, m, "bf16", xe.element_size())
    times = {}
    for name in sm.TILE_SETTINGS["bf16"]:
        h, out = sm._launch(xe, *ws, act, tiles=name)
        torch.cuda.synchronize()
        if not (_same_bits(out, out0) and _same_bits(h, h0)):
            fail("tiles", f"{what} tiles {name}: not the default's bits")
        times[name] = device_ms(lambda: sm.streamed_moe_kernel(
            xe, *ws, activation=act, tiles=name))[0]
        cost = autotune.tile_cost(E, C, d, m, act, name, profile, "bf16",
                                  "bf16")
        log("tiles", f"{what} {name}: the default's bits; device "
                     f"{times[name]:.4f} ms, predicted "
                     f"{cost['t'] * 1e3:.4f} ms (fits {cost['fits']}), "
                     f"bound {bound:.4f} ms ({by})")
    tiles = _planned(E, C, d, m, act)
    row_times, text = kernel_times(lambda: sm.streamed_moe_kernel(
        xe, *ws, activation=act, tiles=tiles))
    plain_ms = median_ms(lambda: ref.streamed_moe_plain(xe, *ws, act),
                         reps=5, warmup=1)
    default = sm.DEFAULT_TILES(C, torch.bfloat16)
    log("tiles", f"{what}: all {len(times)} settings give the default's "
                 f"bits; analytic pick {tiles}: {text}, "
                 f"{times[tiles] / times[default]:.3f}x the default "
                 f"{default}'s device time; fastest "
                 f"{min(times, key=times.get)} {min(times.values()):.4f} ms; "
                 f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({by}), "
                 f"the pick at {row_times['device_ms'] / bound:.2f}x it")
    del xe, ws, h0, out0
    torch.cuda.empty_cache()
    return dict(max_abs_err=err_plain, **row_times, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None, tiles=tiles)


def _moe_decode_8bit(shape, label, bf16_ms):
    """streamed_moe at one decode step's (E, C, d, m), swiglu, bf16 x, with
    int8 and with fp8 weights: against its plain version (PLAIN_TOL) and
    the oracle (ORACLE_TOL); every 8-bit tile setting the default's bits
    (output and scratch); the analytic pick's device time beside the 8-bit
    bytes bound and ``bf16_ms``, the bf16 call's device time at the shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    E, C, d, m = shape
    act = "swiglu"
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, torch.bfloat16)
    for wdt in ("int8", "fp8"):
        what = f"streamed_moe E={E} C={C} d={d} m={m} {act} w={wdt} ({label})"
        ws, scales = _stream_operands(wg, wu, wd, wdt)
        oracle = ref.streamed_moe_quant_ref(xe, wg, wu, wd, act, wdt)
        h0, out0 = sm._launch(xe, *ws, act, **scales)
        torch.cuda.synchronize()
        plain = ref.streamed_moe_plain(xe, *ws, act, **scales)
        err_plain = (out0 - plain).abs().max().item()
        rel_plain, rel_oracle = rel_err(out0, plain), rel_err(out0, oracle)
        del oracle, plain
        line = (f"{what}: max_abs_err vs plain {err_plain:.3e} (rel "
                f"{rel_plain:.3e}, tol {PLAIN_TOL:g}), rel vs oracle "
                f"{rel_oracle:.3e} (tol {ORACLE_TOL[wdt]:g})")
        if rel_plain > PLAIN_TOL or rel_oracle > ORACLE_TOL[wdt] or \
                not torch.isfinite(out0).all():
            fail("kernels", line)
        for name in sm.TILE_SETTINGS["8bit"]:
            h, out = sm._launch(xe, *ws, act, tiles=name, **scales)
            torch.cuda.synchronize()
            if not (_same_bits(out, out0) and _same_bits(h, h0)):
                fail("tiles", f"{what} tiles {name}: not the default's bits")
        tiles = _planned(E, C, d, m, act, "bf16", wdt)
        dev = device_ms(lambda: sm.streamed_moe_kernel(
            xe, *ws, activation=act, tiles=tiles, **scales))[0]
        bound, by = streamed_moe_bound_ms(E, C, d, m, wdt, xe.element_size())
        log("kernels", f"{line}; all {len(sm.TILE_SETTINGS['8bit'])} 8-bit "
                       f"settings give the default's bits; analytic pick "
                       f"{tiles}: {dev:.4f} ms on the device, {dev / bound:.2f}x"
                       f" the {bound:.4f} ms bound ({by}), {dev / bf16_ms:.3f}"
                       f" of the bf16 call's {bf16_ms:.4f} ms")
        del ws, scales, h0, out0
        torch.cuda.empty_cache()
    del xe, wg, wu, wd
    torch.cuda.empty_cache()


def _ssm_rows_equal(a, b):
    """Two snapshot_ssm tuples, bit for bit (NaNs included)."""
    la = [t for s in a for t in s]
    lb = [t for s in b for t in s]
    return len(la) == len(lb) > 0 and all(_same_bits(x, y)
                                          for x, y in zip(la, lb))


def _preempt_check(params, cfg, phase):
    """A request preempted mid-decode on the fused engine, both slots then
    taken by two intruders, and the request restored: the handle's SSM
    snapshot equals the live rows bit for bit, the intruders change the
    rows it came from, the restored rows equal the snapshot, and the
    request emits the tokens of a run that was never preempted."""
    import numpy as np
    from repro_torch.serving import Engine, ServeConfig, statepool
    rng = np.random.default_rng(2)
    victim, short, *intruders = (rng.integers(0, cfg.vocab_size, size=n)
                                 .tolist() for n in (20, 6, 12, 5))
    scfg = ServeConfig(max_batch=2, max_ctx=64, chunk_tokens=CHUNK)
    base = Engine(params, cfg, scfg, device="cuda")
    rids = [base.submit_chunked(victim, 8), base.submit_chunked(short, 2)]
    want = base.run()
    want = [want[r] for r in rids]
    del base
    eng = Engine(params, cfg, scfg, device="cuda")
    rids = [eng.submit_chunked(victim, 8), eng.submit_chunked(short, 2)]
    eng.step()
    eng.step()
    r = eng.requests[rids[0]]
    if r.done or not r.generated or r.progress:
        fail(phase, f"the victim is not mid-decode: {len(r.generated)} "
                    f"tokens, done {r.done}, progress {r.progress}")
    slot = r.slot
    live = statepool.snapshot_ssm(eng.caches, slot)
    handle = eng.preempt(rids[0])
    if not _ssm_rows_equal(handle.ssm, live):
        fail(phase, "the preemption snapshot is not the live rows' bits")
    for p in intruders:
        eng.submit_chunked(p, 4)
    eng.run()
    dirtied = not _ssm_rows_equal(statepool.snapshot_ssm(eng.caches, slot),
                                  handle.ssm)
    eng.restore(handle)
    if not _ssm_rows_equal(statepool.snapshot_ssm(
            eng.caches, eng.requests[rids[0]].slot), handle.ssm):
        fail(phase, "the restored rows are not the snapshot's bits")
    outs = eng.run()
    got = [outs[r] for r in rids]
    if got != want or not dirtied:
        fail(phase, f"preempt / restore: tokens {got} vs never preempted "
                    f"{want}; the intruders changed the victim's rows "
                    f"{dirtied}")
    n_bytes = sum(t.numel() * t.element_size() for s in handle.ssm
                  for t in s)
    log(phase, f"preempted a request mid-decode ({len(want[0])} tokens "
               f"wanted), two intruders ran through both slots (the "
               f"victim's rows changed), restored: snapshot == live rows "
               f"and restored rows == snapshot bit for bit ({n_bytes} bytes "
               f"of SSM state a row); tokens == the never-preempted run's")


def _prefill_kernels(params, cfg, phase):
    """One prefill chunk step (TRAFFIC_BATCH rows x CHUNK tokens, a fresh
    pool) eagerly under the profiler: the device kernels the prefill
    graph holds.  -> their count."""
    import torch
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import transformer
    B, ps, dev = TRAFFIC_BATCH, 8, params["embed"].device
    caches = transformer.init_paged_caches(cfg, B, B * 2, ps, device=dev)
    table = torch.arange(B * 2, device=dev).view(B, 2)
    tokens = torch.ones((B, CHUNK), dtype=torch.int64, device=dev)
    mask = torch.ones((B, CHUNK), dtype=torch.bool, device=dev)
    cl = torch.zeros((B,), dtype=torch.int64, device=dev)

    def step():
        with torch.no_grad():
            transformer.prefill_chunk(
                params, tokens, caches, cl, cfg,
                spec=ExecutionSpec(strategy="capacity"), token_mask=mask,
                return_hidden=True, page_table=table)

    step()
    _, rows = _profile(f"{phase} prefill chunk step ({B} x {CHUNK} tokens, "
                       f"eager)", step)
    n = sum(k for _, k, _ in rows)
    n_ssm = sum(1 for k in cfg.layer_kinds() if k == "ssm")
    log(phase, f"one prefill chunk step runs {n} device kernels "
               f"({n_ssm} Mamba-2 layers x {CHUNK} sequential recurrence "
               f"steps of mamba2_chunk = {n_ssm * CHUNK} steps); the "
               f"prefill graph replays them")
    del caches
    return n


def phase_mamba_serve():
    """Phase 12: mamba2-370m at full width (48 layers, d_model 1024,
    d_state 128), bf16, seed 0, on the serve CLI's fused engine (the
    ``only`` segment): a run that captures, fused == eager on it, a warm
    run that only replays (one host sync an iteration, the SSD kernel on
    every layer of every one-shot prefill); chunked admission fused ==
    eager; the preemption check.  -> the warm run's SSD launches (the
    serve_prefill path)."""
    import dataclasses
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.launch import serve
    from repro_torch.tree import leaves
    from repro_torch.serving import Engine
    args = serve.parse_args(["--arch", MAMBA, "--seed", "0"] + SLICE_ARGV)
    torch.cuda.reset_peak_memory_stats()
    cold = serve.run(args)
    eng, cfg, params = cold["engine"], cold["cfg"], cold["params"]
    ms = eng.megastep()
    if ms.boundaries or set(ms.graphs) != {"only"}:
        fail("mamba-serve", f"segments {sorted(ms.graphs)}, boundaries "
                            f"{ms.boundaries}: want the only segment")
    eager = Engine(params, cfg, dataclasses.replace(eng.scfg, fused=False),
                   device="cuda")
    got, secs = _serve_prompts(eager, cold["prompts"], cold["max_new"])
    _same_run((eng, list(cold["outs"].values())), (eager, got),
              f"{MAMBA} static")
    log("mamba-serve", f"first run (captures {ms.captures} graph in "
                       f"{ms.capture_s:.3f}s): {cold['seconds']:.3f}s; fused "
                       f"== eager (tokens, stats); eager {secs:.3f}s")
    del eager
    captures, syncs0, iters0 = ms.captures, eng.stats["host_syncs"], \
        eng.stats["iterations"]
    _zero_counts(eng)
    ssd.LAUNCHES = 0
    warm = serve.run(args, engine=eng)
    launches = ssd.LAUNCHES
    iters = eng.stats["iterations"] - iters0
    syncs = eng.stats["host_syncs"] - syncs0
    outs = list(warm["outs"].values())
    toks = [t for seq in outs for t in seq]
    want = len(cold["prompts"]) * cfg.num_layers
    same = outs == list(cold["outs"].values())
    if len(toks) != 64 or not all(0 <= t < cfg.vocab_size for t in toks) \
            or not same:
        fail("mamba-serve", f"{len(toks)} tokens; the warm run's tokens "
                            f"equal the first's: {same}")
    if launches != want or ms.captures != captures or syncs != iters:
        fail("mamba-serve", f"ssd launches {launches} (want {want}), "
                            f"captures {captures} -> {ms.captures}, {syncs} "
                            f"host syncs over {iters} iterations (want 1 "
                            f"each)")
    _check_on_card(warm, "mamba-serve")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in leaves(params))
    log("mamba-serve", f"{MAMBA} full width bf16 ({n_params / 1e9:.3f} B "
                       f"params), fused engine, graph captured: 4 requests x "
                       f"16 tokens = {len(toks)} tokens in "
                       f"{warm['seconds']:.3f}s "
                       f"({len(toks) / warm['seconds']:.1f} tok/s; the 4 "
                       f"one-shot prefills of submit "
                       f"{warm['submit_seconds']:.3f}s), {iters} decode "
                       f"iterations, {syncs / iters:.1f} host syncs per "
                       f"iteration, captures {ms.captures} (unchanged), ssd "
                       f"launches {launches} == 4 prompts x {cfg.num_layers}"
                       f" layers, the same tokens as the first run; peak "
                       f"memory {peak / 2**30:.2f} GiB")
    _profile(f"{MAMBA} warm slice", lambda: serve.run(args, engine=eng))
    del cold, warm, eng
    torch.cuda.empty_cache()
    _chunked_fused_vs_eager(params, cfg, "mamba-serve")
    _prefill_kernels(params, cfg, "mamba-serve")
    _preempt_check(params, cfg, "mamba-serve")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_jamba():
    """Phase 12j: Jamba-v0.1 at its published widths, one period deep
    (JAMBA_LAYERS; 1 attention and 7 Mamba-2 layers, 4 MoE and 4 dense
    FFN), ``_serve_family`` with the SSM checks (the SSD kernel on the 7
    Mamba-2 layers of every one-shot prefill, a prefill chunk step's
    kernels, the preemption check) and the shared-prefix loops, whose
    cache hits restore SSM snapshots.  -> the warm run's streamed_moe and
    SSD launches."""
    from repro_torch.configs import get_config
    return _serve_family(get_config(JAMBA).replace(num_layers=JAMBA_LAYERS),
                         "jamba", prefix=True)


# ---------------------------------------------------------------------------
# the rest of the families: kernels at their shapes (3m), the paper's
# Table I MoE models served (13, 13q), InternVL2's prefix scoring (14),
# Whisper's encoder-decoder (15)
# ---------------------------------------------------------------------------


def phase_family_kernels():
    """streamed_moe at the decode steps of DeepSeek-MoE-16B, Qwen3-30B-A3B,
    Yuan2-M32 and Phi-3.5-MoE (FAMILY_MOE, ``_moe_decode_shape``), and
    flash attention at InternVL2's scoring shape (hd = 128, bf16 and fp32)
    against its plain version and the oracle.  -> (streamed_moe rows,
    flash rows) by path."""
    moe_rows = {path: _moe_decode_shape(shape, path)
                for path, shape in FAMILY_MOE}
    for path, shape in FAMILY_MOE:
        _moe_decode_8bit(shape, path, moe_rows[path]["device_ms"])
    S = SCORE_S + 256
    flash = _flash_case(SCORE_B, S, S, 16, 128, "bf16", timed=True)
    flash32 = _flash_case(SCORE_B, S, S, 16, 128, "fp32", timed=True)
    return moe_rows, {"forward_internvl2": flash,
                      "forward_internvl2_fp32": flash32}


def _serve_family(cfg, phase, prefix=False, check=None, rows=None):
    """A model served at full width, bf16, ``capacity``, seed 0, the
    parameters built once and shared by every engine.  The slice (4 x 8 ->
    16 tokens) on the fused engine: a first run that captures, fused ==
    eager on it, a warm run (nb + 1 host syncs an iteration, no recapture,
    one streamed_moe launch per MoE layer per prefill and step, the SSD
    kernel once per Mamba-2 layer of each one-shot prefill), profiled; for
    a MoE model the slice under the dynamic schedule, fused == eager (a
    dense model, ``cfg.moe`` None, has no boundary, no experts to schedule
    and no streamed_moe launch); for a model with Mamba-2 layers, a
    prefill chunk step's kernels and the preemption check; with
    ``prefix``, phase 6b's shared-prefix stream unbounded and with
    preemption + the prefix cache: the same tokens.  A MoE model's first
    static run and its warm run keep no one-hot product and make two
    moe_dispatch launches for each streamed_moe launch, eager and captured
    (``_rows_check``).  -> the warm run's streamed_moe and SSD launches;
    ``rows["launches"]`` the warm run's moe_dispatch launches.
    ``check(params, cfg)`` runs on the parameters once they are built."""
    import torch
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import ssd
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.tree import leaves
    from repro_torch.serving import Engine, ServeConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_moe, mcfg = _n_moe(cfg), cfg.moe
    kinds = cfg.layer_kinds()
    n_ssm = kinds.count("ssm")
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    shared = ""
    if mcfg is not None and mcfg.num_shared_experts:
        w = params["periods"][0]["moe"]["shared"]["w_up"]
        want = (cfg.num_layers, cfg.d_model,
                mcfg.num_shared_experts * mcfg.d_expert)
        if tuple(w.shape) != want:
            fail(phase, f"shared experts' w_up {tuple(w.shape)}, want {want}")
        shared = (f", {mcfg.num_shared_experts} shared experts on every "
                  f"layer (w_up {want})")
    experts = "dense" if mcfg is None else (
        f"{mcfg.num_experts} experts top-{mcfg.top_k}, d_expert "
        f"{mcfg.d_expert}{shared}")
    log(phase, f"{cfg.name}: {cfg.num_layers} layers ({kinds.count('attn')}"
               f" attention, {n_ssm} Mamba-2; {n_moe} MoE, "
               f"{cfg.ffn_kinds().count('dense')} dense FFN), d_model "
               f"{cfg.d_model}, {experts}: {n_params / 1e9:.3f} B params "
               f"(param_count {cfg.param_count() / 1e9:.3f} B), bf16, "
               f"drawn in {time.perf_counter() - t0:.2f}s")
    if check is not None:
        check(params, cfg)
    args = serve.parse_args(["--arch", cfg.name, "--seed", "0"] + SLICE_ARGV)

    def engine(spec=None, **kw):
        return Engine(params, cfg, ServeConfig(
            max_batch=args.max_batch, max_ctx=args.prompt_len + args.max_new
            + 8, spec=spec, **kw), device="cuda")

    def cold_run(schedule):
        """A first run (captures) and the eager loop on the same prompts:
        the same tokens, trace and statistics."""
        eng = engine(ExecutionSpec(strategy="capacity", schedule=schedule))
        _zero_counts(eng)
        captured = sm.CAPTURED
        cold = serve.run(args, engine=eng)
        launches = _launches(eng)
        if mcfg is not None:
            _rows_check(phase, f"{schedule} first run",
                        sm.CAPTURED - captured)
        if launches != n_moe * (4 + eng.stats["iterations"]):
            fail(phase, f"{schedule} first run: {launches} streamed_moe "
                        f"launches")
        eager = engine(eng.scfg.spec, fused=False)
        got, secs = _serve_prompts(eager, cold["prompts"], cold["max_new"])
        outs = list(cold["outs"].values())
        _same_run((eng, outs), (eager, got), f"{cfg.name} {schedule}")
        ms = eng.megastep()
        log(phase, f"{schedule}: first run {cold['seconds']:.3f}s "
                   f"({ms.captures} graphs captured in {ms.capture_s:.3f}s);"
                   f" fused == eager (tokens, {len(eng.trace)} trace "
                   f"records, stats), eager {secs:.3f}s; dynamic schedules "
                   f"{eng.stats['dynamic_schedules']}")
        del eager
        return eng, outs

    eng, first = cold_run("static")
    torch.cuda.empty_cache()
    ms = eng.megastep()
    nb = len(ms.boundaries)
    captures, syncs0, iters0 = ms.captures, eng.stats["host_syncs"], \
        eng.stats["iterations"]
    _zero_counts(eng)
    ssd.LAUNCHES = 0
    warm = serve.run(args, engine=eng)
    launches, ssd_launches = _launches(eng), ssd.LAUNCHES
    if mcfg is not None:
        _rows_check(phase, "warm slice", 0)
    if rows is not None:
        # by graph replays: two for each replayed streamed_moe launch, as
        # the first run's captures held
        rows["launches"] = kmd.LAUNCHES + 2 * eng.graph_launches()
    iters = eng.stats["iterations"] - iters0
    syncs = eng.stats["host_syncs"] - syncs0
    outs = list(warm["outs"].values())
    toks = [t for seq in outs for t in seq]
    if len(toks) != 64 or not all(0 <= t < cfg.vocab_size for t in toks) \
            or outs != first:
        fail(phase, f"warm slice: {len(toks)} tokens, the first run's "
                    f"tokens {outs == first}")
    if nb != n_moe or syncs != iters * (nb + 1) or ms.captures != captures \
            or launches != n_moe * (4 + iters) or ssd_launches != 4 * n_ssm:
        fail(phase, f"warm slice: {nb} boundaries, {syncs} host syncs over "
                    f"{iters} iterations (want {nb + 1} each), captures "
                    f"{captures} -> {ms.captures}, streamed_moe launches "
                    f"{launches} (want {n_moe * (4 + iters)}), ssd launches "
                    f"{ssd_launches} (want {4 * n_ssm})")
    _check_on_card(warm, phase)
    log(phase, f"static warm slice: 4 requests x 16 tokens = {len(toks)} "
               f"tokens in {warm['seconds']:.3f}s "
               f"({len(toks) / warm['seconds']:.1f} tok/s; the 4 one-shot "
               f"prefills of submit {warm['submit_seconds']:.3f}s, the fused"
               f" steps {warm['seconds'] - warm['submit_seconds']:.3f}s), "
               f"{iters} decode iterations, {syncs / iters:.1f} host syncs "
               f"per iteration (nb + 1 = {nb + 1}), captures {ms.captures} "
               f"(unchanged), streamed_moe launches {launches} == {n_moe} "
               f"MoE layers x (4 + {iters}) ({eng.graph_launches()} by "
               f"graph replays) at C = "
               f"{mcfg.top_k * args.max_batch if mcfg else 0} a decode "
               f"step, ssd launches {ssd_launches} == 4 prompts x {n_ssm} "
               f"Mamba-2 layers; the first run's tokens")
    _profile(f"{cfg.name} warm slice", lambda: serve.run(args, engine=eng),
             eng)
    del warm, eng, ms
    torch.cuda.empty_cache()
    peaks = {"static": torch.cuda.max_memory_allocated()}
    if mcfg is not None:
        torch.cuda.reset_peak_memory_stats()
        eng, dynamic = cold_run("dynamic")
        log(phase, f"the dynamic schedule's tokens "
                   f"{'equal' if dynamic == first else 'differ from'} the "
                   f"static one's")
        del eng
        torch.cuda.empty_cache()
        peaks["dynamic"] = torch.cuda.max_memory_allocated()
    if n_ssm:
        _prefill_kernels(params, cfg, phase)
        _preempt_check(params, cfg, phase)
    if prefix:
        torch.cuda.reset_peak_memory_stats()
        _prefix_loops(params, cfg, phase)
        peaks["prefix stream"] = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    log(phase, f"peak device memory {max(peaks.values()) / 2**30:.2f} GiB ("
               + ", ".join(f"{k} runs {v / 2**30:.2f}" for k, v in
                           peaks.items())
               + f"; the weights {weights / 2**30:.2f} GiB)")
    del params
    torch.cuda.empty_cache()
    return launches, ssd_launches


def _rows_check(phase, what, sm_captured):
    """Since ``_zero_counts``: no MoE call kept the one-hot products, and
    the moe_dispatch kernels ran twice (the gather and the combine) for
    each streamed_moe launch, eagerly and into the graphs captured
    (``sm_captured`` streamed_moe launches)."""
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import moe
    line = (f"{what}: moe_dispatch launches {kmd.LAUNCHES} eager, "
            f"{kmd.CAPTURED} captured, against streamed_moe's "
            f"{sm.LAUNCHES} and {sm_captured}; MoE calls that kept the "
            f"one-hot products {moe.ONE_HOT_CALLS}")
    if moe.ONE_HOT_CALLS or kmd.LAUNCHES != 2 * sm.LAUNCHES or \
            kmd.CAPTURED != 2 * sm_captured:
        fail(phase, line)
    log(phase, line)


def _prefix_loops(params, cfg, phase):
    """Phase 6b's shared-prefix stream, closed loops unbounded and with
    ``preempt_queue_depth=0`` + the prefix cache on the fused engine: all
    complete, preemptions and cache hits happen (each cache hit of a model
    with Mamba-2 layers restores an SSM snapshot), the same tokens."""
    import torch
    from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                     ServeConfig, TrafficConfig,
                                     make_traffic, run_closed_loop,
                                     statepool)
    traffic = make_traffic(TrafficConfig(vocab=cfg.vocab_size,
                                         **PREFIX_TRAFFIC))
    n_req = PREFIX_TRAFFIC["num_requests"]
    runs = {}
    for name, cache, depth in (PREFIX_LOOPS[0], PREFIX_LOOPS[2]):
        eng = Engine(params, cfg, ServeConfig(
            max_batch=TRAFFIC_BATCH, max_ctx=256, chunk_tokens=CHUNK,
            prefix_cache=cache, preempt_queue_depth=depth), device="cuda")
        _zero_counts(eng)
        sched = Scheduler(eng, SchedulerConfig(queue_capacity=64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_closed_loop(sched, traffic)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m, s = res["metrics"], eng.stats
        if m.completed != n_req or res["dropped"]:
            fail(phase, f"prefix {name}: {m.completed}/{n_req} completed")
        hits = sum(1 for r in eng.trace if r.get("event") == "cache_hit")
        snapshots = all(e.ssm != () for e in eng.pool.entries.values()) \
            if statepool.has_ssm(eng.caches) else True
        if cache and (m.cache_hits == 0 or hits != m.cache_hits or
                      m.preemptions == 0 or m.preemptions != m.restores or
                      not snapshots):
            fail(phase, f"prefix {name}: {m.cache_hits} cache hits "
                        f"({hits} hit events), {m.preemptions} preemptions "
                        f"/ {m.restores} restores, every entry with its SSM "
                        f"snapshot {snapshots}")
        loop_launches, chunk = _check_traffic_launches(eng, _n_moe(cfg), 0,
                                                       phase)
        runs[name] = res["outputs"]
        log(phase, f"prefix {name}: {m.completed}/{n_req} completed in "
                   f"{m.iterations} iterations, {secs:.3f}s; "
                   f"{m.preemptions} preemptions / {m.restores} restores, "
                   f"{m.cache_hits} cache hits, {s['prefill_tokens_saved']} "
                   f"prefill tokens saved; streamed_moe launches "
                   f"{loop_launches} ({chunk} in prefill steps at C = "
                   f"{TRAFFIC_BATCH * CHUNK * cfg.moe.top_k}); peak "
                   f"resident state {s['peak_resident_state_bytes']} bytes")
        del eng, sched
        torch.cuda.empty_cache()
    want = runs["unbounded"]
    bad = [r for r in want if runs["preempt+cache"][r] != want[r]]
    if bad:
        fail(phase, f"prefix preempt+cache: {len(bad)} requests emit other "
                    f"tokens than the unbounded run ({bad[:4]})")
    log(phase, "prefix preempt+cache == unbounded token for token")


def phase_deepseek():
    """Phase 13: DeepSeek-MoE-16B at full width and depth (28 layers,
    16.88 B parameters, 64 experts top-6 and two shared experts a layer),
    ``_serve_family`` with the shared-prefix loops, and phase dist1's
    decode_fn check (no spec == capacity) on its parameters.  ->
    streamed_moe and moe_dispatch launches of the warm slice (the
    serve_deepseek path)."""
    from repro_torch.configs import get_config
    rows = {}
    launches = _serve_family(get_config(DEEPSEEK), "deepseek", prefix=True,
                             check=_dist1_decode, rows=rows)[0]
    return launches, rows["launches"]


def phase_qwen3():
    """Phase 13q: Qwen3-30B-A3B at its published widths (128 experts
    top-8, d_expert 768), QWEN_LAYERS deep.  -> streamed_moe launches of
    the warm slice (the serve_qwen3 path)."""
    from repro_torch.configs import get_config
    return _serve_family(get_config(QWEN).replace(num_layers=QWEN_LAYERS),
                         "qwen3")[0]


def phase_internvl2():
    """Phase 14: InternVL2-2b at full width and depth (24 layers, 1.89 B
    parameters): ``loss_fn`` over SCORE_B x SCORE_S text tokens behind 256
    random patch embeddings through the flash kernel (hd = 128, GQA 16 /
    8), bf16, then fp32 with kernels against ``use_kernels(False)`` (as
    phase 9 holds granite); then in fp32 ``prefill_fn`` with the prefix
    and DECODE_STEPS greedy ``decode_fn`` steps against the teacher-forced
    forward (phase 7's tolerance).  -> flash launches of the bf16 loss."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import api, transformer
    cfg = get_config(VLM)
    P = cfg.frontend.num_prefix_tokens
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, seed=0, device="cuda")
    batch = _score_batch(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    prefix = torch.randn(SCORE_B, P, cfg.d_model, generator=g,
                         device="cuda") * 0.02
    batch["prefix_embeds"] = prefix.to(torch.bfloat16)
    with torch.no_grad():
        api.loss_fn(params, batch, cfg, use_flash=True)      # warm-up
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        loss, m = api.loss_fn(params, batch, cfg, use_flash=True)
        loss = loss.item()
        secs = time.perf_counter() - t0
    launches = fa.LAUNCHES
    T = SCORE_B * SCORE_S
    if launches != n_attn or not math.isfinite(loss):
        fail("internvl2", f"loss {loss}, flash launches {launches} (want "
                          f"{n_attn})")
    log("internvl2", f"{VLM} full width bf16 ({cfg.param_count() / 1e9:.3f}"
                     f" B params), {SCORE_B} x ({P} patch embeddings + "
                     f"{SCORE_S} text tokens): loss {loss:.4f} (only the "
                     f"text scored) in {secs:.3f}s (warm) = {T / secs:.0f} "
                     f"scored tok/s; flash launches {launches} at (B, S, H, "
                     f"hd) = ({SCORE_B}, {P + SCORE_S}, {cfg.num_heads}, "
                     f"{cfg.resolved_head_dim}); peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    params = api.init_params(cfg32, seed=0, device="cuda")
    batch["prefix_embeds"] = prefix
    out = {}
    for kernels in (True, False):
        with torch.no_grad(), ops.use_kernels(kernels):
            fa.LAUNCHES = 0
            loss32, _ = api.loss_fn(params, batch, cfg32, use_flash=True)
            if kernels:
                launches32 = fa.LAUNCHES
            logits, _ = transformer.forward(params, batch["tokens"], cfg32,
                                            prefix_embeds=prefix,
                                            use_flash=True)
            out[kernels] = (loss32.item(), logits[:, P:])
            del logits
    if launches32 != n_attn:
        fail("internvl2", f"fp32 flash launches {launches32} (want {n_attn})")
    (lk, zk), (lp, zp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    top2 = zp.topk(2, dim=-1).values
    differ = zk.argmax(-1) != zp.argmax(-1)
    miss = (differ & (top2[..., 0] - top2[..., 1] >= MARGIN_TOL)).float() \
        .mean().item()
    line = (f"fp32 parity: loss {lk:.6f} with kernels, {lp:.6f} with "
            f"use_kernels(False), rel {rel:.3e} (tol {LOSS_TOL:g}); argmax "
            f"differs where the plain top-2 margin is >= {MARGIN_TOL:g} at "
            f"{miss:.4f} of the text positions (tol {ARGMAX_MISS:g}); "
            f"logits rel err {rel_err(zk, zp):.3e}; fp32 flash launches "
            f"{launches32}")
    if rel > LOSS_TOL or miss > ARGMAX_MISS:
        fail("internvl2", line)
    log("internvl2", line)
    del out, zk, zp, top2
    torch.cuda.empty_cache()

    B, S = SCORE_B, SCORE_S
    max_seq = P + S + DECODE_STEPS
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = api.prefill_fn(
            params, {"tokens": batch["tokens"], "prefix_embeds": prefix},
            cfg32, max_seq)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps, toks = [logits[:, -1:]], []
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS - 1):
            toks.append(steps[-1].argmax(-1))
            lg, caches = api.decode_fn(params, toks[-1], caches,
                                       torch.full((B,), P + S + i,
                                                  device="cuda"), cfg32)
            steps.append(lg)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        del caches, logits
        seq = torch.cat([batch["tokens"]] + toks, dim=1)
        teacher, _ = transformer.forward(params, seq, cfg32,
                                         prefix_embeds=prefix, use_flash=True)
        teacher = teacher[:, P + S - 1:]
    got = torch.cat(steps, 1)
    rel = rel_err(got, teacher)
    if not torch.isfinite(got).all() or rel > LOGIT_TOL:
        fail("internvl2", f"decode vs teacher forcing rel {rel:.3e} (tol "
                          f"{LOGIT_TOL:g})")
    log("internvl2", f"fp32 prefill_fn with the prefix ({P} + {S} "
                     f"positions) {t_pre:.3f}s, {DECODE_STEPS - 1} greedy "
                     f"decode_fn steps {t_dec:.3f}s "
                     f"({B * (DECODE_STEPS - 1) / t_dec:.1f} tok/s, dense "
                     f"caches, eager): the {DECODE_STEPS} positions' "
                     f"logits vs the teacher-forced forward rel {rel:.3e} "
                     f"(tol {LOGIT_TOL:g})")
    del params, teacher, steps, got
    torch.cuda.empty_cache()
    return launches, launches32


def phase_whisper():
    """Phase 15: Whisper-base at full width and depth (6 + 6 layers,
    d_model 512) over WHISPER_FRAMES frames, the 30 s window.  It runs no
    TPU kernel (its attention is bidirectional in the encoder and never
    flash in the decoder, as in the reference): ``loss_fn`` in bf16, then
    in fp32 ``prefill_fn`` and DECODE_STEPS greedy ``decode_fn`` steps
    whose logits equal ``decode_train``'s teacher-forced ones (the
    reference's test_decode_matches_teacher_forcing, on the card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api, whisper
    cfg = get_config(WHISPER)
    B, F = WHISPER_B, WHISPER_FRAMES
    g = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn(B, F, cfg.d_model, generator=g, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, WHISPER_TOKENS),
                           generator=g, device="cuda")
    labels = torch.cat([tokens[:, 1:], torch.full((B, 1), -1,
                                                  device="cuda")], dim=1)
    fa.LAUNCHES = sm.LAUNCHES = 0
    params = api.init_params(cfg, seed=0, device="cuda")
    batch = {"frames": frames.to(torch.bfloat16), "tokens": tokens,
             "labels": labels}
    with torch.no_grad():
        api.loss_fn(params, batch, cfg)                      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = api.loss_fn(params, batch, cfg)
        loss = loss.item()
        secs = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail("whisper", f"loss {loss}")
    log("whisper", f"{WHISPER} full width bf16 ({cfg.param_count() / 1e6:.1f}"
                   f" M params; {cfg.encoder_layers} encoder + "
                   f"{cfg.num_layers} decoder layers): loss over {B} clips x "
                   f"{F} frames, {WHISPER_TOKENS} tokens each {loss:.4f} in "
                   f"{secs:.3f}s (warm) = {B * WHISPER_TOKENS / secs:.0f} "
                   f"scored tok/s")
    del params
    cfg32 = cfg.replace(dtype="float32")
    params = api.init_params(cfg32, seed=0, device="cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = api.prefill_fn(
            params, {"frames": frames, "tokens": tokens[:, :1]}, cfg32,
            DECODE_STEPS)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        seq, steps = [tokens[:, :1]], []
        t0 = time.perf_counter()
        for t in range(DECODE_STEPS):
            lg, caches = api.decode_fn(params, seq[-1], caches,
                                       torch.full((B,), t, device="cuda"),
                                       cfg32)
            steps.append(lg)
            seq.append(lg.argmax(-1))
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        memory = whisper.encode(params, frames, cfg32)
        teacher = whisper.decode_train(params, torch.cat(seq[:-1], 1),
                                       memory, cfg32)
    got = torch.cat(steps, 1)
    over = ((got - teacher).abs() - TF_TOL * teacher.abs()).max().item()
    first = (steps[0] - logits).abs().max().item()
    if not torch.isfinite(got).all() or over > TF_TOL or first > TF_TOL:
        fail("whisper", f"decode vs teacher forcing: max(|d| - rtol |tf|) "
                        f"{over:.3e} (atol {TF_TOL:g}); step 0 vs prefill "
                        f"{first:.3e}")
    if fa.LAUNCHES or sm.LAUNCHES:
        fail("whisper", f"kernel launches: flash {fa.LAUNCHES}, streamed_moe"
                        f" {sm.LAUNCHES} (the path runs none)")
    log("whisper", f"fp32 prefill_fn (encoder over {F} frames, the cross "
                   f"K/V of {cfg.num_layers} layers) {t_pre:.3f}s; "
                   f"{DECODE_STEPS} greedy decode_fn steps {t_dec:.3f}s "
                   f"({B * DECODE_STEPS / t_dec:.1f} tok/s, eager): logits "
                   f"== decode_train's teacher-forced ones, max abs err "
                   f"{(got - teacher).abs().max().item():.3e}, max(|d| - "
                   f"rtol |tf|) {over:.3e} (rtol = atol = {TF_TOL:g}); no "
                   f"TPU kernel on this path (0 flash, 0 streamed_moe "
                   f"launches)")
    del params, caches, memory
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# phase nemotron: the dense family at its published widths
# ---------------------------------------------------------------------------


def _nemotron_fp32():
    """Phase nemotron (b): NEMOTRON_FP32_LAYERS layer at full width in fp32,
    ``loss_fn`` and the logits over SCORE_B x SCORE_S tokens through the
    flash kernel (split TF32 at hd 192) against ``use_kernels(False)``,
    held as phase 14 holds InternVL2.  -> flash launches of the loss with
    kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import api, transformer
    cfg = get_config(NEMOTRON).replace(num_layers=NEMOTRON_FP32_LAYERS,
                                       dtype="float32")
    gc.collect()      # engines of earlier phases may sit in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    batch = _score_batch(cfg)
    out = {}
    for kernels in (False, True):
        with torch.no_grad(), ops.use_kernels(kernels):
            fa.LAUNCHES = 0
            t0 = time.perf_counter()
            loss, _ = api.loss_fn(params, batch, cfg, use_flash=True)
            loss = loss.item()
            secs = time.perf_counter() - t0
            launches = fa.LAUNCHES
            logits, _ = transformer.forward(params, batch["tokens"], cfg,
                                            use_flash=True)
        out[kernels] = (loss, logits, launches, secs)
        del logits
    (lk, zk, nk, tk), (lp, zp, npl, tp) = out[True], out[False]
    n_attn = cfg.layer_kinds().count("attn")
    if nk != n_attn or npl:
        fail("nemotron", f"fp32 flash launches {nk} with kernels (want "
                         f"{n_attn}), {npl} without (want 0)")
    rel = abs(lk - lp) / abs(lp)
    top2 = zp.topk(2, dim=-1).values
    differ = zk.argmax(-1) != zp.argmax(-1)
    miss = (differ & (top2[..., 0] - top2[..., 1] >= MARGIN_TOL)).float() \
        .mean().item()
    line = (f"(b) fp32, {cfg.num_layers} of 96 layers at full width "
            f"({cfg.param_count() / 1e9:.3f} B params, drawn in "
            f"{drawn:.2f}s), {SCORE_B} x {SCORE_S} tokens: loss {lk:.6f} "
            f"with kernels ({nk} flash launch at hd "
            f"{cfg.resolved_head_dim}, split TF32; one cold call "
            f"{tk:.3f}s), {lp:.6f} with use_kernels(False) (one cold call "
            f"{tp:.3f}s), rel {rel:.3e} (tol "
            f"{LOSS_TOL:g}); argmax differs where the plain top-2 margin "
            f"is >= {MARGIN_TOL:g} at {miss:.4f} of the positions (tol "
            f"{ARGMAX_MISS:g}), at all {differ.float().mean().item():.4f}; "
            f"logits rel err {rel_err(zk, zp):.3e}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not math.isfinite(lk) or rel > LOSS_TOL or miss > ARGMAX_MISS:
        fail("nemotron", line)
    log("nemotron", line)
    del params, out, zk, zp, top2, differ
    torch.cuda.empty_cache()
    return nk


def _nemotron_scoring(params, cfg, launches):
    """Phase nemotron (a): ``loss_fn`` over SCORE_B x SCORE_S tokens in
    bf16 through the flash kernel (a warm-up call, then the timed one):
    one flash launch per layer, no streamed_moe launch, a finite loss;
    scored tok/s and peak memory.  The flash launches go to
    ``launches``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api
    batch = _score_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        api.loss_fn(params, batch, cfg, use_flash=True)      # warm-up
        torch.cuda.synchronize()
        fa.LAUNCHES = sm.LAUNCHES = 0
        t0 = time.perf_counter()
        loss, _ = api.loss_fn(params, batch, cfg, use_flash=True)
        loss = loss.item()
        secs = time.perf_counter() - t0
    launches.append(fa.LAUNCHES)
    n_attn = cfg.layer_kinds().count("attn")
    peak = torch.cuda.max_memory_allocated()
    T = SCORE_B * SCORE_S
    line = (f"(a) bf16 scoring, {cfg.num_layers} of 96 layers: loss "
            f"{loss:.4f} over {SCORE_B} x {SCORE_S} tokens in {secs:.3f}s "
            f"(warm) = {T / secs:.0f} scored tok/s; flash launches "
            f"{fa.LAUNCHES} (want {n_attn}) at (B, S, H, hd) = ({SCORE_B}, "
            f"{SCORE_S}, {cfg.num_heads}, {cfg.resolved_head_dim}), "
            f"streamed_moe launches {sm.LAUNCHES}; peak memory "
            f"{peak / 2**30:.2f} GiB (limit {NEMOTRON_PEAK_GB} GB)")
    if fa.LAUNCHES != n_attn or sm.LAUNCHES or not math.isfinite(loss) \
            or peak >= NEMOTRON_PEAK_GB * 1e9:
        fail("nemotron", line)
    log("nemotron", line)
    torch.cuda.reset_peak_memory_stats()


def phase_nemotron():
    """Phase nemotron (run after phase 15): Nemotron-4-340B, the dense
    family, at its published widths.  (b) ``_nemotron_fp32``; then
    NEMOTRON_LAYERS layers in bf16, the parameters built once: (a)
    ``_nemotron_scoring`` and (c) the slice served through
    ``_serve_family`` (fused == eager, a warm run with no recapture and 1
    host sync an iteration: no MoE boundary).  Serving runs no kernel:
    the paged prefill and decode attention at hd 192 are torch ops, as the
    reference's are plain XLA.  -> flash launches of the bf16 loss and of
    the fp32 loss with kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(NEMOTRON).replace(num_layers=NEMOTRON_LAYERS)
    if (cfg.num_heads, cfg.resolved_head_dim, cfg.moe) != \
            (NEMOTRON_HEADS, NEMOTRON_HD, None):
        fail("nemotron", f"{NEMOTRON}: {cfg.num_heads} heads of hd "
                         f"{cfg.resolved_head_dim}, moe {cfg.moe}")
    launches32 = _nemotron_fp32()
    launches = []
    moe, ssd = _serve_family(cfg, "nemotron",
                             check=lambda p, c: _nemotron_scoring(p, c,
                                                                  launches))
    if moe or ssd:
        fail("nemotron", f"serving launched {moe} streamed_moe and {ssd} "
                         f"SSD kernels (a dense model runs none)")
    log("nemotron", "(c) served: no kernel on this path (the paged "
                    "prefill and decode attention at hd 192 are torch ops, "
                    "as the reference's are plain XLA)")
    return launches[0], launches32


# ---------------------------------------------------------------------------
# phases dist1, 3r and dist2: the distributed MoE families (ROADMAP A.14)
# ---------------------------------------------------------------------------

# phase dist1: api.loss_fn on full granite (bf16) over DIST1_B x DIST1_S
# tokens under each spec a user can leave or give: no spec (the config
# names fse_dp), ExecutionSpec() (auto), ep and tp; each must give
# capacity's bits on one rank
DIST1_B, DIST1_S = 2, 256
MOE_SPEC = os.path.join(HERE, "examples", "moe-spec.json")
# phase 3r and the ring run of phase dist2: streamed_moe at the per-rank
# widths of the ring at P = 8, m = d_expert / (P micro-slices), on a decode
# step of 8 slots a rank, drop-free as the engine serves it (capacity
# factor E: C = 8 k rows an expert)
RING_P, RING_SLOTS = 8, 8
RING_LAYERS = (("granite", ARCH, (1, 2, 4, 8, 16)),
               ("deepseek", DEEPSEEK, (2,)))
# 8-bit weights through the ring at the widths that need padding for them
RING_8BIT = {("granite", 16), ("deepseek", 2)}
# the ring's output against the P = 1 capacity output in the same format:
# the reference's bf16 tolerance; 8-bit formats quantize each micro-slice
# of w_down on its own rows, so fp8 is held at the reference's fp8 one
RING_TOL = {"bf16": 3e-2, "int8": 3e-2, "fp8": 6e-2}
# phase dist2: DIST2_P gloo ranks on the one card, one full-width granite
# MoE layer (drop-free) on DIST2_B x DIST2_S tokens a rank
DIST2_P, DIST2_B, DIST2_S = 2, 2, 64
DIST2_MICRO = (1, 4)
DIST2_TOL = {"fp32": 2e-5, "bf16": 3e-2}


def _granite_moe_layer(dtype, cfg_name=ARCH, seed=0):
    """(moe config drop-free, one MoE layer's parameters) at full width on
    the card, from ``seed``; routed experts only."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    cfg = get_config(cfg_name)
    mcfg = dataclasses.replace(cfg.moe, num_shared_experts=0,
                               capacity_factor=float(cfg.moe.num_experts))
    g = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, mcfg, moe_mod.moe_init(g, cfg.d_model, mcfg, cfg.activation,
                                       dtype, "cuda")


def _width_case(E, C, d, m, wdt, label):
    """streamed_moe at one (E, C, d, m), bf16 activations, ``wdt`` weights,
    swiglu, through the wrapper, which zero-pads m to its path's multiple:
    the padded launch against the plain version on the padded operands
    (bf16: ``moe_bf16_check``; 8-bit: 1e-5) and the wrapper's output the
    same bits; the output against the plain version and the fp32 oracle on
    the unpadded operands; the planner's tile setting (the one the ring
    runs) held the same way; the time of a call with the planner's tiles,
    the padding's share of its device time, the bound of the unpadded
    work.  -> (the kernels line's row, log line)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    act, bf = "swiglu", torch.bfloat16
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, act, bf)
    ws, scales = _stream_operands(wg, wu, wd, wdt)
    m_pad = sm.padded_width(m, bf, ws[1].dtype)
    *pws, psg, psu = sm.pad_width(*ws, scales.get("s_g"), scales.get("s_u"),
                                  m_pad=m_pad)
    pscales = dict(s_g=psg, s_u=psu, s_d=scales["s_d"]) if scales else {}
    tiles = _planned(E, C, d, m, act, "bf16", wdt)
    plain = ref.streamed_moe_plain(xe, *ws, act, **scales)
    oracle = ref.streamed_moe_quant_ref(xe, wg, wu, wd, act, wdt)
    h_plain = ref.streamed_moe_plain_h(xe, *pws, act, s_g=psg, s_u=psu) \
        if wdt == "bf16" else None
    padded_plain = None if wdt == "bf16" else ref.streamed_moe_plain(
        xe, *pws, act, **pscales)

    def held(setting):
        """The padded launch and the wrapper at one tile setting -> (ok,
        the launch's output, text)."""
        h, got = sm._launch(xe, *pws, act, tiles=setting, **pscales)
        wrapped = sm.streamed_moe_kernel(xe, *ws, activation=act,
                                         tiles=setting, **scales)
        torch.cuda.synchronize()
        rel_oracle = rel_err(got, oracle)
        text = (f"max_abs_err vs plain {(got - plain).abs().max().item():.3e}"
                f" (rel {rel_err(got, plain):.3e}")
        if wdt == "bf16":
            ok, mt = moe_bf16_check(h, got, h_plain, xe, *pws, act)
            text += (f"), h at most {mt['over']:.3f} of its bound (tol 1), "
                     f"share differing {mt['flips']:.3e}, down product rel "
                     f"{mt['down']:.3e} (tol {mt['down_tol']:g})")
        else:
            ok = rel_err(got, padded_plain) <= PLAIN_TOL
            text += f", padded plain tol {PLAIN_TOL:g})"
        text += (f", rel vs oracle {rel_oracle:.3e} (tol "
                 f"{ORACLE_TOL[wdt]:g}), wrapper == padded launch "
                 f"{_same_bits(wrapped, got)}")
        ok = ok and rel_oracle <= ORACLE_TOL[wdt] and \
            _same_bits(wrapped, got) and bool(torch.isfinite(got).all())
        return ok, got, text

    what = f"streamed_moe E={E} C={C} d={d} m={m} w={wdt} x=bf16 ({label})"
    ok, got, text = held(None)
    ok_p, got_p, text_p = held(tiles)
    err = (got - plain).abs().max().item()
    line = (f"{what}: padded to m={m_pad}; default tiles: {text}; planned "
            f"tiles {tiles}: {text_p}, the default's bits "
            f"{_same_bits(got_p, got)}")
    if not (ok and ok_p):
        fail("ring", line)
    times, text = kernel_times(lambda: sm.streamed_moe_kernel(
        xe, *ws, activation=act, tiles=tiles, **scales))
    pad_ms = device_ms(lambda: sm.pad_width(
        *ws, scales.get("s_g"), scales.get("s_u"), m_pad=m_pad))[0] \
        if m_pad != m else 0.0
    plain_ms = median_ms(lambda: ref.streamed_moe_plain(xe, *ws, act,
                                                        **scales))
    bound, by = streamed_moe_bound_ms(E, C, d, m, wdt, 2)
    line += (f"; timed at tiles {tiles}: {text}, the padding {pad_ms:.4f} ms "
             f"({pad_ms / times['device_ms']:.3f} of the device time), "
             f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us ({by})")
    row = dict(max_abs_err=err, **times, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=None, tiles=tiles, m_padded=m_pad,
               pad_share=pad_ms / times["device_ms"])
    return row, line


def phase_ring_widths():
    """Phase 3r: streamed_moe at the ring's per-rank widths at P = 8
    (``_width_case``): granite at 1, 2, 4, 8 and 16 micro-slices (m = 64,
    32, 16, 8, 4) and DeepSeek at 2 (m = 88), bf16, and int8 / fp8 weights
    at m = 88 and m = 4.  -> the bf16 rows by path."""
    import torch
    from repro_torch.configs import get_config
    rows = {}
    for label, arch, micros in RING_LAYERS:
        cfg = get_config(arch)
        mcfg = cfg.moe
        E, d = mcfg.num_experts, cfg.d_model
        C = RING_SLOTS * mcfg.top_k          # capacity_of(8) at factor E
        for M in micros:
            m = mcfg.d_expert // (RING_P * M)
            for wdt in ("bf16",) + (("int8", "fp8") if (label, M) in
                                    RING_8BIT else ()):
                row, line = _width_case(E, C, d, m, wdt, f"{label} P={RING_P}"
                                        f" micro-slices {M}")
                log("ring", line)
                if wdt == "bf16":
                    rows[f"ring_{label}_p{RING_P}_m{m}"] = row
                torch.cuda.empty_cache()
    return rows


def _dist1_decode(params, cfg):
    """decode_fn for one step at ``cfg``'s depth with no spec (the config
    names fse_dp) against spec='capacity': the same logits bit for bit,
    one streamed_moe launch per MoE layer."""
    import torch
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api
    g = torch.Generator(device="cuda").manual_seed(0)
    token = torch.randint(0, cfg.vocab_size, (2, 1), generator=g,
                          device="cuda")
    cache_len = torch.zeros((2,), dtype=torch.int32, device="cuda")
    logits = {}
    for spec in (None, "capacity"):
        caches = api.init_decode_caches(params, cfg, 2, 16)
        _zero_counts()
        with torch.no_grad():
            logits[spec], _ = api.decode_fn(params, token, caches, cache_len,
                                            cfg, spec=spec)
        torch.cuda.synchronize()
        if spec is None:
            n = sm.LAUNCHES
    if not _same_bits(logits[None], logits["capacity"]) or n != _n_moe(cfg):
        fail("dist1", f"{cfg.name} decode_fn: no spec == capacity "
                      f"{_same_bits(logits[None], logits['capacity'])}, "
                      f"{n} streamed_moe launches (want {_n_moe(cfg)})")
    log("dist1", f"{cfg.name} ({cfg.num_layers} layers, moe.impl "
                 f"{cfg.moe.impl}): decode_fn with no spec == "
                 f"spec='capacity' bit for bit (logits "
                 f"{tuple(logits[None].shape)}), {n} streamed_moe launches")


def _spec_serve(spec_path):
    """The slice on the fused engine under the spec at ``spec_path``: a
    first run that captures, then a warm run on the same engine that must
    not capture.  -> (the warm run's tokens, host syncs an iteration,
    streamed_moe launches)."""
    from repro_torch.launch import serve
    argv = ["--moe-spec", spec_path] + SLICE_ARGV
    _zero_counts()
    cold = _serve(argv)
    eng, cfg = cold["engine"], cold["cfg"]
    ms = eng.megastep()
    captures, syncs0, iters0 = ms.captures, eng.stats["host_syncs"], \
        eng.stats["iterations"]
    _zero_counts(eng)
    warm = serve.run(serve.parse_args(["--arch", ARCH, "--seed", "0"] + argv),
                     engine=eng)
    iters = eng.stats["iterations"] - iters0
    syncs = (eng.stats["host_syncs"] - syncs0) / iters
    launches = _launches(eng)
    if ms.captures != captures or launches != _n_moe(cfg) * (4 + iters):
        fail("dist1", f"{spec_path}: captures {captures} -> {ms.captures}, "
                      f"{launches} streamed_moe launches")
    _check_on_card(warm, "dist1")
    return list(warm["outs"].values()), syncs, launches


def phase_dist1():
    """Phase dist1: one rank, full width.  ``api.loss_fn`` on granite with
    no spec (its config names fse_dp), ``ExecutionSpec()`` (auto), ep and
    tp == spec='capacity' bit for bit; ``serve --moe-spec
    examples/moe-spec.json`` (auto, fse_dp prefill, ep decode, a layer
    override, the dynamic schedule) == the same spec with every strategy
    capacity: the same tokens, no recapture, the same host syncs an
    iteration.  (DeepSeek's decode_fn runs in phase 13.)  -> the kernels
    line's row of the no-spec loss path, and its launches."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api
    cfg = get_config(ARCH)
    params = api.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (DIST1_B, DIST1_S), generator=g,
                           device="cuda")
    batch = {"tokens": tokens, "labels": torch.cat([tokens[:, 1:], torch.full(
        (DIST1_B, 1), -1, device="cuda")], 1)}
    out, launches = {}, {}
    for name, spec in (("capacity", "capacity"), ("no spec", None),
                       ("ExecutionSpec()", ExecutionSpec()), ("ep", "ep"),
                       ("tp", "tp")):
        _zero_counts()
        with torch.no_grad():
            loss, m = api.loss_fn(params, batch, cfg, spec=spec)
        torch.cuda.synchronize()
        launches[name] = sm.LAUNCHES
        out[name] = (loss, m["ce"], m["aux"])
    n_moe = _n_moe(cfg)
    for name, vals in out.items():
        same = all(_same_bits(a, b) for a, b in zip(vals, out["capacity"]))
        if not same or launches[name] != n_moe:
            fail("dist1", f"granite loss_fn {name}: capacity's bits {same}, "
                          f"{launches[name]} streamed_moe launches (want "
                          f"{n_moe})")
    log("dist1", f"{ARCH} full width bf16, {DIST1_B} x {DIST1_S} tokens, "
                 f"moe.impl {cfg.moe.impl}: loss_fn with no spec, "
                 f"ExecutionSpec() (auto), ep and tp == capacity bit for bit "
                 f"(loss {out['capacity'][0].item():.6f}, aux "
                 f"{out['capacity'][2].item():.6f}), {n_moe} streamed_moe "
                 f"launches each")
    C = cfg.moe.capacity_rows(DIST1_B * DIST1_S)
    row, line = _width_case(cfg.moe.num_experts, C, cfg.d_model,
                            cfg.moe.d_expert, "bf16", "dist1 loss")
    log("dist1", line)
    del params
    torch.cuda.empty_cache()
    with open(MOE_SPEC) as f:
        spec = json.load(f)
    cap = dict(spec, strategy="capacity", prefill="capacity",
               decode="capacity",
               layer_overrides={k: "capacity" for k in spec["layer_overrides"]})
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "capacity-spec.json")
        with open(cap_path, "w") as f:
            json.dump(cap, f)
        got, syncs, n = _spec_serve(MOE_SPEC)
        want, syncs_cap, n_cap = _spec_serve(cap_path)
    if got != want or syncs != syncs_cap or n != n_cap:
        fail("dist1", f"serve --moe-spec {MOE_SPEC}: tokens equal "
                      f"{got == want}, host syncs an iteration {syncs} vs "
                      f"{syncs_cap}, launches {n} vs {n_cap}")
    log("dist1", f"serve --moe-spec examples/moe-spec.json ({spec}) == the "
                 f"spec with every strategy capacity: the same "
                 f"{sum(len(t) for t in got)} tokens, no recapture on the warm"
                 f" run, {syncs:.1f} host syncs an iteration each, {n} "
                 f"streamed_moe launches each")
    torch.cuda.empty_cache()
    return row, launches["no spec"]


def _want_launches(plan, P):
    """streamed_moe launches of one MoE layer call on a rank under
    ``plan``: P M for the ring modes (stream, index), 1 for slice, EP and
    TP."""
    if plan.family in ("ep", "tp") or plan.mode == "slice":
        return 1
    return P * plan.micro_slices


def _dist2_rank(rank, world, job):
    """One gloo rank on the card: ``job`` 'p2' runs the strategies of phase
    dist2 on a granite MoE layer, 'ring' the ring widths of phase 3r.  Each
    rank computes the P = 1 ``capacity`` outputs itself (no mesh), and
    counts its streamed_moe launches case by case.  -> picklable results."""
    import dataclasses
    import torch
    from repro_torch.core import autotune, strategy
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.parallel import collectives, meshctx
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshctx.ProcessMesh.create((world,), ("model",))
    res = {"transport": collectives.transport(mesh, "model", "cuda"),
           "cases": {}}

    def run(spec, params, x, mcfg, act, plan=None):
        sm.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), meshctx.with_mesh(mesh):
            y, _ = strategy.execute(spec, params, x, mcfg, act, plan=plan)
        torch.cuda.synchronize()
        return y, sm.LAUNCHES, time.perf_counter() - t0

    def capacity(params, x, mcfg, act, wdt=None):
        with torch.no_grad():
            return strategy.execute(ExecutionSpec(strategy="capacity",
                                                  weight_dtype=wdt),
                                    params, x, mcfg, act)[0]

    def err(y, want):
        return ((y.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    g = torch.Generator(device="cuda").manual_seed(1)
    if job == "p2":
        cfg, mcfg, p32 = _granite_moe_layer(torch.float32)
        act, d = cfg.activation, cfg.d_model
        x32 = torch.randn(DIST2_B, DIST2_S, d, generator=g, device="cuda")
        layers = {"fp32": (p32, x32), "bf16": (
            {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else
                 {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
             for k, v in p32.items()}, x32.to(torch.bfloat16))}
        want = {fmt: capacity(params, x, mcfg, act)
                for fmt, (params, x) in layers.items()}
        cases = []
        for mode in ("stream", "index", "slice"):
            for M in (DIST2_MICRO if mode != "slice" else (1,)):
                cases.append((f"{mode} M={M}", "fse_dp", mode, M))
        cases += [(n, n, None, None) for n in ("ep", "tp", "auto")]
        ys, res["auto"] = {}, {}
        for fmt, (params, x) in layers.items():
            for label, name, mode, M in cases:
                plan = None
                if mode is not None:
                    plan = dataclasses.replace(autotune.plan_moe(
                        DIST2_B, DIST2_S, d, mcfg, act, world,
                        dtype_bytes=x.element_size(), mode=mode),
                        micro_slices=M, tiles=None)
                for sched in ("static", "dynamic"):
                    spec = ExecutionSpec(strategy=name, schedule=sched)
                    # the plan each case runs, for its launch count
                    with spec.scope(), meshctx.with_mesh(mesh):
                        ran = plan or strategy.get_strategy(name).plan(
                            strategy.StrategyContext.from_inputs(
                                x, mcfg, act))
                    if name == "auto":
                        res["auto"][fmt, sched] = (ran.family, ran.mode,
                                                   ran.micro_slices)
                    y, n, secs = run(spec, params, x, mcfg, act, plan)
                    ys[fmt, label, sched] = y
                    res["cases"][fmt, label, sched] = dict(
                        launches=n, want=_want_launches(ran, world),
                        seconds=secs, err=err(y, want[fmt]),
                        same=sched == "static" or _same_bits(
                            y, ys[fmt, label, "static"]))
        return res
    for label, arch, micros in RING_LAYERS:
        cfg, mcfg, params = _granite_moe_layer(torch.bfloat16, arch)
        act, d = cfg.activation, cfg.d_model
        x = torch.randn(RING_SLOTS, world, d, generator=g,
                        device="cuda").to(torch.bfloat16)
        for M in micros:
            for wdt in ("bf16",) + (("int8", "fp8") if (label, M) in
                                    RING_8BIT else ()):
                plan = dataclasses.replace(autotune.plan_moe(
                    RING_SLOTS, world, d, mcfg, act, world, dtype_bytes=2,
                    weight_bytes=WEIGHT_BYTES[wdt], mode="stream"),
                    micro_slices=M, tiles=None)
                y, n, secs = run(ExecutionSpec(strategy="fse_dp",
                                               weight_dtype=wdt),
                                 params, x, mcfg, act, plan)
                res["cases"][label, M, wdt] = dict(
                    launches=n, seconds=secs, m=mcfg.d_expert // (world * M),
                    err=err(y, capacity(params, x, mcfg, act, wdt)))
        del params
        torch.cuda.empty_cache()
    return res


def phase_dist2():
    """Phase dist2: gloo ranks on the one card (``parallel.localrun``; CUDA
    payloads staged through host buffers, the ``gloo-host`` transport).
    (a) DIST2_P ranks, one full-width granite MoE layer (E = 32, top-8, d =
    1024, d_expert = 512, drop-free) on DIST2_B x DIST2_S tokens: fse_dp
    forced to stream and index at 1 and 4 micro-slices and slice, ep, tp
    and auto, static and dynamic, in fp32 and bf16, each within DIST2_TOL
    (2e-5, 3e-2) of max |y| of the P = 1 capacity output in its format
    (bf16 router logits route some tokens to other experts than fp32 ones
    do, so bf16 is held against bf16), dynamic == static bit for bit, the
    launches on each rank exactly the case's plan's (``_want_launches``).
    (b) RING_P ranks, the ring (stream) at phase 3r's widths on a
    decode step of 8 slots a rank: granite at 1-16 micro-slices, DeepSeek
    at 2, bf16 (and int8 / fp8 where 3r pads them), each within RING_TOL of
    the P = 1 capacity output in its format.  The times are gloo through
    host memory on one card: no ring's speed.  -> streamed_moe launches of
    the ring run by 3r path."""
    import torch
    from repro_torch.parallel import localrun
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p2 = localrun.run(_dist2_rank, DIST2_P, "p2")
    for key in p2[0]["cases"]:
        fmt, label, sched = key
        c = [r["cases"][key] for r in p2]
        bad = [r for r, ci in enumerate(c) if ci["err"] > DIST2_TOL[fmt]
               or not ci["same"] or ci["launches"] != ci["want"]]
        if bad:
            fail("dist2", f"P={DIST2_P} {fmt} {label} {sched}: ranks {bad}: "
                          + "; ".join(f"err {ci['err']:.3e} (tol "
                                      f"{DIST2_TOL[fmt]:g}), dynamic == "
                                      f"static {ci['same']}, launches "
                                      f"{ci['launches']} (want "
                                      f"{ci['want']})" for ci in c))
        log("dist2", f"P={DIST2_P} ({p2[0]['transport']}) {fmt} {label} "
                     f"{sched}: rel err {max(ci['err'] for ci in c):.3e} "
                     f"(tol {DIST2_TOL[fmt]:g}, vs the P = 1 capacity "
                     f"output in {fmt}"
                     + (", == static bit for bit" if sched == "dynamic"
                        else "")
                     + "), streamed_moe launches by rank "
                     + str([ci["launches"] for ci in c])
                     + f" (want {c[0]['want']} each)"
                     + ", seconds a call by rank "
                     + str([round(ci["seconds"], 4) for ci in c]))
    log("dist2", f"P={DIST2_P}: auto planned {p2[0]['auto']}; every case "
                 f"held on every rank in {time.perf_counter() - t0:.1f}s "
                 f"(times: gloo through host buffers on one card, not a "
                 f"ring speed)")
    t0 = time.perf_counter()
    ring = localrun.run(_dist2_rank, RING_P, "ring")
    launches = {}
    for key in ring[0]["cases"]:
        label, M, wdt = key
        c = [r["cases"][key] for r in ring]
        m = c[0]["m"]
        worst = max(ci["err"] for ci in c)
        n = [ci["launches"] for ci in c]
        if worst > RING_TOL[wdt] or min(n) != RING_P * M:
            fail("dist2", f"ring P={RING_P} {label} M={M} m={m} {wdt}: rel "
                          f"err {worst:.3e} (tol {RING_TOL[wdt]:g}), "
                          f"launches by rank {n} (want {RING_P * M} each)")
        log("dist2", f"ring P={RING_P} {label} micro-slices {M} (m = {m}) "
                     f"{wdt}: rel err vs the P = 1 capacity output "
                     f"{worst:.3e} (tol {RING_TOL[wdt]:g}), {RING_P * M} "
                     f"streamed_moe launches on each rank, seconds a call "
                     f"by rank {[round(ci['seconds'], 4) for ci in c]}")
        if wdt == "bf16":
            launches[f"ring_{label}_p{RING_P}_m{m}"] = sum(n)
    log("dist2", f"ring run held on {RING_P} ranks in "
                 f"{time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase train: the training slice (ROADMAP A.15a)
# ---------------------------------------------------------------------------

# (a) ``training.train`` on full-width, full-depth granite in bf16 with
# remat, on SyntheticLM batches of SCORE_B x SCORE_S tokens (C = 1280):
# AdamW at TRAIN_LR, linear warmup over TRAIN_WARMUP steps, then a cosine
# to 0 at TRAIN_STEPS; weight decay 0.1, clipping at 1.0 (TrainConfig's)
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 20, 1e-3, 5
# (b), (c): fp32 granite at full width, TRAIN_GRAD_LAYERS deep, one batch.
# Kernels vs use_kernels(False): max |g_k - g_p| / max |g_p| per leaf
# within the reference's gradient rtol (tests/test_streamed_moe_parity.py),
# both runs taking the plain run's top-k choices (an fp32 near-tie may
# pick another expert where the forwards' last bits differ; the two
# gradients are then those of different functions).  int8 weights: each
# leaf within STE_DRIFT relative norm of the fp32-weight gradients (the
# reference's straight-through bound).  remat == no remat: each leaf
# within REMAT_TOL of its max |g| (embedding backward atomics, fp32
# reassociation), the loss within REMAT_TOL relative
TRAIN_GRAD_LAYERS = 4
TRAIN_GRAD_TOL = 2e-4
STE_DRIFT = 0.05
REMAT_TOL = 1e-6
# (d): crash at RESUME_CRASH of RESUME_STEPS (checkpoints every
# RESUME_EVERY), auto-resume; the final loss within the reference's rtol
# (tests/test_train.py)
RESUME_LAYERS, RESUME_STEPS, RESUME_CRASH, RESUME_EVERY = 2, 4, 2, 2
RESUME_RTOL = 1e-5
# (e): the distributed bodies' gradients on gloo ranks sharing the card,
# against one rank's capacity gradients, at the reference's
# fsedp_grad.py setup (parallel.gradcheck) and tolerance
DIST_GRAD_RTOL, DIST_GRAD_ATOL = 5e-3, 5e-4


class _PinnedRouting:
    """Patches ``gating.route`` while entered: records each call's top-k
    indices and, with ``pinned`` (an earlier run's record), takes those
    indices instead of its own (weights renormalized from this run's
    probabilities, so the router's gradient is this run's), counting the
    tokens whose own choice differs."""

    def __init__(self, pinned=None):
        self.pinned, self.record, self.flips = pinned, [], 0

    def __enter__(self):
        import torch
        from repro_torch.core import gating
        self._orig = orig = gating.route

        def route(params, x, *, top_k):
            r = orig(params, x, top_k=top_k)
            if self.pinned is not None:
                idx = self.pinned[len(self.record)]
                own, want = torch.sort(r.indices, 1).values, \
                    torch.sort(idx, 1).values
                self.flips += int((own != want).any(1).sum())
                w = r.probs.gather(1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
                combine = torch.zeros_like(r.probs).scatter_(1, idx, w)
                r = gating.Routing(idx, w.to(x.dtype), r.probs,
                                   combine.to(x.dtype))
            self.record.append(r.indices.detach())
            return r
        gating.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.core import gating
        gating.route = self._orig


def _train_batch(cfg):
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SCORE_S,
                                  global_batch=SCORE_B, seed=0))
    return {k: torch.from_numpy(v).long().cuda()
            for k, v in data.batch(0).items()}


def _loss_grads(params, batch, cfg, *, kernels=True, weight_dtype=None,
                remat=False, routing=None):
    """(loss, every leaf's gradient, streamed_moe launches) of
    ``api.loss_fn`` under ``capacity``."""
    import torch
    from repro_torch import tree
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api
    leaves = tree.leaves(params)
    spec = ExecutionSpec(strategy="capacity", weight_dtype=weight_dtype)
    n0 = sm.LAUNCHES
    with ops.use_kernels(kernels), routing or _PinnedRouting():
        loss, _ = api.loss_fn(params, batch, cfg, spec=spec, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, sm.LAUNCHES - n0


def _leaf_errs(got, want, norm=False):
    """Per leaf max |got - want| / max |want| (``norm``: relative norms)."""
    out = []
    for g, w in zip(got, want):
        if norm:
            out.append(((g.float() - w.float()).norm()
                        / w.float().norm()).item())
        else:
            out.append(((g.float() - w.float()).abs().max()
                        / w.float().abs().max()).item())
    return out


def _train_run(cfg, dcfg, tcfg, crash_at_step=None):
    """``training.train`` with a hook at every logged step -> (result, per
    step (wall seconds, streamed_moe launches so far, metrics))."""
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.training import train
    marks = []

    def hook(step, metrics):
        marks.append((time.perf_counter(), sm.LAUNCHES, metrics))
    res = train(cfg, dcfg, tcfg, seed=0, hooks=hook, device="cuda",
                crash_at_step=crash_at_step)
    return res, marks


def phase_train():
    """Phase train: (a) the training path at full width and depth, (b)
    kernel vs plain gradients, (c) remat == no remat, (d) crash and
    resume, (e) the distributed bodies' gradients on the card.  ->
    streamed_moe launches of (a)."""
    import tempfile
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.models import api
    from repro_torch.training import TrainConfig
    cfg = get_config(ARCH)
    T = SCORE_B * SCORE_S
    n_moe = _n_moe(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SCORE_S,
                      global_batch=SCORE_B, seed=0)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS, remat=True, log_every=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sm.LAUNCHES = 0
    t0 = time.perf_counter()
    res, marks = _train_run(cfg, dcfg, tcfg)
    torch.cuda.synchronize()
    launches = sm.LAUNCHES
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree.leaves(res.params))
    del res
    torch.cuda.empty_cache()
    step_s = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    per_step = [marks[0][1]] + [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    losses = [m[2]["loss"] for m in marks]
    gnorms = [m[2]["grad_norm"] for m in marks]
    med = statistics.median(step_s)
    line = (f"{ARCH} full width and depth ({n_params} parameters), bf16, "
            f"remat, {SCORE_B} x {SCORE_S} tokens a step (C = "
            f"{cfg.moe.capacity_rows(T)}), {TRAIN_STEPS} AdamW steps (lr "
            f"{TRAIN_LR:g}, warmup {TRAIN_WARMUP}): median step "
            f"{med:.4f}s over steps 1-{TRAIN_STEPS - 1} (min "
            f"{min(step_s):.4f}, max {max(step_s):.4f}) = {T / med:.0f} "
            f"training tok/s; {wall:.1f}s in all; peak memory "
            f"{peak / 2**30:.2f} GiB; streamed_moe launches a step "
            f"{sorted(set(per_step))} (want {2 * n_moe}: forward + remat "
            f"recompute); loss {losses[0]:.4f} -> {losses[-1]:.4f} (by step: "
            f"{[round(v, 4) for v in losses]}); grad norm "
            f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}")
    finite = all(math.isfinite(v) for v in losses + gnorms)
    if per_step != [2 * n_moe] * TRAIN_STEPS or not finite \
            or not losses[-1] < losses[0]:
        fail("train", line)
    log("train", line)

    # (b) kernels vs plain, and int8 weights, fp32 at reduced depth
    cfg32 = cfg.replace(dtype="float32", num_layers=TRAIN_GRAD_LAYERS)
    params = api.init_params(cfg32, seed=0, device="cuda")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    paths = [k for k, _ in tree.leaves_with_path(params)]
    batch = _train_batch(cfg32)
    plain = _PinnedRouting()
    loss_p, g_p, _ = _loss_grads(params, batch, cfg32, kernels=False,
                                 routing=plain)
    pinned = _PinnedRouting(plain.record)
    loss_k, g_k, n_k = _loss_grads(params, batch, cfg32, routing=pinned)
    errs = _leaf_errs(g_k, g_p)
    worst = max(range(len(errs)), key=errs.__getitem__)
    line = (f"fp32 {TRAIN_GRAD_LAYERS} layers, {T} tokens: loss_fn gradients "
            f"with kernels ({n_k} streamed_moe launches) vs "
            f"use_kernels(False), {len(paths)} leaves: worst {paths[worst]} "
            f"max|g_k - g_p| / max|g_p| {errs[worst]:.3e} (tol "
            f"{TRAIN_GRAD_TOL:g}); loss {loss_k.item():.6f} vs "
            f"{loss_p.item():.6f}; tokens whose own top-k differs from the "
            f"plain run's (pinned to it) {pinned.flips} of "
            f"{T * TRAIN_GRAD_LAYERS}")
    ok = errs[worst] <= TRAIN_GRAD_TOL and n_k == TRAIN_GRAD_LAYERS and \
        all(torch.isfinite(g).all() for g in g_k)
    if not ok:
        fail("train", line)
    log("train", line)
    q = _PinnedRouting(plain.record)
    _, g_q, n_q = _loss_grads(params, batch, cfg32, weight_dtype="int8",
                              routing=q)
    drift = _leaf_errs(g_q, g_k, norm=True)
    worst = max(range(len(drift)), key=drift.__getitem__)
    line = (f"int8 weights ({n_q} launches): straight-through gradients, "
            f"worst leaf {paths[worst]} at {drift[worst]:.3e} relative norm "
            f"from the fp32-weight ones (tol {STE_DRIFT:g}); tokens whose "
            f"own top-k differs from the plain run's {q.flips}")
    if drift[worst] > STE_DRIFT or not all(torch.isfinite(g).all()
                                           for g in g_q):
        fail("train", line)
    log("train", line)
    del g_p, g_q

    # (c) remat == no remat, kernels on, each run its own routing
    loss_n, g_n, n_n = _loss_grads(params, batch, cfg32)
    loss_r, g_r, n_r = _loss_grads(params, batch, cfg32, remat=True)
    errs = _leaf_errs(g_r, g_n)
    worst = max(range(len(errs)), key=errs.__getitem__)
    rel = abs(loss_r.item() - loss_n.item()) / abs(loss_n.item())
    line = (f"remat vs no remat (fp32, {TRAIN_GRAD_LAYERS} layers): loss "
            f"{'bit for bit' if torch.equal(loss_r, loss_n) else f'rel {rel:.3e}'}"
            f", leaves bit for bit {sum(torch.equal(a, b) for a, b in zip(g_r, g_n))}"
            f" of {len(paths)}, worst {paths[worst]} {errs[worst]:.3e} of its "
            f"max (tol {REMAT_TOL:g}); streamed_moe launches {n_r} with remat, "
            f"{n_n} without (want {2 * TRAIN_GRAD_LAYERS}, "
            f"{TRAIN_GRAD_LAYERS})")
    if errs[worst] > REMAT_TOL or rel > REMAT_TOL or \
            (n_r, n_n) != (2 * TRAIN_GRAD_LAYERS, TRAIN_GRAD_LAYERS):
        fail("train", line)
    log("train", line)
    del params, g_k, g_n, g_r
    torch.cuda.empty_cache()

    # (d) crash and resume through checkpoints
    cfg_r = cfg.replace(num_layers=RESUME_LAYERS)
    tc = dict(lr=TRAIN_LR, warmup=2, total_steps=RESUME_STEPS, remat=True,
              log_every=1, ckpt_every=RESUME_EVERY)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        straight, _ = _train_run(cfg_r, dcfg, TrainConfig(ckpt_dir=d1, **tc))
        try:
            _train_run(cfg_r, dcfg, TrainConfig(ckpt_dir=d2, **tc),
                       crash_at_step=RESUME_CRASH)
            fail("train", "the simulated preemption did not happen")
        except RuntimeError as e:
            if "preemption" not in str(e):
                raise
        resumed, _ = _train_run(cfg_r, dcfg, TrainConfig(ckpt_dir=d2, **tc))
    want, got = straight.losses[-1][1], resumed.losses[-1][1]
    rel = abs(got - want) / abs(want)
    line = (f"crash at step {RESUME_CRASH} of {RESUME_STEPS} ({ARCH} "
            f"{RESUME_LAYERS} layers, bf16, checkpoints every {RESUME_EVERY}"
            f" steps), resumed from step {resumed.resumed_from}: final loss "
            f"{got:.6f} vs the straight run's {want:.6f}, rel {rel:.3e} (tol "
            f"{RESUME_RTOL:g}); {time.perf_counter() - t0:.1f}s")
    if resumed.resumed_from != RESUME_CRASH or rel > RESUME_RTOL:
        fail("train", line)
    log("train", line)
    del straight, resumed
    torch.cuda.empty_cache()

    # (e) the distributed bodies' gradients, gloo ranks on the card
    from repro_torch.parallel import localrun
    for shape in ((2,), (2, 4)):
        t0 = time.perf_counter()
        ranks = localrun.run(_dist_grad_rank, math.prod(shape), shape)
        for case in ranks[0]["cases"]:
            worst = max(r["cases"][case] for r in ranks)
            line = (f"mesh {shape}: {case} gradients on every rank vs one "
                    f"rank's capacity gradients: worst |g - g1| / (atol + "
                    f"rtol |g1|) {worst:.3e} (rtol {DIST_GRAD_RTOL:g}, atol "
                    f"{DIST_GRAD_ATOL:g}; want <= 1)")
            if not worst <= 1.0:
                fail("train", line)
            log("train", line)
        log("train", f"mesh {shape}: {math.prod(shape)} ranks "
                     f"({ranks[0]['transport']}) held in "
                     f"{time.perf_counter() - t0:.1f}s")
    return launches


def _dist_grad_rank(rank, world, shape):
    """One gloo rank of phase train (e): the ring's stream / index / slice
    modes on the ``shape`` mesh, and ``ep`` and ``tp`` on a one-axis mesh,
    through ``parallel.gradcheck`` (each rank takes its share of the loss
    and sums the weight gradients over the mesh), held to the capacity
    gradients this rank computes alone over every row.
    -> {case: worst |g - g1| / (atol + rtol |g1|)}."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.parallel import collectives, gradcheck, meshctx
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("model",) if len(shape) == 1 else ("data", "model")
    mesh = meshctx.ProcessMesh.create(shape, names)
    arrays = gradcheck.inputs()
    p = gradcheck.params(arrays, lambda a: torch.from_numpy(a).cuda()
                         .requires_grad_(True))
    y, _ = strategy.execute("capacity", p, torch.from_numpy(arrays["x"])
                            .cuda(), gradcheck.moe_config(), "swiglu")
    want = torch.autograd.grad(torch.sum(y ** 2), [
        gradcheck.leaf(p, k) for k in gradcheck.LEAVES])
    cases = [("fse_dp", m, "onehot", "static")
             for m in ("stream", "index", "slice")]
    if len(shape) == 1:
        cases += [("ep", None, "onehot", "static"),
                  ("tp", None, "onehot", "static")]
    got = gradcheck.rank_grads(mesh, arrays, cases, device="cuda")
    return {"transport": collectives.transport(mesh, "model", "cuda"),
            "cases": {case: max(
                ((g[k] - w).abs() / (DIST_GRAD_ATOL + DIST_GRAD_RTOL
                                     * w.abs())).max().item()
                for k, w in zip(gradcheck.LEAVES, want))
                for case, g in got.items()}}


# ---------------------------------------------------------------------------
# phase mesh: the mesh machinery (ROADMAP A.15b)
# ---------------------------------------------------------------------------

# (a) launch.steps.build_train_step on granite at full width and depth,
# bf16, remat, on a MESH_SHAPE ("data", "model") mesh of gloo ranks sharing
# the card (the gloo-host transport): MESH_B x MESH_S SyntheticLM tokens a
# step, one row a data group, AdamW at MESH_LR, MESH_STEPS steps
MESH_SHAPE = (2, 2)
MESH_B, MESH_S, MESH_STEPS, MESH_LR = 2, 2048, 5, 1e-4
# (b) the same granite in fp32 at MESH_GRAD_LAYERS layers (widths not cut),
# one step on MESH_SHAPE with fsdp off and forced on, against one device's
# step (loss_fn's gradients and adamw.apply): every gathered leaf of the
# params, m and v within MESH_LEAF_TOL of the leaf's max |.|, the loss
# within MESH_LOSS_TOL relative.  Drop-free (capacity factor E / k: a rank
# sizes its capacity from its own tokens) and with aux_loss_coef 0 (on a
# mesh the FSE-DP load-balance loss is the mean of each rank's own, the
# reference's pmean_all, not one device's)
MESH_GRAD_LAYERS = 4
MESH_LEAF_TOL, MESH_LOSS_TOL = 2e-4, 1e-5
# (d) the dry run on DRY_MESH ranks: the five archs of the reference's
# tests/distributed_scripts/dryrun_small.py, reduced, x train / prefill /
# decode at (seq 64, batch 8)
DRY_MESH = (2, 4)
DRY_ARCHS = ("granite-moe-1b-a400m", "jamba-v0.1-52b", "mamba2-370m",
             "whisper-base", "internvl2-2b")


def _tree_bytes(t):
    from repro_torch import tree
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


class _Margins:
    """Patches ``gating.route`` while entered: the smallest gap between
    the k-th and the (k+1)-th router probability of any token (a top-k
    choice another run's last bits could flip only below that)."""

    def __enter__(self):
        import torch
        from repro_torch.core import gating
        self._orig = orig = gating.route
        self.least = float("inf")

        def route(params, x, *, top_k):
            r = orig(params, x, top_k=top_k)
            top = torch.topk(r.probs.float(), top_k + 1, dim=-1).values
            self.least = min(self.least, (top[:, top_k - 1]
                                          - top[:, top_k]).min().item())
            return r
        gating.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.core import gating
        gating.route = self._orig


def _mesh_train(mesh, cfg):
    """(a) on this rank -> its record."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import autotune
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import quant
    from repro_torch.kernels import streamed_moe as sm
    from repro_torch.launch import specs, steps
    from repro_torch.models import api
    from repro_torch.optim import adamw
    shape = ShapeSpec("mesh_train", MESH_S, MESH_B, "train")
    fn, (psh, osh, bsh), _, (pstruct, ostruct, _) = steps.build_train_step(
        cfg, shape, mesh, lr=MESH_LR, remat=True)
    full = api.init_params(cfg, seed=0, device="cuda")
    params = steps.shard_tree(full, psh)
    del full
    torch.cuda.empty_cache()
    opt = adamw.init(params, state_dtype=steps.state_dtype(cfg))
    P = mesh.size("model")
    plan = autotune.plan_moe(MESH_B // mesh.size("data"), MESH_S,
                             cfg.d_model, cfg.moe, cfg.activation, P,
                             dtype_bytes=2, weight_bytes=quant.weight_bytes())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_S,
                                  global_batch=MESH_B, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sm.LAUNCHES = 0
    losses, secs, launches = [], [], []
    for step in range(MESH_STEPS):
        batch = steps.shard_tree({k: torch.from_numpy(v).cuda() for k, v
                                  in data.batch(step).items()}, bsh)
        torch.cuda.synchronize()
        n0, t0 = sm.LAUNCHES, time.perf_counter()
        params, opt, loss = fn(params, opt, batch)
        losses.append(loss.item())
        secs.append(time.perf_counter() - t0)
        launches.append(sm.LAUNCHES - n0)
    w_up = params["periods"][0]["moe"]["w_up"]
    rec = dict(losses=losses, secs=secs, launches=launches,
               want=2 * _n_moe(cfg) * _want_launches(plan, P),
               plan=(plan.mode, plan.micro_slices, plan.tiles),
               stored=_tree_bytes((params, opt)),
               one_device=_tree_bytes((pstruct, ostruct)),
               w_up=tuple(w_up.shape), peak=torch.cuda.max_memory_allocated())
    del params, opt, batch
    torch.cuda.empty_cache()
    return rec


def _leaf_worst(got, want):
    """(worst path, max |got - want| / max |want| there) over two trees."""
    from repro_torch import tree
    worst = ("", 0.0)
    for (k, g), w in zip(tree.leaves_with_path(got), tree.leaves(want)):
        e = ((g.float() - w.float()).abs().max()
             / w.float().abs().max().clamp(min=1e-30)).item()
        if e > worst[1] or not math.isfinite(e):
            worst = (k, e)
    return worst


def _mesh_parity(mesh, cfg, ckpt_dir):
    """(b) and (c) on this rank -> its record (rank 0's holds the
    comparisons)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.checkpointing import manager
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    moe = cfg.moe
    cfg = cfg.replace(dtype="float32", num_layers=MESH_GRAD_LAYERS,
                      moe=dataclasses.replace(
                          moe, aux_loss_coef=0.0,
                          capacity_factor=moe.num_experts / moe.top_k))
    shape = ShapeSpec("mesh_parity", MESH_S, MESH_B, "train")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_S,
                                  global_batch=MESH_B, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    rec, want = {}, None
    if mesh.rank == 0:        # one device's step, kernels on (capacity)
        params = api.init_params(cfg, seed=0, device="cuda")
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with _Margins() as mg:          # the recompute routes again
            loss, _ = api.loss_fn(params, {k: v.long() for k, v in
                                           batch.items()}, cfg, remat=True)
            grads = torch.autograd.grad(loss, leaves)
        opt = adamw.init(params)
        adamw.apply(params, tree.unflatten(params, list(grads)), opt,
                    lr=MESH_LR)
        want = (loss.item(), params, opt.m, opt.v)
        rec["margin"] = mg.least
        del grads
    for fsdp in (False, True):
        fn, (psh, osh, bsh), _, _ = steps.train_step_for(
            cfg, shape, mesh, fsdp=fsdp, lr=MESH_LR, remat=True)
        full = api.init_params(cfg, seed=0, device="cuda")
        params = steps.shard_tree(full, psh)
        opt = steps.shard_tree(adamw.init(full), osh)
        del full
        params, opt, loss = fn(params, opt, steps.shard_tree(batch, bsh))
        got = (steps.gather_tree(params, psh), steps.gather_tree(opt.m, psh),
               steps.gather_tree(opt.v, psh))
        if want is not None:
            rec[fsdp] = dict(
                loss=loss.item(), want_loss=want[0],
                **{part: _leaf_worst(g, w) for part, g, w in
                   zip(("params", "m", "v"), got, want[1:])})
        if not fsdp:          # (c) the elastic checkpoint
            t0 = time.perf_counter()
            manager.save(ckpt_dir, 1, params, shardings=psh)
            saved = got[0]
            mesh14 = make_mesh((1, 4), ("data", "model"))
            psh14 = shd.param_shardings(specs.params_struct(cfg), mesh14,
                                        fsdp=False)
            blocks, _, _ = manager.restore(ckpt_dir, saved, shardings=psh14)
            back = steps.gather_tree(blocks, psh14)
            rec["restore_1x4"] = all(torch.equal(a, b) for a, b in zip(
                tree.leaves(back), tree.leaves(saved)))
            if mesh.rank == 0:
                one, _, _ = manager.restore(ckpt_dir, saved)
                rec["restore_one"] = all(torch.equal(a, b) for a, b in zip(
                    tree.leaves(one), tree.leaves(saved)))
                del one
            rec["ckpt_s"] = time.perf_counter() - t0
            del blocks, back
        del params, opt, got
        torch.cuda.empty_cache()
    return rec


def _mesh_rank(rank, world, ckpt_dir):
    """One gloo rank of phase mesh: (a), then (b) and (c)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    out = {"transport": collectives.transport(mesh, "model", "cuda"),
           "train": _mesh_train(mesh, cfg)}
    out["train_s"] = time.perf_counter() - t0
    out["parity"] = _mesh_parity(mesh, cfg, ckpt_dir)
    out["total_s"] = time.perf_counter() - t0
    return out


def phase_mesh():
    """Phase mesh: (a) the sharded train step on full-width granite on a
    (2, 2) mesh of gloo ranks sharing the card, (b) its fp32 parity with
    one device's step, fsdp off and on, (c) a checkpoint saved from (2, 2)
    restored onto one device and onto (1, 4), (d) the dry run on 8 ranks
    and shape-only on the production meshes.  -> (the kernels line's
    mesh_train row, the streamed_moe launches of (a))."""
    import tempfile
    import torch
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.configs.shapes import SHAPE_ORDER
    from repro_torch.core import autotune
    from repro_torch.kernels import quant
    from repro_torch.launch import dryrun
    from repro_torch.parallel import localrun
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    mcfg = cfg.moe
    P, n_data = MESH_SHAPE[1], MESH_SHAPE[0]
    plan = autotune.plan_moe(MESH_B // n_data, MESH_S, cfg.d_model, mcfg,
                             cfg.activation, P, dtype_bytes=2,
                             weight_bytes=quant.weight_bytes())
    # the per-rank call of the ring at the plan's width, timed alone
    T_loc = MESH_B // n_data * MESH_S // P if plan.mode == "stream" else \
        MESH_B // n_data * MESH_S
    m = mcfg.d_expert // (P * plan.micro_slices)
    row, line = _width_case(mcfg.num_experts, mcfg.capacity_rows(T_loc),
                            cfg.d_model, m, "bf16",
                            f"mesh_train P={P} {plan.mode} micro-slices "
                            f"{plan.micro_slices}")
    log("mesh", line)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        ranks = localrun.run(_mesh_rank, math.prod(MESH_SHAPE), ckpt)
    wall = time.perf_counter() - t0
    a = [r["train"] for r in ranks]
    losses = [r["losses"] for r in a]
    med = statistics.median(s for r in a for s in r["secs"][1:])
    T = MESH_B * MESH_S
    line = (f"{ARCH} full width and depth, bf16, remat, build_train_step on "
            f"a {MESH_SHAPE} (data, model) mesh of gloo ranks on the card "
            f"({ranks[0]['transport']}), fse_dp plan {a[0]['plan']}: "
            f"{MESH_STEPS} steps of {MESH_B} x {MESH_S} tokens (lr "
            f"{MESH_LR:g}); losses {[round(v, 4) for v in losses[0]]}, "
            f"the same on every rank {all(l == losses[0] for l in losses)}; "
            f"median step {med:.3f}s over steps 2-{MESH_STEPS} = "
            f"{T / med:.0f} tok/s (gloo through host memory: no link "
            f"speed); streamed_moe launches a step by rank "
            f"{[r['launches'] for r in a]} (want {a[0]['want']}: forward + "
            f"remat recompute, {_n_moe(cfg)} MoE layers x "
            f"{_want_launches(plan, P)}); stored params + AdamW state a rank "
            f"{[round(r['stored'] / 1e9, 3) for r in a]} GB vs one device's "
            f"{a[0]['one_device'] / 1e9:.3f} GB ({a[0]['stored'] / a[0]['one_device']:.3f}); "
            f"w_up block {a[0]['w_up']} (d_expert {mcfg.d_expert} over "
            f"{P}); peak memory by rank "
            f"{[round(r['peak'] / 2**30, 2) for r in a]} GiB; the ranks' "
            f"(a) {max(r['train_s'] for r in ranks):.1f}s, all of it "
            f"{wall:.1f}s")
    finite = all(math.isfinite(v) for v in losses[0])
    if not finite or any(l != losses[0] for l in losses) or any(
            n != r["want"] for r in a for n in r["launches"]) or any(
            r["w_up"][-1] != mcfg.d_expert // P for r in a):
        fail("mesh", line)
    log("mesh", line)
    b = ranks[0]["parity"]
    for fsdp in (False, True):
        c = b[fsdp]
        rel = abs(c["loss"] - c["want_loss"]) / abs(c["want_loss"])
        line = (f"fp32 {MESH_GRAD_LAYERS} layers, one step on {MESH_SHAPE}, "
                f"fsdp {'on' if fsdp else 'off'}, vs one device's step: loss "
                f"{c['loss']:.6f} vs {c['want_loss']:.6f} (rel {rel:.3e}, "
                f"tol {MESH_LOSS_TOL:g}); worst leaf of params "
                f"{c['params'][0]} {c['params'][1]:.3e}, m {c['m'][0]} "
                f"{c['m'][1]:.3e}, v {c['v'][0]} {c['v'][1]:.3e} of its max "
                f"(tol {MESH_LEAF_TOL:g}); the one-device run's least top-k "
                f"margin {b['margin']:.3e}")
        if rel > MESH_LOSS_TOL or max(c[p][1] for p in ("params", "m", "v")) \
                > MESH_LEAF_TOL:
            fail("mesh", line)
        log("mesh", line)
    ok = all(r["parity"]["restore_1x4"] for r in ranks) and \
        b["restore_one"]
    line = (f"checkpoint saved from {MESH_SHAPE}, restored onto (1, 4) and "
            f"onto one device: bit for bit {ok} "
            f"({max(r['parity']['ckpt_s'] for r in ranks):.1f}s)")
    if not ok:
        fail("mesh", line)
    log("mesh", line)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        recs = dryrun.run_on_ranks([(x, s) for x in DRY_ARCHS
                                    for s in dryrun.SMALL_ORDER], DRY_MESH,
                                   device="cuda", out_dir=out, verbose=False)
        for r in recs:
            line = (f"dry run {r['arch']} {r['kind']} on {DRY_MESH} ranks: "
                    f"{r['status']}" + (
                        f", step {r['step_s']:.2f}s, args "
                        f"{r['per_device_bytes']} B, peak "
                        f"{r['peak_bytes']} B, flops "
                        f"{r['cost_flops_per_device']:.3e}, collectives "
                        f"{r['collectives_per_device']['total']:.3e} B a rank"
                        if r["status"] == "ok" else f": {r.get('error')}"))
            if r["status"] != "ok":
                fail("mesh", line)
            log("mesh", line)
        n_ranks = time.perf_counter() - t0
        shape_only = [dryrun.run_cell(x, s, multi_pod=mp, out_dir=out,
                                      verbose=False)
                      for x in ASSIGNED_ARCHS for s in SHAPE_ORDER
                      for mp in (False, True)]
    bad = [(r["arch"], r["shape"], r["mesh"]) for r in shape_only
           if r["status"] == "error"]
    big = {r["mesh"]: r["per_device_bytes"] for r in shape_only
           if r["arch"] == "nemotron-4-340b" and r["shape"] == "train_4k"}
    line = (f"dry run: 15 cells ok on {DRY_MESH} ranks in {n_ranks:.1f}s; "
            f"shape-only {len(shape_only)} cells on pod16x16 / pod2x16x16: "
            f"{sum(r['status'] == 'ok' for r in shape_only)} ok, "
            f"{sum(r['status'] == 'skip' for r in shape_only)} skip, "
            f"errors {bad}; nemotron-4-340b train_4k arguments a rank "
            f"{big} B; phase mesh {time.perf_counter() - t_phase:.1f}s")
    if bad:
        fail("mesh", line)
    log("mesh", line)
    return row, sum(sum(r["launches"]) for r in a)


EXAMPLES = os.path.join(HERE, "examples")
EXAMPLE_RANKS = 2
EXAMPLE_STEPS = 30
EXAMPLE_STEP1_TOL = 2e-5        # fp32 streamed_moe, of max |whole expert|
EXAMPLE_BUDGET_S = 60


def _example(name):
    """An ``examples/*_torch.py`` module, imported by name (its gloo ranks
    import it the same way)."""
    import importlib
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def phase_examples():
    """Phase examples: the port's four examples (``examples/*_torch.py``)
    in this process on the card, as a user runs them: the quickstart at 2
    gloo ranks (step 1's micro-slice sum through the kernel held at 2e-5
    of the whole expert, step 2's strategies within 2e-4 of the dense
    oracle), the serve example (identical outputs with and without token
    buffering), the training example at 30 steps (the last logged loss
    below the first) and the simulator example; the streamed_moe launches
    of these runs (the wrapper's and the serve engines' graph replays; the
    quickstart ranks' are their own processes'), then the kernel at the
    training example's shape against its plain version and timed.  ->
    (the kernels line's row, launches)."""
    import tempfile
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamed_moe as sm
    t_phase = time.perf_counter()
    sm.LAUNCHES = 0
    secs = {}
    t0 = time.perf_counter()
    qs = _example("quickstart_torch").main(
        ["--ranks", str(EXAMPLE_RANKS)])
    secs["quickstart"] = time.perf_counter() - t0
    line = (f"quickstart at {EXAMPLE_RANKS} gloo ranks: step 1 micro-slice "
            f"sum vs whole expert rel {qs['step1_rel']:.3e} (tol "
            f"{EXAMPLE_STEP1_TOL:g}), on {qs['parts'].device}; step 2 worst "
            f"vs the dense oracle {max(qs['step2'].values()):.3e} over "
            f"{sorted(qs['step2'])}; {secs['quickstart']:.1f}s")
    if qs["step1_rel"] > EXAMPLE_STEP1_TOL or not qs["parts"].is_cuda:
        fail("examples", line)
    log("examples", line)
    t0 = time.perf_counter()
    sv = _example("serve_low_batch_torch").main([])
    secs["serve"] = time.perf_counter() - t0
    outs0, outs1 = sv["outputs"]
    graph = sum(e.graph_launches() for e in sv["engines"])
    line = (f"serve: outputs identical {outs0 == outs1} ({len(outs0)} "
            f"requests x {len(outs0[0])} tokens), loads saved "
            f"{sv['engines'][1].stats['expert_loads_saved']}, "
            f"{graph} launches replayed in graphs; {secs['serve']:.1f}s")
    if outs0 != outs1:
        fail("examples", line)
    log("examples", line)
    t0 = time.perf_counter()
    tr = _example("train_moe_100m_torch")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res = tr.main(["--steps", str(EXAMPLE_STEPS), "--ckpt-dir",
                       ckpt_dir])
    secs["train"] = time.perf_counter() - t0
    first, last = res.losses[0][1], res.losses[-1][1]
    line = (f"train: {res.final_step} steps, logged loss {first:.4f} -> "
            f"{last:.4f}; {secs['train']:.1f}s")
    if not (last < first and all(math.isfinite(v) for _, v in res.losses)):
        fail("examples", line)
    log("examples", line)
    t0 = time.perf_counter()
    sim = _example("expert_streaming_sim_torch").main([])
    secs["sim"] = time.perf_counter() - t0
    log("examples", f"sim: speedup over EP {min(sim['speedups']):.2f}x .. "
                    f"{max(sim['speedups']):.2f}x; {secs['sim']:.1f}s")
    torch.cuda.synchronize()
    launches = sm.LAUNCHES + graph
    total = time.perf_counter() - t_phase
    line = (f"four examples in {total:.1f}s (budget {EXAMPLE_BUDGET_S} s): "
            + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
            + f"; streamed_moe launches {launches}")
    if launches == 0 or "jax" in sys.modules:
        fail("examples", line)
    log("examples", line)
    # the kernel at the training example's forward shape (fp32, its
    # default 8 x 128 tokens a step)
    cfg = tr.build_100m_config()
    E, d, m = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    C = cfg.moe.capacity_rows(8 * 128)
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, "swiglu", torch.float32)
    tiles = _planned(E, C, d, m, "swiglu", "fp32", "fp32")
    got = sm.streamed_moe_kernel(xe, wg, wu, wd, activation="swiglu",
                                 tiles=tiles)
    plain = ref.streamed_moe_plain(xe, wg, wu, wd, "swiglu")
    err = (got - plain).abs().max().item()
    times, text = kernel_times(lambda: sm.streamed_moe_kernel(
        xe, wg, wu, wd, activation="swiglu", tiles=tiles))
    plain_ms = median_ms(lambda: ref.streamed_moe_plain(xe, wg, wu, wd,
                                                        "swiglu"))
    bound, by = streamed_moe_bound_ms(E, C, d, m, "fp32", 4, split=True)
    bound_fp32, _ = streamed_moe_bound_ms(E, C, d, m, "fp32", 4)
    line = (f"streamed_moe E={E} C={C} d={d} m={m} fp32 (the training "
            f"example's forward), tiles {tiles}: max_abs_err vs plain "
            f"{err:.3e} (rel {rel_err(got, plain):.3e}, tol {PLAIN_TOL:g}); "
            f"{text}, plain {plain_ms:.4f} ms, split-TF32 bound "
            f"{bound * 1e3:.1f} us ({by}), fp32-FMA bound "
            f"{bound_fp32 * 1e3:.1f} us")
    if rel_err(got, plain) > PLAIN_TOL:
        fail("examples", line)
    log("examples", line)
    row = dict(max_abs_err=err, **times, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=None, tiles=tiles,
               bound_fp32_ms=bound_fp32)
    return row, launches


SOURCES = {"streamed_moe": "src/repro/kernels/streamed_moe.py:201",
           "flash_attention": "src/repro/kernels/flash_attention.py:81",
           "ssd": "src/repro/kernels/ssd.py:51",
           # no Pallas kernel: XLA's one-hot dispatch and combine einsums
           "moe_dispatch": "src/repro/models/moe.py:151"}


ONLY = {"mesh": lambda: phase_mesh(), "nemotron": lambda: phase_nemotron(),
        "examples": lambda: phase_examples(),
        "dispatch": lambda: phase_dispatch(),
        "forward": lambda: phase_forward(),
        "deepseek": lambda: phase_deepseek()}


def main():
    if sys.argv[1:2] == ["--only"]:
        # development: the environment, the build and the named phases
        # (comma-separated), without the summary lines
        phase_env()
        phase_build()
        for name in sys.argv[2].split(","):
            ONLY[name]()
        print("only: done", flush=True)
        return
    try:
        card = phase_env()
        import tempfile
        import torch
        # the measured level's cache: never the checkout's
        autotune_cache = tempfile.TemporaryDirectory()
        os.environ["REPRO_AUTOTUNE_CACHE"] = autotune_cache.name
        phase_build()
        rows = phase_kernels()
        sorted_row, rows["moe_dispatch"] = phase_dispatch()
        rows["streamed_moe"].update(serve_sorted=sorted_row,
                                    serve_prefix=sorted_row)
        phase_tiles()
        moe_rows, ssd_rows = phase_ssm_kernels()
        rows["streamed_moe"].update(moe_rows)
        rows["ssd"].update(ssd_rows)
        moe_rows, flash_rows = phase_family_kernels()
        rows["streamed_moe"].update(moe_rows)
        rows["flash_attention"].update(flash_rows)
        rows["streamed_moe"].update(phase_tiers())
        rows["streamed_moe"].update(phase_ring_widths())
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
        launches["streamed_moe", "serve_fp32"] = phase_parity()
        launches["streamed_moe", "serve_fp8"] = phase_features()
        forward, forward32 = phase_forward()
        for k, n in forward.items():
            launches[k, "forward"] = n
        for k, n in forward32.items():
            launches[k, "forward_fp32"] = n
        launches["ssd", "mamba"] = phase_mamba()
        launches["ssd", "serve_prefill"] = phase_mamba_serve()
        (launches["streamed_moe", "serve_jamba"],
         launches["ssd", "serve_prefill_jamba"]) = phase_jamba()
        (launches["streamed_moe", "serve_deepseek"],
         launches["moe_dispatch", "serve_deepseek"]) = phase_deepseek()
        launches["streamed_moe", "serve_qwen3"] = phase_qwen3()
        (launches["flash_attention", "forward_internvl2"],
         launches["flash_attention", "forward_internvl2_fp32"]) = \
            phase_internvl2()
        phase_whisper()
        phase_profile({path: eng for path, (eng, _, _) in traffic.items()})
        del traffic
        # after the traffic engines are gone: the most room on the card
        (launches["flash_attention", "forward_nemotron"],
         launches["flash_attention", "forward_nemotron_fp32"]) = \
            phase_nemotron()
        # after phase 11: with these phases before it, one run stamped a
        # device record of its last profile 547 ms after the device went
        # idle, past the window's 0.5 s (PROFILE_PAD_S)
        rows["streamed_moe"]["dist1_loss"], \
            launches["streamed_moe", "dist1_loss"] = phase_dist1()
        for path, n in phase_dist2().items():
            launches["streamed_moe", path] = n
        # the training path's forward runs the scoring forward's C = 1280
        # shape: its row's times and bound
        rows["streamed_moe"]["train"] = dict(rows["streamed_moe"]["forward"])
        launches["streamed_moe", "train"] = phase_train()
        rows["streamed_moe"]["mesh_train"], \
            launches["streamed_moe", "mesh_train"] = phase_mesh()
        rows["streamed_moe"]["examples"], \
            launches["streamed_moe", "examples"] = phase_examples()
        if "jax" in sys.modules:
            fail("summary", "jax was imported")
        log("summary", f"every phase passed in "
                       f"{time.perf_counter() - _T0:.1f}s")
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
