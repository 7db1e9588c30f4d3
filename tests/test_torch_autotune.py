"""The Hopper tile planner (``repro_torch.core.autotune``) against the JAX
package's ``core.autotune``, on the CPU.

* the autotune level: ``use_autotune`` refuses an unknown level with the
  reference's message, ``autotune_level`` honours ``REPRO_AUTOTUNE`` and
  the context, ``kernel_opts_for`` is ``{}`` at ``off``, and
  ``ExecutionSpec(autotune=...).scope()`` enters the level, in both;
* ``ops.streamed_moe_autotuned`` equals the reference's under every level,
  in fp32, bf16, int8 and fp8 weights, swiglu and relu2, at the
  reference's tolerances (the port's CPU path is the plain version, which
  has no tiles; the reference runs its Pallas kernel in interpret mode with
  its planner's tiles);
* the planner with ``CardProfile.h100_sxm()``: its candidates fit shared
  memory and registers, the default wins a tie, a small shared-memory
  limit shrinks the pick, and its picks at the serving shapes are
  settings of ``TILE_SETTINGS``;
* ``TILE_SETTINGS`` is the table in ``csrc/streamed_moe.cu``;
* the wrapper refuses an unknown setting on the CPU and gives the plain
  result for a known one;
* the measured cache (timing monkeypatched): the port's own file name, a
  second lookup returns the same entry, another kernel source is another
  key, and nothing is timed inside a graph capture;
* the engine serves the reference's tokens under every level, and
  ``serve --autotune off --dry-run`` runs.

The kernel's settings, timed and held bit for bit against each other, run
only on the card (``chip_smoke.py`` phase 3c).
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core import autotune as jat
from repro.core.strategy import ExecutionSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core import autotune as at
from repro_torch.core.strategy import ExecutionSpec
from repro_torch.kernels import ops, quant
from repro_torch.kernels import streamed_moe as sm
from repro_torch.serving import Engine, ServeConfig

REPO = Path(__file__).resolve().parent.parent
ARCH = "granite-moe-1b-a400m"
LEVELS = ("off", "analytic", "measured")
# the reference's kernel tolerances (tests/test_quantization.py KERNEL_TOL;
# bf16 as tests/test_kernels.py)
TOL = {"fp32": 2e-5, "bf16": 3e-2, "int8": 2e-5, "fp8": 2e-5}
H100 = at.CardProfile.h100_sxm()
SERVING = ((32, 64, 1024, 512), (32, 1024, 1024, 512), (32, 1280, 1024, 512))


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    """Both packages' measured caches empty and pointed at ``tmp_path``."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setattr(jat, "_MEASURED", {})
    monkeypatch.setattr(jat, "_CACHE_LOADED", False)
    monkeypatch.setattr(at, "_MEASURED", {})
    monkeypatch.setattr(at, "_CACHE_LOADED", False)
    jat._kernel_opts_cached.cache_clear()
    at._kernel_opts_cached.cache_clear()
    yield tmp_path
    jat._kernel_opts_cached.cache_clear()
    at._kernel_opts_cached.cache_clear()


# ---------------------------------------------------------------------------
# the level
# ---------------------------------------------------------------------------


def test_use_autotune_rejects_unknown_level_as_reference():
    with pytest.raises(ValueError) as want:
        with jat.use_autotune("fast"):
            pass
    with pytest.raises(ValueError) as got:
        with at.use_autotune("fast"):
            pass
    assert str(got.value) == str(want.value)


def test_level_follows_context_as_reference():
    base = (at.autotune_level(), jat.autotune_level())
    assert base[0] == base[1]
    for level in LEVELS:
        with at.use_autotune(level), jat.use_autotune(level):
            assert at.autotune_level() == jat.autotune_level() == level
            with at.use_autotune("off"), jat.use_autotune("off"):
                assert at.autotune_level() == jat.autotune_level() == "off"
            assert at.autotune_level() == level
    assert (at.autotune_level(), jat.autotune_level()) == base


@pytest.mark.parametrize("env", ["off", "measured"])
def test_level_default_honours_env_as_reference(env):
    code = ("from repro_torch.core import autotune as a; "
            "from repro.core import autotune as j; "
            "print(a.autotune_level(), j.autotune_level())")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env=dict(os.environ, REPRO_AUTOTUNE=env, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [env, env]


def test_kernel_opts_off_is_empty_in_both():
    assert at.kernel_opts_for(8, 16, 64, 32, "swiglu", level="off") == {} \
        == jat.kernel_opts_for(8, 16, 64, 32, "swiglu", level="off")
    with at.use_autotune("off"):
        assert at.kernel_opts_for(32, 1024, 1024, 512, "swiglu") == {}
    with pytest.raises(ValueError, match="unknown autotune level"):
        at.kernel_opts_for(8, 16, 64, 32, "swiglu", level="fast")


@pytest.mark.parametrize("level", LEVELS)
def test_spec_scope_enters_level_as_reference(level):
    other = "off" if level != "off" else "analytic"
    with at.use_autotune(other), jat.use_autotune(other):
        with ExecutionSpec(strategy="capacity", autotune=level).scope(), \
                JSpec(strategy="capacity", autotune=level).scope():
            assert at.autotune_level() == jat.autotune_level() == level
        with ExecutionSpec(strategy="capacity").scope(), \
                JSpec(strategy="capacity").scope():
            assert at.autotune_level() == jat.autotune_level() == other


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------


def _moe_inputs(E=2, C=5, d=16, m=8, seed=0):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, d, m)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((E, m, d)).astype(np.float32) * 0.3
    return xe, wg, wu, wd


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
@pytest.mark.parametrize("wdt", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("level", LEVELS)
def test_autotuned_matches_reference(fresh_caches, level, wdt, act):
    xe, wg, wu, wd = _moe_inputs()
    wg = wg if act == "swiglu" else None
    with jat.use_autotune(level), jquant.use_weight_dtype(wdt), \
            jops.use_kernels(True):
        want = np.asarray(jops.streamed_moe_autotuned(
            jnp.asarray(xe), None if wg is None else jnp.asarray(wg),
            jnp.asarray(wu), jnp.asarray(wd), act))
    t = [None if a is None else torch.from_numpy(a) for a in (xe, wg, wu, wd)]
    before = sm.LAUNCHES
    with at.use_autotune(level), quant.use_weight_dtype(wdt):
        got = ops.streamed_moe_autotuned(*t, act)
    assert sm.LAUNCHES == before            # CPU tensors: the plain version
    assert not at._MEASURED                 # ... which plans no tiles
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[wdt],
                               atol=TOL[wdt])


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wdt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", SERVING)
def test_planner_candidates_fit_and_pick_a_setting(shape, wdt):
    E, C, d, m = shape
    plan = at.plan_kernel_tiles(E, C, d, m, "swiglu", H100, "bf16", wdt)
    path = "bf16" if wdt == "bf16" else "8bit"
    assert plan["tiles"] in sm.TILE_SETTINGS[path]
    assert plan["default"] == sm.DEFAULT_TILES(C, quant_dtype(wdt))
    assert plan["fits"]
    for name, t in plan["ranked"]:
        cost = at.tile_cost(E, C, d, m, "swiglu", name, H100, "bf16", wdt)
        assert cost["t"] == t
        assert cost["fits"]
        for phase in cost["phases"]:
            assert phase["smem"] <= H100.smem_block
            assert phase["regs"] <= H100.regs_thread
            assert phase["blocks_per_sm"] >= 1
    assert plan["predicted_s"] <= plan["default_s"]


def quant_dtype(wdt):
    return {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[wdt]


def test_planner_drops_settings_that_cannot_fit():
    """A gated 64 x 64 warp tile would keep 256 fp32 accumulators a
    thread: more than 255 registers, so such a setting never fits."""
    est = at._estimated_regs(2 * 64 * 64 // 32, 1)
    assert est > H100.regs_thread
    assert at.blocks_per_sm(H100, 256, 240 * 1024, 128) == 0


# (setting, threads, shared bytes up / down, accumulators a thread up /
# down) of the wgmma path: consumer warpgroups of 64 rows and a producer
# warp; a stage holds the activation tile and the weight tiles, 128-byte
# swizzled, no padding, with its two 8-byte barriers; swiglu keeps two
# accumulators of BN / 2 a thread
WG_PHASES = (("wg:1x64:k64s4", 160, 4 * (8192 + 2 * 8192 + 16) + 1024,
              4 * (8192 + 8192 + 16) + 1024, 64, 32),
             ("wg:2x128:k64s4", 288, 4 * (16384 + 2 * 16384 + 16) + 1024,
              4 * (16384 + 16384 + 16) + 1024, 128, 64))


@pytest.mark.parametrize("name,threads,smem_up,smem_down,acc_up,acc_down",
                         WG_PHASES)
def test_wgmma_phases(name, threads, smem_up, smem_down, acc_up, acc_down):
    wgs, bn, bk, _ = sm.TILE_SETTINGS["bf16"][name]
    up, down = at._phases("bf16", (wgs, bn, bk, _), True, "bf16")
    assert up == (64 * wgs, bn, bk, threads, smem_up, acc_up, 1)
    assert down == (64 * wgs, bn, bk, threads, smem_down, acc_down, 1)
    cost = at.tile_cost(32, 1024, 1024, 512, "swiglu", name, H100)
    for phase, acc, smem in zip(cost["phases"], (acc_up, acc_down),
                                (smem_up, smem_down)):
        # wgmma reads A from shared memory: no A fragments in registers
        assert phase["regs"] == at._estimated_regs(acc, 0) == acc + 40
        assert phase["threads"] == threads and phase["smem"] == smem
        assert phase["blocks_per_sm"] == at.blocks_per_sm(
            H100, threads, smem, acc + 40) >= 1


# (setting, C, x dtype, threads up / down, shared bytes up / down,
# accumulators a thread up / down) of the 8-bit path: consumer warpgroups
# of 64 weight columns and no producer warp; a stage holds the activation
# planes' tiles (the C tile's rows, 128-byte swizzled) and the raw 8-bit
# weight tiles, with its two 8-byte barriers; each thread keeps a partial
# and a promoted sum of C_tile / 2 a weight matrix.  C = 64 takes a tile of
# 64, C = 16 one of 16, fp32 x (three planes) one of 32
Q_PHASES = (("8bit:up2x128k128s3:dn4x256k128s2", 64, "bf16", 256, 512,
             3 * (128 * 64 * 2 + 2 * 128 * 128 + 16) + 1024,
             2 * (3 * 128 * 64 * 2 + 128 * 256 + 16) + 1024, 128, 64),
            ("8bit:up1x64k64s6:dn2x128k64s3", 16, "bf16", 128, 256,
             6 * (64 * 16 * 2 + 2 * 64 * 64 + 16) + 1024,
             3 * (3 * 64 * 16 * 2 + 64 * 128 + 16) + 1024, 32, 16),
            ("8bit:up2x128k128s3:dn4x256k128s2", 37, "fp32", 256, 512,
             3 * (3 * 128 * 32 * 2 + 2 * 128 * 128 + 16) + 1024,
             2 * (3 * 128 * 32 * 2 + 128 * 256 + 16) + 1024, 64, 32))


@pytest.mark.parametrize("name,C,x,threads_up,threads_down,smem_up,"
                         "smem_down,acc_up,acc_down", Q_PHASES)
def test_8bit_wgmma_phases(name, C, x, threads_up, threads_down, smem_up,
                           smem_down, acc_up, acc_down):
    row = sm.TILE_SETTINGS["8bit"][name]
    up, down = at._phases("8bit", row, True, x, C)
    tile = sm.q_c_tile(C, torch.float32 if x == "fp32" else torch.bfloat16)
    parts = 3 if x == "fp32" else 1
    assert up == (tile, 64 * row[0][0], row[0][1], threads_up, smem_up,
                  acc_up, parts)
    assert down == (tile, 64 * row[1][0], row[1][1], threads_down,
                    smem_down, acc_down, 3)
    cost = at.tile_cost(32, C, 1024, 512, "swiglu", name, H100, x, "int8")
    for phase, acc, smem, threads, n_w in zip(
            cost["phases"], (acc_up, acc_down), (smem_up, smem_down),
            (threads_up, threads_down), (2, 1)):
        # two buffers of a weight matrix's A fragment (4 registers each)
        assert phase["regs"] == at._estimated_regs(acc, 8 * n_w) \
            == acc + 8 * n_w + 40 <= H100.regs_thread
        assert phase["threads"] == threads and phase["smem"] == smem
        assert phase["smem"] <= H100.smem_block
        assert phase["blocks_per_sm"] == at.blocks_per_sm(
            H100, threads, smem, acc + 8 * n_w + 40) >= 1


# (setting, C, x dtype, weights, then per phase (up, down) what _phases
# gives, (rows a block, columns a block, k-rows a stage, threads, shared
# bytes, accumulators a thread, terms), and the A-fragment registers) of
# the split-TF32 path: as the 8-bit path, consumer warpgroups of 64 weight
# columns and a block's rows the C tile (C rounded up to 16, at most 64,
# for any x); a stage holds the activation planes' fp32 tiles (two for
# fp32, one for an operand exact in TF32) and the weight tiles in their
# own type; a product takes one TF32 term per activation plane and one
# more for fp32 weights' lo part.  With bf16 weights (fp32 x) phase 1 is
# the CUDA-core tile: 64 x 64, 256 threads, 32 k-rows a step in two fp32
# buffers, 16 sums and 16 fragment registers a thread a weight matrix.
T_PHASES = (("tf32:up2x128k64s2:dn4x256k64s2", 64, "fp32", "fp32",
             (64, 128, 64, 256, 2 * (2 * 64 * 64 * 4 + 2 * 64 * 128 * 4 + 16)
              + 1024, 128, 3, 32),
             (64, 256, 64, 512, 2 * (2 * 64 * 64 * 4 + 64 * 256 * 4 + 16)
              + 1024, 64, 3, 16)),
            ("tf32:up2x128k64s2:dn2x128k64s3", 37, "fp32", "bf16",
             (64, 64, 32, 256, 4 * (2 * 32 * 68 + 2 * 2 * 32 * 64), 32, 1, 16),
             (48, 128, 64, 256, 3 * (64 * 48 * 4 + 64 * 128 * 2 + 16) + 1024,
              48, 1, 8)),
            ("tf32:up2x128k64s2:dn4x256k64s2", 16, "bf16", "fp32",
             (16, 128, 64, 256, 2 * (64 * 16 * 4 + 2 * 64 * 128 * 4 + 16)
              + 1024, 32, 2, 32),
             (16, 256, 64, 512, 2 * (2 * 64 * 16 * 4 + 64 * 256 * 4 + 16)
              + 1024, 16, 3, 16)))


@pytest.mark.parametrize("name,C,x,wdt,up,down", T_PHASES)
def test_tf32_wgmma_phases(name, C, x, wdt, up, down):
    row = sm.TILE_SETTINGS["tf32"][name]
    assert at._phases("tf32", row, True, x, C, wdt) == [up[:7], down[:7]]
    cost = at.tile_cost(32, C, 1024, 512, "swiglu", name, H100, x, wdt)
    for phase, (_, _, _, threads, smem, acc, _, frag) in zip(cost["phases"],
                                                             (up, down)):
        assert phase["regs"] == at._estimated_regs(acc, frag) \
            == acc + frag + 40 <= H100.regs_thread
        assert phase["threads"] == threads and phase["smem"] == smem
        assert phase["smem"] <= H100.smem_block
        assert phase["blocks_per_sm"] == at.blocks_per_sm(
            H100, threads, smem, acc + frag + 40) >= 1


@pytest.mark.parametrize("x,wdt", [("fp32", "fp32"), ("bf16", "fp32"),
                                   ("fp32", "bf16")])
@pytest.mark.parametrize("C", [16, 64, 1280])
def test_planner_picks_a_tf32_setting(C, x, wdt):
    """fp32 weights, or fp32 x with bf16 weights: the planner scores the
    split-TF32 table (priced at half the bf16 wgmma rate, three terms of
    fp32 operands; phase 1 of bf16 weights at the CUDA cores' rate) and
    picks a row of it that fits."""
    plan = at.plan_kernel_tiles(32, C, 1024, 512, "swiglu", H100, x, wdt)
    assert plan["tiles"] in sm.TILE_SETTINGS["tf32"]
    assert plan["default"] == list(sm.TILE_SETTINGS["tf32"])[0]
    assert plan["fits"] and plan["predicted_s"] <= plan["default_s"]
    for name, t in plan["ranked"]:
        assert at.tile_cost(32, C, 1024, 512, "swiglu", name, H100, x,
                            wdt)["fits"]
    # bf16 weights with fp32 x: phase 1 priced at the CUDA cores' fp32
    # rate, the same for every row
    if wdt == "bf16":
        ups = {at.tile_cost(32, C, 1024, 512, "swiglu", name, H100, x,
                            wdt)["phases"][0]["t"]
               for name in sm.TILE_SETTINGS["tf32"]}
        assert len(ups) == 1
        assert ups.pop() >= 2 * 2 * 32 * C * 1024 * 512 / H100.fp32_peak


@pytest.mark.parametrize("wdt", ["int8", "fp8"])
@pytest.mark.parametrize("C", [16, 64, 1024])
def test_planner_never_ranks_an_8bit_setting_over_the_shared_memory(
        monkeypatch, C, wdt):
    """Eight stages of 128 k-rows up (36 KB each at a C tile of 16, 48 KB
    at 64) cannot fit the card's 227 KB a block: such an 8-bit setting is
    scored as not fitting, is never ranked and never picked; every ranked
    one fits."""
    big = "8bit:up2x128k128s8:dn4x256k128s2"
    monkeypatch.setitem(sm.TILE_SETTINGS["8bit"], big,
                        ((2, 128, 8), (4, 128, 2)))
    cost = at.tile_cost(32, C, 1024, 512, "swiglu", big, H100, "bf16", wdt)
    assert not cost["fits"]
    assert cost["phases"][0]["smem"] > H100.smem_block
    plan = at.plan_kernel_tiles(32, C, 1024, 512, "swiglu", H100, "bf16",
                                wdt)
    assert plan["fits"] and big not in dict(plan["ranked"])
    assert plan["tiles"] != big
    for name, _ in plan["ranked"]:
        assert all(p["smem"] <= H100.smem_block for p in at.tile_cost(
            32, C, 1024, 512, "swiglu", name, H100, "bf16", wdt)["phases"])


def test_planner_drops_a_ring_over_the_shared_memory(monkeypatch):
    """Five 48 KB stages (241 KB) cannot fit the card's 227 KB a block:
    such a setting is scored as not fitting and is never a candidate."""
    big = "wg:2x128:k64s5"
    monkeypatch.setitem(sm.TILE_SETTINGS["bf16"], big, (2, 128, 64, 5))
    cost = at.tile_cost(32, 1024, 1024, 512, "swiglu", big, H100)
    assert not cost["fits"]
    assert cost["phases"][0]["smem"] > H100.smem_block
    plan = at.plan_kernel_tiles(32, 1024, 1024, 512, "swiglu", H100)
    assert plan["fits"] and big not in dict(plan["ranked"])
    assert plan["tiles"] != big


def test_planner_default_wins_ties(monkeypatch):
    def flat(E, C, d, m, activation, tiles, profile, x_dtype="bf16",
             weight_dtype="bf16"):
        return {"t": 1e-3, "fits": True, "phases": []}
    monkeypatch.setattr(at, "tile_cost", flat)
    for C in (64, 1024):
        plan = at.plan_kernel_tiles(32, C, 1024, 512, "swiglu", H100)
        assert plan["tiles"] == plan["default"] == sm.DEFAULT_TILES(
            C, torch.bfloat16)
    # within the tie band the default still wins
    def near(E, C, d, m, activation, tiles, profile, x_dtype="bf16",
             weight_dtype="bf16"):
        t = 1e-3 if tiles == sm.DEFAULT_TILES(C, torch.bfloat16) \
            else 1e-3 * (1 - at.TIE / 2)
        return {"t": t, "fits": True, "phases": []}
    monkeypatch.setattr(at, "tile_cost", near)
    plan = at.plan_kernel_tiles(32, 1024, 1024, 512, "swiglu", H100)
    assert plan["tiles"] == plan["default"]
    assert plan["ranked"][0][0] != plan["default"]


def test_planner_shrinks_under_small_shared_memory():
    """The counterpart of the reference's tiny-VMEM test: with 60 KB a
    block, the default's four 48 KB stages no longer fit at C = 1024."""
    import dataclasses
    small = dataclasses.replace(H100, smem_block=60 * 1024)
    big = at.plan_kernel_tiles(32, 1024, 1024, 512, "swiglu", H100)
    tight = at.plan_kernel_tiles(32, 1024, 1024, 512, "swiglu", small)
    smem = {p: max(ph["smem"] for ph in at.tile_cost(
        32, 1024, 1024, 512, "swiglu", plan["tiles"], p)["phases"])
        for p, plan in ((H100, big), (small, tight))}
    assert not at.tile_cost(32, 1024, 1024, 512, "swiglu", big["default"],
                            small)["fits"]
    assert tight["fits"] and tight["tiles"] != big["default"]
    assert smem[small] <= small.smem_block < smem[H100]


def test_unknown_card_raises(monkeypatch):
    class Props:
        name = "NVIDIA A100-SXM4-80GB"
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    with pytest.raises(ValueError, match="known cards.*H100"):
        at.CardProfile.from_device(0)


# ---------------------------------------------------------------------------
# the table and the wrapper
# ---------------------------------------------------------------------------


def _cu_table(macro):
    src = (REPO / "src/repro_torch/kernels/csrc/streamed_moe.cu").read_text()
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", src, re.S).group(1)
    return [tuple(int(v) for v in row.split(","))
            for row in re.findall(r"X\(([\d,\s]+)\)", body)]


def test_tile_settings_mirror_the_kernel_source():
    assert _cu_table("WG_SETTINGS") == list(sm.TILE_SETTINGS["bf16"].values())
    assert _cu_table("Q_SETTINGS") == [
        up + down for up, down in sm.TILE_SETTINGS["8bit"].values()]
    assert _cu_table("T_SETTINGS") == [
        up + down for up, down in sm.TILE_SETTINGS["tf32"].values()]
    # the defaults: the rule the kernel had before it took settings
    names = list(sm.TILE_SETTINGS["bf16"])
    assert sm.TILE_SETTINGS["bf16"][sm.DEFAULT_TILES(64, torch.bfloat16)] \
        == (1, 64, 64, 4) and names.index(
            sm.DEFAULT_TILES(65, torch.bfloat16)) == 1
    # the 8-bit default: two consumer warpgroups (128 weight columns), 128
    # k-rows a stage and 3 stages up; four (256 columns) and 2 stages down
    assert sm.TILE_SETTINGS["8bit"][sm.DEFAULT_TILES(64, torch.int8)] == \
        ((2, 128, 3), (4, 128, 2))
    assert list(sm.TILE_SETTINGS["8bit"])[0] == \
        "8bit:up2x128k128s3:dn4x256k128s2"
    # split TF32: every stage one 64-k-row promotion chunk
    assert all(row[1] == 64 for up, down in sm.TILE_SETTINGS["tf32"].values()
               for row in (up, down))
    assert list(sm.TILE_SETTINGS["tf32"]).index(
        sm.DEFAULT_TILES(64, torch.float32, torch.float32)) == 0


@pytest.mark.parametrize("wdt", ["fp32", "bf16", "int8", "fp8"])
def test_wrapper_validates_tiles_on_cpu(wdt):
    xe, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs(d=32, m=16))
    x = xe.to(torch.bfloat16) if wdt != "fp32" else xe
    ws, scales = (wg, wu, wd), {}
    if wdt in quant.QUANTIZED:
        qs = [quant.quantize(w, wdt) for w in ws]
        ws = [q for q, _ in qs]
        scales = dict(zip(("s_g", "s_u", "s_d"), (s for _, s in qs)))
    else:
        ws = [quant.storage_cast(w, wdt) for w in ws]
    path = sm.tile_path(x.dtype, ws[1].dtype)
    want = sm.streamed_moe_kernel(x, *ws, activation="swiglu", **scales)
    for name in sm.TILE_SETTINGS[path]:
        got = sm.streamed_moe_kernel(x, *ws, activation="swiglu",
                                     tiles=name, **scales)
        assert torch.equal(got, want)
    other = next(n for p, t in sm.TILE_SETTINGS.items() if p != path
                 for n in t)
    for bad in ("bf16:1x1:w1x1:k1s1", other):
        with pytest.raises(ValueError, match="unknown streamed_moe tile"):
            sm.streamed_moe_kernel(x, *ws, activation="swiglu", tiles=bad,
                                   **scales)
    with pytest.raises(ValueError, match="unknown streamed_moe tile"):
        ops.streamed_moe(xe, wg, wu, wd, "swiglu", weight_dtype=wdt,
                         tiles="bf16:1x1:w1x1:k1s1")


# ---------------------------------------------------------------------------
# measured tiles
# ---------------------------------------------------------------------------


def _fake_card(monkeypatch, times=None):
    """No card here: a device key, and a timing function that records
    what it is asked to time."""
    asked = []

    def fake(E, C, d, m, activation, x_dtype, weight_dtype, tiles, reps):
        asked.append(tiles)
        return (times or {}).get(tiles, 1.0 + 0.01 * len(asked))
    monkeypatch.setattr(at, "_time_setting", fake)
    monkeypatch.setattr(at, "_device_key", lambda: "NVIDIA H100 80GB HBM3/"
                        "torch-test/cuda-test")
    return asked


def test_measured_cache_roundtrip(fresh_caches, monkeypatch):
    default = sm.DEFAULT_TILES(1024, torch.bfloat16)
    fastest = "wg:2x64:k64s3"
    asked = _fake_card(monkeypatch, {fastest: 0.5})
    plan = at.plan_kernel_tiles(32, 1024, 1024, 512, "swiglu", H100)
    before = at.TIMINGS
    entry = at.measured_kernel_tiles(32, 1024, 1024, 512, "swiglu",
                                     profile=H100)
    assert asked[0] == default and plan["tiles"] in asked
    assert len(asked) == len(set(asked)) == 5
    assert at.TIMINGS == before + 5
    assert entry["tiles"] == (fastest if fastest in asked
                              else min(entry["candidates"],
                                       key=lambda r: r["ms"])["tiles"])
    path = fresh_caches / "kernel_tiles_torch.json"
    assert at.CACHE_FILE == "kernel_tiles_torch.json" != "kernel_tiles.json"
    assert path.exists()
    disk = json.loads(path.read_text())
    assert list(disk) == [at.measured_key(32, 1024, 1024, 512, "swiglu",
                                          "bf16", "bf16")]
    # a second call is a cache hit: the same object, nothing timed
    again = at.measured_kernel_tiles(32, 1024, 1024, 512, "swiglu",
                                     profile=H100)
    assert again is entry and at.TIMINGS == before + 5
    # a fresh process (memory dropped) reads the disk and times nothing
    at.forget_measured()
    opts = at.kernel_opts_for(32, 1024, 1024, 512, "swiglu",
                              level="measured", profile=H100)
    assert opts == {"tiles": entry["tiles"]} and at.TIMINGS == before + 5
    # another kernel source is another key: timed again
    monkeypatch.setattr(at, "_kernel_hash", lambda: "0" * 12)
    at.measured_kernel_tiles(32, 1024, 1024, 512, "swiglu", profile=H100)
    assert at.TIMINGS == before + 10
    assert len(json.loads(path.read_text())) == 2


def test_measured_never_times_inside_a_capture(fresh_caches, monkeypatch):
    _fake_card(monkeypatch)
    entry = at.measured_kernel_tiles(32, 64, 1024, 512, "swiglu",
                                     profile=H100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert at.measured_kernel_tiles(32, 64, 1024, 512, "swiglu",
                                    profile=H100) is entry
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        at.measured_kernel_tiles(32, 1024, 1024, 512, "swiglu",
                                 profile=H100)


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------

PROMPTS = ([5, 9, 2, 77, 31], [100, 3, 64], [7, 7, 8, 1, 2, 3, 4])


def test_engine_tokens_under_every_level(fresh_caches):
    """On the CPU no level plans tiles, so this holds the plumbing: the
    level scoped by the spec, the fused segments keyed on the ambient
    level, and the same tokens as the reference's engine under each."""
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    outs = {}
    for level in LEVELS:
        kw = dict(max_batch=4, max_ctx=32, page_size=4, chunk_tokens=3,
                  spec={"strategy": "capacity", "autotune": level})
        with jops.use_kernels(False):
            jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
            want = [jeng.submit(list(p), max_new=8) for p in PROMPTS]
            jouts = jeng.run()
        eng = Engine(params, cfg, ServeConfig(**kw), device="cpu")
        assert eng.scfg.spec.autotune == level
        rids = [eng.submit(list(p), max_new=8) for p in PROMPTS]
        got = eng.run()
        outs[level] = [got[r] for r in rids]
        assert outs[level] == [jouts[r] for r in want]
        with at.use_autotune(level):
            assert eng.megastep() is eng._megasteps[
                (True, None, False, level)]
    assert outs["off"] == outs["analytic"] == outs["measured"]


def test_serve_cli_autotune_off_dry_run():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dry-run", "--autotune", "off"],
        env=env, timeout=300, capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", ARCH, "--autotune", "measured"])
    assert serve.build_spec(args).autotune == "measured"
    assert serve.build_spec(serve.parse_args(["--arch", ARCH])).autotune \
        is None
