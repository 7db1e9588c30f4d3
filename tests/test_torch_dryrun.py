"""The port's dry run and step analysis (``launch.dryrun``,
``launch.analysis``).

* On 8 gloo ranks, a (2, 4) ("data", "model") mesh: the five archs of the
  reference's ``tests/distributed_scripts/dryrun_small.py``, reduced, MoE
  at ``fse_dp``, x train / prefill / decode at (seq 64, batch 8), each
  step run once: every one of the 15 records ``ok``, with FLOPs,
  collective bytes and argument bytes on every rank (the port of
  ``tests/test_fse_dp_distributed.py::test_small_mesh_dryrun_machinery``).
* Shape-only, every assigned arch x shape on ``pod16x16`` and
  ``pod2x16x16``: no ``error``; each ok record's ``per_device_bytes`` is
  one rank's share of the cell's global arguments.
* ``roofline_terms`` and ``model_flops`` equal the reference's for every
  config x shape, given the reference's constants.
* ``collective_bytes()`` equals the bytes the collectives delivered, on
  2 ranks in a case whose sizes are known.
"""
import json
import os
import tempfile

import pytest

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import analysis as janalysis
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_configs
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES
from repro_torch.launch import analysis, dryrun

SMALL_ARCHS = ["granite-moe-1b-a400m", "jamba-v0.1-52b", "mamba2-370m",
               "whisper-base", "internvl2-2b"]


@pytest.fixture(scope="module")
def on_ranks():
    with tempfile.TemporaryDirectory() as out:
        recs = dryrun.run_on_ranks(
            [(a, s) for a in SMALL_ARCHS for s in dryrun.SMALL_ORDER],
            (2, 4), device="cpu", out_dir=out, verbose=False)
        files = sorted(os.listdir(out))
    return recs, files


def test_small_mesh_dryrun_machinery(on_ranks):
    recs, files = on_ranks
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) >= 15, [(r["arch"], r["shape"], r.get("error"))
                           for r in recs if r["status"] != "ok"]
    assert len(files) == 15 and all(f.endswith("__ranks2x4.json")
                                    for f in files)


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_small_mesh_records(on_ranks, arch):
    recs, _ = on_ranks
    for r in (r for r in recs if r["arch"] == arch):
        assert r["status"] == "ok" and r["chips"] == 8
        assert len(r["ranks"]) == 8
        for rank in r["ranks"]:
            assert rank["step_s"] > 0 and rank["flops"] > 0
            assert rank["argument_bytes"] > 0 and rank["peak_bytes"] > 0
            coll = rank["collectives"]
            assert coll["count"] > 0 and coll["total"] == sum(
                coll[c] for c in analysis.collectives.CATEGORIES)
            assert rank["roofline"]["dominant"] in ("compute", "memory",
                                                    "collective")


@pytest.fixture(scope="module")
def shape_only():
    with tempfile.TemporaryDirectory() as out:
        recs = [dryrun.run_cell(a, s, multi_pod=mp, out_dir=out,
                                verbose=False)
                for a in ASSIGNED_ARCHS for s in SHAPE_ORDER
                for mp in (False, True)]
        on_disk = {f: json.load(open(os.path.join(out, f)))
                   for f in os.listdir(out)}
    return recs, on_disk


def test_shape_only_production_dryrun(shape_only):
    recs, on_disk = shape_only
    assert len(on_disk) == len(recs) == len(ASSIGNED_ARCHS) * 4 * 2
    assert not [r for r in recs if r["status"] == "error"]
    for r in recs:
        assert r["status"] in ("ok", "skip")
        if r["status"] == "ok":
            assert r["per_device_bytes"] > 0 and r["roofline"] is None
            assert r["chips"] == (512 if r["mesh"] == "pod2x16x16" else 256)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "nemotron-4-340b"])
def test_shape_only_bytes_are_a_share(shape_only, arch):
    """A rank's arguments lie between an even share of the step's global
    arguments and the whole of them."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step
    recs, _ = shape_only
    cfg = get_config(arch)
    for r in (r for r in recs if r["arch"] == arch and r["status"] == "ok"):
        mesh = make_production_mesh(multi_pod=r["mesh"] == "pod2x16x16",
                                    shape_only=True)
        structs = build_step(cfg, SHAPES[r["shape"]], mesh)[3]
        glob = sum(t.numel() * t.element_size()
                   for t in tree.leaves(structs))
        assert glob / r["chips"] <= r["per_device_bytes"] < glob


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_and_roofline_equal_the_references(arch, monkeypatch):
    monkeypatch.setattr(analysis, "PEAK_FLOPS", janalysis.PEAK_FLOPS)
    monkeypatch.setattr(analysis, "HBM_BW", janalysis.HBM_BW)
    monkeypatch.setattr(analysis, "LINK_BW", janalysis.ICI_BW)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPE_ORDER:
        mf = analysis.model_flops(cfg, SHAPES[name])
        assert mf == janalysis.model_flops(jcfg, JSHAPES[name])
        for chips in (256, 512):
            args = (mf, mf / 3.0, mf / 50.0, chips)
            assert analysis.roofline_terms(*args) == \
                janalysis.roofline_terms(*args)


def _rank_bytes(rank, world):
    import torch
    from repro_torch.parallel import collectives, meshctx
    mesh = meshctx.ProcessMesh.create((2,), ("model",))
    collectives.reset_counters()
    x = torch.ones((3, 5), requires_grad=True)             # 60 bytes
    y = collectives.all_gather(x, mesh, "model", dim=0)    # 120 bytes out
    torch.autograd.grad(y.sum(), x)                        # 60 back
    collectives.psum(torch.ones(7), mesh, "model")         # 28
    collectives.all_to_all(torch.ones(4, 2), mesh, "model")  # 32
    collectives.ring_shift([torch.ones(6), torch.ones(2, 2, dtype=torch.float64)],
                           mesh, "model").wait()           # 24 + 32
    from repro_torch.launch import analysis as an
    return an.collective_bytes()


def test_collective_bytes_counts_what_moved():
    from repro_torch.parallel import localrun
    for got in localrun.run(_rank_bytes, 2):
        assert got == {"all-gather": 120.0, "all-reduce": 28.0,
                       "reduce-scatter": 60.0, "all-to-all": 32.0,
                       "collective-permute": 56.0, "count": 5,
                       "total": 296.0}
