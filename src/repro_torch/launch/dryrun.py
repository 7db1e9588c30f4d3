"""Dry run of every (arch x shape) cell's sharded step (port of
``repro.launch.dryrun``), in two modes, each writing one JSON record per
cell to ``artifacts/dryrun/<arch>__<shape>__<mesh>[__<tag>].json``:

**On ranks** (``--mesh 2x4``): the counterpart of the reference's lowering
on fake CPU devices.  One ``parallel.localrun`` of N gloo ranks runs each
cell's step once (``launch.steps``, under ``use_kernels(False)`` as the
reference's dry run) on random inputs from a seed, and records per rank
its status, the first step's seconds (in place of lower / compile
seconds), its argument bytes under the shardings, its peak memory (CUDA
``max_memory_allocated`` on the card, the process's peak RSS on the CPU),
its FLOPs (``analysis.step_cost``), the bytes its collectives moved and
the roofline terms (the memory term from the argument bytes: no
"bytes accessed" is counted).  ``--reduced`` runs the reduced configs,
their MoE at ``fse_dp``, on the cells of the reference's
``tests/distributed_scripts/dryrun_small.py`` (seq 64, batch 8).

**Shape-only** (no ``--mesh``): the counterpart of the lowering on the
256- and 512-chip production meshes, which no world of ranks here can
run.  On ``pod16x16`` / ``pod2x16x16`` (``meshctx.MeshShape``) it builds
the cell's step and records its status (ok, skip with ``applicable``'s
reason, error), ``per_device_bytes`` (the largest rank's arguments under
the shardings, from the meta structs), ``params``, ``active_params``,
``model_flops`` and whether those bytes fit one 80 GB card.  What only a
run knows is ``null``: ``lower_s``, ``compile_s``, ``memory``,
``cost_flops_per_device``, ``cost_bytes_per_device``,
``collectives_per_device``, ``hlo_ops``, ``roofline``,
``roofline_uncorrected``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch granite-moe-1b-a400m --reduced --mesh 2x4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs import (ASSIGNED_ARCHS, get_config, reduced_config)
from repro_torch.configs.shapes import SHAPES, SHAPE_ORDER, ShapeSpec, applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun")
# the cells of the reference's tests/distributed_scripts/dryrun_small.py
SMALL_SHAPES = {f"{k}_small": ShapeSpec(f"{k}_small", 64, 8, k)
                for k in ("train", "prefill", "decode")}
SMALL_ORDER = list(SMALL_SHAPES)
CARD_BYTES = 80 * 2 ** 30     # one H100 80 GB's memory
_NULL_FIELDS = ("lower_s", "compile_s", "memory", "cost_flops_per_device",
                "cost_bytes_per_device", "collectives_per_device", "hlo_ops",
                "roofline", "roofline_uncorrected")


def _shape(name: str) -> ShapeSpec:
    return SMALL_SHAPES[name] if name in SMALL_SHAPES else SHAPES[name]


def _config(arch: str, reduced: bool):
    """The full config, or the reduced one with its MoE at ``fse_dp`` (as
    the reference's dryrun_small.py sets it)."""
    if not reduced:
        return get_config(arch)
    cfg = reduced_config(arch)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="fse_dp"))
    return cfg


def _scan_trips(cfg) -> int:
    from repro_torch.models.transformer import period_plan
    if cfg.is_encoder_decoder:
        return cfg.num_layers
    p, _ = period_plan(cfg)
    return cfg.num_layers // p


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                                 f"{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _base(arch, shape, mesh_name, tag, reduced):
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "kind": shape.kind, "status": "skip", "reason": "", "tag": tag,
            "reduced": reduced}


# ---------------------------------------------------------------------------
# shape-only: the production meshes
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             distributed: bool = True, tag: str = "", opts: tuple = (),
             reduced: bool = False) -> dict:
    """The shape-only record of one cell on the production mesh."""
    from repro_torch.launch import analysis
    from repro_torch.parallel import sharding as shd
    cfg = _config(arch, reduced)
    shape = _shape(shape_name)
    ok, why = applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = _base(arch, shape, mesh_name, tag, reduced)
    rec["reason"] = why
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return _write(rec, out_dir)
    mesh = make_production_mesh(multi_pod=multi_pod, shape_only=True)
    rec["opts"] = list(opts)
    try:
        _, in_sh, _, structs = build_step(cfg, shape, mesh,
                                          distributed=distributed)
        per_dev = shd.block_bytes(structs, in_sh)
        rec.update({f: None for f in _NULL_FIELDS})
        rec.update({
            "status": "ok", "chips": mesh.world_size,
            "per_device_bytes": per_dev, "fits_80gb": per_dev <= CARD_BYTES,
            "model_flops": analysis.model_flops(cfg, shape),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "scan_trips": _scan_trips(cfg)})
        if verbose:
            print(f"[ok] {arch} x {shape_name} x {mesh_name}: arguments "
                  f"{per_dev / 2**30:.2f} GiB a rank (fits 80 GB: "
                  f"{rec['fits_80gb']})")
    except Exception as e:        # record failures: they are bugs to fix
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[ERROR] {arch} x {shape_name} x {mesh_name}: {e}")
    return _write(rec, out_dir)


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------


def _inputs(cfg, shape, structs, in_sh, device, seed=0):
    """This rank's blocks of random inputs for the step: parameters from
    ``api.init_params(seed)``, AdamW state from them, tokens and frontend
    embeddings from a numpy seed, empty decode caches."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.launch.specs import WHISPER_MEMORY_LEN
    from repro_torch.launch.steps import state_dtype
    from repro_torch.parallel.sharding import shard_tree
    rng = np.random.default_rng(seed)
    full = api.init_params(cfg, seed=seed, device=device)
    params = shard_tree(full, in_sh[0])

    def draw(t):
        if t.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, size=tuple(t.shape))
            return torch.from_numpy(a.astype(np.int32)).to(device)
        a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=t.dtype)

    if shape.kind == "train":
        opt = adamw.init(params, state_dtype=state_dtype(cfg))
        batch = shard_tree({k: draw(v) for k, v in structs[2].items()},
                           in_sh[2])
        return params, opt, batch
    if shape.kind == "prefill":
        return params, shard_tree({k: draw(v) for k, v in
                                   structs[1].items()}, in_sh[1])
    caches = shard_tree(api.init_decode_caches(
        full, cfg, shape.global_batch, shape.seq_len,
        memory_len=WHISPER_MEMORY_LEN), in_sh[1])
    token = in_sh[2].shard(draw(structs[2])).contiguous()
    cache_len = in_sh[3].shard(torch.full(
        tuple(structs[3].shape), shape.seq_len // 2, dtype=torch.int32,
        device=device)).contiguous()
    return params, caches, token, cache_len


def _peak_bytes(device) -> tuple:
    import resource
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(), "cuda_max_allocated"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, \
        "peak_rss"


def _rank_cells(rank, world, cells, mesh_shape, axes, reduced, device,
                distributed, opts):
    """One gloo rank: every cell's step once -> [record of this rank]."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch import tree
    from repro_torch.parallel import collectives, meshctx
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(mesh_shape, axes)
    out = []
    for arch, shape_name in cells:
        cfg = _config(arch, reduced)
        shape = _shape(shape_name)
        rec = {"rank": rank, "status": "ok"}
        try:
            fn, in_sh, _, structs = build_step(cfg, shape, mesh,
                                               distributed=distributed)
            args = _inputs(cfg, shape, structs, in_sh, device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            collectives.reset_counters()
            t0 = time.perf_counter()
            with kops.use_kernels(False), meshctx.with_opts(*opts):
                cost = analysis.step_cost(fn, *args)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            rec["step_s"] = time.perf_counter() - t0
            coll = analysis.collective_bytes()
            arg_bytes = sum(t.numel() * t.element_size()
                            for t in tree.leaves(args))
            peak, kind = _peak_bytes(device)
            rec.update(argument_bytes=arg_bytes, peak_bytes=peak,
                       peak_kind=kind, flops=cost["flops"], collectives=coll,
                       roofline=analysis.roofline_terms(
                           cost["flops"] * world, arg_bytes * world,
                           coll["total"] * world, world))
            del args
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        out.append(rec)
    return out


def run_on_ranks(cells, mesh_shape=(2, 4), *, axes=("data", "model"),
                 reduced: bool = True, device: str = "cpu",
                 out_dir: str = ARTIFACT_DIR, tag: str = "",
                 distributed: bool = True, opts: tuple = (),
                 verbose: bool = True) -> list:
    """Every cell of ``cells`` ((arch, shape name) pairs) once on one
    ``localrun`` of prod(mesh_shape) gloo ranks -> its records (written)."""
    from repro_torch.launch import analysis
    from repro_torch.parallel import localrun
    world = math.prod(mesh_shape)
    mesh_name = "ranks" + "x".join(str(s) for s in mesh_shape)
    todo, recs = [], []
    for arch, shape_name in cells:
        cfg, shape = _config(arch, reduced), _shape(shape_name)
        ok, why = applicable(cfg, shape)
        if ok:
            todo.append((arch, shape_name))
        else:
            rec = _base(arch, shape, mesh_name, tag, reduced)
            rec["reason"] = why
            recs.append(_write(rec, out_dir))
    if not todo:
        return recs
    t0 = time.perf_counter()
    try:
        ranks = localrun.run(_rank_cells, world, todo, tuple(mesh_shape),
                             tuple(axes), reduced, device, distributed,
                             tuple(opts))
        err = None
    except Exception as e:
        ranks, err = None, f"{type(e).__name__}: {e}"
    for i, (arch, shape_name) in enumerate(todo):
        cfg, shape = _config(arch, reduced), _shape(shape_name)
        rec = _base(arch, shape, mesh_name, tag, reduced)
        rec.update(chips=world, device=device, opts=list(opts),
                   model_flops=analysis.model_flops(cfg, shape),
                   params=cfg.param_count(),
                   active_params=cfg.active_param_count(),
                   scan_trips=_scan_trips(cfg))
        if ranks is None:
            rec.update(status="error", error=err)
        else:
            per = [r[i] for r in ranks]
            bad = [r for r in per if r["status"] != "ok"]
            rec["ranks"] = per
            if bad:
                rec.update(status="error", error=bad[0]["error"])
            else:
                rec.update(
                    status="ok",
                    step_s=max(r["step_s"] for r in per),
                    per_device_bytes=max(r["argument_bytes"] for r in per),
                    peak_bytes=max(r["peak_bytes"] for r in per),
                    cost_flops_per_device=max(r["flops"] for r in per),
                    collectives_per_device=max(
                        per, key=lambda r: r["collectives"]["total"]
                    )["collectives"],
                    roofline=analysis.roofline_terms(
                        sum(r["flops"] for r in per),
                        sum(r["argument_bytes"] for r in per),
                        sum(r["collectives"]["total"] for r in per), world))
        if verbose:
            if rec["status"] == "ok":
                print(f"{arch:24s} {shape.kind:8s} ok {rec['step_s']:6.2f}s "
                      f"flops/rank={rec['cost_flops_per_device']:.2e} "
                      f"args/rank={rec['per_device_bytes']} "
                      f"coll/rank={rec['collectives_per_device']['total']:.2e}"
                      f" peak={rec['peak_bytes']} on {mesh_name}")
            else:
                print(f"{arch:24s} {shape.kind:8s} ERROR {rec['error']}")
        recs.append(_write(rec, out_dir))
    if verbose:
        print(f"{len(todo)} cells on {world} ranks in "
              f"{time.perf_counter() - t0:.1f}s")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (assigned 10)")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + SHAPE_ORDER + SMALL_ORDER)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--tag", default="", help="artifact suffix (perf variants)")
    ap.add_argument("--opts", default="",
                    help="comma list: sorted,sp_attn,scatter_cache")
    ap.add_argument("--mesh", default="",
                    help="run on a mesh of local gloo ranks, e.g. 2x4 "
                         "(data x model); default: shape-only on the "
                         "production meshes")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs, MoE at fse_dp; with --shape all "
                         "the (64, 8) train / prefill / decode cells")
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device with --mesh (cuda or cpu)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)
    if opts and not args.tag:
        args.tag = "+".join(opts)
    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    if args.shape != "all":
        shapes = [args.shape]
    else:
        shapes = SMALL_ORDER if args.reduced else SHAPE_ORDER
    if args.mesh:
        from repro_torch.device import resolve_device
        resolve_device(args.device)
        mesh = tuple(int(s) for s in args.mesh.lower().split("x"))
        axes = ("data", "model") if len(mesh) == 2 else \
            ("pod", "data", "model")[-len(mesh):]
        recs = run_on_ranks([(a, s) for a in archs for s in shapes], mesh,
                            axes=axes, reduced=args.reduced,
                            device=args.device, out_dir=args.out,
                            tag=args.tag, opts=opts)
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        recs = [run_cell(a, s, multi_pod=mp, out_dir=args.out, tag=args.tag,
                         opts=opts, reduced=args.reduced)
                for a in archs for s in shapes for mp in meshes]
    raise SystemExit(1 if any(r["status"] == "error" for r in recs) else 0)


if __name__ == "__main__":
    main()
