"""The distributed MoE families on 8 gloo ranks: port vs JAX, on the CPU.

The reference runs in one subprocess on its (2, 4) ``("data", "model")``
mesh of 8 fake CPU devices (``tests/conftest.py`` keeps the flag out of
pytest's own process), with ``use_kernels(False)``: its jnp oracle.  The
port runs the same cases on one ``parallel.localrun`` of 8 gloo ranks laid
out as the same mesh, each rank holding its data group's rows and the full
parameters.  Both sides take the same numpy-seeded inputs and weights
(E = 8, top-2, d = 32, d_expert = 64, B = 4, S = 16, as the reference's
``fsedp_modes.py``).

Holds: the port's ``moe_fse_dp`` (stream / index / slice, forced plans),
``moe_ep``, ``moe_tp`` and ``strategy.execute("auto")``, gated (swiglu)
and gateless (relu2), one-hot and sorted dispatch, equal the reference's
within 2e-5 of max |y| (fp32 ``streamed_moe``'s tolerance) and its aux
within 1e-6, under the static schedule, the in-call dynamic one and a
host-built EMA one; within the port, dynamic == static and a forced plan
== the hand-forced body, bit for bit; ``layer_overrides`` on a 4-layer toy
== per-layer forced runs, bit for bit; and ``api.loss_fn`` on reduced
granite (``impl="fse_dp"``, drop-free) on the mesh equals the
reference's on its mesh, and its CE the reference's single-device
``capacity`` CE, within 1e-5 relative.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import api

E, K, D, DE, B, S = 8, 2, 32, 64, 4, 16
MESH = ((2, 4), ("data", "model"))
P_MODEL, N_DATA = 4, 2
B_GRP = B // N_DATA
Y_TOL = 2e-5
AUX_TOL = 1e-6
LOSS_TOL = 1e-5
ACTS = ("swiglu", "relu2")
DISPATCH = ("onehot", "sorted")
MODES = ("stream", "index", "slice")
SCHEDULES = ("static", "dynamic", "ema")
# (strategy, activation, dispatch): the reference's cases; fse_dp forced
# per mode, ep / tp / auto and the planner's own fse_dp plan
CASES = [(f"fse_dp:{m}", a, disp) for m in MODES for a in ACTS
         for disp in DISPATCH]
CASES += [(n, a, "onehot") for n in ("ep", "tp", "auto", "fse_dp")
          for a in ACTS]
OVERRIDES = ("fse_dp", "ep", "fse_dp", "ep")
GRANITE = "granite-moe-1b-a400m"


def _moe_cfg():
    return dict(num_experts=E, top_k=K, d_expert=DE, capacity_factor=E / K,
                micro_slices=2)


def _granite_cfg(cfg=None):
    """Reduced granite in fp32 under ``fse_dp``, drop-free (capacity
    factor E / k): each rank sizes its capacity from its own tokens, so
    with drops its CE differs from one device's by design (the
    reference's mesh run differs the same way)."""
    cfg = (cfg or reduced_config(GRANITE)).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, impl="fse_dp",
        capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _inputs():
    """x, per-activation MoE weights and the granite batch, from seeds."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    out = {"x": rng.standard_normal((B, S, D)).astype(f32)}
    for a in ACTS:
        out[f"{a}/w_router"] = (rng.standard_normal((D, E)) / D ** 0.5
                                ).astype(f32)
        for k in (("w_gate", "w_up") if a == "swiglu" else ("w_up",)):
            out[f"{a}/{k}"] = (rng.standard_normal((E, D, DE)) / D ** 0.5
                               ).astype(f32)
        out[f"{a}/w_down"] = (rng.standard_normal((E, DE, D)) / DE ** 0.5
                              ).astype(f32)
    cfg = _granite_cfg()
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    out["tokens"] = tokens
    out["labels"] = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], 1)
    params = api.init_params(cfg, seed=0, device="cpu")
    for path, t in tree.leaves_with_path(params):
        out["granite/" + path] = t.numpy()
    return out


def _moe_params(arrays, act, to):
    p = {"router": {"w_router": to(arrays[f"{act}/w_router"])},
         "w_up": to(arrays[f"{act}/w_up"]),
         "w_down": to(arrays[f"{act}/w_down"])}
    if act == "swiglu":
        p["w_gate"] = to(arrays[f"{act}/w_gate"])
    return p


def _unflatten(arrays, prefix, to):
    """The ``prefix`` leaves of ``tree.leaves_with_path`` paths back into
    a tree (levels with integer keys become tuples)."""
    root = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = root, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = to(v)

    def fix(n):
        if not isinstance(n, dict):
            return n
        n = {k: fix(v) for k, v in n.items()}
        if n and all(k.isdigit() for k in n):
            return tuple(n[str(i)] for i in range(len(n)))
        return n
    return fix(root)


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 8 fake devices
# ---------------------------------------------------------------------------


def _reference_main(inp, out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.configs.base import MoEConfig as JMoE
    from repro.core import autotune as jat
    from repro.core import strategy as jst
    from repro.kernels import ops as jops
    from repro.models import api as japi
    from repro.models import moe as jmoe
    from repro.parallel import meshctx as jmesh

    arrays = dict(np.load(inp))
    moe = JMoE(**_moe_cfg())
    # Auto axes: the forward's sharding constraints refuse Explicit ones
    mesh = jax.make_mesh(*MESH, axis_types=(jax.sharding.AxisType.Auto,) * 2)
    x = jnp.asarray(arrays["x"])
    res = {}
    with jops.use_kernels(False), jat.use_autotune("analytic"), \
            jmesh.with_mesh(mesh):
        for name, act, disp in CASES:
            params = _moe_params(arrays, act, jnp.asarray)
            strat, _, mode = name.partition(":")
            plan = None if not mode else jat.plan_moe(
                B_GRP, S, D, moe, act, P_MODEL, dtype_bytes=4, mode=mode)
            with jmoe.use_sorted_dispatch(disp == "sorted"):
                y, aux = jax.jit(lambda p, xx: jst.execute(
                    strat, p, xx, moe, act, plan=plan))(params, x)
            res[f"{name}|{act}|{disp}|y"] = np.asarray(y)
            res[f"{name}|{act}|{disp}|aux"] = np.asarray(aux)
        jcfg = _granite_cfg(jreduced(GRANITE))
        gp = _unflatten(arrays, "granite", jnp.asarray)
        batch = {"tokens": jnp.asarray(arrays["tokens"]),
                 "labels": jnp.asarray(arrays["labels"])}
        loss, m = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(gp, batch)
        res["loss_mesh"] = np.asarray([loss, m["ce"], m["aux"]])
    with jops.use_kernels(False):
        loss, m = japi.loss_fn(gp, batch, jcfg, spec="capacity")
        res["loss_capacity"] = np.asarray([loss, m["ce"], m["aux"]])
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port, on 8 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank, world, inp):
    from repro_torch.core import autotune, fse_dp, strategy, trajectory
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.parallel import meshctx

    arrays = dict(np.load(inp))
    mesh = meshctx.ProcessMesh.create(*MESH)
    dg, r = mesh.index("data"), mesh.index("model")
    rows = slice(dg * B_GRP, (dg + 1) * B_GRP)
    x = torch.from_numpy(arrays["x"][rows])
    moe = MoEConfig(**_moe_cfg())
    tracker = trajectory.LoadTracker(E, decay=0.8)
    rng = np.random.default_rng(0)
    for _ in range(4):
        tracker.update(rng.integers(0, 12, size=E))
    out = {}
    with torch.no_grad(), autotune.use_autotune("analytic"), \
            meshctx.with_mesh(mesh):
        for name, act, disp in CASES:
            params = _moe_params(arrays, act, torch.from_numpy)
            strat, _, mode = name.partition(":")
            plan = None if not mode else autotune.plan_moe(
                B_GRP, S, D, moe, act, P_MODEL, dtype_bytes=4, mode=mode)
            sched = {"static": None, "dynamic": trajectory.DYNAMIC,
                     "ema": tracker.schedule(plan=plan)}
            with moe_mod.use_sorted_dispatch(disp == "sorted"):
                for s, schedule in sched.items():
                    y, aux = strategy.execute(strat, params, x, moe, act,
                                              plan=plan, schedule=schedule)
                    out[f"{name}|{act}|{disp}|{s}|y"] = y.numpy()
                    out[f"{name}|{act}|{disp}|{s}|aux"] = aux.numpy()
                if mode:        # the hand-forced body, as moe_fse_dp runs it
                    w = fse_dp.shard_expert_weights(params, r, P_MODEL)
                    xl = x[:, r * S // P_MODEL:(r + 1) * S // P_MODEL] \
                        if mode == "stream" else x
                    y, _ = fse_dp.BODIES[mode](
                        xl, params["router"]["w_router"], *w, moe=moe,
                        activation=act, mesh=mesh, axis="model",
                        micro_slices=plan.micro_slices,
                        kopts=plan.kernel_opts())
                    if mode == "stream":
                        from repro_torch.parallel import collectives
                        y = collectives.all_gather(y, mesh, "model", dim=1)
                    out[f"{name}|{act}|{disp}|forced|y"] = y.numpy()
        # layer_overrides on a 4-layer toy vs per-layer forced runs
        toy = ModelConfig(name="toy-moe-4l", family="moe", num_layers=4,
                          d_model=D, num_heads=4, num_kv_heads=4, d_ff=0,
                          vocab_size=64, dtype="float32",
                          moe=MoEConfig(**_moe_cfg(), impl="fse_dp"))
        tp = api.init_params(toy, seed=1, device="cpu")
        tokens = torch.from_numpy(arrays["tokens"][rows] % toy.vocab_size)
        spec = ExecutionSpec(strategy="fse_dp", layer_overrides=dict(
            enumerate(OVERRIDES)))
        out["toy|spec"], aux1 = (t.numpy() for t in transformer.forward(
            tp, tokens, toy, spec=spec))
        h = transformer._embed(tp, tokens)
        pos = torch.arange(S)[None, :]
        aux2 = torch.zeros(())
        for layer, slot, mixer, ffn_kind in transformer.layer_slots(tp, toy):
            h, a = transformer._apply_slot_full(
                slot, h, toy, mixer, ffn_kind, positions=pos,
                spec=ExecutionSpec(strategy=OVERRIDES[layer]), layer=layer,
                use_flash=False)
            aux2 = aux2 + a
        out["toy|forced"] = transformer._unembed(tp, transformer.apply_norm(
            toy.norm, tp["final_norm"], h)).numpy()
        out["toy|aux"] = np.asarray([aux1, aux2.numpy()])
        slot0 = next(transformer.layer_slots(tp, toy))[1]["moe"]
        hx = torch.from_numpy(arrays["x"][rows])
        out["toy|block"] = np.asarray([torch.equal(
            moe_mod.moe_block(slot0, hx, toy.moe, toy.activation, spec=spec,
                              layer=i),
            moe_mod.moe_block(slot0, hx, toy.moe, toy.activation,
                              spec=OVERRIDES[i])) for i in range(4)])
        # the slice as a whole: loss_fn on this data group's rows
        cfg = _granite_cfg()
        gp = _unflatten(arrays, "granite", torch.from_numpy)
        batch = {"tokens": torch.from_numpy(arrays["tokens"][rows]),
                 "labels": torch.from_numpy(arrays["labels"][rows])}
        loss, m = api.loss_fn(gp, batch, cfg)
        out["loss"] = np.asarray([loss, m["ce"], m["aux"]])
    from repro_torch.parallel import collectives
    out["collectives"] = dict(collectives.COUNTS)
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.parallel import localrun
    with tempfile.TemporaryDirectory() as tmp:
        inp, ref_out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        arrays = _inputs()
        np.savez(inp, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        ref = subprocess.Popen([sys.executable, __file__, inp, ref_out],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        try:
            port = localrun.run(_port_rank, 8, inp)
        finally:
            log, _ = ref.communicate(timeout=600)
        assert ref.returncode == 0, log
        want = dict(np.load(ref_out))
    return port, want


def _global(port, key):
    """The port's global array: each data group's rows from its model rank
    0, after checking every model rank of the group holds the same bits."""
    parts = []
    for dg in range(N_DATA):
        group = [port[dg * P_MODEL + r][key] for r in range(P_MODEL)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        parts.append(group[0])
    return np.concatenate(parts, 0)


def _aux(port, key):
    vals = [p[key] for p in port]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name,act,disp", CASES)
def test_port_matches_reference(runs, name, act, disp, schedule):
    port, want = runs
    y = _global(port, f"{name}|{act}|{disp}|{schedule}|y")
    wy = want[f"{name}|{act}|{disp}|y"]
    assert y.shape == wy.shape == (B, S, D)
    assert np.isfinite(y).all()
    assert np.abs(y - wy).max() <= Y_TOL * np.abs(wy).max()
    aux = _aux(port, f"{name}|{act}|{disp}|{schedule}|aux")
    assert abs(float(aux) - float(want[f"{name}|{act}|{disp}|aux"])) \
        <= AUX_TOL


@pytest.mark.parametrize("schedule", ("dynamic", "ema"))
@pytest.mark.parametrize("name,act,disp", CASES)
def test_dynamic_equals_static(runs, name, act, disp, schedule):
    port, _ = runs
    for rank in port:
        for part in ("y", "aux"):
            np.testing.assert_array_equal(
                rank[f"{name}|{act}|{disp}|{schedule}|{part}"],
                rank[f"{name}|{act}|{disp}|static|{part}"])


@pytest.mark.parametrize("name,act,disp",
                         [c for c in CASES if ":" in c[0]])
def test_forced_plan_equals_hand_forced_body(runs, name, act, disp):
    port, _ = runs
    for rank in port:
        np.testing.assert_array_equal(rank[f"{name}|{act}|{disp}|forced|y"],
                                      rank[f"{name}|{act}|{disp}|static|y"])


@pytest.mark.parametrize("op", ["ring_shift", "all_to_all", "psum",
                                "all_gather"])
def test_ranks_communicated(runs, op):
    """The cases ran the distributed bodies, not one device's path."""
    port, _ = runs
    assert all(rank["collectives"].get(op, 0) > 0 for rank in port)


def test_mesh_context_without_ranks():
    """The mesh functions the reference's model code calls, on a mesh laid
    out row-major as ``jax.make_mesh`` lays out devices."""
    from repro_torch.parallel import meshctx
    assert meshctx.get_mesh() is None and meshctx.model_axis_size() == 1
    sizes, names = MESH
    for r in range(8):
        coords = tuple(meshctx._unravel(r, sizes))
        assert coords == (r // 4, r % 4)
        assert meshctx._ravel(coords, sizes) == r
    mesh = meshctx.ProcessMesh(names, sizes, (1, 2), (None, None),
                               ((2, 6), (4, 5, 6, 7)), 6)
    with meshctx.with_mesh(mesh):
        assert meshctx.get_mesh() is mesh
        assert meshctx.model_axis_size() == 4
        assert meshctx.model_axis_size("data") == 2
        assert meshctx.model_axis_size("pipe") == 1
        assert (mesh.world_size, mesh.index("model"), mesh.line("data")) == \
            (8, 2, (2, 6))
    assert meshctx.get_mesh() is None
    with meshctx.with_opts("sorted"):
        assert meshctx.opt_enabled("sorted")
        assert not meshctx.opt_enabled("sp_attn")
    assert not meshctx.opt_enabled("sorted")


def test_distributed_bodies_refuse_autograd():
    """The bodies' grouped GEMM is differentiable: its gradients are the
    reference oracle's VJP (the streamed_moe backward), to fp32 rounding.
    (The name is the test's from when the port had no backward and the
    bodies raised under autograd.)"""
    from repro_torch.core import fse_dp
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    xe = torch.randn((2, 3, 8), generator=g, requires_grad=True)
    wu = torch.randn((2, 8, 4), generator=g, requires_grad=True)
    wd = torch.randn((2, 4, 8), generator=g, requires_grad=True)
    got = torch.autograd.grad(
        fse_dp._expert_partial(xe, None, wu, wd, "relu2").square().sum(),
        (xe, wu, wd))
    want = torch.autograd.grad(
        ref.streamed_moe_ref(xe, None, wu, wd, "relu2").square().sum(),
        (xe, wu, wd))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_layer_overrides_match_forced_layers(runs):
    port, _ = runs
    for rank in port:
        np.testing.assert_array_equal(rank["toy|spec"], rank["toy|forced"])
        np.testing.assert_array_equal(rank["toy|aux"][0], rank["toy|aux"][1])
        assert rank["toy|block"].all()


@pytest.mark.parametrize("want_key,parts", [("loss_mesh", slice(0, 3)),
                                            ("loss_capacity", slice(1, 2))])
def test_granite_loss_on_the_mesh(runs, want_key, parts):
    """(loss, ce, aux), the mean over the data groups of each group's
    (equal row counts), against the reference's on its mesh; the CE
    against its single-device ``capacity`` run (the aux is a mean of
    per-rank values on a mesh, so it differs from one device's there)."""
    port, want = runs
    got = np.mean([_aux(port[dg * P_MODEL:(dg + 1) * P_MODEL], "loss")
                   for dg in range(N_DATA)], 0)
    np.testing.assert_allclose(got[parts], want[want_key][parts],
                               rtol=LOSS_TOL)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
