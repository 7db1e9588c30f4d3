"""The port's mesh steps (``launch.steps``) on gloo ranks, on the CPU, in
fp32 with the plain versions, against the reference.

The reference's own sharded steps do not run under the installed JAX
(``jax.make_mesh`` gives Explicit axes, which its sharding constraints
refuse; with Auto axes its train step fails on ``psum``'s variance
check), so each step is held to the reference's single-device function,
whose values GSPMD would keep: ``jax.value_and_grad(api.loss_fn)`` and
``adamw.apply(lr=1e-4)`` for the train step, ``prefill_fn`` (the last
position's logits) and ``decode_fn`` for the prefill and serve steps.
The reference runs in one subprocess with 4 fake CPU devices
(``tests/conftest.py`` keeps the flag out of pytest's own process).

Configs: reduced granite, reduced Jamba (MoE at ``fse_dp``, capacity
factor E / k so that no rank drops a token one device keeps) and reduced
Whisper, fp32, on a (2, 2) ("data", "model") mesh; granite also on (2, 4)
and with ZeRO-3 (fsdp) forced on.  Holds:

* the train step's loss within 1e-5 relative of the reference's, and
  every gathered leaf of the new params, m and v within 2e-4 of the
  leaf's max |.|.  These runs set ``aux_loss_coef`` to 0: on a mesh the
  FSE-DP bodies' load-balance loss is the mean over the ranks of each
  rank's own (the reference's ``pmean_all`` in ``core/fse_dp.py``), not
  one device's over every token, so with the aux term on, the reference's
  sharded step would not compute one device's loss either.  The aux term
  is held instead by ``test_aux_loss_is_the_reference_mesh_loss``: the
  step's loss at granite's own coefficient equals the reference's
  ``loss_fn`` on its own (2, 2) mesh of fake devices (forward only);
  ``test_dropping_loss_is_the_reference_mesh_loss`` does the same at
  granite's own capacity factor too, where each rank's capacity drops
  tokens;
* ``unshard=True`` (the per-period gather) equal to ``unshard=False``
  (the stack gathered once) bit for bit, fsdp off and on;
* at rest each rank stores the d_expert slice of every expert, never a
  whole stack (its m equals one device's slice, so its gradient does);
* the prefill step's ``logits[:, -1:]`` and the serve step's logits
  (from the reference's prefill caches) within 1e-4 of max |logits|;
* a checkpoint saved from (2, 2) restored onto (1, 4) and onto one
  process bit for bit.
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
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.parallel.sharding import path_key

LOSS_TOL, LEAF_TOL, LOGIT_TOL = 1e-5, 2e-4, 1e-4
LR = 1e-4
B, S, PROMPT, FRAMES = 4, 32, 24, 32
TRAIN = ShapeSpec("mesh_train", S, B, "train")
PREFILL = ShapeSpec("mesh_prefill", S, B, "prefill")
DECODE = ShapeSpec("mesh_decode", S, B, "decode")
ARCHS = {"granite": "granite-moe-1b-a400m", "jamba": "jamba-v0.1-52b",
         "whisper": "whisper-base"}
# (config, mesh, fsdp, unshard): the train runs on the ranks
TRAIN_RUNS = {(2, 2): [("granite", False, False), ("granite", False, True),
                       ("granite", True, True), ("granite", True, False),
                       ("jamba", False, False), ("jamba", False, True),
                       ("whisper", False, False), ("whisper", False, True)],
              (2, 4): [("granite", False, False), ("granite", True, True)]}
PARITY = [(m, c, f) for m, runs in TRAIN_RUNS.items()
          for c, f, u in runs if u == f]


def _config(name, reduced_config, aux=False, drop=False):
    """fp32, MoE at fse_dp; ``aux``: the config's own load-balance
    coefficient, else 0; ``drop``: the config's own capacity factor, else
    E / k (drop-free)."""
    cfg = reduced_config(ARCHS[name]).replace(dtype="float32")
    if cfg.moe is None:
        return cfg
    moe = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        moe, impl="fse_dp",
        capacity_factor=(moe.capacity_factor if drop
                         else moe.num_experts / moe.top_k),
        aux_loss_coef=moe.aux_loss_coef if aux else 0.0))


def _inputs():
    """Per config: the port's seed-0 parameters and the batches."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    rng = np.random.default_rng(0)
    out = {}
    for name in ARCHS:
        cfg = _config(name, reduced_config)
        for path, t in tree.leaves_with_path(api.init_params(
                cfg, seed=0, device="cpu")):
            out[f"{name}/params/{path}"] = t.numpy()
        T = S if name != "whisper" else PROMPT
        toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
        out[f"{name}/train/tokens"] = toks[:, :-1]
        labels = toks[:, 1:].copy()
        labels[0, -3:] = -1                 # unscored positions
        out[f"{name}/train/labels"] = labels
        out[f"{name}/prefill/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        out[f"{name}/token"] = rng.integers(0, cfg.vocab_size,
                                            (B, 1)).astype(np.int32)
        if name == "whisper":
            for kind in ("train", "prefill"):
                out[f"{name}/{kind}/frames"] = rng.standard_normal(
                    (B, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _batch(arrays, name, kind, to):
    pre = f"{name}/{kind}/"
    return {k[len(pre):]: to(v) for k, v in arrays.items()
            if k.startswith(pre)}


def _cache_len(name):
    # the reference's encoder-decoder prefill leaves the self-attention
    # cache empty, so its decode starts at 0
    return 0 if name == "whisper" else PROMPT


def _unflatten(arrays, prefix, to):
    """The ``prefix/...`` arrays back into a tree (integer levels become
    tuples)."""
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
# the reference, in a subprocess with 4 fake devices
# ---------------------------------------------------------------------------


def _reference_main(inp, out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.kernels import ops as jops
    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro.parallel import meshctx as jmesh
    from repro.parallel import sharding as jshd

    def flat(prefix, t):
        return {f"{prefix}/{jshd.path_key(p)}": np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(t)[0]}

    arrays = dict(np.load(inp))
    res = {}
    with jops.use_kernels(False):
        for name in ARCHS:
            cfg = _config(name, jreduced)
            params = _unflatten(arrays, f"{name}/params", jnp.asarray)
            batch = _batch(arrays, name, "train", jnp.asarray)
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: japi.loss_fn(p, batch, cfg), has_aux=True))(params)
            p2, st, _ = jax.jit(lambda p, g: jadamw.apply(
                p, g, jadamw.init(p), lr=LR))(params, grads)
            res[f"{name}/loss"] = np.asarray(loss)
            res.update(flat(f"{name}/new/params", p2))
            res.update(flat(f"{name}/new/m", st.m))
            res.update(flat(f"{name}/new/v", st.v))
            pb = _batch(arrays, name, "prefill", jnp.asarray)
            logits, caches = jax.jit(lambda p, b: japi.prefill_fn(
                p, b, cfg, S))(params, pb)
            res[f"{name}/prefill_logits"] = np.asarray(logits[:, -1:])
            res.update(flat(f"{name}/caches", caches))
            token = jnp.asarray(arrays[f"{name}/token"])
            cache_len = jnp.full((B,), _cache_len(name), jnp.int32)
            logits, _ = jax.jit(lambda p, tk, c, n: japi.decode_fn(
                p, tk, c, n, cfg))(params, token, caches, cache_len)
            res[f"{name}/decode_logits"] = np.asarray(logits)
    # granite's loss at its own aux coefficient on the reference's (2, 2)
    # mesh (Auto axes: its constraints refuse Explicit ones)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = _unflatten(arrays, "granite/params", jnp.asarray)
    batch = _batch(arrays, "granite", "train", jnp.asarray)
    for key, drop in (("aux", False), ("drop", True)):
        cfg = _config("granite", jreduced, aux=True, drop=drop)
        with jops.use_kernels(False), jmesh.with_mesh(mesh):
            loss, _ = jax.jit(lambda p, b: japi.loss_fn(p, b, cfg))(params,
                                                                    batch)
        res[f"granite/loss_mesh_{key}"] = np.asarray(loss)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


def _numpy_tree(prefix, t):
    return {f"{prefix}/{k}": v.detach().numpy()
            for k, v in tree.leaves_with_path(t)}


def _port_rank(rank, world, mesh_shape, inp, want_path, ckpt_dir):
    from repro_torch.checkpointing import manager
    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd

    arrays = dict(np.load(inp))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    t = lambda a: torch.from_numpy(np.array(a))
    out = {}
    for name, fsdp, unshard in TRAIN_RUNS[mesh_shape]:
        cfg = _config(name, reduced_config)
        fn, (psh, osh, bsh), out_sh, _ = steps.train_step_for(
            cfg, TRAIN, mesh, fsdp=fsdp, lr=LR, unshard=unshard)
        full = api.init_params(cfg, seed=0, device="cpu")
        params = steps.shard_tree(full, psh)
        opt = steps.shard_tree(adamw.init(full), osh)
        if name == "granite" and not fsdp:
            w = params["periods"][0]["moe"]["w_up"]
            out["granite/stored_w_up"] = np.asarray(w.shape)
        batch = steps.shard_tree(_batch(arrays, name, "train", t), bsh)
        params, opt, loss = fn(params, opt, batch)
        tag = f"{name}|{fsdp}|{unshard}"
        out[f"{tag}/loss"] = loss.numpy()
        out.update(_numpy_tree(f"{tag}/params", steps.gather_tree(params,
                                                                  psh)))
        out.update(_numpy_tree(f"{tag}/m", steps.gather_tree(opt.m, psh)))
        out.update(_numpy_tree(f"{tag}/v", steps.gather_tree(opt.v, psh)))
        if mesh_shape == (2, 2) and (name, fsdp, unshard) == \
                ("granite", False, False):
            manager.save(ckpt_dir, 1, params, shardings=psh)
            out.update(_numpy_tree("saved", steps.gather_tree(params, psh)))
    if mesh_shape != (2, 2):
        return out
    # granite's loss at its own aux coefficient, drop-free and at its own
    # capacity factor
    for key, drop in (("aux", False), ("drop", True)):
        cfg = _config("granite", reduced_config, aux=True, drop=drop)
        fn, (psh, osh, bsh), _, _ = steps.train_step_for(cfg, TRAIN, mesh,
                                                         fsdp=False, lr=LR)
        full = api.init_params(cfg, seed=0, device="cpu")
        _, _, loss = fn(steps.shard_tree(full, psh),
                        steps.shard_tree(adamw.init(full), osh),
                        steps.shard_tree(_batch(arrays, "granite", "train",
                                                t), bsh))
        out[f"granite/loss_{key}"] = loss.numpy()
    want = dict(np.load(want_path))
    for name in ARCHS:
        cfg = _config(name, reduced_config)
        full = api.init_params(cfg, seed=0, device="cpu")
        fn, (psh, bsh), (lsh, _), _ = steps.build_prefill_step(cfg, PREFILL,
                                                              mesh)
        logits, _ = fn(steps.shard_tree(full, psh), steps.shard_tree(
            _batch(arrays, name, "prefill", t), bsh))
        out[f"{name}/prefill_logits"] = lsh.gather(logits).numpy()
        fn, (psh, csh, tsh, lensh), (lsh, _), (_, cstruct, _, _) = \
            steps.build_serve_step(cfg, DECODE, mesh)
        caches = tree.unflatten(cstruct, [
            t(want[f"{name}/caches/{shd.path_key(k)}"])
            for k, _ in tree.leaves_with_path(cstruct)])
        logits, _ = fn(steps.shard_tree(full, psh),
                       steps.shard_tree(caches, csh),
                       tsh.shard(t(arrays[f"{name}/token"])),
                       lensh.shard(torch.full((B,), _cache_len(name),
                                              dtype=torch.int32)))
        out[f"{name}/decode_logits"] = lsh.gather(logits).numpy()
    return out


def _restore_rank(rank, world, ckpt_dir):
    """Restore the (2, 2) checkpoint onto a (1, 4) mesh."""
    from repro_torch.checkpointing import manager
    from repro_torch.configs import reduced_config
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh((1, 4), ("data", "model"))
    cfg = _config("granite", reduced_config)
    struct = specs.params_struct(cfg)
    psh = shd.param_shardings(struct, mesh, fsdp=False)
    blocks, step, _ = manager.restore(ckpt_dir, struct, shardings=psh)
    return step, _numpy_tree("restored", steps.gather_tree(blocks, psh)), \
        [tuple(b.shape) for b in tree.leaves(blocks)]


@pytest.fixture(scope="module")
def runs():
    from repro_torch.checkpointing import manager
    from repro_torch.configs import reduced_config
    from repro_torch.launch import specs
    from repro_torch.parallel import localrun
    with tempfile.TemporaryDirectory() as tmp:
        inp, want_path = os.path.join(tmp, "in.npz"), \
            os.path.join(tmp, "ref.npz")
        ckpt = os.path.join(tmp, "ckpt")
        np.savez(inp, **_inputs())
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        ref = subprocess.Popen([sys.executable, __file__, inp, want_path],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        try:        # (2, 4) reads no reference output: run it meanwhile
            port = {(2, 4): localrun.run(_port_rank, 8, (2, 4), inp,
                                         want_path, ckpt)}
        finally:
            log, _ = ref.communicate(timeout=600)
        assert ref.returncode == 0, log
        want = dict(np.load(want_path))
        port[(2, 2)] = localrun.run(_port_rank, 4, (2, 2), inp, want_path,
                                    ckpt)
        restored = localrun.run(_restore_rank, 4, ckpt)
        one, step, _ = manager.restore(ckpt, specs.params_struct(
            _config("granite", reduced_config)))
        one = (step, _numpy_tree("restored", one))
    return port, want, restored, one


def _leaf_errs(got, want):
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
            for k, w in want.items()}


@pytest.mark.parametrize("mesh,name,fsdp", PARITY,
                         ids=[f"{c}-{m[0]}x{m[1]}-fsdp{int(f)}"
                              for m, c, f in PARITY])
def test_train_step_matches_one_device(runs, mesh, name, fsdp):
    port, want, _, _ = runs
    tag = f"{name}|{fsdp}|{fsdp}"
    for rank in port[mesh]:
        np.testing.assert_allclose(rank[f"{tag}/loss"], want[f"{name}/loss"],
                                   rtol=LOSS_TOL)
    got = port[mesh][0]
    for part in ("params", "m", "v"):
        pre_w, pre_g = f"{name}/new/{part}/", f"{tag}/{part}/"
        ref = {k[len(pre_w):]: v for k, v in want.items()
               if k.startswith(pre_w)}
        mine = {k[len(pre_g):]: v for k, v in got.items()
                if k.startswith(pre_g)}
        mine = {path_key(k): v for k, v in mine.items()}
        assert set(mine) == set(ref)
        errs = _leaf_errs(mine, ref)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_TOL, (part, worst, errs[worst])


@pytest.mark.parametrize("name,fsdp", [("granite", False), ("granite", True),
                                       ("jamba", False), ("whisper", False)])
def test_unshard_is_bit_for_bit(runs, name, fsdp):
    port, _, _, _ = runs
    for rank in port[(2, 2)]:
        a = {k.split("/", 1)[1]: v for k, v in rank.items()
             if k.startswith(f"{name}|{fsdp}|True/")}
        b = {k.split("/", 1)[1]: v for k, v in rank.items()
             if k.startswith(f"{name}|{fsdp}|False/")}
        assert a and a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_experts_stored_as_slices(runs):
    """granite: E = 8, d = 64, d_expert = 64 over a model axis of 2 and 4."""
    port, _, _, _ = runs
    for mesh, P in (((2, 2), 2), ((2, 4), 4)):
        for rank in port[mesh]:
            assert tuple(rank["granite/stored_w_up"]) == (2, 8, 64, 64 // P)


def test_aux_loss_is_the_reference_mesh_loss(runs):
    port, want, _, _ = runs
    for rank in port[(2, 2)]:
        np.testing.assert_allclose(rank["granite/loss_aux"],
                                   want["granite/loss_mesh_aux"],
                                   rtol=LOSS_TOL)


def test_dropping_loss_is_the_reference_mesh_loss(runs):
    """At granite's own capacity factor (1.25) each rank's capacity drops
    tokens: the loss moves off the drop-free one and stays the
    reference's."""
    port, want, _, _ = runs
    assert abs(float(want["granite/loss_mesh_drop"])
               - float(want["granite/loss_mesh_aux"])) > 1e2 * LOSS_TOL
    for rank in port[(2, 2)]:
        np.testing.assert_allclose(rank["granite/loss_drop"],
                                   want["granite/loss_mesh_drop"],
                                   rtol=LOSS_TOL)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_serving_steps_match_one_device(runs, name, kind):
    port, want, _, _ = runs
    w = want[f"{name}/{kind}_logits"]
    for rank in port[(2, 2)]:
        got = rank[f"{name}/{kind}_logits"]
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= LOGIT_TOL * np.abs(w).max()


def test_elastic_restore_onto_1x4(runs):
    port, _, restored, _ = runs
    saved = {k.split("/", 1)[1]: v for k, v in port[(2, 2)][0].items()
             if k.startswith("saved/")}
    for step, tree_np, shapes in restored:
        assert step == 1
        got = {k.split("/", 1)[1]: v for k, v in tree_np.items()}
        assert got.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    # the (1, 4) blocks are a quarter of the experts' d_expert
    assert (2, 8, 64, 16) in restored[0][2]


def test_elastic_restore_onto_one_process(runs):
    port, _, _, (step, one) = runs
    saved = {k.split("/", 1)[1]: v for k, v in port[(2, 2)][0].items()
             if k.startswith("saved/")}
    got = {k.split("/", 1)[1]: v for k, v in one.items()}
    assert step == 1 and got.keys() == saved.keys()
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
